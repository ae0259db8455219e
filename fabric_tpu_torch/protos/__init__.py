"""Hand-written proto3 wire codec for the messages the ledger path reads and writes."""
