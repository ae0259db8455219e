"""The ledger: rwsets, the state DB (in memory and in SQLite), MVCC on the host and on the card, the commit hash, the block and private-data stores, and KVLedger over them."""
