"""The ledger's commit-time state path: rwsets, the state DB, MVCC on the host and on the card, and the commit hash."""
