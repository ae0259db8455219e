"""Block validation: the block parse, state-based endorsement and the block
validator that writes TRANSACTIONS_FILTER."""
