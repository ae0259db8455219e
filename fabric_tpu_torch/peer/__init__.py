"""The peer's commit path: a channel's block checks, validation and ledger, and the two-stage commit pipeline."""
