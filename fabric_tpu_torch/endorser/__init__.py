"""Endorsement-side transaction construction (reference core/endorser +
protoutil/txutils.go CreateSignedTx), for tests and the chip smoke."""
