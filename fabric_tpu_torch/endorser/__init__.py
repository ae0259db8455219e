"""Endorsement-side transaction construction (reference core/endorser +
protoutil/txutils.go CreateSignedTx) and the endorser service
(`endorser.Endorser.process_proposal`)."""
