"""Multi-channel validation (one block per channel, every signature in one launch) and the verify batcher channels share."""
