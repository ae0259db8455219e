"""Limb arithmetic, field ops and the P-256 verify kernels with their plain versions."""
