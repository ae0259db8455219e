"""Curve constants, the P-256 oracle and the DER codec (host code)."""
