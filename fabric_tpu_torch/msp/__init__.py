"""Membership Service Provider: X.509 identities, validation, principals, and
the test material generator."""
