"""Host utilities: the native host runtime (batched SHA-256, DER and block parse)."""
