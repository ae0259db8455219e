"""Idemix anonymous credentials on FP256BN (reference idemix/ package):
the scheme over the port's dict messages and the batched verification of
BASELINE config #3 on the card."""

from fabric_tpu_torch.idemix.scheme import (
    ALG_NO_REVOCATION,
    IdemixError,
    check_issuer_public_key,
    ecp2_from_proto,
    ecp2_to_proto,
    ecp_from_proto,
    ecp_to_proto,
    make_nym,
    new_cred_request,
    new_credential,
    new_issuer_key,
    new_signature,
    verify_cred_request,
    verify_signature,
)

__all__ = [
    "ALG_NO_REVOCATION",
    "IdemixError",
    "check_issuer_public_key",
    "ecp2_from_proto",
    "ecp2_to_proto",
    "ecp_from_proto",
    "ecp_to_proto",
    "make_nym",
    "new_cred_request",
    "new_credential",
    "new_issuer_key",
    "new_signature",
    "verify_cred_request",
    "verify_signature",
]
