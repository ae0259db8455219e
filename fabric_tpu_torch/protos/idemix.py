"""The Idemix wire messages (the JAX package's `protos/src/idemix.proto`) as
tables for the port's codec (`protos/wire.py`).

The bytes must be protobuf's to the byte: `IssuerPublicKey.hash` is the hash
of the serialized key and enters every Fiat-Shamir challenge.
"""

from __future__ import annotations

from fabric_tpu_torch.protos.wire import Field, Schema, _msg, decode, encode

ECP: Schema = {1: Field("x", "bytes"), 2: Field("y", "bytes")}
ECP2: Schema = {
    1: Field("xa", "bytes"),
    2: Field("xb", "bytes"),
    3: Field("ya", "bytes"),
    4: Field("yb", "bytes"),
}
ISSUER_PUBLIC_KEY: Schema = {
    1: Field("attribute_names", "string", repeated=True),
    2: _msg("h_sk", ECP),
    3: _msg("h_rand", ECP),
    4: _msg("h_attrs", ECP, repeated=True),
    5: _msg("w", ECP2),
    6: _msg("bar_g1", ECP),
    7: _msg("bar_g2", ECP),
    8: Field("proof_c", "bytes"),
    9: Field("proof_s", "bytes"),
    10: Field("hash", "bytes"),
}
ISSUER_KEY: Schema = {1: Field("isk", "bytes"), 2: _msg("ipk", ISSUER_PUBLIC_KEY)}
CREDENTIAL: Schema = {
    1: _msg("a", ECP),
    2: _msg("b", ECP),
    3: Field("e", "bytes"),
    4: Field("s", "bytes"),
    5: Field("attrs", "bytes", repeated=True),
}
CRED_REQUEST: Schema = {
    1: _msg("nym", ECP),
    2: Field("issuer_nonce", "bytes"),
    3: Field("proof_c", "bytes"),
    4: Field("proof_s", "bytes"),
}
NON_REVOCATION_PROOF: Schema = {
    1: Field("revocation_alg", "int32"),
    2: Field("non_revocation_proof", "bytes"),
}
SIGNATURE: Schema = {
    1: _msg("a_prime", ECP),
    2: _msg("a_bar", ECP),
    3: _msg("b_prime", ECP),
    4: Field("proof_c", "bytes"),
    5: Field("proof_s_sk", "bytes"),
    6: Field("proof_s_e", "bytes"),
    7: Field("proof_s_r2", "bytes"),
    8: Field("proof_s_r3", "bytes"),
    9: Field("proof_s_s_prime", "bytes"),
    10: Field("proof_s_attrs", "bytes", repeated=True),
    11: Field("nonce", "bytes"),
    12: _msg("nym", ECP),
    13: Field("proof_s_r_nym", "bytes"),
    14: _msg("revocation_epoch_pk", ECP2),
    15: Field("revocation_pk_sig", "bytes"),
    16: Field("epoch", "int64"),
    17: _msg("non_revocation_proof", NON_REVOCATION_PROOF),
}
NYM_SIGNATURE: Schema = {
    1: Field("proof_c", "bytes"),
    2: Field("proof_s_sk", "bytes"),
    3: Field("proof_s_r_nym", "bytes"),
    4: Field("nonce", "bytes"),
}
CREDENTIAL_REVOCATION_INFORMATION: Schema = {
    1: Field("epoch", "int64"),
    2: _msg("epoch_pk", ECP2),
    3: Field("epoch_pk_sig", "bytes"),
    4: Field("revocation_alg", "int32"),
    5: Field("revocation_data", "bytes"),
}

__all__ = [
    "CREDENTIAL",
    "CREDENTIAL_REVOCATION_INFORMATION",
    "CRED_REQUEST",
    "ECP",
    "ECP2",
    "ISSUER_KEY",
    "ISSUER_PUBLIC_KEY",
    "NON_REVOCATION_PROOF",
    "NYM_SIGNATURE",
    "SIGNATURE",
    "decode",
    "encode",
]
