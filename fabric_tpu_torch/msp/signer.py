"""Signing identities (reference msp SigningIdentity + signer package).

The port's counterpart of the JAX package's `msp/signer.py`. Transaction
nonces and ECDSA nonces come from a seeded `random.Random`: test and smoke
material, never a production signer.
"""

from __future__ import annotations

import random

from fabric_tpu_torch.common import p256
from fabric_tpu_torch.msp.cryptogen import NodeIdentity, sign_der
from fabric_tpu_torch.protos import protoutil


class SigningIdentity:
    """An identity that can sign: wraps a NodeIdentity's cert + key."""

    def __init__(self, node: NodeIdentity, rng: random.Random):
        self.node = node
        self.msp_id = node.msp_id
        self.rng = rng
        self._serialized = protoutil.serialize_identity(node.msp_id, node.cert_pem)

    def serialize(self) -> bytes:
        return self._serialized

    def sign(self, msg: bytes) -> bytes:
        """SHA-256 digest then low-S ECDSA, DER-encoded (msp/identities.go Sign)."""
        return sign_der(self.node.priv_scalar, p256.sha256(msg), self.rng)

    def new_nonce(self) -> bytes:
        return self.rng.getrandbits(192).to_bytes(24, "big")
