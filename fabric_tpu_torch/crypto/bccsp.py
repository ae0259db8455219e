"""The BCCSP provider SPI, as much of it as the device provider needs.

Shaped after Fabric's provider interface (bccsp/bccsp.go: Hash / Verify)
plus the batch extension the validator feeds: ``batch_verify``. The verify
decision is Fabric's verifyECDSA (bccsp/sw/ecdsa.go:41-57): DER unmarshal,
then the low-S rule, then the curve equation.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.utils import native


@dataclass(frozen=True)
class ECDSAPublicKey:
    """An imported P-256 public key."""

    x: int
    y: int

    @property
    def point(self) -> Tuple[int, int]:
        return (self.x, self.y)

    def ski(self) -> bytes:
        """Subject Key Identifier: SHA-256 of the uncompressed point
        (bccsp/sw/ecdsakey.go SKI)."""
        return hashlib.sha256(p256.pubkey_to_bytes(self.point)).digest()


@dataclass(frozen=True)
class ECDSAPrivateKey:
    d: int
    public: ECDSAPublicKey


class VerifyError(Exception):
    """Verification *errors* (vs. a clean False), mirroring Fabric's
    (bool, error) split: malformed DER and high-S return an error, a failed
    curve equation returns (false, nil)."""


class Provider:
    """SPI. Verify semantics contract (bccsp/sw/ecdsa.go verifyECDSA):

    - signature fails DER unmarshal or has non-positive R/S -> VerifyError
    - S > N/2 (not low-S)                                   -> VerifyError
    - otherwise                                             -> bool
    """

    def hash(self, msg: bytes) -> bytes:
        return hashlib.sha256(msg).digest()

    def batch_hash(self, msgs: Sequence[bytes]) -> List[bytes]:
        """One digest per message, through the native library's batched
        SHA-256; equal to [self.hash(m) for m in msgs]."""
        return [bytes(d) for d in native.batch_sha256(msgs)]

    def key_import(self, raw: bytes) -> ECDSAPublicKey:
        x, y = p256.pubkey_from_bytes(raw)
        return ECDSAPublicKey(x, y)

    def verify(self, key: ECDSAPublicKey, signature: bytes, digest: bytes) -> bool:
        raise NotImplementedError

    def batch_verify(
        self,
        keys: Sequence[ECDSAPublicKey],
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ) -> List[bool]:
        """Batched verification; host parse/low-S failures map to False."""
        out = []
        for k, sig, d in zip(keys, signatures, digests, strict=True):
            try:
                out.append(self.verify(k, sig, d))
            except VerifyError:
                out.append(False)
        return out

    def describe_backend(self) -> str:
        """Short label of the execution path batches actually take."""
        return type(self).__name__


def parse_and_precheck(signature: bytes) -> Tuple[int, int]:
    """Host-side DER unmarshal + low-S gate.

    Raises VerifyError exactly where Fabric returns an error.
    """
    try:
        r, s = der.unmarshal_signature(signature)
    except der.DerError as e:
        raise VerifyError(f"failed unmarshalling signature [{e}]") from e
    if not p256.is_low_s(s):
        raise VerifyError("invalid S, must be smaller than half the order")
    return r, s
