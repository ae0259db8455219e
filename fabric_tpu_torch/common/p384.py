"""NIST P-384 (secp384r1): the Idemix revocation authority's long-term key.

The JAX package takes this key from the `cryptography` package
(`fabric_tpu/idemix/scheme.py:691-744`, `fabric_tpu/cli/idemixgen.py:40-60`),
which the card's machine does not have. This module is the port's own: the
curve, Jacobian arithmetic (the shape of `common/p256.py`), ECDSA over a
32-byte SHA-256 digest, DER signatures, and keys with SubjectPublicKeyInfo
and PKCS#8 PEMs whose bytes equal `cryptography`'s for the same scalar.

The reference signs with `ec.ECDSA(Prehashed(SHA256()))`, so e is the
digest read as a big-endian integer: 256 bits are fewer than 384, and
nothing is truncated. Verification is Go's `ecdsa.Verify` and OpenSSL's:
1 <= r, s < n and the signature in canonical DER, with no low-S rule (the
P-256 path's Fabric rule is not applied to this key by either).

Departure: the nonce k, and a generated key's scalar, come from the
`random.Random` the caller passes, where `cryptography` draws them from the
OS. The port makes every input from a seed.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

from fabric_tpu_torch.common import der
from fabric_tpu_torch.common.x509 import X509Error, _enc, _tlv, pem_decode, pem_encode

# Curve parameters (SEC 2 secp384r1).
P = 2**384 - 2**128 - 2**96 + 2**32 - 1
A = P - 3
B = 0xB3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF
GX = 0xAA87CA22BE8B05378EB1C71EF320AD746E1D3B628BA79B9859F741E082542A385502F25DBF55296C3A545E3872760AB7
GY = 0x3617DE4A96262C6F5D9E98BF9292DC29F8F41DBD289A147CE9DA3113B5F0B8C00A60B1CE1D7E819D7A431D7C90EA0E5F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFC7634D81F4372DDF581A0DB248B0A77AECEC196ACCC52973

FIELD_BYTES = 48
DIGEST_BYTES = 32  # SHA-256, the only hash the reference signs with

# Affine points are (x, y) tuples; None is the point at infinity.
AffinePoint = Optional[Tuple[int, int]]
GENERATOR: Tuple[int, int] = (GX, GY)

# OIDs as DER content bytes
OID_EC_PUBLIC_KEY = bytes.fromhex("2a8648ce3d0201")  # 1.2.840.10045.2.1
OID_SECP384R1 = bytes.fromhex("2b81040022")  # 1.3.132.0.34


class SignatureError(ValueError):
    """A signature that does not verify (cryptography's InvalidSignature)."""


def is_on_curve(pt: AffinePoint) -> bool:
    if pt is None:
        return False
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x + A * x + B)) % P == 0


# ---------------------------------------------------------------------------
# Jacobian arithmetic (X, Y, Z) with x = X / Z^2, y = Y / Z^3; Z = 0 is O
# ---------------------------------------------------------------------------

_O = (1, 1, 0)


def _double(p):
    """dbl-2001-b (a = -3)."""
    x1, y1, z1 = p
    if z1 == 0 or y1 == 0:
        return _O
    delta = z1 * z1 % P
    gamma = y1 * y1 % P
    beta = x1 * gamma % P
    alpha = 3 * (x1 - delta) * (x1 + delta) % P
    x3 = (alpha * alpha - 8 * beta) % P
    z3 = ((y1 + z1) ** 2 - gamma - delta) % P
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % P
    return (x3, y3, z3)


def _add(p, q):
    """add-2007-bl, falling back to doubling for equal points."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    h = (u2 - u1) % P
    r = 2 * (s2 - s1) % P
    if h == 0:
        return _double(p) if r == 0 else _O
    i = 4 * h * h % P
    j = h * i % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) * h % P
    return (x3, y3, z3)


def _to_affine(p) -> AffinePoint:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _jacobian(pt: AffinePoint):
    return _O if pt is None else (pt[0], pt[1], 1)


def point_add(p1: AffinePoint, p2: AffinePoint) -> AffinePoint:
    return _to_affine(_add(_jacobian(p1), _jacobian(p2)))


def scalar_mult(k: int, pt: AffinePoint) -> AffinePoint:
    """k * pt by double-and-add from the top bit."""
    k %= N
    acc = _O
    q = _jacobian(pt)
    for bit in bin(k)[2:] if k else "":
        acc = _double(acc)
        if bit == "1":
            acc = _add(acc, q)
    return _to_affine(acc)


def mult_add(u1: int, u2: int, q: Tuple[int, int]) -> AffinePoint:
    """u1 * G + u2 * q (Shamir's trick, one doubling chain)."""
    g, qj = _jacobian(GENERATOR), _jacobian(q)
    both = _add(g, qj)
    acc = _O
    for i in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
        acc = _double(acc)
        b1, b2 = u1 >> i & 1, u2 >> i & 1
        if b1 and b2:
            acc = _add(acc, both)
        elif b1:
            acc = _add(acc, g)
        elif b2:
            acc = _add(acc, qj)
    return _to_affine(acc)


# ---------------------------------------------------------------------------
# ECDSA over a SHA-256 digest
# ---------------------------------------------------------------------------


def _digest_int(digest: bytes) -> int:
    if len(digest) != DIGEST_BYTES:
        raise ValueError(
            f"the digest must be {DIGEST_BYTES} bytes (SHA-256), got {len(digest)}")
    return int.from_bytes(digest, "big")


def sign_digest(priv: int, digest: bytes, rng: random.Random) -> Tuple[int, int]:
    """(r, s) over the digest, the nonce k drawn from `rng`."""
    e = _digest_int(digest)
    while True:
        k = rng.randrange(1, N)
        pt = scalar_mult(k, GENERATOR)
        r = pt[0] % N
        s = pow(k, -1, N) * (e + r * priv) % N
        if r and s:
            return r, s


def verify_digest(pub: Tuple[int, int], digest: bytes, r: int, s: int) -> bool:
    """Raw ECDSA verification (Go's ecdsa.Verify; no low-S rule)."""
    if not (1 <= r < N and 1 <= s < N) or not is_on_curve(pub):
        return False
    e = _digest_int(digest)
    w = pow(s, -1, N)
    pt = mult_add(e * w % N, r * w % N, pub)
    return pt is not None and pt[0] % N == r


def parse_signature(sig: bytes) -> Tuple[int, int]:
    """(r, s) of a DER signature in canonical form (OpenSSL re-encodes what
    it parses and refuses any difference); raises SignatureError."""
    try:
        r, s = der.unmarshal_signature(sig)
    except der.DerError as exc:
        raise SignatureError(f"malformed signature: {exc}") from exc
    if der.marshal_signature(r, s) != sig:
        raise SignatureError("signature is not canonical DER")
    return r, s


# ---------------------------------------------------------------------------
# Keys and their PEMs
# ---------------------------------------------------------------------------


def _read_tlv(buf: bytes, off: int, tag: int, what: str) -> Tuple[int, int]:
    """(content start, content end) of the element at `off`, which must
    carry `tag`."""
    got, start, end = _tlv(buf, off, len(buf))
    if got != tag:
        raise X509Error(f"{what}: expected tag {tag:#x}, got {got:#x}")
    return start, end


_ALGORITHM = _enc(0x30, _enc(0x06, OID_EC_PUBLIC_KEY) + _enc(0x06, OID_SECP384R1))


def _point_bytes(pt: Tuple[int, int]) -> bytes:
    return b"\x04" + pt[0].to_bytes(FIELD_BYTES, "big") + pt[1].to_bytes(FIELD_BYTES, "big")


def _point_from_bytes(raw: bytes) -> Tuple[int, int]:
    if len(raw) != 1 + 2 * FIELD_BYTES or raw[0] != 0x04:
        raise X509Error("expected a 97-byte uncompressed P-384 point")
    pt = (int.from_bytes(raw[1:1 + FIELD_BYTES], "big"), int.from_bytes(raw[1 + FIELD_BYTES:], "big"))
    if not is_on_curve(pt):
        raise X509Error("the public key is not on P-384")
    return pt


class ECDSAP384PublicKey:
    def __init__(self, x: int, y: int):
        if not is_on_curve((x, y)):
            raise ValueError("the public key is not on P-384")
        self.x, self.y = x, y

    @property
    def point(self) -> Tuple[int, int]:
        return (self.x, self.y)

    def spki_der(self) -> bytes:
        return _enc(0x30, _ALGORITHM + _enc(0x03, b"\x00" + _point_bytes(self.point)))

    def public_bytes_pem(self) -> bytes:
        """SubjectPublicKeyInfo PEM, as `public_bytes(PEM, SubjectPublicKeyInfo)`."""
        return pem_encode("PUBLIC KEY", self.spki_der())

    def verify(self, signature: bytes, digest: bytes) -> None:
        """Raise SignatureError unless the DER signature holds over the
        SHA-256 digest."""
        r, s = parse_signature(signature)
        if not verify_digest(self.point, digest, r, s):
            raise SignatureError("signature does not verify")

    def __eq__(self, other) -> bool:
        return isinstance(other, ECDSAP384PublicKey) and self.point == other.point

    def __hash__(self) -> int:
        return hash(self.point)


class ECDSAP384PrivateKey:
    def __init__(self, d: int):
        if not 1 <= d < N:
            raise ValueError("the private scalar must lie in [1, n)")
        self.d = d
        self._public: Optional[ECDSAP384PublicKey] = None

    @classmethod
    def generate(cls, rng: random.Random) -> "ECDSAP384PrivateKey":
        return cls(rng.randrange(1, N))

    def public_key(self) -> ECDSAP384PublicKey:
        if self._public is None:
            self._public = ECDSAP384PublicKey(*scalar_mult(self.d, GENERATOR))
        return self._public

    def sign(self, digest: bytes, rng: random.Random) -> bytes:
        """The DER signature over the SHA-256 digest, the nonce from `rng`."""
        return der.marshal_signature(*sign_digest(self.d, digest, rng))

    def pkcs8_der(self) -> bytes:
        """PKCS#8 with the ECPrivateKey carrying its public key and no
        parameters field, as OpenSSL writes it."""
        ec_private_key = _enc(0x30, _enc(0x02, b"\x01")
                              + _enc(0x04, self.d.to_bytes(FIELD_BYTES, "big"))
                              + _enc(0xA1, _enc(0x03, b"\x00" + _point_bytes(
                                  self.public_key().point))))
        return _enc(0x30, _enc(0x02, b"\x00") + _ALGORITHM + _enc(0x04, ec_private_key))

    def private_bytes_pem(self) -> bytes:
        """PKCS#8 PEM, no encryption, as `private_bytes(PEM, PKCS8,
        NoEncryption())`."""
        return pem_encode("PRIVATE KEY", self.pkcs8_der())


def load_pem_public_key(data: bytes) -> ECDSAP384PublicKey:
    """A P-384 SubjectPublicKeyInfo PEM."""
    buf = pem_decode("PUBLIC KEY", data)
    start, end = _read_tlv(buf, 0, 0x30, "SubjectPublicKeyInfo")
    if buf[start:start + len(_ALGORITHM)] != _ALGORITHM:
        raise X509Error("not an EC public key on P-384")
    bits_start, bits_end = _read_tlv(buf, start + len(_ALGORITHM), 0x03, "subjectPublicKey")
    if bits_end != end or buf[bits_start] != 0:
        raise X509Error("malformed subjectPublicKey")
    return ECDSAP384PublicKey(*_point_from_bytes(buf[bits_start + 1:bits_end]))


def load_pem_private_key(data: bytes) -> ECDSAP384PrivateKey:
    """A P-384 PKCS#8 PEM without encryption. The optional parameters and
    public key of the ECPrivateKey are accepted; a public key that is not
    the scalar's raises."""
    buf = pem_decode("PRIVATE KEY", data)
    start, end = _read_tlv(buf, 0, 0x30, "PrivateKeyInfo")
    if buf[start:start + 3] != b"\x02\x01\x00":
        raise X509Error("unsupported PKCS#8 version")
    off = start + 3
    if buf[off:off + len(_ALGORITHM)] != _ALGORITHM:
        raise X509Error("not an EC private key on P-384")
    inner_start, inner_end = _read_tlv(buf, off + len(_ALGORITHM), 0x04, "privateKey")
    seq_start, seq_end = _read_tlv(buf, inner_start, 0x30, "ECPrivateKey")
    if buf[seq_start:seq_start + 3] != b"\x02\x01\x01":
        raise X509Error("unsupported ECPrivateKey version")
    d_start, d_end = _read_tlv(buf, seq_start + 3, 0x04, "privateKey scalar")
    key = ECDSAP384PrivateKey(int.from_bytes(buf[d_start:d_end], "big"))
    off = d_end
    if off < seq_end and buf[off] == 0xA0:
        params_start, params_end = _read_tlv(buf, off, 0xA0, "parameters")
        if buf[params_start:params_end] != _enc(0x06, OID_SECP384R1):
            raise X509Error("ECPrivateKey parameters are not P-384")
        off = params_end
    if off < seq_end and buf[off] == 0xA1:
        pub_start, _ = _read_tlv(buf, off, 0xA1, "publicKey")
        bits_start, bits_end = _read_tlv(buf, pub_start, 0x03, "publicKey bits")
        if _point_from_bytes(buf[bits_start + 1:bits_end]) != key.public_key().point:
            raise X509Error("the public key is not the private scalar's")
    return key
