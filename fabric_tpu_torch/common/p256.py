"""Pure-Python NIST P-256 (secp256r1) arithmetic and ECDSA: the port's oracle.

A small big-int implementation of the verification semantics of Go's
crypto/ecdsa.Verify plus Fabric's low-S rule (bccsp/sw/ecdsa.go:41-57,
bccsp/utils/ecdsa.go). The batched kernels are tested against it. It is
written for clarity, not speed. Signing takes an explicit nonce: the port
makes every input from a fixed seed.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

# Curve parameters (FIPS 186-4 / SEC2 secp256r1).
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
# Fabric accepts only low-S signatures: s <= N >> 1.
HALF_N = N >> 1

# Affine points are (x, y) tuples; None is the point at infinity.
AffinePoint = Optional[Tuple[int, int]]

GENERATOR: Tuple[int, int] = (GX, GY)


def is_on_curve(pt: AffinePoint) -> bool:
    if pt is None:
        return True
    x, y = pt
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x + A * x + B)) % P == 0


def point_add(p1: AffinePoint, p2: AffinePoint) -> AffinePoint:
    """Affine group law (slow; oracle only). Inverses use Python's
    extended-Euclid pow(x, -1, m), about ten times faster than Fermat."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None  # p1 == -p2
        lam = (3 * x1 * x1 + A) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def scalar_mult(k: int, pt: AffinePoint) -> AffinePoint:
    """k * pt by double-and-add (oracle only)."""
    k %= N
    result: AffinePoint = None
    addend = pt
    while k:
        if k & 1:
            result = point_add(result, addend)
        addend = point_add(addend, addend)
        k >>= 1
    return result


_G_POWERS = []  # affine 2^i * G for i < 256, built on first use


def base_mult(k: int) -> AffinePoint:
    """k * G for signing and key generation: the table of 2^i * G summed in
    Jacobian coordinates (mixed additions, one inversion at the end), some
    twenty times faster than `scalar_mult`. Where a partial sum meets a
    table point or its negative, it returns `scalar_mult(k, G)`."""
    if not _G_POWERS:
        pt = GENERATOR
        for _ in range(256):
            _G_POWERS.append(pt)
            pt = point_add(pt, pt)
    k %= N
    acc = None  # Jacobian (X, Y, Z)
    for i in range(k.bit_length()):
        if not k >> i & 1:
            continue
        x2, y2 = _G_POWERS[i]
        if acc is None:
            acc = (x2, y2, 1)
            continue
        x1, y1, z1 = acc
        z1z1 = z1 * z1 % P
        h = (x2 * z1z1 - x1) % P
        r = 2 * (y2 * z1 * z1z1 - y1) % P
        if h == 0:  # doubling or the point at infinity (madd-2007-bl excludes both)
            return scalar_mult(k, GENERATOR)
        hh = h * h % P
        i4 = 4 * hh
        j = h * i4
        v = x1 * i4
        x3 = (r * r - j - 2 * v) % P
        acc = (x3, (r * (v - x3) - 2 * y1 * j) % P, ((z1 + h) ** 2 - z1z1 - hh) % P)
    if acc is None:
        return None
    x, y, z = acc
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def hash_to_int(digest: bytes) -> int:
    """Leftmost-bits digest truncation, matching Go crypto/ecdsa hashToInt."""
    if len(digest) > 32:
        digest = digest[:32]
    return int.from_bytes(digest, "big")


def is_low_s(s: int) -> bool:
    """Fabric's low-S rule: s <= N>>1 (bccsp/utils/ecdsa.go IsLowS)."""
    return s <= HALF_N


def verify_digest(pub: Tuple[int, int], digest: bytes, r: int, s: int) -> bool:
    """Raw ECDSA verification (Go crypto/ecdsa.Verify semantics).

    Does NOT apply the low-S rule; callers check is_low_s first.
    """
    if not (1 <= r < N and 1 <= s < N):
        return False
    if pub is None or not is_on_curve(pub):
        return False
    e = hash_to_int(digest)
    w = pow(s, -1, N)
    u1 = (e * w) % N
    u2 = (r * w) % N
    pt = point_add(scalar_mult(u1, GENERATOR), scalar_mult(u2, pub))
    if pt is None:
        return False
    return pt[0] % N == r


def sign_digest(
    priv: int, digest: bytes, k: int, low_s: bool = True
) -> Tuple[int, int]:
    """ECDSA signing with the caller's nonce `k` (vector generation only).

    Normalizes to low-S like Fabric's signer unless `low_s` is False.
    """
    e = hash_to_int(digest)
    pt = base_mult(k)
    if pt is None:
        raise ValueError("bad fixed nonce: k*G is infinity")
    r = pt[0] % N
    s = (pow(k, -1, N) * (e + r * priv)) % N
    if r == 0 or s == 0:
        raise ValueError("bad fixed nonce: r or s is 0")
    if low_s and not is_low_s(s):
        s = N - s
    return r, s


def pubkey_from_bytes(data: bytes) -> Tuple[int, int]:
    """Parse an uncompressed SEC1 point (0x04 || X || Y) and validate it."""
    if len(data) != 65 or data[0] != 0x04:
        raise ValueError("expected 65-byte uncompressed SEC1 point")
    pt = (int.from_bytes(data[1:33], "big"), int.from_bytes(data[33:65], "big"))
    if not is_on_curve(pt):
        raise ValueError("point not on curve")
    return pt


def pubkey_to_bytes(pub: Tuple[int, int]) -> bytes:
    return b"\x04" + pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
