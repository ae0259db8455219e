"""Conversions between the JAX package's number layout and the kernel's.

The JAX package (and the port's plain versions) hold a 256-bit number as
20 little-endian 13-bit limbs, limb-major (20, B), and Montgomery residues
with R = 2^260. The CUDA kernels compute on 8 little-endian 32-bit words
with R = 2^256: the P-256 kernel's table of multiples of G is in that form,
and so are the FP256BN pairing kernel's line schedules and the values its
debug entry writes. These host functions let the tests and the smoke feed
both packages the same inputs and compare their tables and outputs.
"""

from __future__ import annotations

import numpy as np

from fabric_tpu_torch.common import p256
from fabric_tpu_torch.common.limbparams import NLIMBS, RADIX_BITS
from fabric_tpu_torch.ops import bignum as bn

NWORDS = 8


def _ints_to_words(vals) -> np.ndarray:
    out = np.zeros((NWORDS, len(vals)), dtype=np.uint32)
    for j, v in enumerate(vals):
        if v >> (32 * NWORDS):
            raise ValueError("value does not fit in 256 bits")
        for i in range(NWORDS):
            out[i, j] = (v >> (32 * i)) & 0xFFFFFFFF
    return out


def limbs13_to_words(limbs) -> np.ndarray:
    """(20, B) canonical 13-bit limbs -> (8, B) uint32 words."""
    return _ints_to_words(bn.limbs_to_ints(limbs))


def words_to_limbs13(words) -> np.ndarray:
    """(8, B) uint32 words -> (20, B) uint32 13-bit limbs."""
    words = np.asarray(words)
    vals = [
        sum(int(words[i, j]) << (32 * i) for i in range(NWORDS))
        for j in range(words.shape[1])
    ]
    return np.array([bn.int_to_limbs(v) for v in vals], dtype=np.uint32).T.reshape(NLIMBS, -1)


def g_table_from_reference(table) -> np.ndarray:
    """JAX's `g_small_table()` ((16, 3, 20) 13-bit limbs, Montgomery
    R = 2^260) -> the kernel's (16, 3, 8) uint32 words with R = 2^256.

    A residue v = x * 2^260 mod p becomes x * 2^256 = v * 2^-4 mod p."""
    table = np.asarray(table)
    inv16 = pow(1 << (RADIX_BITS - 32 * NWORDS), -1, p256.P)
    out = np.zeros((table.shape[0], table.shape[1], NWORDS), dtype=np.uint32)
    for d in range(table.shape[0]):
        vals = bn.limbs_to_ints(table[d].T)
        out[d] = _ints_to_words([(v * inv16) % p256.P for v in vals]).T
    return out


def _rescale(vals, modulus, shift: int):
    """Montgomery residues times 2^shift mod `modulus` (shift may be < 0)."""
    if modulus is None:
        return vals
    f = pow(2, shift, modulus) if shift >= 0 else pow(1 << -shift, -1, modulus)
    return [(v * f) % modulus for v in vals]


def limbs_to_words(limbs, axis: int = 0, modulus=None) -> np.ndarray:
    """13-bit limbs along `axis` (length 20) -> 32-bit words along `axis`
    (length 8), any other axes kept. With `modulus`, the values are
    Montgomery residues with R = 2^260 and come out with R = 2^256
    (v * 2^-4 mod modulus): points, scalars (no modulus) and the rows of
    line schedules alike."""
    a = np.moveaxis(np.asarray(limbs), axis, -1)
    flat = a.reshape(-1, NLIMBS).T
    vals = _rescale(bn.limbs_to_ints(flat), modulus, 32 * NWORDS - RADIX_BITS)
    out = _ints_to_words(vals).T.reshape(a.shape[:-1] + (NWORDS,))
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


def words_to_limbs(words, axis: int = 0, modulus=None) -> np.ndarray:
    """The inverse of `limbs_to_words`: 32-bit words along `axis` -> 13-bit
    limbs (uint32), Montgomery R = 2^256 -> 2^260 with `modulus`."""
    a = np.moveaxis(np.asarray(words).astype(np.uint32), axis, -1)
    flat = a.reshape(-1, NWORDS)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in flat]
    vals = _rescale(vals, modulus, RADIX_BITS - 32 * NWORDS)
    out = np.array([bn.int_to_limbs(v) for v in vals], dtype=np.uint32)
    out = out.reshape(a.shape[:-1] + (NLIMBS,))
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))
