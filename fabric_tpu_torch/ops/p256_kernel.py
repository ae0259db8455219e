"""Batched ECDSA-P256 verification: the CUDA kernels and their plain versions.

`verify_batch` (K1, limb inputs) and `verify_batch_bytes` (K2, byte inputs
with a distinct-key table) are the wrappers of the two entry points of
`csrc/p256_verify.cu`. Given CUDA tensors they launch the kernel on the
current stream and do not synchronize; given CPU tensors they run the plain
versions `verify_batch_ref` / `verify_batch_bytes_ref`. Anything else
raises; there is no fallback.

The plain versions mirror the JAX package's `ops/p256_kernel` step for
step: 13-bit limbs with R = 2^260, complete Renes-Costello-Batina formulas
(a = -3), s^-1 by Fermat, u1*G + u2*Q by a 4-bit-window Horner loop from
the identity (one Python loop over the 64 windows), and the projective
final check X == r*Z or X == (r+n)*Z (the latter only when r < p - n),
AND-ed with the host's valid_in mask.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from fabric_tpu_torch.common import p256
from fabric_tpu_torch.ops import bignum as bn
from fabric_tpu_torch.ops import cudalib
from fabric_tpu_torch.ops import fieldops as fo

CTX_P = bn.MontCtx(p256.P)
CTX_N = bn.MontCtx(p256.N)

_R = 1 << bn.RADIX_BITS
WINDOW_BITS = 4
NUM_WINDOWS = 64  # 256 bits / 4

FIELD = fo.Field(CTX_P)
FE = fo.FE
Point = fo.Point
fe_mul = FIELD.mul
fe_add = FIELD.add
fe_sub = FIELD.sub

# Kernel launches per entry point, counted by the wrappers below where they
# launch (never for the plain versions).
LAUNCHES: Dict[str, int] = {"p256_verify_bytes": 0, "p256_verify_limbs": 0}

# Work of one verify in the CUDA kernel (see the header of
# csrc/p256_verify.cu): Montgomery multiplies mod n and mod p, and the
# 32x32->64 word products and 32-bit low products they contain. p's words
# are 0, 1 and 2^32 - 1, so its reduction is counted as multiplier-free.
MULS_MOD_N = 1 + (14 + 63 * 4 + 63) + 2
MULS_MOD_P = 2 + 14 * 14 + NUM_WINDOWS * (4 * 13 + 2 * 14) + 4
WORD_PRODUCTS_PER_VERIFY = MULS_MOD_N * 128 + MULS_MOD_P * 64
LOW_PRODUCTS_PER_VERIFY = MULS_MOD_N * 8
# A word product issues as two IMAD slots, a low product as one.
IMAD_PER_VERIFY = 2 * WORD_PRODUCTS_PER_VERIFY + LOW_PRODUCTS_PER_VERIFY


def _col(x: int, device) -> torch.Tensor:
    return torch.tensor(bn.int_to_limbs(x), dtype=torch.int64, device=device).reshape(
        bn.NLIMBS, 1
    )


def fe_norm(a: FE) -> FE:
    return FE(bn.reduce_canonical(CTX_P, a.limbs, a.bound - 1), 1)


@functools.lru_cache(maxsize=None)
def _b_mont(device: torch.device) -> FE:
    return FE(_col((p256.B * _R) % p256.P, device), 1)


# ---------------------------------------------------------------------------
# Point arithmetic (plain versions)
# ---------------------------------------------------------------------------


def point_add(p: Point, q: Point) -> Point:
    """Complete addition, RCB 2016 algorithm 4 (a = -3)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    bb = _b_mont(x1.limbs.device)

    t0 = fe_mul(x1, x2)
    t1 = fe_mul(y1, y2)
    t2 = fe_mul(z1, z2)
    t3 = fe_add(x1, y1)
    t4 = fe_add(x2, y2)
    t3 = fe_mul(t3, t4)
    t4 = fe_add(t0, t1)
    t3 = fe_sub(t3, t4)
    t4 = fe_add(y1, z1)
    t5 = fe_add(y2, z2)
    t4 = fe_mul(t4, t5)
    t5 = fe_add(t1, t2)
    t4 = fe_sub(t4, t5)
    x3 = fe_add(x1, z1)
    y3 = fe_add(x2, z2)
    x3 = fe_mul(x3, y3)
    y3 = fe_add(t0, t2)
    y3 = fe_sub(x3, y3)
    z3 = fe_mul(bb, t2)
    x3 = fe_sub(y3, z3)
    z3 = fe_add(x3, x3)
    x3 = fe_add(x3, z3)
    z3 = fe_sub(t1, x3)
    x3 = fe_add(t1, x3)  # bound 4
    y3 = fe_mul(bb, y3)
    t1 = fe_add(t2, t2)
    t2 = fe_add(t1, t2)
    y3 = fe_sub(y3, t2)
    y3 = fe_sub(y3, t0)
    t1 = fe_add(y3, y3)
    y3 = fe_add(t1, y3)  # bound 3
    t1 = fe_add(t0, t0)
    t0 = fe_add(t1, t0)
    t0 = fe_sub(t0, t2)
    t1 = fe_mul(t4, y3)
    t2 = fe_mul(t0, y3)
    y3 = fe_mul(x3, z3)
    y3 = fe_add(y3, t2)
    x3 = fe_mul(t3, x3)
    x3 = fe_sub(x3, t1)
    z3 = fe_mul(t4, z3)
    t1 = fe_mul(t3, t0)
    z3 = fe_add(z3, t1)
    return Point(x3, fe_norm(y3), fe_norm(z3))


def point_double(p: Point) -> Point:
    """Complete doubling, RCB 2016 algorithm 6 (a = -3)."""
    x, y, z = p
    bb = _b_mont(x.limbs.device)

    t0 = fe_mul(x, x)
    t1 = fe_mul(y, y)
    t2 = fe_mul(z, z)
    t3 = fe_mul(x, y)
    t3 = fe_add(t3, t3)
    z3 = fe_mul(x, z)
    z3 = fe_add(z3, z3)
    y3 = fe_mul(bb, t2)
    y3 = fe_sub(y3, z3)
    x3 = fe_add(y3, y3)
    y3 = fe_add(x3, y3)  # bound 3
    x3 = fe_sub(t1, y3)
    y3 = fe_add(t1, y3)  # bound 4
    y3 = fe_mul(x3, y3)
    x3 = fe_mul(x3, t3)
    t3 = fe_add(t2, t2)
    t2 = fe_add(t2, t3)  # bound 3
    z3 = fe_mul(bb, z3)
    z3 = fe_sub(z3, t2)
    z3 = fe_sub(z3, t0)
    t3 = fe_add(z3, z3)
    z3 = fe_add(z3, t3)  # bound 3
    t3 = fe_add(t0, t0)
    t0 = fe_add(t3, t0)
    t0 = fe_sub(t0, t2)
    t0 = fe_mul(t0, z3)
    y3 = fe_add(y3, t0)
    t0 = fe_mul(y, z)
    t0 = fe_add(t0, t0)
    z3 = fe_mul(t0, z3)
    x3 = fe_sub(x3, z3)
    z3 = fe_mul(t0, t1)
    z3 = fe_add(z3, z3)
    z3 = fe_add(z3, z3)  # bound 4
    return Point(x3, fe_norm(y3), fe_norm(z3))


# ---------------------------------------------------------------------------
# Small multiples of G (host precompute)
# ---------------------------------------------------------------------------


def _g_multiples():
    acc = None
    out = [None]
    for _ in range(1, 16):
        acc = p256.point_add(acc, p256.GENERATOR)
        out.append(acc)
    return out


@functools.lru_cache(maxsize=None)
def g_small_table() -> torch.Tensor:
    """(16, 3, 20) int64: entry d = projective Montgomery (R = 2^260)
    coordinates of d*G, the identity (0 : 1 : 0) at d = 0. The plain
    versions' table, equal to the JAX package's `g_small_table()`."""
    one_m = _R % p256.P
    rows = []
    for pt in _g_multiples():
        if pt is None:
            coords = (0, one_m, 0)
        else:
            coords = ((pt[0] * _R) % p256.P, (pt[1] * _R) % p256.P, one_m)
        rows.append([bn.int_to_limbs(c) for c in coords])
    return torch.tensor(rows, dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def g_table_words() -> np.ndarray:
    """(16, 3, 8) uint32: the kernel's table of d*G, little-endian 32-bit
    words, Montgomery R = 2^256."""
    r = 1 << 256
    out = np.zeros((16, 3, 8), dtype=np.uint32)
    for d, pt in enumerate(_g_multiples()):
        coords = (0, r % p256.P, 0) if pt is None else (
            (pt[0] * r) % p256.P, (pt[1] * r) % p256.P, r % p256.P
        )
        for c, v in enumerate(coords):
            out[d, c] = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    return out


@functools.lru_cache(maxsize=None)
def _g_table_limbs(device: torch.device) -> torch.Tensor:
    return g_small_table().to(device)


@functools.lru_cache(maxsize=None)
def _g_table_device(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(g_table_words().view(np.int32).copy()).to(device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def scalar_digits_msb(u: torch.Tensor) -> torch.Tensor:
    """(20, B) canonical limbs -> (64, B) 4-bit digits, MSB window first."""
    digits = []
    for w in range(NUM_WINDOWS):
        bit = (NUM_WINDOWS - 1 - w) * WINDOW_BITS
        limb, off = divmod(bit, bn.LIMB_BITS)
        d = u[limb] >> off
        if off > bn.LIMB_BITS - WINDOW_BITS and limb + 1 < bn.NLIMBS:
            d = d | (u[limb + 1] << (bn.LIMB_BITS - off))
        digits.append(d & (16 - 1))
    return torch.stack(digits)


def bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 big-endian -> (20, B) int64 13-bit limbs."""
    u = b.to(torch.int64)
    limbs = []
    for j in range(bn.NLIMBS):
        bit_lo = j * bn.LIMB_BITS
        k0, shift = divmod(bit_lo, 8)  # little-endian byte index
        acc = u[:, 31 - k0] >> shift
        if k0 + 1 < 32:
            acc = acc | (u[:, 31 - (k0 + 1)] << (8 - shift))
        if k0 + 2 < 32:
            acc = acc | (u[:, 31 - (k0 + 2)] << (16 - shift))
        limbs.append(acc & bn.LIMB_MASK)
    return torch.stack(limbs)


def _select(table: torch.Tensor, idx: torch.Tensor) -> Point:
    """table (16, 3, 20, B) per lane, or (16, 3, 20) shared; idx (B,)."""
    if table.dim() == 4:
        index = idx.reshape(1, 1, 1, -1).expand(1, 3, bn.NLIMBS, idx.shape[0])
        sel = table.gather(0, index)[0]
    else:
        sel = table[idx].permute(1, 2, 0)
    return Point(FE(sel[0], 1), FE(sel[1], 1), FE(sel[2], 1))


def verify_batch_ref(
    e: torch.Tensor,
    r: torch.Tensor,
    s: torch.Tensor,
    qx: torch.Tensor,
    qy: torch.Tensor,
    valid_in: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K1. Limb inputs (20, B) int64 canonical; valid_in
    (B,) bool (host prechecks). Returns (B,) bool.

    Semantics (Go crypto/ecdsa.Verify): w = s^-1 mod n; u1 = e*w;
    u2 = r*w; accept iff u1*G + u2*Q is not infinity and x mod n == r.
    """
    device = e.device
    batch = e.shape[1]

    # --- scalar field: u1 = e/s, u2 = r/s (mod n) ---
    s_inv = bn.mont_pow(CTX_N, bn.to_mont(CTX_N, s), p256.N - 2)
    e_m = bn.to_mont(CTX_N, e)  # e < 2^256 may exceed n; reduced here
    r_m = bn.to_mont(CTX_N, r)
    u1 = bn.from_mont(CTX_N, bn.mont_mul(CTX_N, e_m, s_inv))
    u2 = bn.from_mont(CTX_N, bn.mont_mul(CTX_N, r_m, s_inv))
    d1 = scalar_digits_msb(u1)
    d2 = scalar_digits_msb(u2)

    # --- per-lane table of small multiples of Q ---
    ident = FIELD.identity(batch, device)
    q_pt = Point(
        FE(bn.to_mont(CTX_P, qx), 1),
        FE(bn.to_mont(CTX_P, qy), 1),
        FE(CTX_P.const("one_mont", device).expand(bn.NLIMBS, batch).clone(), 1),
    )
    rows = [ident, q_pt]
    for _ in range(14):
        rows.append(point_add(rows[-1], q_pt))
    q_table = torch.stack(
        [torch.stack([p.x.limbs, p.y.limbs, p.z.limbs]) for p in rows]
    )  # (16, 3, 20, B)
    g_table = _g_table_limbs(device)

    # --- main window loop: R = 16R + d1*G + d2*Q, MSB first (Horner) ---
    acc = ident
    for w in range(NUM_WINDOWS):
        for _ in range(WINDOW_BITS):
            acc = point_double(acc)
        acc = point_add(acc, _select(q_table, d2[w]))
        acc = point_add(acc, _select(g_table, d1[w]))

    # --- final comparison, projectively: X == v*Z for v in {r, r+n} ---
    x_can = bn.reduce_canonical(CTX_P, acc.x.limbs, acc.x.bound - 1)
    n_col = _col(p256.N, device)
    r_plus_n, _ = bn.carry(r + n_col)  # value < 2^257, fits in 20 limbs
    rz = bn.mont_mul(CTX_P, bn.to_mont(CTX_P, r), acc.z.limbs)
    rpnz = bn.mont_mul(CTX_P, bn.to_mont(CTX_P, r_plus_n), acc.z.limbs)
    # the r+n candidate is an affine x only when r + n < p
    _, borrow = bn.carry(r - _col(p256.P - p256.N, device))
    rpn_in_range = borrow < 0
    matches = bn.eq(x_can, rz) | (rpn_in_range & bn.eq(x_can, rpnz))
    not_inf = ~bn.is_zero(acc.z.limbs)
    return valid_in & not_inf & matches


def verify_batch_bytes_ref(
    e_b: torch.Tensor,
    r_b: torch.Tensor,
    s_b: torch.Tensor,
    kx: torch.Tensor,
    ky: torch.Tensor,
    key_idx: torch.Tensor,
    valid_in: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K2: bytes to limbs, the per-lane key gather, K1."""
    idx = key_idx.to(torch.int64)
    return verify_batch_ref(
        bytes_to_limbs(e_b),
        bytes_to_limbs(r_b),
        bytes_to_limbs(s_b),
        kx[:, idx],
        ky[:, idx],
        valid_in,
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cudalib.load("p256_verify")
    lib.p256_verify_bytes_launch.argtypes = [_P] * 9 + [_I, _I, _P]
    lib.p256_verify_bytes_launch.restype = _I
    lib.p256_verify_limbs_launch.argtypes = [_P] * 8 + [_I, _P]
    lib.p256_verify_limbs_launch.restype = _I
    return lib


def _launch_check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def verify_batch(
    e: torch.Tensor,
    r: torch.Tensor,
    s: torch.Tensor,
    qx: torch.Tensor,
    qy: torch.Tensor,
    valid_in: torch.Tensor,
) -> torch.Tensor:
    """K1: (20, B) int64 limb columns and a (B,) bool mask -> (B,) bool."""
    device = e.device
    batch = e.shape[1] if e.dim() == 2 else -1
    for name, t in (("e", e), ("r", r), ("s", s), ("qx", qx), ("qy", qy)):
        cudalib.check_tensor(name, t, torch.int64, (bn.NLIMBS, batch), device)
    cudalib.check_tensor("valid_in", valid_in, torch.bool, (batch,), device)
    if not cudalib.kernel_device(device, "P-256 verify"):
        return verify_batch_ref(e, r, s, qx, qy, valid_in)
    out = torch.empty(batch, dtype=torch.bool, device=device)
    if batch == 0:
        return out
    with torch.cuda.device(device):
        rc = _lib().p256_verify_limbs_launch(
            e.data_ptr(), r.data_ptr(), s.data_ptr(), qx.data_ptr(), qy.data_ptr(),
            valid_in.data_ptr(), _g_table_device(device).data_ptr(), out.data_ptr(),
            batch, torch.cuda.current_stream(device).cuda_stream,
        )
    _launch_check("p256_verify_limbs", rc)
    return out


def verify_batch_bytes(
    e_b: torch.Tensor,
    r_b: torch.Tensor,
    s_b: torch.Tensor,
    kx: torch.Tensor,
    ky: torch.Tensor,
    key_idx: torch.Tensor,
    valid_in: torch.Tensor,
) -> torch.Tensor:
    """K2: (B, 32) uint8 big-endian e, r, s; (20, K) int64 limb columns of
    the distinct keys; (B,) int32 key index; (B,) bool mask -> (B,) bool."""
    device = e_b.device
    batch = e_b.shape[0] if e_b.dim() == 2 else -1
    nkeys = kx.shape[1] if kx.dim() == 2 else -1
    for name, t in (("e_b", e_b), ("r_b", r_b), ("s_b", s_b)):
        cudalib.check_tensor(name, t, torch.uint8, (batch, 32), device)
    for name, t in (("kx", kx), ("ky", ky)):
        cudalib.check_tensor(name, t, torch.int64, (bn.NLIMBS, nkeys), device)
    cudalib.check_tensor("key_idx", key_idx, torch.int32, (batch,), device)
    cudalib.check_tensor("valid_in", valid_in, torch.bool, (batch,), device)
    if not cudalib.kernel_device(device, "P-256 verify"):
        return verify_batch_bytes_ref(e_b, r_b, s_b, kx, ky, key_idx, valid_in)
    out = torch.empty(batch, dtype=torch.bool, device=device)
    if batch == 0:
        return out
    with torch.cuda.device(device):
        rc = _lib().p256_verify_bytes_launch(
            e_b.data_ptr(), r_b.data_ptr(), s_b.data_ptr(), kx.data_ptr(), ky.data_ptr(),
            key_idx.data_ptr(), valid_in.data_ptr(), _g_table_device(device).data_ptr(),
            out.data_ptr(), batch, nkeys, torch.cuda.current_stream(device).cuda_stream,
        )
    _launch_check("p256_verify_bytes", rc)
    return out
