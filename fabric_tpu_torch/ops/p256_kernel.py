"""Batched ECDSA-P256 verification: the CUDA kernels and their plain versions.

`verify_batch` (K1, limb inputs) and `verify_batch_bytes` (K2, byte inputs
with a distinct-key table) are the wrappers of the two entry points of
`csrc/p256_verify.cu`; `key_tables` is the wrapper of its third kernel,
which builds the fixed-base table (the comb) of each key column K2 reads.
Given CUDA tensors they launch the kernel on the current stream and do
not synchronize; given CPU tensors they run the plain versions
`verify_batch_ref` / `verify_batch_bytes_ref` / `key_tables_ref`.
Anything else raises; there is no fallback.

The plain verify versions mirror the JAX package's `ops/p256_kernel` step
for step: 13-bit limbs with R = 2^260, complete Renes-Costello-Batina
formulas (a = -3), s^-1 by Fermat, u1*G + u2*Q by a 4-bit-window Horner loop
from the identity (one Python loop over the 64 windows), and the projective
final check X == r*Z or X == (r+n)*Z (the latter only when r < p - n),
AND-ed with the host's valid_in mask. The kernels compute the same verdicts
another way (the `.cu` header): combs of G and of each key, a lane as a
group of eight threads, an addition chain for s^-1. `key_tables_ref` runs
the table kernel's own formulas in its order, so its words equal the
kernel's.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional

import numpy as np
import torch

from fabric_tpu_torch.common import p256
from fabric_tpu_torch.ops import bignum as bn
from fabric_tpu_torch.ops import convert, cudalib
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
LAUNCHES: Dict[str, int] = {"p256_verify_bytes": 0, "p256_verify_limbs": 0,
                            "p256_key_tables": 0}
# several dispatcher threads launch in one process (two sidecars, a rescue
# beside a server): the counts' read-modify-write takes this lock
_LAUNCHES_LOCK = threading.Lock()

# ---------------------------------------------------------------------------
# Work counts (Montgomery multiplies mod p and mod n), from which the
# smoke's bounds are computed. A multiply mod p is 64 32x32->64 word
# products (p's reduction needs no multiplier), two IMAD issue slots each;
# mod n 128 word products and 8 32-bit low products.
# ---------------------------------------------------------------------------

IMAD_MOD_P = 2 * 64
IMAD_MOD_N = 2 * 128 + 8
MULS_ADD = 14  # complete addition, RCB 2016 algorithm 4 (a = -3)
MULS_DOUBLE = 13  # algorithm 6
MULS_CHECK = 4  # the final check: r and r + n to Montgomery, times Z

# s^(n-2) in the kernel (csrc/p256_verify.cu INV_CHAIN): x^2, the odd powers
# x^3..x^15 (7), then per step {squarings, slot multiplied by, slot stored
# to}; slots 0-7 hold x^(2i+1), 8-11 x^(2^k - 1) for k = 4, 8, 16, 32.
INV_CHAIN = (
    (2, 1, 8), (4, 8, 9), (8, 9, 10), (16, 10, 11), (64, 11, -1), (32, 11, -1),
    (4, 5, -1), (2, 1, -1), (5, 3, -1), (6, 6, -1), (4, 7, -1), (4, 2, -1),
    (5, 5, -1), (5, 6, -1), (5, 3, -1), (7, 5, -1), (2, 1, -1), (6, 7, -1),
    (2, 0, -1), (8, 4, -1), (3, 3, -1), (5, 3, -1), (4, 3, -1), (5, 3, -1),
    (5, 2, -1), (3, 1, -1), (8, 5, -1), (4, 7, -1), (5, 1, -1), (5, 1, -1),
    (6, 4, -1), (4, 2, -1), (6, 7, -1),
)
MULS_INV_N = 1 + 7 + sum(sq + 1 for sq, _, _ in INV_CHAIN)  # 255 squarings, 40 multiplies
# x^(p-2) by the chain of x^(2^k - 1), k = 2, 3, 6, 12, 15, 30, 32 (31
# squarings, 7 multiplies) and p - 2's words ffffffff 00000001 0 0 0
# ffffffff ffffffff fffffffd (224 squarings, 5 multiplies)
MULS_INV_P = 31 + 7 + 224 + 5

# The kernels' own work (the .cu header): a lane is THREADS_PER_LANE threads,
# a block LANES_PER_BLOCK lanes.
THREADS_PER_LANE = 8
LANES_PER_BLOCK = 16
# K1, a lane: s to Montgomery, the chain, u1 and u2
KERNEL_MOD_N = 1 + MULS_INV_N + 2
# K2, a live lane: s to Montgomery, u1 and u2; a block with a live lane:
# Montgomery's batch inversion over its lanes' s (a product tree up, the
# chain at the root, two multiplies a node down)
KERNEL_MOD_N_BYTES_LANE = 1 + 2
KERNEL_MOD_N_BYTES_BLOCK = (LANES_PER_BLOCK - 1) + MULS_INV_N + 2 * (LANES_PER_BLOCK - 1)
# K2: each thread 15 additions of comb entries, the tree 4 + 2 + 1, the check
KERNEL_MOD_P_BYTES = THREADS_PER_LANE * 15 * MULS_ADD + 7 * MULS_ADD + MULS_CHECK
# K1: Q to Montgomery, 2Q..15Q, the first window's addition, 63 windows of
# 4 doublings and 2 additions, the check
KERNEL_MOD_P_LIMBS = (2 + 14 * MULS_ADD + MULS_ADD
                      + (NUM_WINDOWS - 1) * (4 * MULS_DOUBLE + 2 * MULS_ADD) + MULS_CHECK)
# a key's comb: 255 doublings of two levels (8 and 6 products, W = b Z
# carried along) on plain field elements, the 256 chain entries' three
# coordinates into Montgomery form, 12 additions a window (its 11 other
# digits, 3 formed twice)
MULS_DOUBLE_TABLE = 8 + 6
TABLE_TO_MONT = 256 * 3
TABLE_FILL_ADDS = 12
KERNEL_MOD_P_TABLE = (255 * MULS_DOUBLE_TABLE + TABLE_TO_MONT
                      + NUM_WINDOWS * TABLE_FILL_ADDS * MULS_ADD)

# The replaced one-thread-a-lane kernel: 332 mod n (Fermat with a
# 4-bit fixed window) and 5,322 mod p (per-lane Q table, 64 windows of 4
# doublings and 2 additions).
MULS_MOD_N_REPLACED = 1 + (14 + 63 * 4 + 63) + 2
MULS_MOD_P_REPLACED = 2 + 14 * MULS_ADD + NUM_WINDOWS * (4 * MULS_DOUBLE + 2 * MULS_ADD) + 4
IMAD_PER_VERIFY_REPLACED = MULS_MOD_P_REPLACED * IMAD_MOD_P + MULS_MOD_N_REPLACED * IMAD_MOD_N

# The least work known for the same verdicts, from which bound_ms is
# counted (tests/test_torch_p256_work.py runs each cost on counted integers
# against the JAX package's oracle). The points are Jacobian, a = -3, with
# the exceptional cases of the incomplete formulas branched on (rare, left
# out of the counts):
MULS_DOUBLE_JACOBIAN = 8  # dbl-2001-b: 3M + 5S
MULS_MIXED_ADD_JACOBIAN = 11  # madd-2007-bl, the second point affine: 7M + 4S
MULS_TO_AFFINE = 3 + 4  # Montgomery's batch inversion (3) and 1/Z^2, 1/Z^3, x, y
# the check r Z^2 == X: Z^2, r Z^2 (r plain times Z^2 in Montgomery form is
# r Z^2 plain), X out of Montgomery form; (r + n) Z^2 only for r < p - n,
# which a random r meets with odds 2^-128
MULS_CHECK_LEAST = 3
# Fixed-base combs: a w-bit comb holds, for each of the ceil(256 / w)
# windows, the 2^w - 1 nonzero multiples d 2^(w i) P as affine (x, y); a
# lane reads one entry a window. The widest that the card's L2 holds (H100:
# 50 MiB) for all the tables a launch reads counts as the least.
L2_BYTES = 50 << 20
COMB_ENTRY_BYTES = 64


def comb_windows(bits: int) -> int:
    return -(-256 // bits)


def comb_bits(tables: int) -> int:
    """The widest comb of which `tables` fit in L2 together."""
    return max(w for w in range(1, 17)
               if tables * comb_windows(w) * ((1 << w) - 1) * COMB_ENTRY_BYTES <= L2_BYTES)


def least_lane_mod_p(keys: int) -> int:
    """A K2 lane over cached combs of G and `keys` keys: a load and a mixed
    addition for each of u1's and u2's windows but the first, the check."""
    return (2 * comb_windows(comb_bits(keys + 1)) - 1) * MULS_MIXED_ADD_JACOBIAN + MULS_CHECK_LEAST


def ladder_mod_p(bits: int) -> int:
    """u2 Q on K1 by a Horner ladder of `bits`-bit windows over the lane's
    own Q: its multiples 2Q..(2^w - 1)Q (a doubling for each even one, a
    mixed addition of Q for each odd one), made affine, then a window's
    doublings and a mixed addition for each window after the first."""
    m = (1 << bits) - 2
    table = (m // 2) * MULS_DOUBLE_JACOBIAN + (m - m // 2) * MULS_MIXED_ADD_JACOBIAN
    return (table + m * MULS_TO_AFFINE
            + (comb_windows(bits) - 1) * (bits * MULS_DOUBLE_JACOBIAN + MULS_MIXED_ADD_JACOBIAN))


# A K2 lane, mod n: s to Montgomery, its share of Montgomery's batch
# inversion (3) and u1, u2; a launch: the batch inversion's inverse.
LEAST_LANE_MOD_N = 1 + 3 + 2
LEAST_LAUNCH_MOD_N = MULS_INV_N
# A K1 lane (its own key): Q to Montgomery, the cheapest ladder width, u1's
# windows added from G's comb (the only table K1 reads), the check; a
# launch also inverts its Q multiples' Z in one batch.
LADDER_BITS = min(range(1, 9), key=ladder_mod_p)
LEAST_LIMB_LANE_MOD_P = (2 + ladder_mod_p(LADDER_BITS)
                         + comb_windows(comb_bits(1)) * MULS_MIXED_ADD_JACOBIAN + MULS_CHECK_LEAST)
LEAST_LIMB_LAUNCH_MOD_P = MULS_INV_P
# the table kernel's own output (a 4-bit projective comb) with the complete
# formulas: the chain's 63 doublings and 7 doublings and 7 additions a window
LEAST_TABLE_MOD_P = (NUM_WINDOWS - 1) * MULS_DOUBLE + NUM_WINDOWS * 7 * (MULS_DOUBLE + MULS_ADD)


def imad_slots(mod_p: int, mod_n: int) -> int:
    return mod_p * IMAD_MOD_P + mod_n * IMAD_MOD_N


def live_blocks(valid_in) -> int:
    """K2's blocks with a live lane, from the (B,) mask of live lanes."""
    v = np.asarray(valid_in, dtype=bool)
    pad = -len(v) % LANES_PER_BLOCK
    return int(np.pad(v, (0, pad)).reshape(-1, LANES_PER_BLOCK).any(axis=1).sum())


def work_bytes_route(live_lanes: int, keys: int, blocks: int) -> Dict[str, int]:
    """IMAD slots of a K2 launch over `live_lanes` lanes in `blocks` live
    blocks, reading cached combs of `keys` keys: the least work known, the
    kernel's own and the replaced kernel's. Building the combs is the table
    kernel's work, not the launch's."""
    return {
        "least": imad_slots(live_lanes * least_lane_mod_p(keys),
                            live_lanes * LEAST_LANE_MOD_N + LEAST_LAUNCH_MOD_N),
        "kernel": imad_slots(live_lanes * KERNEL_MOD_P_BYTES,
                             live_lanes * KERNEL_MOD_N_BYTES_LANE
                             + blocks * KERNEL_MOD_N_BYTES_BLOCK),
        "replaced": live_lanes * IMAD_PER_VERIFY_REPLACED,
    }


def work_limb_route(live_lanes: int) -> Dict[str, int]:
    """The same for a K1 launch."""
    return {
        "least": imad_slots(live_lanes * LEAST_LIMB_LANE_MOD_P + LEAST_LIMB_LAUNCH_MOD_P,
                            live_lanes * LEAST_LANE_MOD_N + LEAST_LAUNCH_MOD_N),
        "kernel": imad_slots(live_lanes * KERNEL_MOD_P_LIMBS, live_lanes * KERNEL_MOD_N),
        "replaced": live_lanes * IMAD_PER_VERIFY_REPLACED,
    }


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
def g_comb_words() -> np.ndarray:
    """(64, 16, 3, 8) uint32: the kernels' comb of G, entry [w, d] the
    projective point d * 16^w * G in little-endian 32-bit words, Montgomery
    R = 2^256, Z = R (the identity (0 : R : 0) at d = 0). Window 0 holds
    the projective d * G of `g_small_table()`."""
    r = 1 << 256
    out = np.zeros((NUM_WINDOWS, 16, 3, 8), dtype=np.uint32)
    base = p256.GENERATOR
    for w in range(NUM_WINDOWS):
        acc = None
        for d in range(16):
            coords = (0, r % p256.P, 0) if acc is None else (
                (acc[0] * r) % p256.P, (acc[1] * r) % p256.P, r % p256.P)
            for c, v in enumerate(coords):
                out[w, d, c] = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
            acc = p256.point_add(acc, base)
        base = acc  # 16 * 16^w * G
    return out


@functools.lru_cache(maxsize=None)
def _g_table_limbs(device: torch.device) -> torch.Tensor:
    return g_small_table().to(device)


@functools.lru_cache(maxsize=None)
def _g_comb_device(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(g_comb_words().view(np.int32).copy()).to(device)


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


def key_tables_ref(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """Plain version of the table kernel: (20, K) limbs of the key columns
    -> (K, 64, 16, 3, 8) int32 words (R = 2^256) of each key's comb, entry
    [w, d] = d * 16^w * Q, built with the kernel's formulas in its order
    (the doubling chain 2^i Q, then each other digit as the sum of its bits'
    entries, lowest first), so its projective words equal the kernel's."""
    device = kx.device
    keys = kx.shape[1]
    one = CTX_P.const("one_mont", device).expand(bn.NLIMBS, keys).clone()
    pt = Point(FE(bn.to_mont(CTX_P, kx), 1), FE(bn.to_mont(CTX_P, ky), 1), FE(one, 1))
    chain = [pt]
    for _ in range(255):
        pt = point_double(pt)
        chain.append(pt)
    # powers[b][c] (20, 64 windows, K): 2^b * 16^w * Q
    powers = [[torch.stack([fe_norm(chain[4 * w + b][c]).limbs for w in range(NUM_WINDOWS)],
                           dim=1) for c in range(3)] for b in range(4)]
    flat = [Point(*(FE(p[c].reshape(bn.NLIMBS, -1), 1) for c in range(3))) for p in powers]
    ident = FIELD.identity(NUM_WINDOWS * keys, device)
    entries = []
    for d in range(16):
        if d == 0:
            acc = ident
        else:
            bits = [b for b in range(4) if d >> b & 1]
            acc = flat[bits[0]]
            for b in bits[1:]:
                acc = point_add(acc, flat[b])
        entries.append(torch.stack([fe_norm(c).limbs for c in acc]))  # (3, 20, 64 * K)
    limbs = torch.stack(entries).reshape(16, 3, bn.NLIMBS, NUM_WINDOWS, keys)
    words = convert.limbs_to_words(limbs.cpu().numpy(), axis=2, modulus=p256.P)
    words = np.ascontiguousarray(words.transpose(4, 3, 0, 1, 2)).view(np.int32)
    return torch.from_numpy(words).to(device)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cudalib.load("p256_verify")
    lib.p256_verify_bytes_launch.argtypes = [_P] * 8 + [_I, _I, _P]
    lib.p256_verify_bytes_launch.restype = _I
    lib.p256_verify_limbs_launch.argtypes = [_P] * 8 + [_I, _P]
    lib.p256_verify_limbs_launch.restype = _I
    lib.p256_key_tables_launch.argtypes = [_P] * 3 + [_I, _P]
    lib.p256_key_tables_launch.restype = _I
    lib.p256_key_tables_stamped_launch.argtypes = [_P] * 4 + [_I, _P]
    lib.p256_key_tables_stamped_launch.restype = _I
    return lib


def _launch_check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def key_tables(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """The combs of the key columns: (20, K) int64 limbs -> (K, 64, 16, 3,
    8) int32 words, by `p256_key_tables` (a block a key) on a CUDA tensor,
    by `key_tables_ref` on a CPU one."""
    device = kx.device
    nkeys = kx.shape[1] if kx.dim() == 2 else -1
    for name, t in (("kx", kx), ("ky", ky)):
        cudalib.check_tensor(name, t, torch.int64, (bn.NLIMBS, nkeys), device)
    if not cudalib.kernel_device(device, "P-256 key table"):
        return key_tables_ref(kx, ky)
    out = torch.empty((nkeys, NUM_WINDOWS, 16, 3, 8), dtype=torch.int32, device=device)
    if nkeys == 0:
        return out
    with torch.cuda.device(device):
        rc = _lib().p256_key_tables_launch(
            kx.data_ptr(), ky.data_ptr(), out.data_ptr(), nkeys,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _launch_check("p256_key_tables", rc)
    return out


def key_tables_stamped(kx: torch.Tensor, ky: torch.Tensor):
    """`key_tables` on the card with each block's SM clock stamps: the
    tables and (K, 8) int64 clock64 readings at the block's start, the end
    of its doubling chain, the end of its fill, and the start of doubling
    128 and the end of each of its four steps (first level of products,
    A..D, second level, the new point). The probe behind the split of the
    table kernel's time; it counts as a launch of `p256_key_tables`."""
    device = kx.device
    nkeys = kx.shape[1] if kx.dim() == 2 else -1
    for name, t in (("kx", kx), ("ky", ky)):
        cudalib.check_tensor(name, t, torch.int64, (bn.NLIMBS, nkeys), device)
    if device.type != "cuda":
        raise ValueError("key_tables_stamped reads the card's clocks: give it CUDA tensors")
    out = torch.empty((nkeys, NUM_WINDOWS, 16, 3, 8), dtype=torch.int32, device=device)
    stamps = torch.zeros((nkeys, 8), dtype=torch.int64, device=device)
    if nkeys == 0:
        return out, stamps
    with torch.cuda.device(device):
        rc = _lib().p256_key_tables_stamped_launch(
            kx.data_ptr(), ky.data_ptr(), out.data_ptr(), stamps.data_ptr(), nkeys,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _launch_check("p256_key_tables", rc)
    return out, stamps


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
            valid_in.data_ptr(), _g_comb_device(device).data_ptr(), out.data_ptr(),
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
    tables: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2: (B, 32) uint8 big-endian e, r, s; (20, K) int64 limb columns of
    the distinct keys; (B,) int32 key index; (B,) bool mask -> (B,) bool.
    `tables`, the keys' combs as `key_tables` returns them, may come from a
    cache (CUDAProvider keeps them by SKI); without it the wrapper builds
    them first (a `p256_key_tables` launch). The plain version needs none."""
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
    if tables is None:
        tables = key_tables(kx, ky)
    cudalib.check_tensor("tables", tables, torch.int32, (nkeys, NUM_WINDOWS, 16, 3, 8), device)
    with torch.cuda.device(device):
        rc = _lib().p256_verify_bytes_launch(
            e_b.data_ptr(), r_b.data_ptr(), s_b.data_ptr(), tables.data_ptr(),
            key_idx.data_ptr(), valid_in.data_ptr(), _g_comb_device(device).data_ptr(),
            out.data_ptr(), batch, nkeys, torch.cuda.current_stream(device).cuda_stream,
        )
    _launch_check("p256_verify_bytes", rc)
    return out
