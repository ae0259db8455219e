"""Batched multi-scalar multiplication on FP256BN's G1: the CUDA kernel and
its plain version.

`msm_batch(bases, scalars)` is the wrapper of `bn256_msm` in
`csrc/bn256.cu` (K3, replacing the JAX package's `ops/bn256_kernel.py`
`msm_batch_device`): per lane the sum of e_k * B_k over K bases. Given CUDA
tensors it launches the kernel on the current stream and does not
synchronize; given CPU tensors it runs the plain version `msm_batch_ref`.
Anything else raises; there is no fallback.

Both take and return the JAX package's layout: bases (K, 3, 20, B) and the
result (3, 20, B) as projective Montgomery coordinates in 13-bit limbs
(R = 2^260, int64), scalars (K, 20, B) plain integers below r. The plain
version follows the JAX program step for step: the complete
Renes-Costello-Batina 2016 formulas for a = 0 (algorithms 7 and 9, b3 = 9),
per-base tables {O, B, 2B, 3B} with 2B = double(B) and 3B = add(2B, B),
then 128 windows of 2 bits, most significant first, each two doublings of
the accumulator and K complete additions of a table entry (the identity
for a zero digit). The plain version stacks the independent multiplies of
each formula into one Montgomery multiply; the values are those of the
one-by-one sequence.

The kernel computes the same sum in another order (csrc/bn256.cu): a lane
is a group of threads, thread k multiplies base k alone by the same
windows, and a shuffle tree adds the partial sums. It returns the same
point, in another projective representative (X : Y : Z); compare results
as points (`unpack_points`), not limbs.

`msm_host_batch` is the host API of the Idemix batch: affine points (None
for the identity) and integer scalars per lane in, affine points out. It
runs on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fabric_tpu_torch.common import fp256bn as host
from fabric_tpu_torch.ops import bignum as bn
from fabric_tpu_torch.ops import cudalib
from fabric_tpu_torch.ops import fieldops as fo

CTX_Q = bn.MontCtx(host.P)
FIELD = fo.Field(CTX_Q)
FE = fo.FE
Point = fo.Point
fe_add = FIELD.add
fe_sub = FIELD.sub

_R = 1 << bn.RADIX_BITS
WINDOW_BITS = 2
NUM_WINDOWS = 128  # 256 bits / 2

# Kernel launches, counted by the wrapper where it launches (never for the
# plain version).
LAUNCHES: Dict[str, int] = {"bn256_msm": 0}

# The kernel runs a lane as a group of G threads, G the power of two at or
# above K, at most a warp (csrc/bn256.cu msm_log_g); thread k takes bases
# k, k + G, ... Config #3 has K = 8, an Idemix key with n attributes n + 4
# at most.
MAX_THREADS = 32

# Work of one MSM lane (see the header of csrc/bn256.cu): Montgomery
# multiplies mod p, each 128 32x32->64 word products (64 for a*b, 64 for
# q*p: FP256BN's p has no special form) and 8 32-bit low products (q = t0 *
# m'), that is 2 * 128 + 8 IMAD issue slots.
MULS_PER_DOUBLE = 9
MULS_PER_ADD = 14
IMAD_PER_MONT_MUL = 2 * 128 + 8


def threads_per_lane(k_count: int) -> int:
    """G, the kernel's threads a lane: the power of two at or above K, at
    most MAX_THREADS."""
    return min(1 << (k_count - 1).bit_length(), MAX_THREADS)


# The multiplies of one real base's thread: the radix change of its
# coordinates, the table (a doubling and an addition), and 128 windows of
# 2 doublings and an addition.
MULS_PER_BASE = 3 + MULS_PER_DOUBLE + MULS_PER_ADD + NUM_WINDOWS * (2 * MULS_PER_DOUBLE
                                                                   + MULS_PER_ADD)


def muls_per_lane(k_real: int, k_count: int) -> int:
    """Montgomery multiplies the kernel runs for a lane with `k_real` real
    bases (neither the identity nor a zero scalar, the rest do no
    arithmetic) of K: each real base's windows, an addition for each base
    a thread takes after its first (K - G, whether real or not), then the
    shuffle tree's G - 1 additions and the result's radix change (3)."""
    g = threads_per_lane(k_count)
    return k_real * MULS_PER_BASE + (max(k_count, g) - 1) * MULS_PER_ADD + 3


def muls_least(k_real: int) -> int:
    """The least work known for the same sum with these formulas and 2-bit
    windows, from which the bound is counted: one accumulator whose
    doublings the bases share (Straus), as the replaced one-thread program
    ran it. 3k + 3 multiplies for the radix changes, the k tables, and 128
    windows of 2 doublings and k additions."""
    return (3 * k_real + 3 + k_real * (MULS_PER_DOUBLE + MULS_PER_ADD)
            + NUM_WINDOWS * (2 * MULS_PER_DOUBLE + k_real * MULS_PER_ADD))


def fe_norm(a: FE) -> FE:
    return FE(bn.reduce_canonical(CTX_Q, a.limbs, a.bound - 1), 1)


@functools.lru_cache(maxsize=None)
def _b3(device: torch.device) -> torch.Tensor:
    return torch.tensor(
        bn.int_to_limbs((3 * host.B_COEFF * _R) % host.P), dtype=torch.int64, device=device
    ).reshape(bn.NLIMBS, 1)


def _muls(*pairs):
    """Independent Field.mul products in one stacked Montgomery multiply."""
    for a, b in pairs:
        assert a.bound * b.bound <= 16, (a.bound, b.bound)
    shape = torch.broadcast_shapes(*(t.limbs.shape for p in pairs for t in p))
    lhs = torch.stack([a.limbs.expand(shape) for a, _ in pairs], 1)
    rhs = torch.stack([b.limbs.expand(shape) for _, b in pairs], 1)
    out = bn.mont_mul(CTX_Q, lhs, rhs, nreduce=1)
    return [FE(out[:, i], 1) for i in range(len(pairs))]


# ---------------------------------------------------------------------------
# Point arithmetic (plain versions), RCB 2016 for a = 0
# ---------------------------------------------------------------------------


def point_add(p: Point, q: Point) -> Point:
    """Complete addition, RCB 2016 algorithm 7 (a = 0)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    b3 = FE(_b3(x1.limbs.device), 1)

    t0, t1, t2, t3, t4, x3 = _muls(
        (x1, x2), (y1, y2), (z1, z2),
        (fe_add(x1, y1), fe_add(x2, y2)),
        (fe_add(y1, z1), fe_add(y2, z2)),
        (fe_add(x1, z1), fe_add(x2, z2)),
    )
    t3 = fe_sub(t3, fe_add(t0, t1))
    t4 = fe_sub(t4, fe_add(t1, t2))
    y3 = fe_sub(x3, fe_add(t0, t2))
    t0 = fe_add(fe_add(t0, t0), t0)  # bound 3
    t2, y3 = _muls((b3, t2), (b3, y3))
    z3 = fe_add(t1, t2)  # bound 2
    t1 = fe_sub(t1, t2)
    x3, t2, y3, t1, t0, z3 = _muls(
        (t4, y3), (t3, t1), (y3, fe_norm(t0)), (t1, fe_norm(z3)),
        (fe_norm(t0), t3), (fe_norm(z3), t4),
    )
    x3 = fe_sub(t2, x3)
    y3 = fe_add(t1, y3)
    z3 = fe_add(z3, t0)  # bound 2
    return Point(x3, fe_norm(y3), fe_norm(z3))


def point_double(p: Point) -> Point:
    """Complete doubling, RCB 2016 algorithm 9 (a = 0)."""
    x, y, z = p
    b3 = FE(_b3(x.limbs.device), 1)

    t0, t1, t2, xy = _muls((y, y), (y, z), (z, z), (x, y))
    z3 = fe_add(t0, t0)
    z3 = fe_add(z3, z3)
    z3 = fe_norm(fe_add(z3, z3))  # 8 * y^2
    (t2,) = _muls((b3, t2))
    x3, z3 = _muls((t2, z3), (t1, z3))
    y3 = fe_add(t0, t2)
    t2 = fe_add(fe_add(t2, t2), t2)  # bound 3
    t0 = fe_sub(t0, t2)
    y3, x3b = _muls((t0, fe_norm(y3)), (t0, xy))
    y3 = fe_add(x3, y3)
    x3 = fe_add(x3b, x3b)
    return Point(fe_norm(x3), fe_norm(y3), z3)


def _point(t: torch.Tensor) -> Point:
    """(3, 20, ...) canonical limbs -> Point."""
    return Point(FE(t[0], 1), FE(t[1], 1), FE(t[2], 1))


def _stack(p: Point) -> torch.Tensor:
    return torch.stack([fe_norm(p.x).limbs, fe_norm(p.y).limbs, fe_norm(p.z).limbs])


# ---------------------------------------------------------------------------
# Host <-> device packing
# ---------------------------------------------------------------------------


def to_mont_int(v: int) -> int:
    return (v * _R) % host.P


def pack_points(pts: Sequence[host.G1Point]) -> np.ndarray:
    """Affine host points (None = identity) -> (3, 20, B) uint32 projective
    Montgomery limbs; the identity is (0 : 1 : 0)."""
    one = to_mont_int(1)
    xs = [0 if pt is None else to_mont_int(pt[0]) for pt in pts]
    ys = [one if pt is None else to_mont_int(pt[1]) for pt in pts]
    zs = [0 if pt is None else one for pt in pts]
    return np.stack([bn.ints_to_limbs(c).numpy() for c in (xs, ys, zs)]).astype(np.uint32)


def unpack_points(arr) -> List[host.G1Point]:
    """(3, 20, B) projective Montgomery limbs -> affine host points/None."""
    arr = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr)
    rinv = pow(_R, -1, host.P)
    xs, ys, zs = ([(v * rinv) % host.P for v in bn.limbs_to_ints(arr[c])] for c in range(3))
    out: List[host.G1Point] = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, host.P)
            out.append(((x * zi) % host.P, (y * zi) % host.P))
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def scalar_digits_msb(scalars: torch.Tensor) -> torch.Tensor:
    """(20, N) limb scalars -> (128, N) 2-bit digits, most significant
    first."""
    digits = []
    for w in range(NUM_WINDOWS):
        bit = 256 - WINDOW_BITS * (w + 1)
        limb, off = divmod(bit, bn.LIMB_BITS)
        d = scalars[limb] >> off
        if off + WINDOW_BITS > bn.LIMB_BITS and limb + 1 < bn.NLIMBS:
            d = d | (scalars[limb + 1] << (bn.LIMB_BITS - off))
        digits.append(d & ((1 << WINDOW_BITS) - 1))
    return torch.stack(digits)


def msm_batch_ref(bases: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: bases (K, 3, 20, B), scalars (K, 20, B) ->
    (3, 20, B), the sum of scalars[k] * bases[k] per lane."""
    k_count, _, _, lanes = bases.shape
    device = bases.device
    # per-base tables {O, B, 2B, 3B}, built over the flattened K*B lanes
    flat = bases.permute(1, 2, 0, 3).reshape(3, bn.NLIMBS, k_count * lanes)
    p1 = _point(flat)
    p2 = point_double(p1)
    p3 = point_add(p2, p1)
    ident = FIELD.identity(k_count * lanes, device)
    tables = torch.stack([_stack(pt) for pt in (ident, p1, p2, p3)])  # (4, 3, 20, K*B)
    tables = tables.reshape(4, 3, bn.NLIMBS, k_count, lanes)
    flat_scalars = scalars.permute(1, 0, 2).reshape(bn.NLIMBS, k_count * lanes)
    digits = scalar_digits_msb(flat_scalars).reshape(NUM_WINDOWS, k_count, lanes)

    acc = FIELD.identity(lanes, device)
    for w in range(NUM_WINDOWS):
        for _ in range(WINDOW_BITS):
            acc = point_double(acc)
        for j in range(k_count):
            idx = digits[w, j].reshape(1, 1, 1, lanes).expand(1, 3, bn.NLIMBS, lanes)
            acc = point_add(acc, _point(tables[:, :, :, j].gather(0, idx)[0]))
    return _stack(acc)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cudalib.load("bn256")
    lib.bn256_msm_launch.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.bn256_msm_launch.restype = _I
    return lib


def msm_batch(bases: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """K3: bases (K, 3, 20, B) int64 projective Montgomery limbs, scalars
    (K, 20, B) int64 limbs below 2^256 -> (3, 20, B) int64."""
    device = bases.device
    k_count, lanes = (bases.shape[0], bases.shape[-1]) if bases.dim() == 4 else (-1, -1)
    cudalib.check_tensor("bases", bases, torch.int64, (k_count, 3, bn.NLIMBS, lanes), device)
    cudalib.check_tensor("scalars", scalars, torch.int64, (k_count, bn.NLIMBS, lanes), device)
    if k_count < 1:
        raise ValueError(f"msm_batch takes at least one base a lane, got {k_count}")
    if not cudalib.kernel_device(device, "FP256BN MSM"):
        return msm_batch_ref(bases, scalars)
    out = torch.empty((3, bn.NLIMBS, lanes), dtype=torch.int64, device=device)
    if lanes == 0:
        return out
    with torch.cuda.device(device):
        rc = _lib().bn256_msm_launch(
            bases.data_ptr(), scalars.data_ptr(), out.data_ptr(), k_count, lanes,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bn256_msm launch failed: cudaError {rc}")
    LAUNCHES["bn256_msm"] += 1
    return out


def pack_batch(bases_per_lane, scalars_per_lane):
    """Per-lane lists of affine bases (None = identity) and int scalars,
    every lane with the same K -> (bases, scalars) numpy arrays in the
    wrapper's layout; scalars are reduced mod r."""
    b_count = len(bases_per_lane)
    k_count = len(bases_per_lane[0])
    bases = np.stack(
        [pack_points([bases_per_lane[i][k] for i in range(b_count)]) for k in range(k_count)]
    )
    scalars = np.stack([
        bn.ints_to_limbs([scalars_per_lane[i][k] % host.R for i in range(b_count)]).numpy()
        for k in range(k_count)
    ])
    return bases.astype(np.int64), scalars


def msm_host_batch(bases_per_lane, scalars_per_lane, device=None,
                   split_ms: Optional[Dict[str, float]] = None) -> List[host.G1Point]:
    """Host API: per-lane lists of affine bases and int scalars, all lanes
    with the same K, through `msm_batch` on `device` (the card unless the
    caller asks for "cpu"; without a card it raises). Returns affine
    points. `split_ms`, when given, gets the host-clock milliseconds of its
    steps: msm_pack (the wrapper's layout), msm_kernel (launch, wait and
    copy back) and msm_unpack (the affine conversion)."""
    dev = cudalib.resolve_device(device, "FP256BN MSM")
    t0 = time.perf_counter()
    bases, scalars = pack_batch(bases_per_lane, scalars_per_lane)
    t1 = time.perf_counter()
    out = msm_batch(torch.from_numpy(bases).to(dev), torch.from_numpy(scalars).to(dev)).cpu()
    t2 = time.perf_counter()
    points = unpack_points(out)
    if split_ms is not None:
        split_ms.update(msm_pack=(t1 - t0) * 1e3, msm_kernel=(t2 - t1) * 1e3,
                        msm_unpack=(time.perf_counter() - t2) * 1e3)
    return points
