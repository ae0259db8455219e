"""numpy limb-matrix batch ECDSA-P256 verification (hostec_np).

The port's copy of the JAX package's `crypto/hostec_np.py`, with its
imports pointed at the port's `common` modules; it imports numpy and
never torch, so its pool workers start light.  The top rung of the
port's host EC ladder, above the CPython list-comprehension tier:
``hostec_np -> hostec -> p256`` (the JAX ladder's OpenSSL rung,
``fastec``, needs the ``cryptography`` package and is not ported).
Where hostec advances every lane through the window schedule with one
fused list comprehension of Python big-ints per field op, this
engine keeps the whole batch as limb MATRICES and lets numpy's C kernels
do the per-lane work — the same direction hardware-offload work takes
for Fabric's validation phase (arXiv:1907.08367, arXiv:2112.02229), on
commodity SIMD instead of an FPGA.

Representation (reusing the radix-2^13 machinery proved overflow-free
for the JAX package's device kernels):

- **Batch interchange format**: a batch of field elements is a
  ``(lanes, NLIMBS)`` uint64 matrix of radix-2^13 limbs — the canonical
  LIMB_BITS/NLIMBS/LIMB_MASK constants from ``common/limbparams`` (the
  same single source of truth ops/bignum.py uses), so the CIOS
  headroom reasoning transfers unchanged.
- **Compute form**: inside the engine, adjacent limb pairs are condensed
  to radix-2^(2*LIMB_BITS) "pair limbs" held as ``(NPAIRS, lanes)``
  uint64 rows (limb-major: each pair-limb row is one contiguous vector
  numpy streams).  NPAIRS = NLIMBS//2 + 1: the spare eleventh pair-limb
  raises the Montgomery radix to R = 2^286, which buys enough value
  headroom (c1*c2 <= 2^30 instead of the device kernel's 16) that the
  group law never needs a conditional subtract — numpy pays ~5us of
  fixed cost per vector op, so the device kernel's reduce_canonical
  discipline (cheap inside a fused device program) would dominate a
  numpy profile.
- **Montgomery CIOS mul/sqr**: product MAC rows then a limb-serial REDC
  sweep, all in uint64 with lazy carries.  The worst-case
  accumulator (derived over `_mul_kernel`) is
  NPAIRS * L32_BOUND * L4_BOUND + the q*m and carry terms
  < 2^62.5 < 2^64 — the pair-radix analog of the device kernel's
  2684174334 < 0.625 * 2^32 bound, with the same shape of proof.
- **Lazy bounds**: field values ride a small `_FE` wrapper tracking an
  exact value bound (multiple of the modulus) and an exact per-limb
  bound; additions and subtractions stay lazy (no carry chains), and
  `fe_mul`/`fe_sqr` carry an operand only when the tracked bound would
  exceed the kernel's proven input contract.  The bounds are Python
  ints computed once per batch op — a runtime mirror of the static
  proof that raises (never asserts) on a violated invariant.
- **Group law**: Jacobian dbl-2001-b (a = -3) and the standard mixed
  madd, identical formulas to hostec so the exceptional-case structure
  matches lane for lane.  Exceptional lanes (P = +-Q, P = infinity) are
  detected wholesale — Z3 < 2p comes back limb-canonical from the
  multiply, so Z3 ≡ 0 (mod p) is exactly "all limbs zero or equal to
  p's" — and patched per lane through hostec's scalar `_madd1`.
- **Scalars**: u2*Q uses lane-shared signed 5-bit windows (the regular
  wNAF(5) digit set: odd-free signed digits in [-15, 16], recoded
  vectorized across lanes) against a per-batch 16-entry table that is
  normalized to affine with ONE tree batch inversion; u1*G uses a
  precomputed 26-window x 1023-entry unsigned 10-bit comb of G
  multiples, normalized once at build with a Montgomery batch
  inversion and stored in the Montgomery domain.
- **Tree batch inversion**: Montgomery's trick serializes a prefix
  product across lanes, which CPython does cheaply but numpy cannot;
  the engine instead pairs lanes level by level (a Blelloch-style
  up/down sweep of Montgomery multiplies on halving widths), inverts
  the single root with one Python `pow`, and walks back down — O(log
  lanes) vector ops per inversion site instead of O(lanes) scalar ones.
- **Shared-memory sharding**: big batches are sharded across a process
  pool through ONE `multiprocessing.shared_memory` block — the parent
  packs prechecked lanes into limb matrices in shm, workers attach by
  name and write verdict bytes into their own slice of the result
  region, so nothing but (name, lo, hi) ever crosses the pickle
  boundary and reassembly is order-preserving by construction.

Semantics are bit-identical to hostec/the oracle (``verify_digest``
implements Go crypto/ecdsa.Verify: no low-S rule here, out-of-range r/s
and off-curve or identity keys return False and never raise).  Single
verifies and small batches delegate down-ladder to hostec — the matrix
engine's fixed cost only pays for itself from ~100 lanes up.  numpy
itself is an optional dependency: the module imports without it and
`bccsp.select_ec_backend` skips this rung with a warning (silently for
callers, loudly in the log) when it is absent.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fabobs, p256
from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.retry import CooldownGate
from fabric_tpu_torch.common.limbparams import (
    LIMB_BITS,
    LIMB_MASK,
    NLIMBS,
    RADIX_BITS,
)
from fabric_tpu_torch.common.p256 import GX, GY, N, P
from fabric_tpu_torch.crypto import hostec

logger = must_get_logger("hostec_np")

try:  # numpy is optional: the ladder skips this rung when it is absent
    import numpy as np

    HAVE_NUMPY = True
except ImportError:  # pragma: no cover - exercised via monkeypatch
    np = None  # type: ignore[assignment]
    HAVE_NUMPY = False

KeyPair = hostec.KeyPair
PubKey = Optional[Tuple[int, int]]

# -- pair-limb parameters, all derived from the canonical radix ----------
PAIR_BITS = 2 * LIMB_BITS  # 26
PAIR_MASK = (1 << PAIR_BITS) - 1
NPAIRS = NLIMBS // 2 + 1  # 11: one spare pair-limb of value headroom
MONT_BITS = PAIR_BITS * NPAIRS  # 286
R_MONT = 1 << MONT_BITS

# Proven input contracts of `_mul_kernel` (per-limb bounds); fe_mul
# carries an operand that exceeds them.  NPAIRS * L32 * L4 + the q*m
# rows stays < 2^63 — see the kernel comment for the exact bound.
L4_BOUND = 4 * (PAIR_MASK + 1) - 1  # ~2^28
L32_BOUND = 32 * (PAIR_MASK + 1) - 1  # ~2^31

# Engine thresholds.  The matrix engine's fixed costs (three inversion
# trees, the per-batch Q table, digit recoding) amortize from roughly a
# thousand lanes up on a 2-core box — below NP_MIN_LANES the sharded
# entrypoint delegates down-ladder to hostec's list engine instead.
NP_MIN_LANES = 1024
MIN_POOL_LANES = 2048  # below this a pool round-trip costs more
MIN_SHARD_LANES = 1024  # never split shards smaller than this


# ---------------------------------------------------------------------------
# Montgomery context over pair limbs
# ---------------------------------------------------------------------------


def _int_to_pairs(x: int) -> List[int]:
    return [(x >> (PAIR_BITS * i)) & PAIR_MASK for i in range(NPAIRS)]


def _pairs_to_int(col) -> int:
    val = 0
    for i in range(NPAIRS - 1, -1, -1):
        val = (val << PAIR_BITS) + int(col[i])
    return val


class _NpMont:
    """Montgomery constants for an odd modulus m < 2^256 at R = 2^286,
    as (NPAIRS, 1) uint64 columns ready to broadcast across lanes."""

    def __init__(self, modulus: int):
        if modulus % 2 == 0:
            raise ValueError("modulus must be odd")
        self.m = modulus
        self.m_pairs = _int_to_pairs(modulus)
        self.m_col = np.array(self.m_pairs, dtype=np.uint64)[:, None]
        self.m0inv = int((-pow(modulus, -1, 1 << PAIR_BITS)) % (1 << PAIR_BITS))
        # contiguous nonzero pair-row runs of m: the REDC MAC skips zero
        # rows wholesale (P-256's p zeroes 4 of its 11 pairs)
        blocks = []
        i = 0
        while i < NPAIRS:
            if self.m_pairs[i]:
                j = i
                while j < NPAIRS and self.m_pairs[j]:
                    j += 1
                blocks.append((i, j))
                i = j
            else:
                i += 1
        self.mac_blocks = tuple(blocks)
        # P-256 fast path: validate the static shift decomposition and
        # build the complement-fold bias.  The REDC sweep adds
        # (PAIR_MASK - q) << 16 where the decomposition wants
        # -(q << 16): each iteration i thereby over-adds the constant
        # (PAIR_MASK << 16) * 2^(PAIR_BITS*(i+8)); the bias is
        # K*m - (that constant sum), chosen canonical (< m, plain
        # nonneg limbs), so the kernel never subtracts and the whole
        # sweep stays interval-provable with zero suppressions.
        self.p256_bias = None
        self.bias_rows = (0, 0)
        if self.m0inv == 1:
            recon = -1
            for coff, sh, sign in _P256_REDC_TERMS:
                recon += sign << (PAIR_BITS * coff + sh)
            if recon == modulus:
                over = 0
                for coff, sh, sign in _P256_REDC_TERMS:
                    if sign < 0:
                        for i in range(NPAIRS):
                            over += (PAIR_MASK << sh) << (
                                PAIR_BITS * (i + coff)
                            )
                kk = over // modulus + 1
                val = kk * modulus - over
                ncols = 2 * NPAIRS
                limbs = [
                    (val >> (PAIR_BITS * i)) & PAIR_MASK
                    for i in range(ncols)
                ]
                nz = [i for i, v in enumerate(limbs) if v] or [0]
                self.bias_rows = (min(nz), max(nz) + 1)
                self.p256_bias = np.array(limbs, dtype=np.uint64)[:, None]
        self.r2 = self.to_limbs((R_MONT * R_MONT) % modulus)
        self.one_mont_int = R_MONT % modulus
        self.rinv = pow(R_MONT, -1, modulus)
        # k*m in a redundant per-limb form with every limb >= `floor`,
        # for borrow-free lazy subtraction; built on demand per (k,
        # floor) and memoized.
        self._ksub: dict = {}

    def to_limbs(self, x: int) -> "np.ndarray":
        """Python int -> (NPAIRS, 1) uint64 column."""
        return np.array(_int_to_pairs(x), dtype=np.uint64)[:, None]

    def sub_k(
        self, floor: int, top_floor: int, vb: int
    ) -> Tuple["np.ndarray", int, int, int]:
        """The least power-of-two k (>= vb) such that k*m can be written
        with pair limbs 0..NPAIRS-2 all >= floor and the spare top limb
        >= top_floor — the borrow-free K of the lazy subtraction
        a + (K - b).  Values span only RADIX_BITS bits, so top_floor is
        tiny (the subtrahend's tracked top-limb spill from earlier
        K-chains).  Returns (column, k, maxlimb, toplimb)."""
        key = (floor, top_floor, vb)
        hit = self._ksub.get(key)
        if hit is not None:
            return hit
        need = sum(
            floor << (PAIR_BITS * i) for i in range(NPAIRS - 1)
        ) + (top_floor << (PAIR_BITS * (NPAIRS - 1)))
        k = 1
        while k < vb or k * self.m < need:
            k <<= 1
        if (k * self.m) >> MONT_BITS:
            raise ArithmeticError("k*m does not fit the pair radix")
        limbs = _int_to_pairs(k * self.m)
        # borrow from limb i+1 => +2^PAIR_BITS at limb i; intermediate
        # negatives resolve when their own turn borrows from above, so
        # feasibility is checked once, at the top
        for i in range(NPAIRS - 1):
            if limbs[i] < floor:
                borrow = (
                    floor - limbs[i] + (1 << PAIR_BITS) - 1
                ) >> PAIR_BITS
                limbs[i] += borrow << PAIR_BITS
                limbs[i + 1] -= borrow
        if limbs[NPAIRS - 1] < top_floor:
            raise ArithmeticError(
                f"cannot redistribute {k}*m with limb floor {floor}"
            )
        col = np.array(limbs, dtype=np.uint64)[:, None]
        out = (col, k, max(limbs), limbs[NPAIRS - 1])
        self._ksub[key] = out
        return out


_CTX_LOCK = threading.Lock()
_CTX: dict = {}


def _ctx(modulus: int) -> _NpMont:
    ctx = _CTX.get(modulus)
    if ctx is None:
        with _CTX_LOCK:
            ctx = _CTX.get(modulus)
            if ctx is None:
                ctx = _NpMont(modulus)
                _CTX[modulus] = ctx
    return ctx


# ---------------------------------------------------------------------------
# Core kernels (the annotations below are the proven input contracts; callers enforce them via _FE bounds)
# ---------------------------------------------------------------------------


def _mul_kernel_ref(
    a: "PairMatL32",
    b: "PairMatL4",
    m_col: "PairMat",
    m0inv: int,
) -> "np.ndarray":
    """Reference Montgomery product — the exact recurrence of
    `_mul_kernel` in plain-operator form, which is what the limb-tier
    proof covers: np.zeros starts every column at [0, 0],
    each MAC row adds at most (32*2^26)(4*2^26) = 2^59, the 11-row
    worst case is NPAIRS * 2^59 < 2^62.46, the dense q*m REDC rows add
    NPAIRS * 2^52 and each shifted carry < 2^36.5 — total < 2^62.5,
    2.8x under uint64.  The JAX package's tests pin this bit-exact
    against the workspace-optimized `_mul_kernel`, and
    tests/test_torch_hostec.py holds both copies to the JAX ones, so the
    proof transfers."""
    lanes = a.shape[1]
    t = np.zeros((2 * NPAIRS, lanes), dtype=np.uint64)
    for i in range(NPAIRS):
        t[i : i + NPAIRS] += a[i] * b
    for i in range(NPAIRS):
        q = ((t[i] & PAIR_MASK) * m0inv) & PAIR_MASK
        t[i : i + NPAIRS - 1] += q * m_col[0 : NPAIRS - 1]
        t[i + 1] += t[i] >> PAIR_BITS
    out = t[NPAIRS : 2 * NPAIRS].copy()
    for i in range(NPAIRS - 1):
        out[i + 1] += out[i] >> PAIR_BITS
        out[i] &= PAIR_MASK
    return out


def _mul_kernel_ref_p256(
    a: "PairMatL32",
    b: "PairMatL4",
    bias: "BiasMat",
) -> "np.ndarray":
    """Reference form of the P-256 shift-REDC fast path (see
    _P256_REDC_TERMS below): q*p collapses to four shifted ADDS per
    REDC iteration — the decomposition's one negative term rides the
    complement (q ^ PAIR_MASK) << 16 and the statically-known over-add
    is cancelled by the `bias` constant (K*p minus the over-add total,
    canonical limbs), keeping every column op non-negative and the
    whole sweep inside the interval domain with no suppression."""
    lanes = a.shape[1]
    t = np.zeros((2 * NPAIRS, lanes), dtype=np.uint64)
    for i in range(NPAIRS):
        t[i : i + NPAIRS] += a[i] * b
    t += bias
    for i in range(NPAIRS):
        q = t[i] & PAIR_MASK
        t[i + 1] += t[i] >> PAIR_BITS
        t[i + 3] += q << 18
        t[i + 7] += q << 10
        t[i + 8] += (q ^ PAIR_MASK) << 16  # -(q<<16) via complement+bias
        t[i + 9] += q << 22
    out = t[NPAIRS : 2 * NPAIRS].copy()
    for i in range(NPAIRS - 1):
        out[i + 1] += out[i] >> PAIR_BITS
        out[i] &= PAIR_MASK
    return out


class _WS:
    """Per-width kernel workspace (one per (field, lanes) pair, reused
    across every multiply of a batch pass — the kernels allocate
    nothing but their output row block)."""

    def __init__(self, lanes: int):
        self.t = np.empty((2 * NPAIRS, lanes), dtype=np.uint64)
        self.tmp = np.empty((NPAIRS, lanes), dtype=np.uint64)
        self.tmp2 = np.empty((NPAIRS, lanes), dtype=np.uint64)
        self.q = np.empty(lanes, dtype=np.uint64)
        self.c = np.empty(lanes, dtype=np.uint64)
        self.w = np.empty(lanes, dtype=np.uint64)


# p = 2^256 - 2^224 + 2^192 + 2^96 - 1: q*p decomposes into FIVE signed
# shifted copies of q instead of an 11-row MAC (the pair-radix global
# analog of the device kernel's per-limb qm_term shift decomposition).
# In 2^26 columns relative to the REDC row i:
#   -q           at col i+0   (absorbed: q IS t[i]'s low bits, and the
#                              carry (t[i] - q) >> 26 == t[i] >> 26)
#   +q << 18     at col i+3   (the +2^96 term;  96 == 3*26 + 18)
#   +q << 10     at col i+7   (the +2^192 term; 192 == 7*26 + 10)
#   -q << 16     at col i+8   (the -2^224 term; 224 == 8*26 + 16)
#   +q << 22     at col i+9   (the +2^256 term; 256 == 9*26 + 22)
# The one negative term is applied as the complement
# (PAIR_MASK - q) << 16 — an unconditional ADD — and the constant
# over-add that introduces is cancelled by a bias constant K*p - E
# (built in _NpMont, canonical limbs) pre-loaded into the accumulator:
# the net extra value is exactly K*p ≡ 0 (mod p), K*p/R < m * 2^-31,
# so the output bound stays < 2m and no column ever underflows.
# _P256_REDC_TERMS is validated against p at context build; the kernel
# below hardcodes it for the static proof.
_P256_REDC_TERMS = ((3, 18, 1), (7, 10, 1), (8, 16, -1), (9, 22, 1))


def _redc_rows_p256(t: "AccMat", q, c, w) -> None:
    """REDC sweep specialized to P-256's p (m0inv == 1, the shift
    decomposition above).  The -2^224 term rides the complement
    (PAIR_MASK - q) << 16 — a pure ADD — with the constant over-add
    folded into the kernel's bias, so every op stays non-negative.
    Each iteration adds at most q << 22 < 2^48 per column on top of
    the MAC bound — margin unchanged."""
    for i in range(NPAIRS):
        q = np.bitwise_and(t[i], PAIR_MASK, out=q)
        c = np.right_shift(t[i], PAIR_BITS, out=c)
        t[i + 1] += c
        w = np.left_shift(q, 18, out=w)
        t[i + 3] += w
        w = np.left_shift(q, 10, out=w)
        t[i + 7] += w
        w = np.bitwise_xor(q, PAIR_MASK, out=w)  # PAIR_MASK - q
        w = np.left_shift(w, 16, out=w)
        t[i + 8] += w
        w = np.left_shift(q, 22, out=w)
        t[i + 9] += w


def _redc_rows(t, m_col, m0inv, blocks, tmp, q, c):
    """The limb-serial REDC sweep shared by every kernel variant: for
    each of the NPAIRS iterations, derive the quotient digit from the
    (exact) low bits of t[i], MAC q*m onto the nonzero row blocks of
    the modulus, and shift the retired limb's carry up.  m0inv == 1
    (P-256's p ≡ -1 mod 2^26) makes the quotient digit free, the same
    specialization the device kernel's qm_term exploits."""
    for i in range(NPAIRS):
        if m0inv == 1:
            q = np.bitwise_and(t[i], PAIR_MASK, out=q)
        else:
            q = np.bitwise_and(t[i], PAIR_MASK, out=q)
            q = np.multiply(q, m0inv, out=q)
            q = np.bitwise_and(q, PAIR_MASK, out=q)
        for lo, hi in blocks:
            w = tmp[0 : hi - lo]
            w = np.multiply(q, m_col[lo:hi], out=w)
            t[i + lo : i + hi] += w
        c = np.right_shift(t[i], PAIR_BITS, out=c)
        t[i + 1] += c


def _finish(t, c) -> "np.ndarray":
    """Copy out the high half and carry-propagate to canonical limbs
    (the spare top pair-limb absorbs the spill: values < 2^30 * m)."""
    out = t[NPAIRS : 2 * NPAIRS].copy()
    for i in range(NPAIRS - 1):
        c = np.right_shift(out[i], PAIR_BITS, out=c)
        out[i + 1] += c
        out[i] &= PAIR_MASK
    return out


def _mul_kernel(
    a: "PairMatL32",
    b: "PairMatL4",
    m_col: "PairMat",
    m0inv: int,
    blocks=((0, NPAIRS - 1),),
    ws: Optional[_WS] = None,
    bias=None,
    bias_rows=(0, 0),
) -> "np.ndarray":
    """Montgomery product a*b*R^-1 mod m on pair-limb matrices.

    Static headroom proof (over this very loop): with a's limbs <= 32*2^26 and b's <= 4*2^26, each product
    row adds at most 2^31 * 2^28 = 2^59 per column; the 11-row MAC
    worst case is NPAIRS * 2^59 < 2^62.46, the REDC rows add
    NPAIRS * 2^26 * 2^26 = 2^55.46 more and each shifted-down carry at
    most 2^36.5 — total < 2^62.5, a 2.8x margin under the uint64
    accumulator.  Widening a's contract to match b's 2^31 (both lazy)
    would push the MAC term past 2^64: `fe_mul` carries the second
    operand first for exactly this reason.
    """
    if ws is None:
        ws = _WS(a.shape[1])
    t, tmp = ws.t, ws.tmp
    # first MAC row writes straight into t, so only the tail zeroes
    np.multiply(a[0], b, out=t[0:NPAIRS])
    t[NPAIRS : 2 * NPAIRS] = 0
    for i in range(1, NPAIRS):
        tmp = np.multiply(a[i], b, out=tmp)
        t[i : i + NPAIRS] += tmp
    if bias is not None:
        lo, hi = bias_rows
        t[lo:hi] += bias[lo:hi]
        _redc_rows_p256(t, ws.q, ws.c, ws.w)
    else:
        _redc_rows(t, m_col, m0inv, blocks, tmp, ws.q, ws.c)
    return _finish(t, ws.c)


def _sqr_kernel(
    a: "PairMatL4",
    m_col: "PairMat",
    m0inv: int,
    blocks=((0, NPAIRS - 1),),
    ws: Optional[_WS] = None,
    bias=None,
    bias_rows=(0, 0),
) -> "np.ndarray":
    """Montgomery square: the off-diagonal half of the product MAC is
    folded through a doubled operand (d = a + a <= 2^29 per limb), so
    the worst column is a[i]^2 + sum d[i]*a[j] <= 2^56 + 10 * 2^57
    < 2^60.4 — comfortably under the `_mul_kernel` bound."""
    if ws is None:
        ws = _WS(a.shape[1])
    t = ws.t
    d = np.add(a, a, out=ws.tmp)  # consumed row by row below
    t[:] = 0
    for i in range(NPAIRS):
        q = np.multiply(a[i], a[i], out=ws.q)
        t[2 * i] += q
        if i + 1 < NPAIRS:
            w = ws.tmp2[0 : NPAIRS - 1 - i]
            w = np.multiply(d[i], a[i + 1 :], out=w)
            t[2 * i + 1 : i + NPAIRS] += w
    if bias is not None:
        lo, hi = bias_rows
        t[lo:hi] += bias[lo:hi]
        _redc_rows_p256(t, ws.q, ws.c, ws.w)
    else:
        _redc_rows(t, m_col, m0inv, blocks, ws.tmp2, ws.q, ws.c)
    return _finish(t, ws.c)


def _carry_kernel(x: "PairMatL32") -> "np.ndarray":
    """In-place carry propagation to canonical (< 2^26) limbs.  The top
    pair-limb absorbs the spill: values here are < 2^30 * m < 2^286, so
    it stays <= PAIR_MASK."""
    for i in range(NPAIRS - 1):
        x[i + 1] += x[i] >> PAIR_BITS
        x[i] &= PAIR_MASK
    return x


def _cond_sub_kernel(x: "PairMat", m_col: "PairMat") -> "np.ndarray":
    """x - m where x >= m else x, on canonical limbs (device
    cond_sub_l's shape: int64 borrow chain, arithmetic shifts)."""
    d = x.astype(np.int64) - m_col.astype(np.int64)
    c = np.zeros(x.shape[1], dtype=np.int64)
    limbs = []
    for i in range(NPAIRS):
        v = d[i] + c
        c = v >> PAIR_BITS
        limbs.append(v & PAIR_MASK)
    keep = c < 0  # borrow out -> x < m
    out = np.empty_like(x)
    for i in range(NPAIRS):
        out[i] = np.where(keep, x[i], limbs[i].astype(np.uint64))
    return out


# ---------------------------------------------------------------------------
# Bound-tracked field elements
# ---------------------------------------------------------------------------


class _FE:
    """A batch of field values as a (NPAIRS, lanes) uint64 matrix with
    exact tracked bounds: value < vb * m, limbs 0..NPAIRS-2 <= lb, the
    spare top limb <= tb (nonzero only through K-chain spill).  The
    bounds are Python ints shared by all lanes (the schedule is
    lane-uniform), recomputed per abstract op — the runtime mirror of
    the static proof."""

    __slots__ = ("limbs", "vb", "lb", "tb")

    def __init__(self, limbs, vb: int, lb: int, tb: int = 0):
        self.limbs = limbs
        self.vb = vb
        self.lb = lb
        self.tb = tb

    def copy(self) -> "_FE":
        return _FE(self.limbs.copy(), self.vb, self.lb, self.tb)


class _Field:
    """Field ops over a _NpMont context with automatic carry-on-demand.
    Instances are per-batch-pass (not shared across threads): they own
    the kernel workspaces."""

    def __init__(self, ctx: _NpMont):
        self.ctx = ctx
        self._ws: dict = {}

    def ws(self, lanes: int) -> _WS:
        w = self._ws.get(lanes)
        if w is None:
            w = _WS(lanes)
            self._ws[lanes] = w
        return w

    def kmul(self, a_limbs, b_limbs) -> "np.ndarray":
        """Raw kernel product on canonical-contract limb matrices."""
        return _mul_kernel(
            a_limbs,
            b_limbs,
            self.ctx.m_col,
            self.ctx.m0inv,
            self.ctx.mac_blocks,
            self.ws(a_limbs.shape[1]),
            self.ctx.p256_bias,
            self.ctx.bias_rows,
        )

    def fe(self, limbs, vb: int = 2, lb: int = PAIR_MASK) -> _FE:
        return _FE(limbs, vb, lb)

    def const_int(self, x: int, lanes: int, mont: bool = True) -> _FE:
        """A broadcast constant (optionally converted to the Montgomery
        domain via one multiply by R^2)."""
        if mont:
            x = (x * R_MONT) % self.ctx.m
        col = self.ctx.to_limbs(x)
        return _FE(
            np.broadcast_to(col, (NPAIRS, lanes)).copy(), 1, PAIR_MASK
        )

    def carried(self, x: _FE) -> _FE:
        if x.lb <= PAIR_MASK and x.tb <= PAIR_MASK:
            return x
        if x.vb >= 1 << 25:  # top pair-limb would spill (value >= 2^285)
            raise ArithmeticError(f"value bound {x.vb}m too lax to carry")
        return _FE(
            _carry_kernel(x.limbs.copy()),
            x.vb,
            PAIR_MASK,
            (x.vb * self.ctx.m) >> RADIX_BITS,
        )

    def mul(self, x: _FE, y: _FE) -> _FE:
        # laziest operand first; carry whatever exceeds the proven
        # kernel contract (never raises: carrying is always available)
        if max(x.lb, x.tb) < max(y.lb, y.tb):
            x, y = y, x
        if max(y.lb, y.tb) > L4_BOUND:
            y = self.carried(y)
        if max(x.lb, x.tb) > L32_BOUND:
            x = self.carried(x)
        if x.vb * y.vb >= 1 << 30:
            raise ArithmeticError(
                f"montgomery input bound exceeded: {x.vb}m * {y.vb}m"
            )
        return _FE(self.kmul(x.limbs, y.limbs), 2, PAIR_MASK)

    def sqr(self, x: _FE) -> _FE:
        if max(x.lb, x.tb) > L4_BOUND:
            x = self.carried(x)
        if x.vb * x.vb >= 1 << 30:
            raise ArithmeticError(f"montgomery input bound exceeded: {x.vb}m^2")
        out = _sqr_kernel(
            x.limbs,
            self.ctx.m_col,
            self.ctx.m0inv,
            self.ctx.mac_blocks,
            self.ws(x.limbs.shape[1]),
            self.ctx.p256_bias,
            self.ctx.bias_rows,
        )
        return _FE(out, 2, PAIR_MASK)

    def add(self, x: _FE, y: _FE) -> _FE:
        return _FE(
            x.limbs + y.limbs, x.vb + y.vb, x.lb + y.lb, x.tb + y.tb
        )

    def sub(self, x: _FE, y: _FE) -> _FE:
        """x - y + k*m with k the least power of two covering y's value
        bound AND the limb-floor redistribution, so the limbwise
        subtraction never borrows."""
        if y.lb > L4_BOUND or y.tb > L4_BOUND:
            y = self.carried(y)
        col, k, maxlimb, top = self.ctx.sub_k(y.lb, y.tb, y.vb)
        return _FE(
            x.limbs + (col - y.limbs),
            x.vb + k,
            x.lb + maxlimb,
            x.tb + top,
        )

    def scale(self, x: _FE, c: int) -> _FE:
        """c*x for small c via the uint64 product (c <= 16 keeps any
        canonical-or-lazy operand far inside the accumulator)."""
        if c * x.lb >= 1 << 62:
            x = self.carried(x)
        return _FE(x.limbs * np.uint64(c), x.vb * c, x.lb * c, x.tb * c)

    def select(self, cond, x: _FE, y: _FE) -> _FE:
        """Lanewise cond ? x : y (cond is a (lanes,) bool array)."""
        return _FE(
            np.where(cond, x.limbs, y.limbs),
            max(x.vb, y.vb),
            max(x.lb, y.lb),
            max(x.tb, y.tb),
        )

    def renorm2(self, x: _FE) -> _FE:
        """Bring the value bound back under 2m (Montgomery-multiply by
        the domain's one: yR * R * R^-1 = yR, value preserved)."""
        if x.vb <= 2:
            return x
        lanes = x.limbs.shape[1]
        one = _FE(
            np.broadcast_to(
                self.ctx.to_limbs(self.ctx.one_mont_int), (NPAIRS, lanes)
            ).copy(),
            1,
            PAIR_MASK,
        )
        return self.mul(x, one)

    def is_zero_mod(self, x: _FE):
        """Lanes where x ≡ 0 (mod m): after renormalizing to < 2m and
        carrying, exactly the lanes whose limbs are all zero or all
        equal m's."""
        x = self.carried(self.renorm2(x))
        z = (x.limbs == 0).all(axis=0)
        e = (x.limbs == self.ctx.m_col).all(axis=0)
        return z | e

    def to_ints(self, x: _FE, from_mont: bool = True) -> List[int]:
        """Exact per-lane Python ints (mod m)."""
        x = self.carried(x)
        m = self.ctx.m
        rinv = self.ctx.rinv if from_mont else 1
        arr = x.limbs
        return [
            (_pairs_to_int(arr[:, j]) * rinv) % m
            for j in range(arr.shape[1])
        ]


# ---------------------------------------------------------------------------
# Tree batch inversion (Montgomery's trick with lane pairing)
# ---------------------------------------------------------------------------


def _invert_lanes(field: _Field, x: _FE) -> _FE:
    """Per-lane modular inverse of a Montgomery-domain batch in O(log
    lanes) vector multiplies: pair lanes level by level, invert the
    single root with one Python pow, walk back down.  Zero lanes come
    back zero (callers mask them), without poisoning the tree."""
    ctx = field.ctx
    x = field.carried(field.renorm2(x))
    lanes = x.limbs.shape[1]
    zero = field.is_zero_mod(x)
    one = ctx.to_limbs(ctx.one_mont_int)
    vals = np.where(zero, one, x.limbs)

    levels = []  # (even, odd, tail_or_None)
    cur = vals
    while cur.shape[1] > 1:
        w = cur.shape[1]
        even = cur[:, 0 : w - 1 : 2]
        odd = cur[:, 1:w:2]
        tail = cur[:, w - 1 : w] if w % 2 else None
        nxt = field.kmul(
            np.ascontiguousarray(even), np.ascontiguousarray(odd)
        )
        if tail is not None:
            nxt = np.concatenate([nxt, tail], axis=1)
        levels.append((even, odd, tail))
        cur = nxt

    root = _pairs_to_int(cur[:, 0])
    root_val = (root * ctx.rinv) % ctx.m
    inv_mont = (pow(root_val, ctx.m - 2, ctx.m) * R_MONT) % ctx.m
    inv = ctx.to_limbs(inv_mont)

    for even, odd, tail in reversed(levels):
        pair_inv = inv if tail is None else inv[:, :-1]
        inv_even = field.kmul(
            np.ascontiguousarray(pair_inv), np.ascontiguousarray(odd)
        )
        inv_odd = field.kmul(
            np.ascontiguousarray(pair_inv), np.ascontiguousarray(even)
        )
        w = even.shape[1] + odd.shape[1] + (0 if tail is None else 1)
        nxt = np.empty((NPAIRS, w), dtype=np.uint64)
        nxt[:, 0 : w - 1 if tail is not None else w : 2] = inv_even
        nxt[:, 1 : w : 2] = inv_odd
        if tail is not None:
            nxt[:, w - 1] = inv[:, -1]
        inv = nxt

    out = np.where(zero, np.zeros((NPAIRS, 1), dtype=np.uint64), inv)
    return _FE(np.ascontiguousarray(out), 2, PAIR_MASK)


# ---------------------------------------------------------------------------
# Packing: Python ints <-> radix-2^13 interchange <-> pair rows
# ---------------------------------------------------------------------------


def ints_to_limbs13(xs: Sequence[int]) -> "np.ndarray":
    """Batch of ints -> the (lanes, NLIMBS) uint64 radix-2^13 batch
    interchange matrix, via one bytes pass (no per-limb Python loop
    over lanes)."""
    lanes = len(xs)
    raw = b"".join(x.to_bytes((RADIX_BITS + 7) // 8, "little") for x in xs)
    nbytes = (RADIX_BITS + 7) // 8
    u8 = np.frombuffer(raw, dtype=np.uint8).reshape(lanes, nbytes)
    out = np.empty((lanes, NLIMBS), dtype=np.uint64)
    for j in range(NLIMBS):
        bit = j * LIMB_BITS
        k, off = bit // 8, bit % 8
        word = u8[:, k].astype(np.uint64) | (
            u8[:, k + 1].astype(np.uint64) << np.uint64(8)
        )
        if k + 2 < nbytes:
            word |= u8[:, k + 2].astype(np.uint64) << np.uint64(16)
        out[:, j] = (word >> np.uint64(off)) & np.uint64(LIMB_MASK)
    return out


def limbs13_to_pairs(limbs: "np.ndarray") -> "np.ndarray":
    """(lanes, NLIMBS) radix-2^13 interchange -> (NPAIRS, lanes) compute
    rows (adjacent limbs condensed; spare top pair-limb zero)."""
    lanes = limbs.shape[0]
    out = np.zeros((NPAIRS, lanes), dtype=np.uint64)
    for i in range(NLIMBS // 2):
        out[i] = limbs[:, 2 * i] | (
            limbs[:, 2 * i + 1] << np.uint64(LIMB_BITS)
        )
    return out


def pairs_to_limbs13(pairs: "np.ndarray") -> "np.ndarray":
    """Canonical (NPAIRS, lanes) pair rows -> (lanes, NLIMBS) radix-2^13
    interchange (values must fit RADIX_BITS, i.e. be fully reduced)."""
    lanes = pairs.shape[1]
    out = np.empty((lanes, NLIMBS), dtype=np.uint64)
    for i in range(NLIMBS // 2):
        out[:, 2 * i] = pairs[i] & np.uint64(LIMB_MASK)
        out[:, 2 * i + 1] = pairs[i] >> np.uint64(LIMB_BITS)
    return out


# ---------------------------------------------------------------------------
# Jacobian group law (hostec's formulas, bound-tracked)
# ---------------------------------------------------------------------------

Jac = Tuple[_FE, _FE, _FE]


def _dbl_vec(field: _Field, X: _FE, Y: _FE, Z: _FE) -> Jac:
    """dbl-2001-b (a = -3): 3M + 5S, matching hostec's _dbl_vec."""
    delta = field.sqr(Z)
    gamma = field.sqr(Y)
    beta = field.mul(X, gamma)
    t1 = field.sub(X, delta)
    t2 = field.add(X, delta)
    mm = field.mul(t1, t2)
    alpha = field.add(field.add(mm, mm), mm)
    X3 = field.sub(field.sqr(alpha), field.scale(beta, 8))
    Z3 = field.sub(
        field.sub(field.sqr(field.add(Y, Z)), gamma), delta
    )
    Y3 = field.sub(
        field.mul(alpha, field.sub(field.scale(beta, 4), X3)),
        field.scale(field.sqr(gamma), 8),
    )
    return X3, Y3, Z3


def _madd_vec(
    field: _Field, X: _FE, Y: _FE, Z: _FE, x2: _FE, y2: _FE
) -> Tuple[_FE, _FE, _FE, "np.ndarray"]:
    """Mixed Jacobian+affine add (8M + 3S), hostec's _madd_vec formulas.
    Returns (X3, Y3, Z3, exceptional) where `exceptional` marks lanes
    with Z3 ≡ 0 mod p (P = infinity, P = +-Q) that the caller must
    patch scalar-wise."""
    ZZ = field.sqr(Z)
    U2 = field.mul(x2, ZZ)
    S2 = field.mul(y2, field.mul(Z, ZZ))
    H = field.sub(U2, X)
    Rr = field.sub(S2, Y)
    H = field.carried(H)
    HH = field.sqr(H)
    HHH = field.mul(H, HH)
    V = field.mul(X, HH)
    X3 = field.sub(
        field.sub(field.sqr(Rr), HHH), field.add(V, V)
    )
    Y3 = field.sub(
        field.mul(Rr, field.sub(V, X3)), field.mul(Y, HHH)
    )
    Z3 = field.mul(Z, H)
    return X3, Y3, Z3, field.is_zero_mod(Z3)


def _patch_exceptional(
    field: _Field,
    flag: "np.ndarray",
    jac: Jac,
    X3: _FE,
    Y3: _FE,
    Z3: _FE,
    ax: _FE,
    ay: _FE,
    inf_out: Optional["np.ndarray"] = None,
) -> Jac:
    """Recompute flagged lanes through hostec's scalar _madd1 in plain
    ints (adversarially reachable, never hot), writing the results back
    into the vector state.  A patched lane whose result is the identity
    (P = -Q) is recorded in `inf_out` when given."""
    if not bool(flag.any()):
        return X3, Y3, Z3
    m = field.ctx.m
    rinv = field.ctx.rinv
    X, Y, Z = (field.carried(v) for v in jac)
    axc, ayc = field.carried(ax), field.carried(ay)
    X3 = field.carried(X3)
    Y3 = field.carried(Y3)
    Z3 = field.carried(Z3)
    for j in np.nonzero(flag)[0]:
        lane = int(j)

        def unm(fe: _FE) -> int:
            return (_pairs_to_int(fe.limbs[:, lane]) * rinv) % m

        nx, ny, nz = hostec._madd1(
            unm(X), unm(Y), unm(Z), unm(axc), unm(ayc)
        )
        if inf_out is not None and nz % m == 0:
            inf_out[lane] = True
        for fe, v in ((X3, nx), (Y3, ny), (Z3, nz)):
            fe.limbs[:, lane] = _ctx(m).to_limbs((v * R_MONT) % m)[:, 0]
    return X3, Y3, Z3


def _select_jac(
    field: _Field, cond: "np.ndarray", new: Jac, old: Jac
) -> Jac:
    return (
        field.select(cond, new[0], old[0]),
        field.select(cond, new[1], old[1]),
        field.select(cond, new[2], old[2]),
    )


# ---------------------------------------------------------------------------
# Scalar digit schedules (lane-shared wNAF(5) for Q, w10 comb for G)
# ---------------------------------------------------------------------------

Q_WINDOW_BITS = 5
# scalars are < 2n < 2^257: ceil(257 / 5) = 52 windows cover every bit
NUM_Q_WINDOWS = (257 + Q_WINDOW_BITS - 1) // Q_WINDOW_BITS
G_WINDOW_BITS = 2 * Q_WINDOW_BITS  # 10: one G window per two rounds
NUM_G_WINDOWS = 26


def _extract_windows(
    pairs: "np.ndarray", width: int, count: int
) -> List["np.ndarray"]:
    """Unsigned `width`-bit windows of a canonical pair-limb batch,
    little-endian window order, each an int64 (lanes,) array."""
    mask = np.int64((1 << width) - 1)
    out = []
    for w in range(count):
        bit = w * width
        i, off = bit // PAIR_BITS, bit % PAIR_BITS
        word = pairs[i] >> np.uint64(off)
        if off + width > PAIR_BITS and i + 1 < NPAIRS:
            word = word | (pairs[i + 1] << np.uint64(PAIR_BITS - off))
        out.append(word.astype(np.int64) & mask)
    return out


def _signed_digits(windows: List["np.ndarray"]) -> List["np.ndarray"]:
    """Unsigned base-32 digits -> signed digits in [-15, 16] (the
    lane-shared regular wNAF(5) recoding): d > 16 becomes d - 32 with a
    carry into the next window.  The top window of a < 2^257 scalar is
    <= 4, so the final carry never overflows."""
    out = []
    carry = np.zeros_like(windows[0])
    for d in windows:
        d = d + carry
        neg = d > 16
        carry = neg.astype(np.int64)
        out.append(d - (carry << np.int64(Q_WINDOW_BITS)))
    if int(out[-1].min()) < 0 or int(out[-1].max()) > 16:
        raise ArithmeticError("wNAF top-window carry overflowed")
    return out


# ---------------------------------------------------------------------------
# Fixed-base G comb (lazy global tables, Montgomery domain)
# ---------------------------------------------------------------------------

_G_COMB_NP = None
_G_TABLE_LOCK = threading.Lock()

G_TABLE_ENTRIES = (1 << G_WINDOW_BITS) - 1  # 1023


def _build_g_comb():
    """(G_TABLE_ENTRIES, NPAIRS) uint64 per coordinate: affine d * G in
    the Montgomery domain, d in 1..1023 (index d - 1).  The window
    depth 2^(10w) rides the shared doubling chain — the comb table
    itself is depth-free, exactly like hostec's Horner table, just
    wider.  Built once in plain Python ints via hostec's scalar helpers
    plus one Montgomery batch inversion, then packed."""
    jac: List[Tuple[int, int, int]] = [(GX, GY, 1)]
    for _d in range(G_TABLE_ENTRIES - 1):
        Xr, Yr, Zr = jac[-1]
        jac.append(hostec._madd1(Xr, Yr, Zr, GX, GY))
    aff = hostec._normalize_jacobians(jac)
    xs = ints_to_limbs13([(x * R_MONT) % P for x, _ in aff])
    ys = ints_to_limbs13([(y * R_MONT) % P for _, y in aff])
    gx = np.ascontiguousarray(limbs13_to_pairs(xs).T)
    gy = np.ascontiguousarray(limbs13_to_pairs(ys).T)
    return gx, gy, G_TABLE_ENTRIES


def _g_comb():
    global _G_COMB_NP
    if _G_COMB_NP is None:
        with _G_TABLE_LOCK:
            if _G_COMB_NP is None:
                _G_COMB_NP = _build_g_comb()
    return _G_COMB_NP


def warm_tables() -> None:
    """Build the fixed-base comb now (e.g. before forking pool workers)."""
    if HAVE_NUMPY:
        _g_comb()
    hostec.warm_tables()


# ---------------------------------------------------------------------------
# Core batch verification
# ---------------------------------------------------------------------------


# test/debug seam: when set, called after every Horner add with
# (kind, round, RX, RY, RZ, acc_inf); tests use it to pin per-round
# accumulator state against the scalar oracle
_DEBUG_HOOK = None


# ONE precheck for the whole ladder: the tiers' accept/reject sets are
# a bit-exactness contract, so the per-lane precheck lives in hostec
# and is shared, never mirrored.
_precheck_lanes = hostec._precheck_lanes


def _verify_packed(
    valid: "np.ndarray",
    rr13: "np.ndarray",
    ss13: "np.ndarray",
    qx13: "np.ndarray",
    qy13: "np.ndarray",
    ee13: "np.ndarray",
) -> "np.ndarray":
    """The matrix engine proper: (lanes, NLIMBS) radix-2^13 interchange
    matrices in, verdict uint8 lanes out.  This is the function shard
    workers run against shared memory."""
    lanes = rr13.shape[0]
    fp = _Field(_ctx(P))
    fn = _Field(_ctx(N))

    # ---- u1 = e/s, u2 = r/s (mod n): one tree inversion for every s
    s_m = fn.mul(_FE(limbs13_to_pairs(ss13), 1, PAIR_MASK), fn.fe(
        np.broadcast_to(fn.ctx.r2, (NPAIRS, lanes)).copy(), 1, PAIR_MASK
    ))
    w = _invert_lanes(fn, s_m)
    e_m = fn.mul(_FE(limbs13_to_pairs(ee13), 1, PAIR_MASK), fn.fe(
        np.broadcast_to(fn.ctx.r2, (NPAIRS, lanes)).copy(), 1, PAIR_MASK
    ))
    r_pairs = limbs13_to_pairs(rr13)
    r_m = fn.mul(_FE(r_pairs.copy(), 1, PAIR_MASK), fn.fe(
        np.broadcast_to(fn.ctx.r2, (NPAIRS, lanes)).copy(), 1, PAIR_MASK
    ))
    # from_mont via a multiply by 1 (the u digits only need the value
    # mod n up to one extra n: (u + n) * Q = u * Q)
    one_col = fn.ctx.to_limbs(1)
    one_b = _FE(np.broadcast_to(one_col, (NPAIRS, lanes)).copy(), 1, PAIR_MASK)
    u1 = fn.carried(fn.mul(fn.mul(e_m, w), one_b))
    u2 = fn.carried(fn.mul(fn.mul(r_m, w), one_b))

    q_digits = _signed_digits(
        _extract_windows(u2.limbs, Q_WINDOW_BITS, NUM_Q_WINDOWS)
    )
    g_digits = _extract_windows(u1.limbs, G_WINDOW_BITS, NUM_G_WINDOWS)

    # ---- per-lane Q table: 1..16 times Q, affine Montgomery, one tree
    # ---- inversion across (16 * lanes)
    r2_b = fp.fe(np.broadcast_to(fp.ctx.r2, (NPAIRS, lanes)).copy(), 1, PAIR_MASK)
    Qx = fp.mul(_FE(limbs13_to_pairs(qx13), 1, PAIR_MASK), r2_b)
    Qy = fp.mul(_FE(limbs13_to_pairs(qy13), 1, PAIR_MASK), r2_b)
    tab_jac: List[Jac] = [(Qx, Qy, None)]  # None Z = affine (Z = 1)
    one_mont = fp.const_int(1, lanes)
    d2 = _dbl_vec(fp, Qx, Qy, one_mont)
    tab_jac.append(d2)
    for _d in range(3, 17):
        Xp, Yp, Zp = tab_jac[-1]
        X3, Y3, Z3, exc = _madd_vec(fp, Xp, Yp, Zp, Qx, Qy)
        # d*Q is never the identity for d <= 16 (prime group order), and
        # P = +-Q cannot occur between d*Q and Q for d >= 2 — but a
        # malicious "point" that slipped the curve check cannot reach
        # here (precheck), so exc must be empty; patch defensively.
        X3, Y3, Z3 = _patch_exceptional(
            fp, exc, (Xp, Yp, Zp), X3, Y3, Z3, Qx, Qy
        )
        tab_jac.append((X3, Y3, Z3))

    z_fes = [
        (t[2] if t[2] is not None else one_mont) for t in tab_jac[1:]
    ]
    zs = np.concatenate([z.limbs for z in z_fes], axis=1)
    # the stacked FE carries the entries' TRUE tracked bounds (the 2Q
    # entry is a lazy _dbl_vec output): _invert_lanes then renormalizes
    # and carries before its kernels, keeping the L4/L32 contracts real
    zinv = _invert_lanes(
        fp,
        _FE(
            np.ascontiguousarray(zs),
            max(z.vb for z in z_fes),
            max(z.lb for z in z_fes),
            max(z.tb for z in z_fes),
        ),
    )
    tqx = np.empty((16, lanes, NPAIRS), dtype=np.uint64)
    tqy = np.empty((32, lanes, NPAIRS), dtype=np.uint64)
    Qxc, Qyc = fp.carried(Qx), fp.carried(Qy)
    tqx[0] = Qxc.limbs.T
    tqy[0] = Qyc.limbs.T
    neg_col, neg_k, neg_max, neg_top = fp.ctx.sub_k(PAIR_MASK, 0, 2)
    tqy[16] = (neg_col - Qyc.limbs).T  # -Q: (x, k*p - y), lazy limbs ok
    for t in range(1, 16):
        zi = _FE(
            np.ascontiguousarray(zinv.limbs[:, (t - 1) * lanes : t * lanes]),
            2,
            PAIR_MASK,
        )
        zi2 = fp.sqr(zi)
        ax = fp.carried(fp.mul(tab_jac[t][0], zi2))
        ay = fp.carried(fp.mul(tab_jac[t][1], fp.mul(zi2, zi)))
        tqx[t] = ax.limbs.T
        tqy[t] = ay.limbs.T
        tqy[16 + t] = (neg_col - ay.limbs).T

    gx_tab, gy_tab, _n = _g_comb()

    # ---- joint Horner: 5 doublings per round; Q digit every round, G
    # ---- digit every second round (w10 comb) — every lane walks the
    # ---- same schedule, digit-0 lanes compute and discard via select
    zero_lane = np.zeros((NPAIRS, lanes), dtype=np.uint64)
    RX = _FE(zero_lane.copy(), 1, PAIR_MASK)
    RY = fp.const_int(1, lanes)
    RZ = _FE(zero_lane.copy(), 1, PAIR_MASK)
    one_mont_fe = fp.const_int(1, lanes)
    # acc = infinity (Z ≡ 0) is the COMMON exceptional case — every lane
    # starts there — so it rides a vectorized select; only genuine
    # P = +-Q collisions (adversarially reachable, never hot) take the
    # scalar patch path.
    acc_inf = np.ones(lanes, dtype=bool)

    def add_affine(RX, RY, RZ, acc_inf, ax, ay, active):
        NX, NY, NZ, exc = _madd_vec(fp, RX, RY, RZ, ax, ay)
        patched_inf = np.zeros_like(acc_inf)
        NX, NY, NZ = _patch_exceptional(
            fp,
            exc & active & ~acc_inf,
            (RX, RY, RZ),
            NX,
            NY,
            NZ,
            ax,
            ay,
            inf_out=patched_inf,
        )
        fresh = acc_inf & active  # infinity + P = (ax, ay, 1)
        NX = fp.select(fresh, ax, NX)
        NY = fp.select(fresh, ay, NY)
        NZ = fp.select(fresh, one_mont_fe, NZ)
        RX, RY, RZ = _select_jac(fp, active, (NX, NY, NZ), (RX, RY, RZ))
        # infinity propagates as a flag (doubling preserves it; an
        # active add clears it unless the scalar patch produced P=-Q)
        new_inf = (acc_inf & ~active) | (active & patched_inf)
        return RX, RY, RZ, new_inf

    lane_idx = np.arange(lanes)
    for j in range(NUM_Q_WINDOWS):
        if j:
            for _ in range(Q_WINDOW_BITS):
                RX, RY, RZ = _dbl_vec(fp, RX, RY, RZ)
        d = q_digits[NUM_Q_WINDOWS - 1 - j]
        xsel = np.clip(np.abs(d) - 1, 0, 15)
        ysel = xsel + np.where(d < 0, 16, 0)
        ax = _FE(
            np.ascontiguousarray(tqx[xsel, lane_idx].T), 2, PAIR_MASK
        )
        ay = _FE(
            np.ascontiguousarray(tqy[ysel, lane_idx].T),
            neg_k,  # positive entries are < 2p; negated ones < neg_k*p
            neg_max,
            neg_top,
        )
        RX, RY, RZ, acc_inf = add_affine(
            RX, RY, RZ, acc_inf, ax, ay, d != 0
        )
        if _DEBUG_HOOK is not None:
            _DEBUG_HOOK("q", j, RX, RY, RZ, acc_inf)
        if j & 1:
            gw = (NUM_Q_WINDOWS - 1 - j) >> 1
            gd = g_digits[gw]
            gi = np.clip(gd - 1, 0, G_TABLE_ENTRIES - 1)
            ax = _FE(
                np.ascontiguousarray(gx_tab[gi].T), 2, PAIR_MASK
            )
            ay = _FE(
                np.ascontiguousarray(gy_tab[gi].T), 2, PAIR_MASK
            )
            RX, RY, RZ, acc_inf = add_affine(
                RX, RY, RZ, acc_inf, ax, ay, gd != 0
            )
            if _DEBUG_HOOK is not None:
                _DEBUG_HOOK("g", j, RX, RY, RZ, acc_inf)

    # ---- affine x(R) via one tree inversion; compare x mod n == r
    infinity = acc_inf
    zinv = _invert_lanes(fp, RZ)
    zi2 = fp.sqr(zinv)
    x_mont = fp.mul(fp.carried(RX), zi2)
    x_aff = fp.mul(x_mont, one_b)  # from Montgomery, < 2p canonical
    x_can = _cond_sub_kernel(fp.carried(x_aff).limbs, fp.ctx.m_col)
    # x mod n: x < p < 2n, so at most one subtract of n
    x_modn = _cond_sub_kernel(x_can, fn.ctx.m_col)
    ok = (x_modn == r_pairs).all(axis=0)
    return (ok & valid.astype(bool) & ~infinity).astype(np.uint8)


def verify_parsed_batch(
    lanes: Sequence[Tuple[PubKey, bytes, int, int]],
) -> List[bool]:
    """One matrix-engine pass over (pub, digest, r, s) lanes, all in
    THIS process.  Bit-exact with hostec.verify_parsed_batch / the
    oracle; the low-S rule is NOT applied here (same contract)."""
    if not HAVE_NUMPY:  # pragma: no cover - ladder skips this rung
        return hostec.verify_parsed_batch(lanes)
    nlanes = len(lanes)
    if nlanes == 0:
        return []
    valid, rr, ss, qx, qy, ee = _precheck_lanes(lanes)
    out = _verify_packed(
        np.array(valid, dtype=np.uint8),
        ints_to_limbs13(rr),
        ints_to_limbs13(ss),
        ints_to_limbs13(qx),
        ints_to_limbs13(qy),
        ints_to_limbs13(ee),
    )
    return [bool(v) for v in out]


# ---------------------------------------------------------------------------
# Shared-memory process-pool sharding
# ---------------------------------------------------------------------------

_POOL = None
_POOL_PROCS = 1
_POOL_LOCK = threading.Lock()
# rebuild cooldown after breakage (see hostec._POOL_GATE); mutated only
# under _POOL_LOCK
_POOL_GATE = CooldownGate()

_SHM_FIELDS = 5  # r, s, qx, qy, e limb matrices


def pool_procs() -> int:
    """Worker count (1 = pool disabled); FABRIC_TPU_HOSTEC_NP_PROCS
    overrides, falling back to hostec's FABRIC_TPU_HOSTEC_PROCS
    discipline (malformed values degrade to the default, never raise)."""
    procs = os.environ.get("FABRIC_TPU_HOSTEC_NP_PROCS", "")
    if procs:
        try:
            return max(int(procs), 1)
        except ValueError:
            pass
    return hostec.pool_procs()


def _pool():
    """Lazy shared ProcessPoolExecutor (started by
    `hostec.start_method()`: never a fork).  Broken or unavailable pools
    degrade to inline compute, never die."""
    global _POOL, _POOL_PROCS
    with _POOL_LOCK:
        if _POOL is None:
            if not _POOL_GATE.ready():
                # recently broken: stay inline for the cooldown
                return None
            procs = pool_procs()
            _POOL_PROCS = procs
            if procs <= 1:
                _POOL = False
                return None
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            start = hostec.start_method()
            try:
                _POOL = ProcessPoolExecutor(
                    max_workers=procs,
                    mp_context=multiprocessing.get_context(start),
                )
                fabobs.obs_count(
                    "fabric_pool_rebuilds_total", pool="hostec_np"
                )
            except Exception as exc:  # pragma: no cover - restricted environments
                logger.warning(
                    "process pool unavailable (%s); verifying inline", exc
                )
                _POOL = False
    return _POOL or None


def shutdown_pool(broken: bool = False) -> None:
    """Tear the pool down; ``broken=True`` arms the rebuild cooldown
    (degrade paths only — clean teardowns leave the gate closed)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL:
            _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None
        if broken:
            _POOL_GATE.record_failure()
    if broken:
        fabobs.obs_count("fabric_pool_cooldowns_total", pool="hostec_np")
        fabobs.obs_count("fabric_degrade_total", seam="hostec_np.pool")
        fabobs.obs_trigger("hostec_np.pool_broken")


def _shard_worker(shm_name: str, nlanes: int, lo: int, hi: int) -> bool:
    """Runs in a pool worker: attach to the parent's shared-memory
    block, verify lanes [lo, hi), write verdict bytes into the result
    region.  Only (name, counts) crossed the pickle boundary."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        mat = np.ndarray(
            (_SHM_FIELDS, nlanes, NLIMBS), dtype=np.uint64, buffer=shm.buf
        )
        flags_off = _SHM_FIELDS * nlanes * NLIMBS * 8
        valid = np.ndarray(
            (nlanes,), dtype=np.uint8, buffer=shm.buf, offset=flags_off
        )
        verdict = np.ndarray(
            (nlanes,),
            dtype=np.uint8,
            buffer=shm.buf,
            offset=flags_off + nlanes,
        )
        sl = slice(lo, hi)
        verdict[sl] = _verify_packed(
            valid[sl].copy(),
            mat[0, sl].copy(),
            mat[1, sl].copy(),
            mat[2, sl].copy(),
            mat[3, sl].copy(),
            mat[4, sl].copy(),
        )
        return True
    finally:
        shm.close()


def verify_parsed_batch_sharded(
    lanes: Sequence[Tuple[PubKey, bytes, int, int]],
) -> Callable[[], List[bool]]:
    """Shard a parsed batch across the process pool through one
    shared-memory block; returns a resolver (call it for the verdicts)
    so callers can overlap host prep with shard execution.  Shards are
    slices of one verdict array: results are order-preserving by
    construction.

    Small batches delegate down-ladder to hostec (the matrix engine's
    fixed cost only pays off from ~NP_MIN_LANES up); mid-size batches
    run inline; a broken pool or shm failure degrades to inline compute
    — degrade, never die."""
    lanes = list(lanes)
    nlanes = len(lanes)
    if not HAVE_NUMPY or nlanes < NP_MIN_LANES:
        return hostec.verify_parsed_batch_sharded(lanes)
    pool = _pool() if nlanes >= MIN_POOL_LANES else None
    if pool is None:
        out = verify_parsed_batch(lanes)
        return lambda: out

    valid, rr, ss, qx, qy, ee = _precheck_lanes(lanes)
    try:
        from multiprocessing import shared_memory

        size = _SHM_FIELDS * nlanes * NLIMBS * 8 + 2 * nlanes
        shm = shared_memory.SharedMemory(create=True, size=size)
    except Exception as exc:  # pragma: no cover - hosts without /dev/shm
        logger.warning("shared memory unavailable (%s); inline verify", exc)
        out = verify_parsed_batch(lanes)
        return lambda: out

    mat = np.ndarray(
        (_SHM_FIELDS, nlanes, NLIMBS), dtype=np.uint64, buffer=shm.buf
    )
    for k, xs in enumerate((rr, ss, qx, qy, ee)):
        mat[k] = ints_to_limbs13(xs)
    flags_off = _SHM_FIELDS * nlanes * NLIMBS * 8
    valid_arr = np.ndarray(
        (nlanes,), dtype=np.uint8, buffer=shm.buf, offset=flags_off
    )
    valid_arr[:] = np.array(valid, dtype=np.uint8)
    verdict = np.ndarray(
        (nlanes,), dtype=np.uint8, buffer=shm.buf, offset=flags_off + nlanes
    )
    verdict[:] = 0

    nshards = min(_POOL_PROCS, max(nlanes // MIN_SHARD_LANES, 1))
    step = (nlanes + nshards - 1) // nshards
    try:
        fault_point("hostec_np.pool.submit")
        futures = [
            pool.submit(
                _shard_worker, shm.name, nlanes, off, min(off + step, nlanes)
            )
            for off in range(0, nlanes, step)
        ]
    except Exception as exc:  # BrokenProcessPool / shutdown race
        logger.warning("pool submit failed (%s); recomputing inline", exc)
        shutdown_pool(broken=True)
        shm.close()
        shm.unlink()
        out = verify_parsed_batch(lanes)
        return lambda: out

    memo: dict = {}

    def resolve() -> List[bool]:
        # memoized: the verdict array is a view over the shm buffer,
        # which the first call unmaps — a second resolve must return
        # the cached verdicts, never re-read the dead mapping
        if "out" in memo:
            return memo["out"]
        try:
            fault_point("hostec_np.pool.resolve")
            for f in futures:
                f.result()
            out = [bool(v) for v in verdict]
            # a batch that made it THROUGH the pool resets the rebuild
            # cooldown ramp (construction alone proves nothing)
            with _POOL_LOCK:
                _POOL_GATE.record_success()
        except Exception as exc:  # worker died mid-run: inline fallback
            logger.warning(
                "pool worker died mid-batch (%s); recomputing inline", exc
            )
            shutdown_pool(broken=True)
            out = verify_parsed_batch(lanes)
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:  # pragma: no cover - racing unlink
                pass
        memo["out"] = out
        return out

    return resolve


# ---------------------------------------------------------------------------
# Scalar API — drop-in parity with the other ladder tiers.  Single
# verifies and signing gain nothing from matrix lanes; they ride
# hostec's scalar paths (bit-identical semantics).
# ---------------------------------------------------------------------------


def verify_digest(pub: Tuple[int, int], digest: bytes, r: int, s: int) -> bool:
    """Go crypto/ecdsa.Verify semantics (no low-S rule), single lane —
    delegated to hostec: one lane cannot amortize a matrix pass."""
    return hostec.verify_digest(pub, digest, r, s)


def scalar_base_mult(k: int) -> p256.AffinePoint:
    return hostec.scalar_base_mult(k)


def sign_digest(priv: int, digest: bytes) -> Tuple[int, int]:
    """ECDSA sign, low-S normalized (hostec's comb-based signer)."""
    return hostec.sign_digest(priv, digest)


def generate_keypair() -> KeyPair:
    return hostec.generate_keypair()
