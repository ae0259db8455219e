"""Batched Ate2 pairing check (the Idemix BBS+ structure check): the CUDA
kernel and its plain version.

Reference semantics (idemix/signature.go:288-296):

    Fexp( Ate(W, A') * Inverse(Ate(GenG2, ABar)) ).Isunity()

with W (the issuer key) and GenG2 fixed G2 points; only the G1 arguments
(A', ABar) vary per signature. As in the JAX package's
`ops/pairing_kernel.py`, the G2 side runs on the host once per point:
`LineSchedule` precomputes every Miller step's line coefficients
l(P) = A + B*px + py (Fp12 constants), so a lane only evaluates lines at
its G1 points and multiplies in Fp12. Both Miller loops share the bit
schedule of |6u + 2| (65 steps, 22 of them with an addition line), then
the value is conjugated (u < 0) and the two Frobenius correction lines
follow. The verdict is fexp(f1 * inv(f2)) == 1, AND-ed with the lane's ok
flag.

The plain version is the replaced program's algorithm: dense lines, m =
f1 * inv(f2), and the host oracle's final exponentiation (conj(m) *
inv(m), times its p^2 Frobenius, then square and multiply over the
768-bit hard part (p^4 - p^2 + 1) / r). The kernel computes the same
values with less work (see csrc/bn256.cu), each step checked here on the
CPU against the plain one:

* sparse lines: the untwist puts x at w^4 and y at w^3, so a line's A is
  nonzero only at w^3 (rows 6-7) and its B only at w^5 (rows 10-11);
  `LineSchedule` raises for any other schedule. l(P) = py + A3 w^3 +
  (B5 px) w^5 takes 2 multiplies, and f * l is `fp12.line_mul`;
* m = f1 * conj(f2): conj(f2) = f2^(p^6), and fexp of a p^6-th power is
  the inverse of fexp in the cyclotomic subgroup (r divides p^6 + 1), so
  fexp(m) is unchanged, also for f2 = 0 (both forms give m = 0);
* the hard part by the x-power chain of the JAX package's
  crypto/hostbn.py (`final_exp_xchain_ref`), its squares cyclotomic
  (`fp12.cyc_sqr`).

`unity_check` is the wrapper of `ate2_unity` in `csrc/bn256.cu` (K4,
replacing the JAX package's `_unity_check` behind `_shared_fn`): given
CUDA lane columns it launches the kernel, given CPU columns it runs the
plain version `unity_check_ref`; anything else raises. `miller2_values`
is the test hook: both Miller values and the final-exponentiated value per
lane as host Fp12 tuples, from the kernel's debug entry or the plain
version.

`Ate2Kernel.check_sharded` splits the lanes over a mesh's axis: one K4
launch a position (a stream a position on the card), the verdicts gathered
to the host.

Departures from the JAX package: one launch per batch, or per mesh
position (no 8/16/64 lane buckets or 64-lane chunks: those bound XLA
compiles).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabric_tpu_torch.common import fp256bn as host
from fabric_tpu_torch.ops import bignum as bn
from fabric_tpu_torch.ops import convert
from fabric_tpu_torch.ops import cudalib
from fabric_tpu_torch.ops import fp12 as f12

# ---------------------------------------------------------------------------
# Host-side line precomputation (per fixed G2 point)
# ---------------------------------------------------------------------------

_SIX_U_TWO = 6 * host.U + 2
_N_BITS = bin(abs(_SIX_U_TWO))[3:]  # loop bits after the implicit MSB
STEPS = len(_N_BITS)  # 65
ADD_STEPS = _N_BITS.count("1")  # 22

_line_coeffs = host.line_coeffs


def _fp12_to_mont_rows(v: host.Fp12) -> np.ndarray:
    """(12, 20) uint32 Montgomery rows, order [c0.re, c0.im, ...]."""
    rows = []
    for c in v:
        rows.append(bn.int_to_limbs(f12.to_mont_int(c[0])))
        rows.append(bn.int_to_limbs(f12.to_mont_int(c[1])))
    return np.array(rows, dtype=np.uint32)


class LineSchedule:
    """Per-G2-point precomputed Miller lines: arrays over the steps
    (doubling line always; addition line + has_add for '1' bits), plus the
    two post-conjugation Frobenius correction lines."""

    def __init__(self, q: host.G2Point):
        qe = host._untwist(q)
        t = qe
        dbl_a, dbl_b, add_a, add_b, has_add = [], [], [], [], []
        zero12 = _fp12_to_mont_rows(host.FP12_ZERO)
        for bit in _N_BITS:
            a, b = _line_coeffs(t, t)
            dbl_a.append(_fp12_to_mont_rows(a))
            dbl_b.append(_fp12_to_mont_rows(b))
            t = host._e12_add(t, t)
            if bit == "1":
                a, b = _line_coeffs(t, qe)
                add_a.append(_fp12_to_mont_rows(a))
                add_b.append(_fp12_to_mont_rows(b))
                has_add.append(1)
                t = host._e12_add(t, qe)
            else:
                add_a.append(zero12)
                add_b.append(zero12)
                has_add.append(0)
        if _SIX_U_TWO >= 0:  # FP256BN: u negative (SIGN_OF_X)
            raise ArithmeticError("the Miller loop's conjugation assumes 6u + 2 < 0")
        t = (t[0], host.fp12_neg(t[1]))
        q1 = (host.fp12_frobenius(qe[0], 1), host.fp12_frobenius(qe[1], 1))
        q2 = (host.fp12_frobenius(qe[0], 2), host.fp12_neg(host.fp12_frobenius(qe[1], 2)))
        corr = []
        a, b = _line_coeffs(t, q1)
        corr.append((_fp12_to_mont_rows(a), _fp12_to_mont_rows(b)))
        t = host._e12_add(t, q1)
        a, b = _line_coeffs(t, q2)
        corr.append((_fp12_to_mont_rows(a), _fp12_to_mont_rows(b)))

        self.dbl_a = np.stack(dbl_a)  # (S, 12, NLIMBS)
        self.dbl_b = np.stack(dbl_b)
        self.add_a = np.stack(add_a)
        self.add_b = np.stack(add_b)
        self.has_add = np.array(has_add, dtype=np.uint32)
        self.corr = corr
        rows = schedule_rows(self)
        if rows[0::2][:, _A_ZERO].any() or rows[1::2][:, _B_ZERO].any():
            raise ArithmeticError("a Miller line has a coefficient the sparse kernel skips")


# The rows a line's A and B may hold (the w^3 and w^5 coefficients); the
# kernel reads only these.
A_ROWS = (6, 7)
B_ROWS = (10, 11)
_A_ZERO = [r for r in range(12) if r not in A_ROWS]
_B_ZERO = [r for r in range(12) if r not in B_ROWS]


@functools.lru_cache(maxsize=1)
def _g2_schedule() -> LineSchedule:
    return LineSchedule(host.G2_GEN)


def schedule_rows(sched: LineSchedule) -> np.ndarray:
    """All line coefficients of a schedule as (4S + 4, 12, 20) Montgomery
    limb rows: step s's doubling (A, B) at 2s, 2s + 1, its addition line at
    2S + 2s, 2S + 2s + 1 (zero rows on a doubling-only step), correction c
    at 4S + 2c, 4S + 2c + 1."""
    s = len(sched.has_add)
    rows = np.zeros((4 * s + 4, 12, bn.NLIMBS), dtype=np.uint32)
    rows[0:2 * s:2], rows[1:2 * s:2] = sched.dbl_a, sched.dbl_b
    rows[2 * s:4 * s:2], rows[2 * s + 1:4 * s:2] = sched.add_a, sched.add_b
    for c, (a, b) in enumerate(sched.corr):
        rows[4 * s + 2 * c], rows[4 * s + 2 * c + 1] = a, b
    return rows


def compact_rows(sched: LineSchedule) -> np.ndarray:
    """The kernel's schedule: per line (step s's doubling line at s, its
    addition line at S + s, correction c at 2S + c) the four Fp values
    A[6], A[7], B[10], B[11] as (2S + 2, 4, 20) Montgomery limbs."""
    rows = schedule_rows(sched)
    return np.concatenate([rows[0::2][:, list(A_ROWS)], rows[1::2][:, list(B_ROWS)]], axis=1)


class _Tables:
    """A schedule on one device: int64 limbs (20, 4S + 4, 12) of every row
    for the plain version, int32 words (2S + 2, 4, 8) with R = 2^256 of
    the compact schedule for the kernel, built on first use."""

    def __init__(self, sched: LineSchedule):
        self.sched = sched
        self._cache: Dict[Tuple[str, str], torch.Tensor] = {}

    def limbs(self, device: torch.device) -> torch.Tensor:
        key = ("limbs", str(device))
        if key not in self._cache:
            rows = schedule_rows(self.sched).astype(np.int64)
            self._cache[key] = torch.from_numpy(np.moveaxis(rows, 2, 0).copy()).to(device)
        return self._cache[key]

    def words(self, device: torch.device) -> torch.Tensor:
        key = ("words", str(device))
        if key not in self._cache:
            w = convert.limbs_to_words(compact_rows(self.sched), axis=2, modulus=host.P)
            self._cache[key] = torch.from_numpy(w.view(np.int32).copy()).to(device)
        return self._cache[key]

    def has_add(self, device: torch.device) -> torch.Tensor:
        key = ("has_add", str(device))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(self.sched.has_add.astype(np.int32)).to(device)
        return self._cache[key]


@functools.lru_cache(maxsize=1)
def _g2_tables() -> _Tables:
    return _Tables(_g2_schedule())


# ---------------------------------------------------------------------------
# Work of one lane (see the header of csrc/bn256.cu)
# ---------------------------------------------------------------------------

MULS_FP_INV = 14 + 63 * 5  # Fermat, 4-bit fixed window
LINES = STEPS + ADD_STEPS + 2  # a Miller loop's lines, the two corrections included
_U_BITS = bin(abs(host.U))[2:]
# the x-power chain: three |u|-power chains (62 squares, 21 multiplies
# each), then 10 squares, 14 multiplies and the p, p^2, p^3 Frobenius maps
CHAIN_SQRS = 3 * (len(_U_BITS) - 1) + 10
CHAIN_MULS = 3 * (_U_BITS.count("1") - 1) + 14


@dataclass(frozen=True)
class TowerCosts:
    """Montgomery multiplies of each operation of a K4 lane."""

    step: int  # a Miller step's square, with the line evaluations it carries
    line: int  # a line's product f * l, and its evaluation where no step carries it
    corr: int  # the correction lines' evaluations where `line` leaves them out
    mul: int  # an Fp12 multiply
    cyc_sqr: int  # a square in the cyclotomic subgroup
    inv: int  # an Fp12 inverse
    frob: Tuple[int, int, int]  # the p, p^2 and p^3 Frobenius maps

    def lane(self) -> int:
        """A lane: the G1 coordinates from R = 2^260 to R = 2^256 (4), both
        Miller loops, f1 * conj(f2), the easy part (an inverse, two
        multiplies, a p^2 map) and the hard part by the x-power chain."""
        return (4 + 2 * (STEPS * self.step + LINES * self.line + self.corr) + self.mul
                + self.inv + 2 * self.mul + self.frob[1]
                + CHAIN_SQRS * self.cyc_sqr + CHAIN_MULS * self.mul + sum(self.frob))


# As the kernel runs them, an Fp2 product by Karatsuba (3 multiplies), an
# Fp2 square 2: a step is a team's 24 Fp2 products, the square's 21 and
# three slots that evaluate the step's lines' B5 * px (thread 5's is not
# kept); f * l is 6 * (2 + 3 + 3); the two correction lines' B5 * px 2 * 2;
# an Fp12 multiply 36 Fp2 products; a cyclotomic square 9 Fp2 squares
# (Granger-Scott); a Frobenius map 2 products an Fp row; the inverse the
# host's norm chain: two Fp12 multiplies, 6 + 3 + 6 Fp2 products (three
# of the last six are not kept), the Fp2 norm (2), its Fermat inverse and 2.
KERNEL = TowerCosts(step=24 * 3, line=48, corr=4, mul=36 * 3, cyc_sqr=9 * 2,
                    inv=2 * 36 * 3 + 15 * 3 + 2 + MULS_FP_INV + 2, frob=(24, 24, 24))
# The least cost known for each operation, from which the bound is counted.
# Over Fp6 = Fp2[v], v = w^2, and Fp12 = Fp6[w]: an Fp6 product by
# Karatsuba is 6 Fp2 products, an Fp12 product 3 Fp6 products (54); a
# square by the complex method 2 Fp6 products (36); a line l = py + w (A3 v
# + l5 v^2) is evaluated with 2 and multiplied in with 2 * 6 for f's two
# halves times py and 2 * 5 Fp2 products for them times a two-term Fp6
# (42); the cyclotomic square is the kernel's (Karabina's compressed
# squares trade 3 Fp2 squares for inversions to decompress); a Frobenius
# map is 5 products by gamma_{n,k} (gamma_{n,0} = 1), 2 multiplies where
# gamma lies in Fp or i Fp, 3 where not: 3 + 2 + 3 + 2 + 3 for p and p^3,
# 5 * 2 for p^2, whose gammas lie in Fp; the inverse is the norm a0^2 -
# v a1^2 by two Chung-Hasan squares (2 Fp2 products and 3 Fp2 squares
# each), the Fp6 inverse (3 Fp2 squares, 9 Fp2 products, the Fp2 inverse)
# and two Fp6 products.
LEAST = TowerCosts(step=2 * 6 * 3, line=2 + 2 * 6 + 2 * 5 * 3, corr=0, mul=3 * 6 * 3,
                   cyc_sqr=9 * 2, inv=2 * (2 * 3 + 3 * 2) + (3 * 2 + 9 * 3 + 2 + MULS_FP_INV + 2)
                   + 2 * 6 * 3, frob=(13, 10, 13))
MULS_PER_LANE = KERNEL.lane()
MULS_LEAST = LEAST.lane()
THREADS_PER_LANE = 12  # csrc/bn256.cu GROUP4: two teams of six in the Miller loops

# The replaced program's lane (one thread; dense lines, 12 multiplies to
# evaluate one and an Fp12 multiply to multiply it in; squares of 21 Fp2
# products; f1 * inv(f2); square and multiply over the 768-bit hard part),
# kept for the bound it had.
_HARD_BITS = bin(host._HARD_EXP)[2:]
MULS_PER_LANE_REPLACED = (
    4 + 2 * (STEPS * 21 * 3 + LINES * (12 + KERNEL.mul))
    + 2 * (KERNEL.inv - 3 * 3) + KERNEL.mul  # f1 * inv(f2); inverses without the unkept products
    + 2 * KERNEL.mul + 6 * 3  # the easy part, its p^2 map in 6 Fp2 products
    + len(_HARD_BITS) * 21 * 3 + _HARD_BITS.count("1") * KERNEL.mul
)

# Kernel launches, counted by the wrappers where they launch (never for the
# plain versions): the verdict entry and the debug entry of the test hook.
LAUNCHES: Dict[str, int] = {"ate2_unity": 0, "ate2_debug": 0}


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _line(a: torch.Tensor, b: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """A + B*px + py (py on row 0): a, b (20, 12, L), px, py (20, L)."""
    lv = bn.add_raw(a, bn.mont_mul(f12.CTX, b, px.unsqueeze(1)))
    lv[:, 0] += py
    return bn.reduce_canonical(f12.CTX, lv, 2)


def _step_rows(w_rows, g_rows, r: int, lanes: int) -> torch.Tensor:
    """Row r of both schedules, the issuer's over the first `lanes` lanes
    and the generator's over the rest: (20, 12, 2 * lanes)."""
    w = w_rows[:, r].unsqueeze(-1).expand(-1, -1, lanes)
    g = g_rows[:, r].unsqueeze(-1).expand(-1, -1, lanes)
    return torch.cat([w, g], -1)


def miller2_ref(w_rows, g_rows, has_add, p1x, p1y, p2x, p2y):
    """Both Miller loops at once, (W, P1) on the first B lanes and (g2, P2)
    on the next B: returns (f1, f2), each (20, 12, B)."""
    lanes = p1x.shape[1]
    px = torch.cat([p1x, p2x], 1)
    py = torch.cat([p1y, p2y], 1)
    steps = len(has_add)

    def line(r):
        return _line(_step_rows(w_rows, g_rows, r, lanes),
                     _step_rows(w_rows, g_rows, r + 1, lanes), px, py)

    f = f12.one(2 * lanes, p1x.device)
    for s in range(steps):
        f = f12.mul(f12.sqr(f), line(2 * s))
        if has_add[s]:
            f = f12.mul(f, line(2 * steps + 2 * s))
    f = f12.conj(f)
    for c in range(2):
        f = f12.mul(f, line(4 * steps + 2 * c))
    return f[..., :lanes], f[..., lanes:]


def final_exp_ref(f: torch.Tensor) -> torch.Tensor:
    """The host oracle's final_exp, operation for operation."""
    easy = f12.mul(f12.conj(f), f12.inv(f))
    easy = f12.mul(f12.frobenius(easy, 2), easy)
    return f12.pow_const(easy, host._HARD_EXP)


# (p^4 - p^2 + 1) / r = lam0 + lam1 p + lam2 p^2 + p^3 with lam0 =
# -(36x^3 + 30x^2 + 18x + 2), lam1 = -(36x^3 + 18x^2 + 12x) + 1, lam2 =
# 6x^2 + 1 for the BN parameter x = u < 0 (Devegili-Scott-Dominguez 2007);
# checked exactly here, as the JAX package's crypto/hostbn.py does.
_LAM = (-36 * host.U ** 3 - 30 * host.U ** 2 - 18 * host.U - 2,
        -36 * host.U ** 3 - 18 * host.U ** 2 - 12 * host.U + 1,
        6 * host.U ** 2 + 1)
if _LAM[0] + _LAM[1] * host.P + _LAM[2] * host.P ** 2 + host.P ** 3 != host._HARD_EXP:
    raise ArithmeticError("the BN hard-part decomposition does not match (p^4 - p^2 + 1) / r")


def _pow_u(s: torch.Tensor) -> torch.Tensor:
    """s^|u| by |u|'s bits from the top (cyclotomic squares)."""
    out = s
    for bit in _U_BITS[1:]:
        out = f12.cyc_sqr(out)
        if bit == "1":
            out = f12.mul(out, s)
    return out


def final_exp_xchain_ref(f: torch.Tensor) -> torch.Tensor:
    """The same value as `final_exp_ref` by the kernel's algorithm: the
    easy part, then the hard part by the x-power chain of the JAX package's
    crypto/hostbn.py (x-powers are conjugated |u|-powers, since x < 0 and
    conj inverts a unitary value), c3^2 computed once."""
    s = f12.mul(f12.conj(f), f12.inv(f))
    s = f12.mul(f12.frobenius(s, 2), s)
    sx = f12.conj(_pow_u(s))
    sx2 = f12.conj(_pow_u(sx))
    sx3 = f12.conj(_pow_u(sx2))
    x2s = f12.cyc_sqr(sx)  # sx^2
    c3 = f12.mul(f12.cyc_sqr(sx2), sx2)  # sx2^3
    c3sq = f12.cyc_sqr(c3)
    t = f12.cyc_sqr(sx3)
    a3 = f12.mul(f12.mul(f12.mul(f12.cyc_sqr(t), t), c3), x2s)  # sx3^6 c3 x2s
    t = f12.cyc_sqr(a3)
    big_a = f12.mul(f12.cyc_sqr(t), t)  # s^(36x^3 + 18x^2 + 12x)
    big_b = f12.mul(f12.mul(f12.cyc_sqr(c3sq), f12.mul(f12.cyc_sqr(x2s), x2s)),
                    f12.cyc_sqr(s))  # s^(12x^2 + 6x + 2)
    y_l1 = f12.mul(f12.conj(big_a), s)
    y_l0 = f12.mul(f12.conj(big_a), f12.conj(big_b))
    y_l2 = f12.mul(c3sq, s)  # s^(6x^2 + 1)
    out = f12.mul(y_l0, f12.frobenius(y_l1, 1))
    out = f12.mul(out, f12.frobenius(y_l2, 2))
    return f12.mul(out, f12.frobenius(s, 3))


def line_mul_ref(f, a, b, px, py):
    """f * (A + B px + py) as the kernel computes it: a, b (20, 12, L)
    line rows, of which it reads A's w^3 and B's w^5 coefficients."""
    l5 = bn.mont_mul(f12.CTX, b[:, list(B_ROWS)], px.unsqueeze(1))
    return f12.line_mul(f, py, a[:, list(A_ROWS)], l5)


def _plain_values(w_tab: _Tables, p1x, p1y, p2x, p2y):
    device = p1x.device
    g_tab = _g2_tables()
    f1, f2 = miller2_ref(w_tab.limbs(device), g_tab.limbs(device), g_tab.sched.has_add,
                         p1x, p1y, p2x, p2y)
    return f1, f2, final_exp_ref(f12.mul(f1, f12.inv(f2)))


def unity_check_ref(w_tab: _Tables, p1x, p1y, p2x, p2y, ok) -> torch.Tensor:
    """Plain version of K4: (B,) bool, fexp(f1 * inv(f2)) == 1 and ok."""
    _, _, fe = _plain_values(w_tab, p1x, p1y, p2x, p2y)
    return f12.equal(fe, f12.one(fe.shape[2], fe.device)) & ok


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cudalib.load("bn256")
    for name in ("ate2_unity_launch", "ate2_debug_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P]
        fn.restype = _I
    return lib


def _check_columns(p1x, p1y, p2x, p2y, ok) -> int:
    device = p1x.device
    lanes = p1x.shape[1] if p1x.dim() == 2 else -1
    for name, t in (("p1x", p1x), ("p1y", p1y), ("p2x", p2x), ("p2y", p2y)):
        cudalib.check_tensor(name, t, torch.int64, (bn.NLIMBS, lanes), device)
    cudalib.check_tensor("ok", ok, torch.bool, (lanes,), device)
    return lanes


def _launch(name: str, w_tab: _Tables, cols, out: torch.Tensor, lanes: int) -> None:
    device = cols[0].device
    g_tab = _g2_tables()
    with torch.cuda.device(device):
        rc = getattr(_lib(), f"{name}_launch")(
            w_tab.words(device).data_ptr(), g_tab.words(device).data_ptr(),
            g_tab.has_add(device).data_ptr(), STEPS,
            *(c.data_ptr() for c in cols), out.data_ptr(), lanes,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def unity_check(w_tab: _Tables, p1x, p1y, p2x, p2y, ok) -> torch.Tensor:
    """K4: the issuer's line tables, lane columns (20, B) int64 Montgomery
    limbs (R = 2^260) of A' (p1) and ABar (p2), a (B,) bool ok mask ->
    (B,) bool."""
    lanes = _check_columns(p1x, p1y, p2x, p2y, ok)
    if not cudalib.kernel_device(p1x.device, "Ate2 pairing"):
        return unity_check_ref(w_tab, p1x, p1y, p2x, p2y, ok)
    out = torch.empty(lanes, dtype=torch.bool, device=p1x.device)
    if lanes:
        _launch("ate2_unity", w_tab, (p1x, p1y, p2x, p2y, ok), out, lanes)
    return out


def miller2_words(w_tab: _Tables, p1x, p1y, p2x, p2y) -> torch.Tensor:
    """The kernel's debug entry: (3, 12, 8, B) int32 words (R = 2^256) of
    f1, f2 and fexp(f1 * conj(f2)) per lane (the value of fexp(f1 *
    inv(f2))), on a CUDA device."""
    if not cudalib.kernel_device(p1x.device, "Ate2 pairing"):
        raise ValueError("miller2_words runs the kernel: pass CUDA tensors")
    ok = torch.ones(p1x.shape[-1], dtype=torch.bool, device=p1x.device)
    lanes = _check_columns(p1x, p1y, p2x, p2y, ok)
    out = torch.empty((3, 12, convert.NWORDS, lanes), dtype=torch.int32, device=p1x.device)
    if lanes:
        _launch("ate2_debug", w_tab, (p1x, p1y, p2x, p2y, ok), out, lanes)
    return out


def miller2_values_ref_words(w_tab: _Tables, p1x, p1y, p2x, p2y) -> torch.Tensor:
    """The plain version's f1, f2 and final value in the debug entry's
    layout, (3, 12, 8, B) int32 words with R = 2^256 (host conversion)."""
    vals = torch.stack(_plain_values(w_tab, p1x, p1y, p2x, p2y)).cpu().numpy()
    words = convert.limbs_to_words(vals, axis=1, modulus=host.P)  # (3, 8, 12, B)
    return torch.from_numpy(np.moveaxis(words, 1, 2).view(np.int32).copy())


def _per_lane(values) -> List[Tuple[host.Fp12, ...]]:
    """(20, 12, B) values -> per lane the tuple of their host values."""
    per = [f12.to_host(v) for v in values]
    return [tuple(v[lane] for v in per) for lane in range(len(per[0]))]


def words_to_host(words: torch.Tensor) -> List[Tuple[host.Fp12, ...]]:
    """(3, 12, 8, B) words (R = 2^256) -> per lane (f1, f2, fexp) host
    values."""
    limbs = convert.words_to_limbs(words.cpu().numpy(), axis=2, modulus=host.P)
    return _per_lane(torch.from_numpy(np.moveaxis(limbs, 2, 1).astype(np.int64)))


# ---------------------------------------------------------------------------
# Host API
# ---------------------------------------------------------------------------


Pair = Optional[Tuple[host.G1Point, host.G1Point]]


def lane_columns(pairs: Sequence[Pair], device):
    """(p1x, p1y, p2x, p2y, ok) for the lanes: a None pair, or one with a
    None point, runs as (G1, G1) with ok False."""
    g = host.G1_GEN
    cols: List[List[int]] = [[], [], [], []]
    ok = []
    for pair in pairs:
        if pair is None or pair[0] is None or pair[1] is None:
            p1, p2, good = g, g, False
        else:
            p1, p2, good = pair[0], pair[1], True
        for c, v in enumerate((p1[0], p1[1], p2[0], p2[1])):
            cols[c].append(f12.to_mont_int(v))
        ok.append(good)
    out = [bn.ints_to_limbs(c).to(device) for c in cols]
    return (*out, torch.tensor(ok, dtype=torch.bool, device=device))


class Ate2Kernel:
    """Batched evaluator of the Idemix pairing structure check for one
    issuer key W: the issuer's line tables are built once (host Fp12
    arithmetic) and kept on the kernel's device; the generator's are shared
    by every issuer. One launch per batch, on `device` (the card unless the
    caller asks for "cpu", where the plain version runs)."""

    def __init__(self, w: host.G2Point, device=None):
        self.device = cudalib.resolve_device(device, "Ate2 pairing")
        self.sched_w = LineSchedule(w)
        self.tables = _Tables(self.sched_w)

    def check(self, pairs: Sequence[Pair]) -> List[bool]:
        if not pairs:
            return []
        mask = unity_check(self.tables, *lane_columns(pairs, self.device))
        return [bool(v) for v in mask.tolist()]

    def check_sharded(self, pairs: Sequence[Pair], mesh, axis: str = "data") -> List[bool]:
        """Lane-sharded pairing over a `parallel.mesh.Mesh` (SURVEY P6): the
        per-lane Miller loop and final exponentiation have no cross-lane
        work, so the lanes, padded with dead lanes (ok False) to a multiple
        of the axis size, split evenly over the devices along `axis`, one
        launch each; the real lanes' verdicts come back. The line tables
        are the kernel's, copied once to each device."""
        from fabric_tpu_torch.parallel.mesh import run_positions

        n = len(pairs)
        if n == 0:
            return []
        devices = mesh.positions(axis)
        for device in devices:
            cudalib.resolve_device(device, "Ate2 pairing")
        w = -(-n // len(devices))
        lanes = list(pairs) + [None] * (w * len(devices) - n)

        def job(chunk):
            return lambda device: unity_check(self.tables, *lane_columns(chunk, device))

        masks = run_positions([(device, job(lanes[j * w:(j + 1) * w]))
                               for j, device in enumerate(devices)])
        return [bool(v) for v in np.concatenate(masks)[:n]]


@functools.lru_cache(maxsize=8)
def kernel_for_issuer(w_bytes: bytes, device=None) -> Ate2Kernel:
    """Cached per-issuer kernel (W from its 128-byte amcl encoding)."""
    return Ate2Kernel(host.g2_from_bytes(w_bytes), device)


def miller2_values(w: host.G2Point, pairs: Sequence[Tuple[host.G1Point, host.G1Point]],
                   device=None):
    """Test hook: per lane (f1, f2, fexp(f1 * inv(f2))) as host Fp12 values,
    f1 the Miller value of (W, P1) and f2 of (g2, P2), from the kernel's
    debug entry on the card (the default; without one it raises) or from
    the plain version when the caller passes `device="cpu"`."""
    dev = cudalib.resolve_device(device, "Ate2 pairing")
    tables = _Tables(LineSchedule(w))
    p1x, p1y, p2x, p2y, _ = lane_columns(pairs, dev)
    if dev.type == "cuda":
        return words_to_host(miller2_words(tables, p1x, p1y, p2x, p2y))
    return _per_lane(_plain_values(tables, p1x, p1y, p2x, p2y))
