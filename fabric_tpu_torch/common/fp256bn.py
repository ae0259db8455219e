"""FP256BN pairing curve: host oracle for the Idemix crypto suite.

The port's own copy of the JAX package's `common/fp256bn.py` (pure Python,
the same values): the field, G1/G2, the Fp12 tower, the optimal-ate Miller
loop, the precomputed line coefficients, the final exponentiation and the
idemix serialization. It is the host half of the MSM and pairing kernels
(`ops/bn256_kernel`, `ops/pairing_kernel`) and their oracle.

The curve (ISO/IEC 15946-5 "BN" P256, the amcl FP256BN ROM):

  p  = 36u^4 + 36u^3 + 24u^2 + 6u + 1       (field modulus)
  r  = 36u^4 + 36u^3 + 18u^2 + 6u + 1       (group order)
  u  = -0x6882F5C030B0A801                  (BN parameter, negative)
  E  : y^2 = x^3 + 3 over Fp, G1 = (1, 2)
  E' : y^2 = x^3 + 3/xi over Fp2 (M-type sextic twist, xi = 1 + i)

Tower: Fp2 = Fp[i]/(i^2+1); Fp12 built directly as Fp2[w]/(w^6 - xi).
G2 points are untwisted into E(Fp12) and the Miller loop runs with generic
Fp12 line arithmetic: slow, and obviously correct.

Serialization (idemix/util.go): BIG = 32-byte big-endian; G1 =
0x04 || x || y (65 bytes); G2 = xa || xb || ya || yb (128 bytes).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

# --------------------------------------------------------------------------
# Curve constants (amcl FP256BN ROM, assembled from base-2^56 chunks)
# --------------------------------------------------------------------------

P = 0xFFFFFFFFFFFCF0CD46E5F25EEE71A49F0CDC65FB12980A82D3292DDBAED33013
R = 0xFFFFFFFFFFFCF0CD46E5F25EEE71A49E0CDC65FB1299921AF62D536CD10B500D
B_COEFF = 3
U = -0x6882F5C030B0A801  # BN parameter (SIGN_OF_X = NEGATIVEX)

G1_X = 1
G1_Y = 2

# G2 generator on the twist (Fp2 coords, ROM CURVE_Pxa/Pxb/Pya/Pyb)
G2_XA = 0xFE0C3350B4C96C2028560F577C28913ACE1C539A12BF843CD22616B689C09EFB
G2_XB = 0x4EA66057738AC054DB5AE1C637D813B924DD78E287D03589D269ED34A37E6A2B
G2_YA = 0x702046E7C542A3B376770D75124E3E51EFCB24758D615848E909B481BEDC27FF
G2_YB = 0x0554E3BCD388C29042EEA649297EB29F8B4CBE80821A98B3E01281114AAD049B

FIELD_BYTES = 32


# --------------------------------------------------------------------------
# Fp2 = Fp[i] / (i^2 + 1): represented as (a, b) = a + b*i
# --------------------------------------------------------------------------

Fp2 = Tuple[int, int]

FP2_ZERO: Fp2 = (0, 0)
FP2_ONE: Fp2 = (1, 0)
XI: Fp2 = (1, 1)  # the sextic non-residue 1 + i


def fp2_add(x: Fp2, y: Fp2) -> Fp2:
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def fp2_sub(x: Fp2, y: Fp2) -> Fp2:
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def fp2_neg(x: Fp2) -> Fp2:
    return ((-x[0]) % P, (-x[1]) % P)


def fp2_mul(x: Fp2, y: Fp2) -> Fp2:
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def fp2_sqr(x: Fp2) -> Fp2:
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def fp2_scalar(x: Fp2, k: int) -> Fp2:
    return (x[0] * k % P, x[1] * k % P)


def fp2_inv(x: Fp2) -> Fp2:
    a, b = x
    norm = (a * a + b * b) % P
    inv = pow(norm, P - 2, P)
    return (a * inv % P, (-b) * inv % P)


def fp2_conj(x: Fp2) -> Fp2:
    return (x[0], (-x[1]) % P)


# --------------------------------------------------------------------------
# Fp12 = Fp2[w] / (w^6 - xi): vector of 6 Fp2 coefficients (c0..c5),
# value = sum(c_k * w^k). G2 untwists into E(Fp12) with x,y in Fp12.
# --------------------------------------------------------------------------

Fp12 = Tuple[Fp2, Fp2, Fp2, Fp2, Fp2, Fp2]

FP12_ZERO: Fp12 = (FP2_ZERO,) * 6
FP12_ONE: Fp12 = (FP2_ONE,) + (FP2_ZERO,) * 5


def fp12_from_fp2(c: Fp2, k: int = 0) -> Fp12:
    out = [FP2_ZERO] * 6
    out[k] = c
    return tuple(out)


def fp12_add(x: Fp12, y: Fp12) -> Fp12:
    return tuple(fp2_add(a, b) for a, b in zip(x, y))


def fp12_sub(x: Fp12, y: Fp12) -> Fp12:
    return tuple(fp2_sub(a, b) for a, b in zip(x, y))


def fp12_neg(x: Fp12) -> Fp12:
    return tuple(fp2_neg(a) for a in x)


def fp12_mul(x: Fp12, y: Fp12) -> Fp12:
    # schoolbook in w with reduction w^6 = xi
    acc: List[Fp2] = [FP2_ZERO] * 11
    for i2, xi_ in enumerate(x):
        if xi_ == FP2_ZERO:
            continue
        for j, yj in enumerate(y):
            if yj == FP2_ZERO:
                continue
            acc[i2 + j] = fp2_add(acc[i2 + j], fp2_mul(xi_, yj))
    out = list(acc[:6])
    for k in range(6, 11):
        if acc[k] != FP2_ZERO:
            out[k - 6] = fp2_add(out[k - 6], fp2_mul(acc[k], XI))
    return tuple(out)


def fp12_sqr(x: Fp12) -> Fp12:
    return fp12_mul(x, x)


def fp12_conj(x: Fp12) -> Fp12:
    """Conjugate over Fp6 (negate odd w-powers): equals x^(p^6), and for
    unitary GT elements the inverse."""
    return (
        x[0],
        fp2_neg(x[1]),
        x[2],
        fp2_neg(x[3]),
        x[4],
        fp2_neg(x[5]),
    )


def fp12_inv(x: Fp12) -> Fp12:
    # generic inverse via solving x * y = 1 with Gaussian elimination is
    # overkill; use the norm-map chain: for a in Fp12 with conj over Fp6,
    # a^{-1} = conj(a) * (a * conj(a))^{-1} where a*conj(a) lies in the
    # even subalgebra (an Fp6 image). We reduce twice down to Fp2.
    # a * conj(a) has only even coefficients -> element of Fp6 over w^2.
    ac = fp12_mul(x, fp12_conj(x))
    if ac[1] != FP2_ZERO or ac[3] != FP2_ZERO or ac[5] != FP2_ZERO:
        raise ArithmeticError("a*conj(a) left the even Fp6 subalgebra")
    # Fp6 = Fp2[v]/(v^3 - xi) with v = w^2: coefficients (ac[0], ac[2], ac[4])
    inv6 = _fp6_inv((ac[0], ac[2], ac[4]))
    inv12 = (inv6[0], FP2_ZERO, inv6[1], FP2_ZERO, inv6[2], FP2_ZERO)
    return fp12_mul(fp12_conj(x), inv12)


def _fp6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = fp2_mul(a0, b0)
    t1 = fp2_add(fp2_mul(a0, b1), fp2_mul(a1, b0))
    t2 = fp2_add(fp2_add(fp2_mul(a0, b2), fp2_mul(a1, b1)), fp2_mul(a2, b0))
    t3 = fp2_add(fp2_mul(a1, b2), fp2_mul(a2, b1))
    t4 = fp2_mul(a2, b2)
    return (
        fp2_add(t0, fp2_mul(t3, XI)),
        fp2_add(t1, fp2_mul(t4, XI)),
        t2,
    )


def _fp6_inv(x):
    a0, a1, a2 = x
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul(XI, fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul(XI, fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(
        fp2_mul(XI, fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))),
        fp2_mul(a0, c0),
    )
    ti = fp2_inv(t)
    return (fp2_mul(c0, ti), fp2_mul(c1, ti), fp2_mul(c2, ti))


def fp12_pow(x: Fp12, e: int) -> Fp12:
    if e < 0:
        return fp12_pow(fp12_conj(x), -e)  # valid for unitary elements only
    out = FP12_ONE
    for bit in bin(e)[2:]:
        out = fp12_sqr(out)
        if bit == "1":
            out = fp12_mul(out, x)
    return out


def fp12_frobenius(x: Fp12, n: int = 1) -> Fp12:
    """x -> x^(p^n). coeff c_k w^k -> c_k^(p^n) * gamma_{n,k} w^k with
    gamma_{n,k} = xi^{k*(p^n-1)/6}."""
    out = []
    for k, c in enumerate(x):
        cc = c
        for _ in range(n % 2):
            cc = fp2_conj(cc)
        gamma = _FROB_GAMMA[n % 12][k]
        out.append(fp2_mul(cc, gamma))
    return tuple(out)


def _fp2_pow(x: Fp2, e: int) -> Fp2:
    out = FP2_ONE
    for bit in bin(e)[2:]:
        out = fp2_sqr(out)
        if bit == "1":
            out = fp2_mul(out, x)
    return out


def _build_frob_constants():
    """gamma_{n,k} = xi^{k*(p^n - 1)/6} for n in 0..11, k in 0..5."""
    gammas = []
    for n in range(12):
        row = []
        for k in range(6):
            e = k * (pow(P, n) - 1) // 6
            row.append(_fp2_pow(XI, e % ((P * P) - 1)))
        gammas.append(row)
    return gammas


_FROB_GAMMA = _build_frob_constants()


# --------------------------------------------------------------------------
# G1: E(Fp) : y^2 = x^3 + 3. Affine (x, y) with None = infinity.
# --------------------------------------------------------------------------

G1Point = Optional[Tuple[int, int]]
G1_GEN: G1Point = (G1_X, G1_Y)


def g1_is_on_curve(pt: G1Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B_COEFF)) % P == 0


def g1_add(p1: G1Point, p2: G1Point) -> G1Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_neg(pt: G1Point) -> G1Point:
    return None if pt is None else (pt[0], (-pt[1]) % P)


def g1_mul(pt: G1Point, k: int) -> G1Point:
    k %= R
    out: G1Point = None
    add = pt
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


def g1_mul2(p: G1Point, a: int, q: G1Point, b: int) -> G1Point:
    """a*P + b*Q (amcl Mul2)."""
    return g1_add(g1_mul(p, a), g1_mul(q, b))


# --------------------------------------------------------------------------
# G2: E'(Fp2) : y^2 = x^3 + 3/xi (M-type twist). Affine Fp2 coords.
# --------------------------------------------------------------------------

G2Point = Optional[Tuple[Fp2, Fp2]]

# M-type sextic twist (amcl CONFIG_CURVE SEXTIC_TWIST = M_TYPE):
# E' : y^2 = x^3 + b * xi
TWIST_B: Fp2 = fp2_scalar(XI, B_COEFF)
G2_GEN: G2Point = ((G2_XA, G2_XB), (G2_YA, G2_YB))


def g2_is_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fp2_sqr(y)
    rhs = fp2_add(fp2_mul(fp2_sqr(x), x), TWIST_B)
    return lhs == rhs


def g2_add(p1: G2Point, p2: G2Point) -> G2Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_add(y1, y2) == FP2_ZERO:
            return None
        lam = fp2_mul(
            fp2_scalar(fp2_sqr(x1), 3), fp2_inv(fp2_scalar(y1, 2))
        )
    else:
        lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sqr(lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(pt: G2Point) -> G2Point:
    return None if pt is None else (pt[0], fp2_neg(pt[1]))


def g2_mul(pt: G2Point, k: int) -> G2Point:
    k %= R
    out: G2Point = None
    add = pt
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


# --------------------------------------------------------------------------
# Pairing: optimal ate over E(Fp12) with generic line functions.
# --------------------------------------------------------------------------

# Untwist map for the M-type twist E' -> E over Fp12:
#   psi(x', y') = (x' / w^2, y' / w^3) = (x' w^4 / xi, y' w^3 / xi)
# since w^6 = xi. Check: y'^2/w^6 = x'^3/w^6 + 3  <=>  y'^2 = x'^3 + 3 xi,
# exactly E'. Verified numerically in tests.


def _untwist(pt: G2Point) -> Optional[Tuple[Fp12, Fp12]]:
    if pt is None:
        return None
    x, y = pt
    xi_inv = fp2_inv(XI)
    fx = fp12_from_fp2(fp2_mul(x, xi_inv), 4)  # x' * w^4 / xi
    fy = fp12_from_fp2(fp2_mul(y, xi_inv), 3)  # y' * w^3 / xi
    return (fx, fy)


E12Point = Optional[Tuple[Fp12, Fp12]]


def _e12_add(p1: E12Point, p2: E12Point) -> E12Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp12_add(y1, y2) == FP12_ZERO:
            return None
        lam = fp12_mul(
            fp12_add(fp12_add(fp12_sqr(x1), fp12_sqr(x1)), fp12_sqr(x1)),
            fp12_inv(fp12_add(y1, y1)),
        )
    else:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_sqr(lam), x1), x2)
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _line(t: E12Point, q: E12Point, p_g1: Tuple[int, int]) -> Fp12:
    """Evaluate the line through T and Q (tangent when T==Q) at the G1
    point P embedded in Fp12."""
    px = fp12_from_fp2((p_g1[0], 0), 0)
    py = fp12_from_fp2((p_g1[1], 0), 0)
    if t is None or q is None:
        raise ArithmeticError("line evaluation through the point at infinity")
    x1, y1 = t
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        three_x2 = fp12_add(fp12_add(fp12_sqr(x1), fp12_sqr(x1)), fp12_sqr(x1))
        lam = fp12_mul(three_x2, fp12_inv(fp12_add(y1, y1)))
    elif x1 == x2:
        # vertical line: x - x1
        return fp12_sub(px, x1)
    else:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    # l = (py - y1) - lam * (px - x1)
    return fp12_sub(fp12_sub(py, y1), fp12_mul(lam, fp12_sub(px, x1)))


def miller_loop(q: G2Point, p: G1Point) -> Fp12:
    """f_{|6u+2|, Q}(P) with the two frobenius correction lines (optimal
    ate for BN curves); conjugated at the end for u < 0."""
    if q is None or p is None:
        return FP12_ONE
    six_u_two = 6 * U + 2
    n = abs(six_u_two)
    qe = _untwist(q)
    t = qe
    f = FP12_ONE
    for bit in bin(n)[3:]:
        f = fp12_mul(fp12_sqr(f), _line(t, t, p))
        t = _e12_add(t, t)
        if bit == "1":
            f = fp12_mul(f, _line(t, qe, p))
            t = _e12_add(t, qe)
    if six_u_two < 0:
        f = fp12_conj(f)
        t = (t[0], fp12_neg(t[1])) if t is not None else None
    # frobenius corrections: Q1 = pi_p(Q), Q2 = -pi_{p^2}(Q)
    q1 = (fp12_frobenius(qe[0], 1), fp12_frobenius(qe[1], 1))
    q2 = (fp12_frobenius(qe[0], 2), fp12_neg(fp12_frobenius(qe[1], 2)))
    f = fp12_mul(f, _line(t, q1, p))
    t = _e12_add(t, q1)
    f = fp12_mul(f, _line(t, q2, p))
    return f


def line_coeffs(
    t: Tuple[Fp12, Fp12], q: Tuple[Fp12, Fp12]
) -> Tuple[Fp12, Fp12]:
    """(A, B) with l(P) = A + B·px + py — the chord/tangent line of
    `_line` factored into P-independent Fp12 constants, so fixed-G2
    Miller schedules (ops/pairing_kernel) can precompute them per
    issuer.  Expanding `_line`: (py − y1) − λ(px − x1) =
    (λ·x1 − y1) + (−λ)·px + py.  Vertical lines cannot occur in the ate
    chain of order-r points — raised, never silently mis-evaluated."""
    x1, y1 = t
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        three_x2 = fp12_add(fp12_add(fp12_sqr(x1), fp12_sqr(x1)), fp12_sqr(x1))
        lam = fp12_mul(three_x2, fp12_inv(fp12_add(y1, y1)))
    else:
        if x1 == x2:
            raise ArithmeticError("vertical line in ate loop (unexpected)")
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    return fp12_sub(fp12_mul(lam, x1), y1), fp12_neg(lam)


_HARD_EXP = (pow(P, 4) - pow(P, 2) + 1) // R


def final_exp(f: Fp12) -> Fp12:
    """f^((p^12 - 1) / r): easy part (p^6-1)(p^2+1), then a direct
    exponentiation by the hard part (p^4 - p^2 + 1)/r, 768 bits with 408
    ones, square and multiply from the top bit."""
    f = fp12_mul(fp12_conj(f), fp12_inv(f))  # f^(p^6 - 1): now unitary
    f = fp12_mul(fp12_frobenius(f, 2), f)  # ^(p^2 + 1)
    return fp12_pow(f, _HARD_EXP)


def ate(q: G2Point, p: G1Point) -> Fp12:
    """FP256BN.Ate analog (NOT final-exponentiated)."""
    return miller_loop(q, p)


def fexp(f: Fp12) -> Fp12:
    return final_exp(f)


def pairing(q: G2Point, p: G1Point) -> Fp12:
    return final_exp(miller_loop(q, p))


def gt_is_unity(f: Fp12) -> bool:
    return f == FP12_ONE


# --------------------------------------------------------------------------
# Serialization (idemix/util.go parity)
# --------------------------------------------------------------------------


def big_to_bytes(n: int) -> bytes:
    return (n % (1 << 256)).to_bytes(FIELD_BYTES, "big")


def big_from_bytes(b: bytes) -> int:
    return int.from_bytes(b[:FIELD_BYTES], "big")


def g1_to_bytes(pt: G1Point) -> bytes:
    """amcl ECP.ToBytes(compress=False): 0x04 || x || y."""
    if pt is None:
        return b"\x04" + b"\x00" * 64
    return b"\x04" + big_to_bytes(pt[0]) + big_to_bytes(pt[1])


def g1_from_bytes(b: bytes) -> G1Point:
    if len(b) != 65 or b[0] != 0x04:
        raise ValueError("bad G1 encoding")
    x = big_from_bytes(b[1:33])
    y = big_from_bytes(b[33:65])
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not g1_is_on_curve(pt):
        raise ValueError("G1 point not on curve")
    return pt


def g2_to_bytes(pt: G2Point) -> bytes:
    """amcl ECP2.ToBytes: xa || xb || ya || yb."""
    if pt is None:
        return b"\x00" * 128
    (xa, xb), (ya, yb) = pt
    return (
        big_to_bytes(xa) + big_to_bytes(xb) + big_to_bytes(ya) + big_to_bytes(yb)
    )


def g2_from_bytes(b: bytes) -> G2Point:
    if len(b) != 128:
        raise ValueError("bad G2 encoding")
    xa, xb, ya, yb = (big_from_bytes(b[i * 32 : (i + 1) * 32]) for i in range(4))
    pt = ((xa, xb), (ya, yb))
    if not g2_is_on_curve(pt):
        raise ValueError("G2 point not on twist curve")
    return pt


def hash_mod_order(data: bytes) -> int:
    """idemix HashModOrder: SHA-256(data) interpreted big-endian mod r."""
    return big_from_bytes(hashlib.sha256(data).digest()) % R


def rand_mod_order(rng) -> int:
    """Uniform scalar in [0, r). `rng` is a random.Random or secrets-like
    object exposing randrange."""
    return rng.randrange(R)
