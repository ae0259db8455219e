"""The Fp2/Fp12 tower of FP256BN in plain PyTorch: the pairing kernel's
plain version.

The values are the host oracle's (`common/fp256bn`): Fp2 = Fp[i]/(i^2+1),
Fp12 = Fp2[w]/(w^6 - xi) as 6 Fp2 coefficients, xi = 1 + i. An Fp12 is an
int64 tensor (20, 12, B): 13-bit limbs of Montgomery residues
(R = 2^260) on axis 0, the rows [c0.re, c0.im, c1.re, ..., c5.im] on axis
1, the lanes on axis 2. Every result is fully reduced, so a value is
unique: it equals the JAX package's `ops/fp12` and the CUDA kernel's word
for word after the change of radix, whatever order the products are taken
in. The JAX package's row-stacked layout exists for its compiler; here it
is kept because one stacked Montgomery multiply per tower operation is
also what makes the plain version quick enough.
"""

from __future__ import annotations

from typing import List

import torch

from fabric_tpu_torch.common import fp256bn as host
from fabric_tpu_torch.ops import bignum as bn

CTX = bn.MontCtx(host.P)
_R = 1 << bn.RADIX_BITS
ROWS = 12

# the 36 Fp2 products of a multiply: coefficient i of x times j of y, summed
# into coefficient i + j (0..10) before the w^6 = xi fold
_I = torch.tensor([i for i in range(6) for j in range(6)])
_J = torch.tensor([j for i in range(6) for j in range(6)])
_IJ = _I + _J
_ODD_W = torch.tensor([2, 3, 6, 7, 10, 11])  # rows of c1, c3, c5
_IM = torch.tensor([1, 3, 5, 7, 9, 11])


def to_mont_int(v: int) -> int:
    return (v * _R) % host.P


def const_rows(values, batch: int, device) -> torch.Tensor:
    """Host integers, one a row -> (20, len(values), batch) Montgomery rows."""
    rows = bn.ints_to_limbs([to_mont_int(v) for v in values]).to(device)
    return rows.unsqueeze(-1).expand(-1, -1, batch).contiguous()


def from_host(vals: List[host.Fp12], device="cpu") -> torch.Tensor:
    """Host Fp12 values, one a lane -> (20, 12, B)."""
    flat = [to_mont_int(x) for v in vals for c in v for x in c]
    t = bn.ints_to_limbs(flat).to(device)  # (20, B * 12)
    return t.reshape(bn.NLIMBS, len(vals), ROWS).permute(0, 2, 1).contiguous()


def to_host(x: torch.Tensor) -> List[host.Fp12]:
    """(20, 12, B) -> host Fp12 values, one a lane."""
    rinv = pow(_R, -1, host.P)
    lanes = x.shape[2]
    ints = bn.limbs_to_ints(x.permute(0, 2, 1).reshape(bn.NLIMBS, -1))
    vals = [(v * rinv) % host.P for v in ints]
    out = []
    for b in range(lanes):
        row = vals[b * ROWS:(b + 1) * ROWS]
        out.append(tuple((row[2 * k], row[2 * k + 1]) for k in range(6)))
    return out


def one(batch: int, device) -> torch.Tensor:
    return const_rows([1] + [0] * 11, batch, device)


def _add(a, b, bound: int = 2):
    """a + b, both canonical, reduced (bound = the sum's bound)."""
    return bn.reduce_canonical(CTX, bn.add_raw(a, b), bound - 1)


def _sub(a, b):
    return bn.sub_mod(CTX, a, b, 1, 1)


def _fp2_products(xr, xi, yr, yi):
    """Karatsuba products of n Fp2 pairs, each (20, n, B): (re, im)."""
    n = xr.shape[1]
    xs = bn.add_raw(xr, xi)  # bound 2
    ys = bn.add_raw(yr, yi)
    p = bn.mont_mul(CTX, torch.cat([xr, xi, xs], 1), torch.cat([yr, yi, ys], 1))
    ac, bd, s = p[:, :n], p[:, n:2 * n], p[:, 2 * n:]
    re = _sub(ac, bd)
    im = bn.sub_mod(CTX, s, bn.add_raw(ac, bd), 2, 2)
    return re, im


def _interleave(re, im):
    return torch.stack([re, im], 2).reshape(re.shape[0], 2 * re.shape[1], *re.shape[2:])


def fp2_mul(x, y):
    """k Fp2 products, rows interleaved [re, im, ...] (20, 2k, B)."""
    x, y = torch.broadcast_tensors(x, y)
    return _interleave(*_fp2_products(x[:, 0::2], x[:, 1::2], y[:, 0::2], y[:, 1::2]))


def fp2_sqr(x):
    """k Fp2 squares, rows interleaved: (re + im)(re - im) and 2 re im, two
    multiplies each."""
    re, im = x[:, 0::2], x[:, 1::2]
    n = re.shape[1]
    p = bn.mont_mul(CTX, torch.cat([bn.add_raw(re, im), re], 1),
                    torch.cat([_sub(re, im), bn.add_raw(im, im)], 1))
    return _interleave(p[:, :n], p[:, n:])


def fp2_mul_xi(x):
    """k Fp2 values times xi = 1 + i: (re - im, re + im)."""
    re, im = x[:, 0::2], x[:, 1::2]
    return _interleave(_sub(re, im), _add(re, im))


def mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = torch.broadcast_tensors(x, y)
    re, im = _fp2_products(
        x[:, 0::2][:, _I], x[:, 1::2][:, _I], y[:, 0::2][:, _J], y[:, 1::2][:, _J]
    )
    shape = (bn.NLIMBS, 11) + tuple(x.shape[2:])
    acc_re = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(1, _IJ.to(x.device), re)
    acc_im = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add_(1, _IJ.to(x.device), im)
    acc_re = bn.reduce_canonical(CTX, acc_re, 5)  # up to 6 terms
    acc_im = bn.reduce_canonical(CTX, acc_im, 5)
    # w^6 = xi: out_k = acc_k + xi * acc_{k+6} for k < 5, out_5 = acc_5
    hr, hi = acc_re[:, 6:], acc_im[:, 6:]
    out_re = _add(acc_re[:, :5], _sub(hr, hi))
    out_im = _add(acc_im[:, :5], bn.add_raw(hr, hi), bound=3)
    return _interleave(
        torch.cat([out_re, acc_re[:, 5:6]], 1), torch.cat([out_im, acc_im[:, 5:6]], 1)
    )


def sqr(x: torch.Tensor) -> torch.Tensor:
    return mul(x, x)


def _coeffs(x: torch.Tensor, ks) -> torch.Tensor:
    """The rows of Fp2 coefficients `ks`, in that order."""
    return x[:, [r for k in ks for r in (2 * k, 2 * k + 1)]]


def _triple(x):
    return _add(_add(x, x), x)


def cyc_sqr(x: torch.Tensor) -> torch.Tensor:
    """x^2 for x in the cyclotomic subgroup, where the final
    exponentiation's hard part runs (Granger-Scott 2010; any other x gets a
    wrong value). Over Fp4 = Fp2[s]/(s^2 - xi) with s = w^3, x = a + b w +
    c w^2 with a = (c0, c3), b = (c1, c4), c = (c2, c5), and

        x^2 = (3 a^2 - 2 conj(a)) + (3 s c^2 + 2 conj(b)) w
              + (3 b^2 - 2 conj(c)) w^2,

    conj(u + v s) = u - v s. Each Fp4 square (u + v s)^2 = (u^2 + xi v^2)
    + ((u + v)^2 - u^2 - v^2) s takes three Fp2 squares: nine in all, 18
    multiplies."""
    lo, hi = x[:, 0:6], x[:, 6:12]  # u = (c0, c1, c2) and v = (c3, c4, c5) of a, b, c
    sq = fp2_sqr(torch.cat([lo, hi, _add(lo, hi)], 1))
    u2, v2, s2 = sq[:, 0:6], sq[:, 6:12], sq[:, 12:18]
    t0 = _add(u2, fp2_mul_xi(v2))  # the 1 parts of a^2, b^2, c^2
    t1 = _sub(_sub(s2, u2), v2)  # their s parts
    a0, b0, c0 = (t0[:, 2 * q:2 * q + 2] for q in range(3))
    a1, b1, c1 = (t1[:, 2 * q:2 * q + 2] for q in range(3))
    out = [None] * 6
    # 3 a^2 - 2 conj(a) -> c0, c3; 3 s c^2 + 2 conj(b) -> c1, c4 (s * (u + v s)
    # = xi v + u s); 3 b^2 - 2 conj(c) -> c2, c5
    for k, t, sign in ((0, a0, -1), (3, a1, 1), (1, fp2_mul_xi(c1), 1), (4, c0, -1),
                       (2, b0, -1), (5, b1, 1)):
        g = _coeffs(x, [k])
        out[k] = _sub(_triple(t), _add(g, g)) if sign < 0 else _add(_triple(t), _add(g, g))
    return torch.cat(out, 1)


def line_mul(f: torch.Tensor, py: torch.Tensor, l3: torch.Tensor,
             l5: torch.Tensor) -> torch.Tensor:
    """f * l for a line l = py + l3 w^3 + l5 w^5 (py in Fp, l3 and l5 Fp2
    rows (20, 2, B)): coefficient k is f_k py + f_(k-3) l3 + f_(k-5) l5,
    an index below 0 wrapping to k + 3 or k + 1 with a factor xi. 48
    multiplies: 12 by py and 12 Fp2 products."""
    fp = bn.mont_mul(CTX, f, py.unsqueeze(1))
    r3 = fp2_mul(_coeffs(f, [(k + 3) % 6 for k in range(6)]), l3.repeat(1, 6, 1))
    r5 = fp2_mul(_coeffs(f, [(k + 1) % 6 for k in range(6)]), l5.repeat(1, 6, 1))
    r3 = torch.cat([fp2_mul_xi(r3[:, :6]), r3[:, 6:]], 1)
    r5 = torch.cat([fp2_mul_xi(r5[:, :10]), r5[:, 10:]], 1)
    return _add(_add(fp, r3), r5)


def _negate_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    rows = rows.to(x.device)
    out = x.clone()
    out[:, rows] = _sub(torch.zeros_like(x[:, rows]), x[:, rows])
    return out


def conj(x: torch.Tensor) -> torch.Tensor:
    """Negate the odd-w coefficients (x^(p^6))."""
    return _negate_rows(x, _ODD_W)


def frobenius(x: torch.Tensor, n: int) -> torch.Tensor:
    """x -> x^(p^n): conjugate every Fp2 coefficient n % 2 times, then
    multiply coefficient k by the host's gamma_{n,k}."""
    if n % 2:
        x = _negate_rows(x, _IM)
    gamma = [g for c in host._FROB_GAMMA[n % 12] for g in c]
    return fp2_mul(x, const_rows(gamma, 1, x.device))


def _fp_inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) row by row (Fermat)."""
    return bn.mont_pow(CTX, a, host.P - 2)


def inv(x: torch.Tensor) -> torch.Tensor:
    """conj(x) * (x * conj(x))^-1 by the host's norm chain: x * conj(x)
    lies in Fp6 over w^2; one Fp6 inverse, one Fp2 inverse, one Fp
    inverse (host fp12_inv, _fp6_inv, fp2_inv)."""
    xc = conj(x)
    ac = mul(x, xc)
    a0, a1, a2 = ac[:, 0:2], ac[:, 4:6], ac[:, 8:10]
    sq = fp2_mul(torch.cat([a0, a2, a1], 1), torch.cat([a0, a2, a1], 1))
    cross = fp2_mul(torch.cat([a1, a0, a0], 1), torch.cat([a2, a1, a2], 1))
    a0sq, a2sq, a1sq = sq[:, 0:2], sq[:, 2:4], sq[:, 4:6]
    a1a2, a0a1, a0a2 = cross[:, 0:2], cross[:, 2:4], cross[:, 4:6]
    c0 = _sub(a0sq, fp2_mul_xi(a1a2))
    c1 = _sub(fp2_mul_xi(a2sq), a0a1)
    c2 = _sub(a1sq, a0a2)
    tc = fp2_mul(torch.cat([a2, a1, a0], 1), torch.cat([c1, c2, c0], 1))
    t = _add(fp2_mul_xi(_add(tc[:, 0:2], tc[:, 2:4])), tc[:, 4:6])
    # fp2_inv: conj(t) / (re^2 + im^2)
    sq_t = bn.mont_mul(CTX, t, t)
    n_inv = _fp_inv(_add(sq_t[:, 0:1], sq_t[:, 1:2]))
    prod = bn.mont_mul(CTX, t, n_inv)
    ti = torch.cat([prod[:, 0:1], _sub(torch.zeros_like(prod[:, 1:2]), prod[:, 1:2])], 1)
    inv6 = fp2_mul(torch.cat([c0, c1, c2], 1), torch.cat([ti, ti, ti], 1))
    inv12 = torch.zeros_like(x)
    inv12[:, 0:2], inv12[:, 4:6], inv12[:, 8:10] = inv6[:, 0:2], inv6[:, 2:4], inv6[:, 4:6]
    return mul(xc, inv12)


def pow_const(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e by square and multiply from the top bit (host fp12_pow)."""
    out = one(x.shape[2], x.device)
    for bit in bin(e)[2:]:
        out = sqr(out)
        if bit == "1":
            out = mul(out, x)
    return out


def equal(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B,) bool: every row and limb equal (both canonical)."""
    return (x == y).all(dim=0).all(dim=0)
