"""Multi-limb modular arithmetic in plain PyTorch: the reference layout.

The plain versions of the port's kernels compute on the JAX package's
number layout so that the two can be held to each other value for value:
radix 2^13, 20 limbs, Montgomery R = 2^260. A big number is a stacked
(20, *batch) tensor, least significant limb first. The dtype is int64,
because PyTorch's uint32 arithmetic is incomplete; the JAX package's
uint32 accumulator bound (< 0.625 * 2^32 per limb in the CIOS loop) holds
here a fortiori, so every intermediate limb equals the JAX one.

Values are canonical (every limb < 2^13, value < modulus) unless a caller
tracks a laxer bound (see fabric_tpu_torch.ops.fieldops.FE).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from fabric_tpu_torch.common.limbparams import (  # noqa: F401
    LIMB_BITS,
    LIMB_MASK,
    NLIMBS,
    RADIX_BITS,
)

# ---------------------------------------------------------------------------
# Host conversions
# ---------------------------------------------------------------------------


def int_to_limbs(x: int, nlimbs: int = NLIMBS) -> List[int]:
    """Python int -> little-endian 13-bit limbs."""
    if x < 0:
        raise ValueError("negative")
    out = []
    for _ in range(nlimbs):
        out.append(x & LIMB_MASK)
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in limbs")
    return out


def ints_to_limbs(xs: Iterable[int], device="cpu") -> torch.Tensor:
    """Batch of ints -> (NLIMBS, B) int64 tensor (limb-major)."""
    rows = [int_to_limbs(x) for x in xs]
    if not rows:
        return torch.zeros((NLIMBS, 0), dtype=torch.int64, device=device)
    return torch.tensor(rows, dtype=torch.int64).T.contiguous().to(device)


def limbs_to_int(a) -> int:
    """(NLIMBS,) limbs -> Python int."""
    val = 0
    for v in reversed([int(v) for v in a]):
        val = (val << LIMB_BITS) | v
    return val


def limbs_to_ints(a) -> List[int]:
    """(NLIMBS, B) tensor or array -> list of B Python ints."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return [limbs_to_int(a[:, j]) for j in range(a.shape[1])]


# ---------------------------------------------------------------------------
# Carry propagation
# ---------------------------------------------------------------------------


def carry(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry-propagate stacked limbs (limb axis 0, any batch shape).
    Returns (canonical limbs, carry_out); the arithmetic shift makes
    negative limbs borrow, so a negative value gives a negative carry_out.

    All limbs carry at once, pass after pass, until no limb has bits above
    LIMB_BITS. Canonical limbs and the carry-out of an integer are unique,
    so the result equals the limb-by-limb chain of the JAX package's
    `carry_l`; a pass costs a handful of tensor ops where the chain costs
    three per limb, and random data settles in two or three passes."""
    t = x
    cout = torch.zeros_like(x[0])
    while True:
        c = t >> LIMB_BITS
        if not bool(c.any()):
            return t, cout
        t = t & LIMB_MASK
        t[1:] += c[:-1]
        cout = cout + c[-1]


# ---------------------------------------------------------------------------
# Montgomery context
# ---------------------------------------------------------------------------


def _column(limbs: List[int]) -> torch.Tensor:
    return torch.tensor(limbs, dtype=torch.int64).reshape(NLIMBS, 1)


class MontCtx:
    """Precomputed Montgomery constants for an odd modulus m < 2^256, with
    R = 2^260. Constant columns are (NLIMBS, 1) tensors, cached per device
    so the plain versions can run on the card too."""

    def __init__(self, modulus: int):
        if modulus % 2 == 0:
            raise ValueError("modulus must be odd")
        self.m = modulus
        r = 1 << RADIX_BITS
        self.m0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self._cpu: Dict[str, torch.Tensor] = {
            "m": _column(int_to_limbs(modulus)),
            "r2": _column(int_to_limbs((r * r) % modulus)),
            "one_mont": _column(int_to_limbs(r % modulus)),
            "one": _column(int_to_limbs(1)),
        }
        # k*m, added before a subtraction so no limb chain underflows
        for k in range(1, 9):
            self._cpu[f"km{k}"] = _column(int_to_limbs(k * modulus))
            # 0, m, ..., k*m side by side: the candidates of _reduce
            self._cpu[f"kmstack{k}"] = torch.tensor(
                [int_to_limbs(j * modulus) for j in range(k + 1)], dtype=torch.int64
            ).T.contiguous()
        self._by_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def const(self, name: str, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        table = self._by_device.get(device)
        if table is None:
            table = {k: v.to(device) for k, v in self._cpu.items()}
            self._by_device[device] = table
        return table[name]


# ---------------------------------------------------------------------------
# Core multiply (CIOS Montgomery on stacked limbs)
# ---------------------------------------------------------------------------


def mont_mul(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor, nreduce: int = 1) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod m on canonical-limb inputs.

    The JAX package's `_mont_mul_l_looped` recurrence: the outer loop over
    a's limbs, the inner loop vectorized over the stacked accumulator.
    Values may be up to 4m; with inputs <= c1*m, c2*m the pre-reduction
    output is < m*(1 + c1*c2*m/2^260), so nreduce=1 suffices for
    c1*c2 <= 16.
    """
    a, b = torch.broadcast_tensors(a, b)
    m = ctx.const("m", a.device).reshape((NLIMBS,) + (1,) * (a.dim() - 1))
    # t of the JAX loop after step i is acc[i + 1 : i + 1 + NLIMBS]: sliding
    # the window down one limb replaces the shift (its low limb, divisible
    # by 2^13 after the q*m term, only passes its carry up)
    acc = torch.zeros((2 * NLIMBS,) + a.shape[1:], dtype=a.dtype, device=a.device)
    for i in range(NLIMBS):
        t = acc[i : i + NLIMBS]
        t += a[i] * b
        q = t[0] & LIMB_MASK
        if ctx.m0inv != 1:  # P-256's p has m' = 1
            q = (q * ctx.m0inv) & LIMB_MASK
        t += q * m
        acc[i + 1] += t[0] >> LIMB_BITS
    t = acc[NLIMBS:]
    return _reduce(ctx, t, nreduce)  # value < 2m for canonical inputs


def _reduce(ctx: MontCtx, x: torch.Tensor, times: int) -> torch.Tensor:
    """Carry x (limbs of any size, value >= 0) and subtract m from it as
    long as it stays >= 0, at most `times` times.

    That is what carrying and then `times` conditional subtracts give,
    one after another; here the candidates x - j*m (j = 0..times) are
    carried together and the largest non-negative one is taken."""
    km = ctx.const(f"kmstack{times}", x.device).reshape(
        (NLIMBS, times + 1) + (1,) * (x.dim() - 1)
    )
    limbs, c = carry(x.unsqueeze(1) - km)  # (NLIMBS, times + 1, *batch)
    j = (c >= 0).sum(dim=0, keepdim=True) - 1  # non-negative for a prefix of j
    return limbs.gather(1, j.unsqueeze(0).expand((NLIMBS,) + j.shape)).squeeze(1)


def cond_sub(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """One conditional subtract: x - m if x >= m else x (limbs canonical)."""
    return _reduce(ctx, x, 1)


def reduce_canonical(ctx: MontCtx, x: torch.Tensor, times: int) -> torch.Tensor:
    """`times` conditional subtracts."""
    return _reduce(ctx, x, times) if times else x


def add_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb-canonical addition WITHOUT modular reduction (value = a+b)."""
    limbs, _ = carry(a + b)
    return limbs


def sub_mod(
    ctx: MontCtx, a: torch.Tensor, b: torch.Tensor, b_bound: int, nreduce: int
) -> torch.Tensor:
    """a - b + b_bound*m, carried with borrows, then `nreduce` conditional
    subtracts."""
    km = ctx.const(f"km{b_bound}", a.device).reshape(
        (NLIMBS,) + (1,) * (a.dim() - 1)
    )
    return _reduce(ctx, a + km - b, nreduce)


def to_mont(ctx: MontCtx, x: torch.Tensor, nreduce: int = 1) -> torch.Tensor:
    r2 = ctx.const("r2", x.device).reshape((NLIMBS,) + (1,) * (x.dim() - 1))
    return mont_mul(ctx, x, r2, nreduce=nreduce)


def from_mont(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    one = ctx.const("one", x.device).reshape((NLIMBS,) + (1,) * (x.dim() - 1))
    return mont_mul(ctx, x, one)


def mont_pow(ctx: MontCtx, x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent in the Montgomery domain, by the JAX package's fixed
    2-bit window: per digit (MSB first) square twice, then multiply by one
    of {1, x, x^2, x^3}. Multiplying by the Montgomery 1 leaves a
    canonical value unchanged, so digit 0 skips it."""
    nbits = exponent.bit_length()
    ndigits = (nbits + 1) // 2
    x2 = mont_mul(ctx, x, x)
    x3 = mont_mul(ctx, x2, x)
    table = (None, x, x2, x3)
    one = ctx.const("one_mont", x.device).reshape((NLIMBS,) + (1,) * (x.dim() - 1))
    acc = one.expand_as(x).clone()
    for i in range(ndigits):
        d = (exponent >> (2 * (ndigits - 1 - i))) & 3
        acc = mont_mul(ctx, acc, acc)
        acc = mont_mul(ctx, acc, acc)
        if d:
            acc = mont_mul(ctx, acc, table[d])
    return acc


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)
