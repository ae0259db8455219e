"""Lazy-reduction field elements for the plain versions of the EC kernels.

The JAX package's `ops/fieldops` with stacked (NLIMBS, B) int64 limbs in
place of limb tuples. The static value bound (value < bound * p) is kept
and asserted exactly as there, so the plain versions follow the same
reduction schedule as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fabric_tpu_torch.ops import bignum as bn


class FE(NamedTuple):
    """A field element (stacked limbs) with a static value bound."""

    limbs: torch.Tensor
    bound: int


class Point(NamedTuple):
    x: FE
    y: FE
    z: FE


class Field:
    def __init__(self, ctx: bn.MontCtx):
        self.ctx = ctx

    def mul(self, a: FE, b: FE) -> FE:
        assert a.bound * b.bound <= 16, (a.bound, b.bound)
        return FE(bn.mont_mul(self.ctx, a.limbs, b.limbs, nreduce=1), 1)

    def add(self, a: FE, b: FE) -> FE:
        assert a.bound + b.bound <= 8, (a.bound, b.bound)
        return FE(bn.add_raw(a.limbs, b.limbs), a.bound + b.bound)

    def sub(self, a: FE, b: FE) -> FE:
        # a - b + bound(b)*p, then conditional subtracts back to canonical.
        return FE(
            bn.sub_mod(
                self.ctx, a.limbs, b.limbs, b.bound,
                nreduce=a.bound + b.bound - 1,
            ),
            1,
        )

    def identity(self, batch: int, device) -> Point:
        """(0 : 1 : 0) in Montgomery form, broadcast to `batch` lanes."""
        zero = torch.zeros((bn.NLIMBS, batch), dtype=torch.int64, device=device)
        one = self.ctx.const("one_mont", device).expand(bn.NLIMBS, batch)
        return Point(FE(zero, 1), FE(one.clone(), 1), FE(zero.clone(), 1))
