"""The canonical limb-radix parameters of the port's plain tensor code.

Radix 2^13, 20 limbs (260 bits for 256-bit fields): the same layout as the
JAX package's device ops, so the plain PyTorch versions can be held to them
value for value. The CUDA kernels use native 32-bit words instead; the
limb layout is only their input format.
"""

from __future__ import annotations

LIMB_BITS = 13
NLIMBS = 20
LIMB_MASK = (1 << LIMB_BITS) - 1
RADIX_BITS = LIMB_BITS * NLIMBS  # 260
