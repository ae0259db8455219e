"""Ordering service (reference orderer/): blockcutter, block writer, solo;
the port's counterpart of the JAX package's `orderer` package."""

from fabric_tpu_torch.orderer.blockcutter import BlockCutter  # noqa: F401
from fabric_tpu_torch.orderer.solo import SoloChain  # noqa: F401

__all__ = ["BlockCutter", "SoloChain"]
