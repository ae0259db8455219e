"""fabric-tpu ported to PyTorch and CUDA on an NVIDIA H100.

The JAX package `fabric_tpu` beside it is the reference. This package
imports neither JAX nor anything of `fabric_tpu`; its entry points run on
`cuda` unless the caller asks for `device="cpu"`, where every kernel
wrapper runs its plain PyTorch version.
"""

__version__ = "0.5.0"  # the JAX package's, whose port this is
