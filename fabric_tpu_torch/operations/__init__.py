"""The operations server (reference core/operations): the port's counterpart
of the JAX package's `operations` package."""

from fabric_tpu_torch.operations.system import Options, System  # noqa: F401
