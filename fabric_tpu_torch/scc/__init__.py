"""System chaincodes (reference core/scc): the port's counterpart of the
JAX package's `scc` package."""

from fabric_tpu_torch.scc.qscc import QSCC  # noqa: F401
from fabric_tpu_torch.scc.cscc import CSCC  # noqa: F401
from fabric_tpu_torch.scc.lscc import LSCC  # noqa: F401
