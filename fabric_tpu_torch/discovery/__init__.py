"""Service discovery (reference discovery/): the principal-set algebra and
the peers / config / endorsers queries; the port's counterpart of the JAX
package's `discovery` package (its gRPC server stays out of the port)."""

from fabric_tpu_torch.discovery.inquire import satisfied_by  # noqa: F401
from fabric_tpu_torch.discovery.service import (  # noqa: F401
    DiscoveryService,
    EndorsementDescriptor,
    PeerInfo,
)
