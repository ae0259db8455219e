"""Chaincode lifecycle (_lifecycle analog).

Reference: core/chaincode/lifecycle/lifecycle.go: install / approve /
commit chaincode definitions with per-org approvals, stored in the
`_lifecycle` namespace of channel state, serving validation info
(endorsement policy + validation plugin) to the commit-time dispatcher.
"""

from fabric_tpu_torch.lifecycle.lifecycle import (
    NAMESPACE,
    ChaincodeDefinition,
    LifecycleError,
    LifecycleResources,
)

__all__ = [
    "ChaincodeDefinition",
    "LifecycleError",
    "LifecycleResources",
    "NAMESPACE",
]
