"""The chaincode runtime (reference core/chaincode + fabric-chaincode-go
shim): the port's counterpart of the JAX package's `chaincode` package."""

from fabric_tpu_torch.chaincode.shim import (  # noqa: F401
    Chaincode,
    ChaincodeStub,
    Response,
    error_response,
    success,
)
from fabric_tpu_torch.chaincode.support import ChaincodeSupport  # noqa: F401
