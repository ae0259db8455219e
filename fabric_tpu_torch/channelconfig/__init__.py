"""On-ledger channel configuration (reference common/channelconfig +
common/configtx + common/capabilities + configtxgen encoder).

The port's counterpart of the JAX package's `channelconfig`, over the wire
codec (`protos/configtx.py`) and the port's MSP and policy manager."""

from fabric_tpu_torch.channelconfig.bundle import (
    Bundle,
    ConfigError,
    bundle_from_envelope,
    bundle_from_genesis_block,
)
from fabric_tpu_torch.channelconfig.configtx import ConfigTxError, Validator
from fabric_tpu_torch.channelconfig.encoder import (
    ApplicationProfile,
    OrdererProfile,
    OrganizationProfile,
    Profile,
    genesis_block,
    new_channel_group,
    new_config,
)

# ConfigError/bundle_from_envelope/new_channel_group are reachable as
# module attributes but not claimed in __all__, as in the JAX package
__all__ = [
    "ApplicationProfile",
    "Bundle",
    "ConfigTxError",
    "OrdererProfile",
    "OrganizationProfile",
    "Profile",
    "Validator",
    "bundle_from_genesis_block",
    "genesis_block",
    "new_config",
]
