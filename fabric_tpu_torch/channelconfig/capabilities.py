"""Capability feature gates from channel config (reference
common/capabilities/{application,channel,orderer}.go).

The port's copy of the JAX package's `channelconfig/capabilities.py`.

Capabilities are opaque string keys inside a Capabilities config value;
a node must "support" every required capability or refuse to process the
channel. The gates that change behavior here mirror the reference:
ApplicationCapabilities.V2_0Validation selects the v20 validation path
(reference common/capabilities/application.go:29,113), V1_2Validation
gates key-level endorsement, V1_1Validation gates tx flags validation.
"""

from __future__ import annotations

from typing import Iterable

V1_1 = "V1_1"
V1_2 = "V1_2"
V1_3 = "V1_3"
V1_4_2 = "V1_4_2"
V1_4_3 = "V1_4_3"
V2_0 = "V2_0"

_ORDERED = (V1_1, V1_2, V1_3, V1_4_2, V1_4_3, V2_0)


class CapabilityError(Exception):
    pass


class _Registry:
    def __init__(self, kind: str, supported: Iterable[str], capabilities: Iterable[str]):
        self.kind = kind
        self._supported = set(supported)
        self.required = set(capabilities)

    def supported(self) -> None:
        missing = self.required - self._supported
        if missing:
            raise CapabilityError(
                f"{self.kind} capabilities {sorted(missing)} are required but "
                f"not supported"
            )

    def _at_least(self, version: str) -> bool:
        idx = _ORDERED.index(version)
        return any(c in self.required for c in _ORDERED[idx:])


class ApplicationCapabilities(_Registry):
    def __init__(self, capabilities: Iterable[str] = ()):
        super().__init__("Application", _ORDERED, capabilities)

    @property
    def v20_validation(self) -> bool:
        return V2_0 in self.required

    @property
    def v12_validation(self) -> bool:
        return self._at_least(V1_2)

    @property
    def v11_validation(self) -> bool:
        return self._at_least(V1_1)

    @property
    def key_level_endorsement(self) -> bool:
        return self._at_least(V1_3)

    @property
    def storage_pvt_data_experimental(self) -> bool:
        return self._at_least(V1_2)

    @property
    def lifecycle_v20(self) -> bool:
        return V2_0 in self.required


class ChannelCapabilities(_Registry):
    def __init__(self, capabilities: Iterable[str] = ()):
        super().__init__("Channel", (V1_3, V1_4_2, V1_4_3, V2_0), capabilities)

    @property
    def consensus_type_migration(self) -> bool:
        return V1_4_2 in self.required or V2_0 in self.required


class OrdererCapabilities(_Registry):
    def __init__(self, capabilities: Iterable[str] = ()):
        super().__init__("Orderer", (V1_1, V1_4_2, V2_0), capabilities)

    @property
    def use_channel_creation_policy_as_admins(self) -> bool:
        return V2_0 in self.required
