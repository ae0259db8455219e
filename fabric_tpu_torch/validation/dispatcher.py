"""Validation-plugin dispatch (reference core/committer/txvalidator/v20/
plugindispatcher + core/handlers/library/registry.go).

The port's counterpart of the JAX package's `validation/dispatcher`.

Resolves, per chaincode namespace, WHICH validation plugin runs and with
WHAT policy — from the committed _lifecycle state when available, else
from legacy static definitions. The reference loads Go .so plugins
(registry.go:134 plugin.Open); here plugins are registered callables and
the builtin plugin is the batched device validator.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Callable, Dict, Optional

from fabric_tpu_torch.lifecycle import NAMESPACE as LIFECYCLE_NS
from fabric_tpu_torch.lifecycle import LifecycleResources
from fabric_tpu_torch.policy.proto_convert import (
    PolicyConversionError,
    unmarshal_application_policy,
)


class PluginRegistry:
    """Named validation plugins (library/registry.go analog). A plugin is
    whatever the caller wants to dispatch on — the BlockValidator only
    checks that the resolved name exists."""

    def __init__(self):
        self._plugins: Dict[str, object] = {"builtin": object(), "vscc": object()}

    def register(self, name: str, plugin: object) -> None:
        self._plugins[name] = plugin

    def load(self, name: str, ref: str) -> object:
        """Dynamic plugin loading, the Go `plugin.Open` analog
        (core/handlers/library/registry.go:134): `ref` is
        "module.path:attribute"; the attribute (or module) becomes the
        registered plugin object."""
        mod_name, _, attr = ref.partition(":")
        mod = importlib.import_module(mod_name)
        plugin = getattr(mod, attr) if attr else mod
        if inspect.isclass(plugin):
            plugin = plugin()  # class reference: instantiate
        self.register(name, plugin)
        return plugin

    def get(self, name: str) -> Optional[object]:
        return self._plugins.get(name)

    def exists(self, name: str) -> bool:
        return name in self._plugins


class LifecycleRegistry:
    """ChaincodeRegistry drop-in that resolves definitions from committed
    _lifecycle state (valinforetriever/shim.go: lifecycle first, legacy
    fallback)."""

    def __init__(
        self,
        state_get: Callable[[str, str], Optional[bytes]],
        legacy=None,
        plugin_registry: Optional[PluginRegistry] = None,
    ):
        """state_get(ns, key) -> committed state bytes."""
        from fabric_tpu_torch.validation.validator import ChaincodeDefinition

        self._cd_cls = ChaincodeDefinition
        self._legacy = legacy
        self.plugins = plugin_registry or PluginRegistry()
        self._resources = LifecycleResources(
            public_get=lambda key: state_get(LIFECYCLE_NS, key),
            public_put=self._readonly,
            org_get=lambda org, key: None,
            org_put=self._readonly,
            org_names=[],
        )

    @staticmethod
    def _readonly(*_args):
        raise RuntimeError("validator-side lifecycle view is read-only")

    def get(self, name: str):
        info = self._resources.validation_info(name)
        if info is None:
            return self._legacy.get(name) if self._legacy else None
        plugin_name, vp_bytes = info
        plugin_name = plugin_name or "builtin"
        if not self.plugins.exists(plugin_name):
            # an unresolvable plugin invalidates the tx (reference
            # plugin_validator.go getOrCreatePlugin error path), surfaced
            # as a missing definition -> INVALID_CHAINCODE
            return None
        try:
            policy = unmarshal_application_policy(vp_bytes)
        except PolicyConversionError:
            return None
        return self._cd_cls(name, policy, plugin=plugin_name)
