"""Legacy (pre-2.0) validation: the v12/v13-era LSCC-backed policy
source, write-set guards, collection-config validation and the
capability router. The port's counterpart of the JAX package's
`validation/legacy`, with the same error strings (reference
core/handlers/validation/builtin/v12/validation_logic.go,
core/handlers/validation/builtin/v13/validation_logic.go
validateRWSetAndCollection / validateNewCollectionConfigsAgainstCommitted,
core/committer/txvalidator/v14 + router.go:34-50).

Pre-V2_0 channels resolve a chaincode's endorsement policy from LSCC's
ChaincodeData record in state — not from the _lifecycle namespace — and
apply the v12 write-set rules: a normal transaction must not write to
the LSCC namespace or any system chaincode namespace, and an LSCC
deploy/upgrade must be shaped as one.  v13 adds private-collection
support at deploy time: the deploy may write a SECOND key,
"<chaincode>~collection", holding a CollectionConfigPackage that must
validate structurally, and an upgrade may only EXPAND the committed
package — existing collections cannot be dropped or modified
(v13 validation_logic.go:  validateNewCollectionConfigs +
validateNewCollectionConfigsAgainstCommitted).

"Cannot be modified" compares each committed collection's bytes with the
new one's, both parsed and serialized again as protobuf does it: the wire
codec keeps unknown fields (`wire.decode(..., keep_unknown=True)`) and
writes known fields in field-number order, so a package that carries an
unknown field is judged as the JAX package judges it.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from fabric_tpu_torch.policy.proto_convert import (
    PolicyConversionError,
    unmarshal_envelope,
)
from fabric_tpu_torch.protos import fabric, wire

SYSTEM_NAMESPACES = ("lscc", "cscc", "qscc", "escc", "vscc", "_lifecycle")

# privdata.BuildCollectionKVSKey separator (core/common/privdata/store.go)
COLLECTION_SEPARATOR = "~"


def collection_key(chaincode: str) -> str:
    return chaincode + COLLECTION_SEPARATOR + "collection"


class LSCCRegistry:
    """ChaincodeRegistry drop-in resolving definitions from LSCC state
    (v12 validation_logic.go getVSCCInfo path: ChaincodeData.policy)."""

    def __init__(self, state_get: Callable[[str, str], Optional[bytes]]):
        """state_get(ns, key) -> committed bytes; definitions live at
        ("lscc", <chaincode name>)."""
        from fabric_tpu_torch.validation.validator import ChaincodeDefinition

        self._cd_cls = ChaincodeDefinition
        self._state_get = state_get

    def get(self, name: str):
        raw = self._state_get("lscc", name)
        if raw is None:
            return None
        try:
            data = wire.decode(fabric.CHAINCODE_DATA, raw)
        except wire.WireError:  # a malformed record: the chaincode is undefined
            return None
        try:
            policy = unmarshal_envelope(data.get("policy", b""))
        except PolicyConversionError:
            return None
        return self._cd_cls(name, policy, plugin=data.get("vscc", "") or "vscc")

    def names(self) -> List[str]:
        return []  # enumeration needs a range scan; unused by validation


def check_v12_writeset(rwset, invoked_namespace: str) -> Optional[str]:
    """The v12 write-set guards. Returns an error string (maps to
    ILLEGAL_WRITESET) or None.

    - writes to LSCC are only legal when the tx INVOKES lscc (deploy /
      upgrade), and then only to the deployed chaincode's own key
      (validation_logic.go:  "LSCC can only issue a single putState");
    - writes to any other system chaincode namespace are always illegal.
    """
    return _check_legacy_writeset(rwset, invoked_namespace, v13=False)


def check_v13_writeset(
    rwset,
    invoked_namespace: str,
    committed_collections_get: Optional[Callable[[str], Optional[bytes]]] = None,
) -> Optional[str]:
    """v13 guards: v12 rules plus collection support on deploy/upgrade
    (v13 validation_logic.go validateRWSetAndCollection).  The deploy may
    write "<cc>~collection" alongside the ChaincodeData key; the package
    must validate, and against `committed_collections_get(cc)` an upgrade
    may only expand (existing collections immutable)."""
    return _check_legacy_writeset(
        rwset,
        invoked_namespace,
        v13=True,
        committed_collections_get=committed_collections_get,
    )


def _check_legacy_writeset(
    rwset,
    invoked_namespace: str,
    v13: bool,
    committed_collections_get=None,
) -> Optional[str]:
    if rwset is None:
        return None
    for ns_rw in rwset.ns_rw_sets:
        ns = ns_rw.namespace
        if ns == "lscc":
            if invoked_namespace != "lscc":
                if ns_rw.writes or ns_rw.metadata_writes:
                    return (
                        "chaincode is not lscc but writes to the lscc "
                        "namespace"
                    )
                continue
            cc_writes = [
                w for w in ns_rw.writes
                if COLLECTION_SEPARATOR not in w.key
            ]
            coll_writes = [
                w for w in ns_rw.writes
                if COLLECTION_SEPARATOR in w.key
            ]
            if len(cc_writes) > 1:
                return "lscc deploy must write exactly one chaincode key"
            if coll_writes and not v13:
                return (
                    "collection configurations require the V1_2 "
                    "application capability (v13 validator)"
                )
            if len(coll_writes) > 1:
                return "lscc deploy may write at most one collection key"
            # the reference additionally pins the single key to the
            # deployed chaincode's name (validateDeployRWSetAndCollection);
            # the invoke args are not threaded here, so pin what we
            # can: the key must not shadow a system chaincode record
            for w in cc_writes:
                if w.key in SYSTEM_NAMESPACES:
                    return (
                        f"lscc deploy may not overwrite system "
                        f"chaincode {w.key}"
                    )
            if coll_writes:
                w = coll_writes[0]
                if not cc_writes:
                    return "collection write without a chaincode deploy"
                cc = cc_writes[0].key
                if w.key != collection_key(cc):
                    return (
                        f"collection key {w.key!r} must be "
                        f"{collection_key(cc)!r}"
                    )
                committed = (
                    committed_collections_get(cc)
                    if committed_collections_get is not None
                    else None
                )
                why = validate_collection_config_package(w.value, committed)
                if why is not None:
                    return why
        elif ns in SYSTEM_NAMESPACES and ns != invoked_namespace:
            if ns_rw.writes or ns_rw.metadata_writes:
                return f"writes to system namespace {ns} are not allowed"
    return None


_ALLOWED_PRINCIPAL_TYPES = (fabric.ROLE, fabric.ORGANIZATION_UNIT, fabric.IDENTITY)


def validate_collection_config_package(
    raw: bytes, committed_raw: Optional[bytes] = None
) -> Optional[str]:
    """Structural validation of a CollectionConfigPackage, plus the
    expand-only rule against the committed package (v13
    validateNewCollectionConfigs +
    validateNewCollectionConfigsAgainstCommitted).  Returns an error
    string or None."""
    try:
        pkg = wire.decode(fabric.COLLECTION_CONFIG_PACKAGE, raw, keep_unknown=True)
    except wire.WireError:  # a malformed package: the tx is invalid
        return "invalid collection configuration supplied"
    seen = set()
    for cfg in pkg.get("config", ()):
        if "static_collection_config" not in cfg:
            return "unknown collection configuration type"
        static = cfg["static_collection_config"]
        name = static.get("name", "")
        if not name:
            return "collection-name cannot be empty"
        if name in seen:
            return (
                f"collection-name: {name} -- found duplicate "
                f"collection configuration"
            )
        seen.add(name)
        maximum = static.get("maximum_peer_count", 0)
        required = static.get("required_peer_count", 0)
        if maximum < required:
            return (
                f"collection-name: {name} -- maximum peer count "
                f"({maximum}) cannot be less than the "
                f"required peer count ({required})"
            )
        member_orgs = static.get("member_orgs_policy", {})
        if "signature_policy" not in member_orgs:
            return (
                f"collection-name: {name} -- collection member "
                f"policy is not set"
            )
        identities = member_orgs["signature_policy"].get("identities", ())
        if not identities:
            return (
                f"collection-name: {name} -- collection member "
                f"policy has no identities"
            )
        for principal in identities:
            classification = principal.get("principal_classification", fabric.ROLE)
            if classification not in _ALLOWED_PRINCIPAL_TYPES:
                return (
                    f"collection-name: {name} -- collection "
                    f"member policy contains an unsupported principal "
                    f"type {classification}"
                )
    if committed_raw:
        try:
            old = wire.decode(fabric.COLLECTION_CONFIG_PACKAGE, committed_raw, keep_unknown=True)
        except wire.WireError:  # a corrupt committed record: the tx is invalid
            return "committed collection configuration is unreadable"
        new_by_name = {
            _static_name(c): wire.encode(fabric.COLLECTION_CONFIG, c)
            for c in pkg.get("config", ())
        }
        for c in old.get("config", ()):
            name = _static_name(c)
            if name not in new_by_name:
                return (
                    f"the following existing collections are missing in "
                    f"the new collection configuration package: [{name}]"
                )
            if new_by_name[name] != wire.encode(fabric.COLLECTION_CONFIG, c):
                return (
                    f"the collection configuration for collection "
                    f"{name!r} cannot be modified on upgrade"
                )
    return None


def _static_name(cfg: dict) -> str:
    return cfg.get("static_collection_config", {}).get("name", "")


class ValidationRouter:
    """router.go:34-50: pick the v20 (_lifecycle) or legacy (LSCC)
    definition source by the channel's application capabilities."""

    def __init__(
        self,
        lifecycle_registry,
        lscc_registry: LSCCRegistry,
        capabilities: Callable[[], Sequence[str]],
    ):
        self._v20 = lifecycle_registry
        self._legacy = lscc_registry
        self._capabilities = capabilities

    @property
    def v20_active(self) -> bool:
        return "V2_0" in tuple(self._capabilities())

    def get(self, name: str):
        if self.v20_active:
            return self._v20.get(name)
        return self._legacy.get(name)

    def names(self) -> List[str]:
        return self._v20.names() if self.v20_active else self._legacy.names()
