"""Chaincode lifecycle: per-org approvals and committed definitions.

The port's counterpart of the JAX package's `lifecycle/lifecycle`: the
state keys and the StateMetadata / StateData bytes it writes are the JAX
package's (`protos/fabric.STATE_METADATA`, `STATE_DATA` through the wire
codec).

Reference mechanics (core/chaincode/lifecycle/lifecycle.go):

- a chaincode definition is a sequence-numbered tuple (version,
  endorsement plugin, validation plugin, validation parameter,
  collections, init-required);
- each org APPROVES a (sequence, definition[, package-id]) by writing it
  into its implicit private collection
  (ApproveChaincodeDefinitionForOrg, lifecycle.go:415);
- anyone may ask which orgs' approvals match a proposed definition
  (CheckCommitReadiness, lifecycle.go:320);
- COMMIT (CommitChaincodeDefinition, lifecycle.go:350) records the
  definition in public state at the next sequence, provided the
  approvals satisfy the channel's lifecycle endorsement policy
  (delegated here to an `approval_policy` callable);
- committed definitions serve validation info to the commit-time
  dispatcher (endorsement_info.go).

State layout mirrors the reference's serializer: in namespace
`_lifecycle`, `namespaces/metadata/<cc>` holds a StateMetadata and
`namespaces/fields/<cc>/<Field>` holds one StateData per field, so
state-level parity checks are possible. Org approvals live under
`chaincode-sources`-style keys in per-org maps here (the implicit
collection analog).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.protos import fabric, wire

NAMESPACE = "_lifecycle"

_NS_PREFIX = "namespaces"
_DATATYPE_DEFINITION = "ChaincodeDefinition"
_DATATYPE_PARAMETERS = "ChaincodeParameters"


class LifecycleError(Exception):
    pass


@dataclass(frozen=True)
class ChaincodeDefinition:
    """One sequence of a chaincode's governance parameters."""

    sequence: int
    version: str = "1.0"
    endorsement_plugin: str = "escc"
    validation_plugin: str = "vscc"
    validation_parameter: bytes = b""  # serialized ApplicationPolicy
    collections: bytes = b""  # serialized CollectionConfigPackage
    init_required: bool = False

    def parameters_equal(self, other: "ChaincodeDefinition") -> bool:
        return (
            self.version == other.version
            and self.endorsement_plugin == other.endorsement_plugin
            and self.validation_plugin == other.validation_plugin
            and self.validation_parameter == other.validation_parameter
            and self.collections == other.collections
            and self.init_required == other.init_required
        )


def _metadata_key(cc: str) -> str:
    return f"{_NS_PREFIX}/metadata/{cc}"


def _field_key(cc: str, fname: str) -> str:
    return f"{_NS_PREFIX}/fields/{cc}/{fname}"


_FIELDS = (
    "Sequence",
    "Version",
    "EndorsementPlugin",
    "ValidationPlugin",
    "ValidationParameter",
    "Collections",
    "InitRequired",
)


def _data_int(v: int) -> bytes:
    return wire.encode(fabric.STATE_DATA, {"Int64": v})


def _data_str(v: str) -> bytes:
    return wire.encode(fabric.STATE_DATA, {"String": v})


def _data_bytes(v: bytes) -> bytes:
    return wire.encode(fabric.STATE_DATA, {"Bytes": v})


def _read_data(raw: Optional[bytes]):
    """The value of the StateData oneof that is set, or None."""
    if raw is None:
        return None
    m = wire.decode(fabric.STATE_DATA, raw)
    for kind in ("Int64", "Bytes", "String"):
        if kind in m:
            return m[kind]
    return None


class LifecycleResources:
    """The _lifecycle namespace over a pluggable state.

    `public_get`/`public_put` operate on (key) within the _lifecycle
    namespace of channel state. Org approvals are stored through
    `org_get`/`org_put(org, key)` — the implicit-collection analog.
    `approval_policy(approvals: {org: bool}) -> bool` stands in for the
    channel's LifecycleEndorsement policy (default: majority).
    """

    def __init__(
        self,
        public_get: Callable[[str], Optional[bytes]],
        public_put: Callable[[str, bytes], None],
        org_get: Callable[[str, str], Optional[bytes]],
        org_put: Callable[[str, str, bytes], None],
        org_names: Sequence[str],
        approval_policy: Optional[Callable[[Dict[str, bool]], bool]] = None,
    ):
        self.public_get = public_get
        self.public_put = public_put
        self.org_get = org_get
        self.org_put = org_put
        self.org_names = list(org_names)
        self.approval_policy = approval_policy or self._majority

    @staticmethod
    def _majority(approvals: Dict[str, bool]) -> bool:
        yes = sum(1 for ok in approvals.values() if ok)
        return yes > len(approvals) // 2

    # -- serialization ------------------------------------------------------

    def _write_definition(
        self,
        put: Callable[[str, bytes], None],
        cc: str,
        cd: ChaincodeDefinition,
        datatype: str,
    ) -> None:
        meta = {"datatype": datatype, "fields": list(_FIELDS)}
        put(_metadata_key(cc), wire.encode(fabric.STATE_METADATA, meta))
        put(_field_key(cc, "Sequence"), _data_int(cd.sequence))
        put(_field_key(cc, "Version"), _data_str(cd.version))
        put(_field_key(cc, "EndorsementPlugin"), _data_str(cd.endorsement_plugin))
        put(_field_key(cc, "ValidationPlugin"), _data_str(cd.validation_plugin))
        put(
            _field_key(cc, "ValidationParameter"),
            _data_bytes(cd.validation_parameter),
        )
        put(_field_key(cc, "Collections"), _data_bytes(cd.collections))
        put(_field_key(cc, "InitRequired"), _data_int(int(cd.init_required)))

    def _read_definition(
        self, get: Callable[[str], Optional[bytes]], cc: str
    ) -> Optional[ChaincodeDefinition]:
        if get(_metadata_key(cc)) is None:
            return None
        seq = _read_data(get(_field_key(cc, "Sequence")))
        if seq is None:
            return None
        return ChaincodeDefinition(
            sequence=seq,
            version=_read_data(get(_field_key(cc, "Version"))) or "",
            endorsement_plugin=_read_data(get(_field_key(cc, "EndorsementPlugin"))) or "",
            validation_plugin=_read_data(get(_field_key(cc, "ValidationPlugin"))) or "",
            validation_parameter=_read_data(get(_field_key(cc, "ValidationParameter"))) or b"",
            collections=_read_data(get(_field_key(cc, "Collections"))) or b"",
            init_required=bool(_read_data(get(_field_key(cc, "InitRequired"))) or 0),
        )

    # -- external functions (lifecycle.go ExternalFunctions) ---------------

    def approve_chaincode_definition_for_org(
        self, org: str, cc: str, cd: ChaincodeDefinition, package_id: str = ""
    ) -> None:
        """ApproveChaincodeDefinitionForOrg (lifecycle.go:415): the
        requested sequence must be the current sequence or current+1."""
        current = self.current_sequence(cc)
        if cd.sequence not in (current, current + 1):
            raise LifecycleError(
                f"requested sequence is {cd.sequence}, but new definition "
                f"must be sequence {current + 1}"
            )
        if cd.sequence == current:
            committed = self.query_chaincode_definition(cc)
            if committed is not None and not committed.parameters_equal(cd):
                raise LifecycleError(
                    "attempted to redefine the current committed sequence "
                    f"({current}) with different parameters"
                )
        self._write_definition(
            lambda k, v: self.org_put(org, f"{cc}#{cd.sequence}/{k}", v),
            cc,
            cd,
            _DATATYPE_PARAMETERS,
        )
        if package_id:
            self.org_put(
                org,
                f"chaincode-sources/{cc}#{cd.sequence}",
                _data_str(package_id),
            )

    def _org_approved(self, org: str, cc: str, cd: ChaincodeDefinition) -> bool:
        stored = self._read_definition(
            lambda k: self.org_get(org, f"{cc}#{cd.sequence}/{k}"), cc
        )
        return stored is not None and stored.parameters_equal(cd) and stored.sequence == cd.sequence

    def check_commit_readiness(
        self, cc: str, cd: ChaincodeDefinition
    ) -> Dict[str, bool]:
        """CheckCommitReadiness (lifecycle.go:320): which orgs have
        approved exactly this definition at this sequence."""
        current = self.current_sequence(cc)
        if cd.sequence != current + 1:
            raise LifecycleError(
                f"requested sequence is {cd.sequence}, but new definition "
                f"must be sequence {current + 1}"
            )
        return {
            org: self._org_approved(org, cc, cd) for org in self.org_names
        }

    def commit_chaincode_definition(
        self, cc: str, cd: ChaincodeDefinition
    ) -> Dict[str, bool]:
        """CommitChaincodeDefinition (lifecycle.go:350)."""
        approvals = self.check_commit_readiness(cc, cd)
        if not self.approval_policy(approvals):
            raise LifecycleError(
                f"chaincode definition not agreed to by enough orgs: "
                f"{approvals}"
            )
        self._write_definition(self.public_put, cc, cd, _DATATYPE_DEFINITION)
        return approvals

    def current_sequence(self, cc: str) -> int:
        seq = _read_data(self.public_get(_field_key(cc, "Sequence")))
        return int(seq) if seq is not None else 0

    def query_chaincode_definition(self, cc: str) -> Optional[ChaincodeDefinition]:
        """QueryChaincodeDefinition (lifecycle.go:625)."""
        return self._read_definition(self.public_get, cc)

    # -- validation info for the dispatcher (endorsement_info.go) ----------

    def validation_info(self, cc: str) -> Optional[Tuple[str, bytes]]:
        """(validation_plugin, validation_parameter) for a committed
        chaincode, or None if undefined — what GetInfoForValidate needs
        (plugindispatcher/dispatcher.go:265)."""
        cd = self.query_chaincode_definition(cc)
        if cd is None:
            return None
        return cd.validation_plugin, cd.validation_parameter
