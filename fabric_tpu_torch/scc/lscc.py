"""lscc — legacy lifecycle system chaincode (reference core/scc/lscc/
lscc.go: Invoke :797, executeDeployOrUpgrade :580, putChaincodeData
lineage, plus the query surface old SDKs keep using).

Two roles:

* **Legacy deploy/upgrade** for pre-V2_0 channels: writes the
  ChaincodeData record at ("lscc", <name>) and the collection package at
  ("lscc", "<name>~collection") through the invoking tx's simulator, so
  the v12/v13 write-set guards validate the exact shapes this module
  produces and `validation.legacy.LSCCRegistry` resolves policies from
  the committed records.  Name/version syntax rules mirror lscc.go
  (isValidCCNameOrVersion: name `[A-Za-z0-9]+([-_][A-Za-z0-9]+)*`,
  version also allows ``.+-_``).
* **Query surface**: getchaincodes, getid, getccdata (ChaincodeData
  bytes, as the reference returns), getcollectionsconfig.

V2_0 channels deploy through _lifecycle (the lifecycle package); deploy /
upgrade here errors on them, like the reference does once the channel
has migrated.

The port's counterpart of the JAX package's `scc/lscc.py`, over the wire
codec and the port's `policy/proto_convert`: the same records, payloads and
messages. A record that does not parse raises with protobuf's text, as the
JAX SCC's `ParseFromString` does.
"""

from __future__ import annotations

import hashlib
import re
from typing import Callable, List, Optional, Tuple

from fabric_tpu_torch.chaincode.shim import ChaincodeStub, Response, error_response, success
from fabric_tpu_torch.policy.proto_convert import unmarshal_envelope
from fabric_tpu_torch.protos import fabric, wire

GET_CHAINCODES = "getchaincodes"
GET_CC_INFO = "getid"
GET_CC_DATA = "getccdata"
GET_COLLECTIONS_CONFIG = "getcollectionsconfig"
DEPLOY = "deploy"
UPGRADE = "upgrade"

_NAME_RE = re.compile(r"^[A-Za-z0-9]+([-_][A-Za-z0-9]+)*$")
_VERSION_RE = re.compile(r"^[A-Za-z0-9_.+-]+$")

COLLECTION_SUFFIX = "~collection"


def _collection_key(name: str) -> str:
    return name + COLLECTION_SUFFIX


def _chaincode_data(raw: bytes) -> dict:
    """A ChaincodeData record, or WireError with protobuf's parse error."""
    try:
        return wire.decode(fabric.CHAINCODE_DATA, raw)
    except wire.WireError as e:
        raise wire.WireError("Error parsing message with type 'protos.ChaincodeData'") from e


class LSCC:
    def __init__(
        self,
        # () -> [(name, version)] of committed definitions on this channel
        list_definitions: Callable[[], List[Tuple[str, str]]],
        # (channel_id) -> bool: True when the channel has the V2_0
        # capability and legacy deploys must be refused
        # (lscc.go InvalidCCOnFabricVersionError)
        v20_active: Optional[Callable[[str], bool]] = None,
    ):
        self._list_definitions = list_definitions
        self._v20_active = v20_active or (lambda cid: False)

    def init(self, stub: ChaincodeStub) -> Response:
        return success()

    def invoke(self, stub: ChaincodeStub) -> Response:
        args = stub.get_args()
        if not args:
            return error_response("Incorrect number of arguments, 0")
        fname = args[0].decode().lower()
        if fname in (DEPLOY, UPGRADE):
            return self._deploy_or_upgrade(stub, fname, args)
        if fname in (GET_CHAINCODES, "getchaincodesinfo"):
            return self._get_chaincodes(stub)
        if fname in (GET_CC_INFO, GET_CC_DATA):
            return self._get_cc(stub, fname, args)
        if fname == GET_COLLECTIONS_CONFIG:
            if len(args) < 2:
                return error_response("Incorrect number of arguments, 1")
            raw = stub.get_state(_collection_key(args[1].decode()))
            if raw is None:
                return error_response(
                    f"collections config not defined for chaincode "
                    f"{args[1].decode()}"
                )
            return success(raw)
        return error_response(f"invalid function to lscc: {fname}")

    # -- legacy deploy/upgrade (executeDeployOrUpgrade :580) -------------
    def _deploy_or_upgrade(
        self, stub: ChaincodeStub, fname: str, args
    ) -> Response:
        if self._v20_active(stub.channel_id):
            return error_response(
                "Channel has been migrated to the new lifecycle, "
                "LSCC is no longer supported for deploy/upgrade"
            )
        # args: [fn, channel, depspec, policy?, escc?, vscc?, collections?]
        if len(args) < 3:
            return error_response(
                f"Incorrect number of arguments, {len(args)}"
            )
        try:
            spec = wire.decode(fabric.CHAINCODE_DEPLOYMENT_SPEC, args[2])
        except wire.WireError:
            return error_response("error unmarshalling ChaincodeDeploymentSpec")
        ccid = spec.get("chaincode_spec", {}).get("chaincode_id", {})
        name, version = ccid.get("name", ""), ccid.get("version", "")
        if not _NAME_RE.match(name or ""):
            return error_response(f"invalid chaincode name '{name}'")
        if not _VERSION_RE.match(version or ""):
            return error_response(f"invalid chaincode version '{version}'")

        existing_raw = stub.get_state(name)
        if fname == DEPLOY and existing_raw is not None:
            return error_response(f"chaincode with name '{name}' already exists")
        if fname == UPGRADE:
            if existing_raw is None:
                return error_response(f"cannot get chaincode data for '{name}'")
            old = _chaincode_data(existing_raw)
            if old.get("version", "") == version:
                return error_response(
                    f"chaincode '{name}' is already instantiated at "
                    f"version '{version}'"
                )

        # the endorsement policy is REQUIRED and must parse: committing a
        # ChaincodeData with empty/garbage policy bytes would make
        # LSCCRegistry.get() fail forever and brick the chaincode with
        # INVALID_CHAINCODE on every tx (the reference validates/defaults
        # the policy at deploy; lacking the channel-org context its
        # default needs, we require it explicitly)
        if len(args) < 4 or not args[3]:
            return error_response(
                "endorsement policy is required for deploy/upgrade"
            )
        try:
            unmarshal_envelope(bytes(args[3]))
        except Exception as e:  # noqa: BLE001 - any parse failure
            return error_response(f"invalid endorsement policy: {e}")

        cd = wire.encode(fabric.CHAINCODE_DATA, {
            "name": name,
            "version": version,
            "escc": args[4].decode() if len(args) > 4 and args[4] else "escc",
            "vscc": args[5].decode() if len(args) > 5 and args[5] else "vscc",
            "policy": bytes(args[3]),  # serialized SignaturePolicyEnvelope
            # id: fingerprint of the code package (ccprovider hash lineage)
            "id": hashlib.sha256(
                bytes(spec.get("code_package", b"")) + name.encode() + version.encode()
            ).digest(),
        })
        stub.put_state(name, cd)

        if len(args) > 6 and args[6]:
            # collection package: written beside the chaincode record;
            # structural validation is the v13 validator's job on commit
            # (validation.legacy.check_v13_writeset), matching the
            # reference split between lscc and the validation plugin
            stub.put_state(_collection_key(name), bytes(args[6]))
        return success(cd)

    # -- queries ----------------------------------------------------------
    def _get_chaincodes(self, stub: ChaincodeStub) -> Response:
        chaincodes = []
        listed = set()
        # committed legacy records first (state), then lifecycle
        # definitions (old SDKs expect one merged view)
        for key, raw in stub.get_state_by_range("", ""):
            if COLLECTION_SUFFIX in key:
                continue
            try:
                cd = _chaincode_data(raw)
            except wire.WireError:  # foreign record
                continue
            info = {
                "name": cd.get("name", "") or key,
                "version": cd.get("version", ""),
                "escc": cd.get("escc", "") or "escc",
                "vscc": cd.get("vscc", "") or "vscc",
                "id": cd.get("id", b""),
            }
            chaincodes.append(info)
            listed.add(info["name"])
        for name, version in sorted(self._list_definitions()):
            if name in listed:
                continue
            chaincodes.append({"name": name, "version": version, "escc": "escc", "vscc": "vscc"})
        return success(wire.encode(fabric.CHAINCODE_QUERY_RESPONSE, {"chaincodes": chaincodes}))

    def _get_cc(self, stub: ChaincodeStub, fname: str, args) -> Response:
        if len(args) < 3:
            return error_response(f"Incorrect number of arguments, {len(args)}")
        name = args[2].decode()
        raw = stub.get_state(name)
        if raw is not None:
            if fname == GET_CC_DATA:
                return success(raw)  # ChaincodeData bytes, as lscc.go returns
            cd = _chaincode_data(raw)
            info = {"name": cd.get("name", "") or name, "version": cd.get("version", ""),
                    "id": cd.get("id", b"")}
            return success(wire.encode(fabric.CHAINCODE_INFO, info))
        for n, version in self._list_definitions():
            if n == name:
                if fname == GET_CC_DATA:
                    return success(wire.encode(fabric.CHAINCODE_DATA, {
                        "name": n, "version": version, "escc": "escc", "vscc": "vscc"}))
                return success(wire.encode(fabric.CHAINCODE_INFO,
                                           {"name": n, "version": version}))
        return error_response(f"chaincode {name} not found")
