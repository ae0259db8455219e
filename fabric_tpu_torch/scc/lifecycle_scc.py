"""_lifecycle — chaincode lifecycle system chaincode endpoint (reference
core/chaincode/lifecycle/scc.go; the install/approve half that talks to
the peer's local package store — the org-scoped state the reference keeps
in implicit collections lives peer-locally here).

Functions (argument encodings simplified to JSON/bytes; the governance
semantics — sequence checks, approvals, commit readiness — live in
the lifecycle package):

  InstallChaincode            args[1] = package tar.gz -> package-id
  QueryInstalledChaincodes    -> JSON [{package_id, label}]
  ApproveChaincodeDefinitionForOrg
                              args[1] = JSON {channel, name, package_id}
  GetInstalledChaincodePackage args[1] = package-id -> package bytes

The port's counterpart of the JAX package's `scc/lifecycle_scc.py`; the
definitions it serves come from the port's `lifecycle/lifecycle.py`.
"""

from __future__ import annotations

import json
from typing import Callable

from fabric_tpu_torch.chaincode.shim import ChaincodeStub, Response, error_response, success

INSTALL = "InstallChaincode"
QUERY_INSTALLED = "QueryInstalledChaincodes"
APPROVE = "ApproveChaincodeDefinitionForOrg"
GET_PACKAGE = "GetInstalledChaincodePackage"


class LifecycleSCC:
    def __init__(
        self,
        install: Callable[[bytes], str],
        list_installed: Callable[[], list],
        approve: Callable[[str, str, str], None],
        load_package: Callable[[str], bytes],
    ):
        self._install = install
        self._list = list_installed
        self._approve = approve
        self._load = load_package

    def init(self, stub: ChaincodeStub) -> Response:
        return success()

    def invoke(self, stub: ChaincodeStub) -> Response:
        args = stub.get_args()
        if not args:
            return error_response("lifecycle scc: no function")
        fname = args[0].decode()
        try:
            if fname == INSTALL:
                if len(args) < 2:
                    return error_response("missing chaincode package")
                return success(self._install(args[1]).encode())
            if fname == QUERY_INSTALLED:
                out = [
                    {"package_id": p.package_id, "label": p.label}
                    for p in self._list()
                ]
                return success(json.dumps(out, sort_keys=True).encode())
            if fname == APPROVE:
                if len(args) < 2:
                    return error_response("missing approval request")
                req = json.loads(args[1])
                self._approve(
                    req.get("channel", ""), req["name"], req["package_id"]
                )
                return success()
            if fname == GET_PACKAGE:
                if len(args) < 2:
                    return error_response("missing package id")
                return success(self._load(args[1].decode()))
        except Exception as exc:  # noqa: BLE001 - scc failures become 500s
            return error_response(f"{fname} failed: {exc}")
        return error_response(f"unknown lifecycle function {fname!r}")
