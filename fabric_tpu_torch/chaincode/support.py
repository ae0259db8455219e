"""Chaincode execution support (reference core/chaincode/
chaincode_support.go + handler.go + the launch registry).

The reference launches chaincode containers lazily and multiplexes tx
executions over each chaincode's gRPC stream; system chaincodes run
in-process over inprocstream (core/scc/inprocstream.go). Here every
registered chaincode executes in-process against the tx's simulator, and
cc2cc calls (handler.go handleInvokeChaincode) share the caller's
simulator in the same channel or get a read-only snapshot of another
channel's state.

The port's counterpart of the JAX package's `chaincode/support.py`. The
out-of-process runtime (`_resolve_external`, `_connect_ccaas`) works against
any `listener` and `launcher` with the JAX package's duck-typed surface.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from fabric_tpu_torch.chaincode.package import PackageError, parse_package
from fabric_tpu_torch.chaincode.shim import (
    Chaincode,
    ChaincodeStub,
    Response,
    error_response,
)
from fabric_tpu_torch.ledger.simulator import TxSimulator


def _parse_go_duration(value, default: float) -> float:
    """Go duration string ("10s", "500ms", "1m30s") -> seconds; the
    reference ccaas builder's connection.json uses this format. Falls
    back to `default` only for absent/empty values; a malformed string
    also defaults (matching the builder's lenient parse) but never
    silently truncates a valid unit."""
    if not value or not isinstance(value, str):
        return default
    import re

    units = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001, "us": 1e-6}
    # longest units first: "m" before "ms" would split "500ms" wrong
    parts = re.findall(r"(\d+(?:\.\d+)?)(ms|us|h|m|s)", value)
    if not parts or "".join(n + u for n, u in parts) != value:
        return default
    return sum(float(n) * units[u] for n, u in parts)


class LaunchError(Exception):
    pass


@dataclass
class TxParams:
    """Per-execution context (reference ccprovider.TxParams)."""

    channel_id: str
    tx_id: str
    simulator: TxSimulator
    creator: bytes = b""
    transient: Optional[Dict[str, bytes]] = None


class ChaincodeSupport:
    """Registry + executor. ``state_getter(channel_id)`` resolves another
    channel's committed-state DB for cross-channel cc2cc reads."""

    def __init__(
        self,
        state_getter: Optional[Callable[[str], object]] = None,
        listener=None,  # extserver.ChaincodeListener (peer's cc endpoint)
        launcher=None,  # extbuilder.Launcher (subprocess runner)
        package_store=None,  # package.PackageStore (installed tgz's)
        source_resolver: Optional[Callable[[str, str], Optional[str]]] = None,
        chaincode_address: Optional[Callable[[], str]] = None,
    ):
        self._chaincodes: Dict[str, Chaincode] = {}
        self._system: Dict[str, bool] = {}
        self._state_getter = state_getter
        # out-of-process runtime (reference container.Router +
        # chaincode_support.go Launch): resolve name -> package-id via
        # the channel's lifecycle, launch the installed package as a
        # subprocess if it is not already connected, then execute over
        # its shim stream.
        self.listener = listener
        self.launcher = launcher
        self.package_store = package_store
        self._source_resolver = source_resolver
        self._chaincode_address = chaincode_address

    def register(
        self, name: str, chaincode: Chaincode, system: bool = False
    ) -> None:
        """Launch analog: a registered chaincode is a running one."""
        if name in self._chaincodes:
            raise LaunchError(f"chaincode {name} already registered")
        self._chaincodes[name] = chaincode
        self._system[name] = system

    def is_system_chaincode(self, name: str) -> bool:
        return self._system.get(name, False)

    def launched(self, name: str) -> bool:
        return name in self._chaincodes

    def execute(
        self,
        tx_params: TxParams,
        name: str,
        args: List[bytes],
        is_init: bool = False,
    ) -> Tuple[Response, Optional[dict]]:
        """ChaincodeSupport.Execute: run one invocation, return the
        chaincode Response plus its ChaincodeEvent message (at most one per
        tx)."""
        cc = self._chaincodes.get(name)
        if cc is None:
            cc = self._resolve_external(tx_params.channel_id, name)
        if cc is None:
            raise LaunchError(f"chaincode {name} is not installed/launched")
        stub = ChaincodeStub(
            namespace=name,
            channel_id=tx_params.channel_id,
            tx_id=tx_params.tx_id,
            args=args,
            simulator=tx_params.simulator,
            creator=tx_params.creator,
            transient=tx_params.transient,
            support=self,
        )
        try:
            resp = cc.init(stub) if is_init else cc.invoke(stub)
        except Exception as exc:  # noqa: BLE001 - chaincode panic analog
            return error_response(f"chaincode {name} failed: {exc}"), None
        if not isinstance(resp, Response):
            return error_response(f"chaincode {name} returned no Response"), None
        return resp, stub.chaincode_event

    def _resolve_external(self, channel_id: str, name: str):
        """Out-of-process path: lifecycle package-id -> ensure launched ->
        shim-stream adapter (chaincode_support.go Launch)."""
        if self.listener is None:
            return None
        pid = None
        if self._source_resolver is not None:
            pid = self._source_resolver(channel_id, name)
        if pid is None:
            # a pre-connected chaincode-as-external-service registered
            # under its plain name (extcc analog)
            if self.listener.connected(name):
                return self.listener.chaincode(name)
            return None
        if not self.listener.connected(pid):
            if self.launcher is None or self.package_store is None:
                return None
            try:
                installed = next(
                    p
                    for p in self.package_store.list_installed()
                    if p.package_id == pid
                )
            except (StopIteration, PackageError):
                raise LaunchError(
                    f"chaincode {name} package {pid} is not installed"
                )
            if installed.cc_type == "ccaas":
                # chaincode-as-a-service (reference ccaas builder): the
                # package carries connection.json and the PEER dials the
                # already-running chaincode server
                self._connect_ccaas(installed, pid)
            else:
                addr = (
                    self._chaincode_address()
                    if self._chaincode_address is not None
                    else None
                )
                if addr is None:
                    raise LaunchError("no chaincode listener address")
                self.launcher.launch(installed, addr)
            if not self.listener.wait_for(pid, timeout=20.0):
                raise LaunchError(
                    f"chaincode {name} ({pid}) did not register in time"
                )
        return self.listener.chaincode(pid)

    def _connect_ccaas(self, installed, pid: str) -> None:
        import json as _json

        with open(installed.path, "rb") as f:
            _meta, files = parse_package(f.read())
        raw = files.get("connection.json") or files.get("src/connection.json")
        if raw is None:
            raise LaunchError(
                f"ccaas package {pid} has no connection.json"
            )
        try:
            conn_cfg = _json.loads(raw)
            address = conn_cfg["address"]
        except (ValueError, KeyError) as exc:
            raise LaunchError(
                f"ccaas package {pid}: bad connection.json: {exc}"
            ) from exc
        timeout = _parse_go_duration(conn_cfg.get("dial_timeout"), 10.0)
        # reference ccaas schema: tls_required + PEM root_cert
        root_ca = None
        if conn_cfg.get("tls_required"):
            pem = conn_cfg.get("root_cert", "")
            if not pem:
                raise LaunchError(
                    f"ccaas {pid}: tls_required without root_cert"
                )
            root_ca = pem.encode() if isinstance(pem, str) else pem
        try:
            self.listener.connect_ccaas(
                address, timeout=timeout, root_ca=root_ca, expected_name=pid
            )
        except Exception as exc:  # noqa: BLE001 - dial/handshake failure
            raise LaunchError(
                f"ccaas {pid}: cannot connect to {address}: {exc}"
            ) from exc

    def invoke_cc2cc(
        self,
        caller_stub: ChaincodeStub,
        name: str,
        args: List[bytes],
        channel: str = "",
    ) -> Response:
        cc = self._chaincodes.get(name)
        if cc is None:
            try:
                cc = self._resolve_external(
                    channel or caller_stub.channel_id, name
                )
            except LaunchError:
                cc = None
        if cc is None:
            return error_response(f"chaincode {name} is not installed/launched")
        same_channel = not channel or channel == caller_stub.channel_id
        if same_channel:
            sim = caller_stub._sim
        else:
            if self._state_getter is None:
                return error_response(
                    "cross-channel invocation requires a state getter"
                )
            other_db = self._state_getter(channel)
            if other_db is None:
                return error_response(f"channel {channel} not found")
            # Read-only: a throwaway simulator whose results are discarded
            # (handler.go: cross-channel cc2cc rwset is not recorded).
            sim = TxSimulator(other_db, tx_id=caller_stub.tx_id)
        stub = ChaincodeStub(
            namespace=name,
            channel_id=channel or caller_stub.channel_id,
            tx_id=caller_stub.tx_id,
            args=args,
            simulator=sim,
            creator=caller_stub.get_creator(),
            transient=caller_stub.get_transient(),
            support=self,
        )
        try:
            return cc.invoke(stub)
        except Exception as exc:  # noqa: BLE001
            return error_response(f"chaincode {name} failed: {exc}")
