"""Chaincode programming interface (reference fabric-chaincode-go shim +
core/chaincode/handler.go message loop).

The reference runs chaincode out-of-process behind a gRPC bidi stream;
every GetState/PutState is a stream round-trip handled by
core/chaincode/handler.go (GET_STATE/PUT_STATE/... messages) that calls
back into the tx's simulator. Here the stub calls the simulator directly
— same state semantics, no serialization tax — and the out-of-process
path is provided by the external chaincode server (extcc analog) which
speaks the same stub API over a socket.

A chaincode is any object with ``init(stub) -> Response`` and
``invoke(stub) -> Response``.

The port's counterpart of the JAX package's `chaincode/shim.py`; a
chaincode event is a `ChaincodeEvent` message dict (`protos/fabric.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Protocol, Tuple

from fabric_tpu_torch.ledger.mvcc import deserialize_metadata
from fabric_tpu_torch.ledger.simulator import (
    TxSimulator,
    create_composite_key,
    split_composite_key,
)

OK = 200
ERROR = 500


@dataclass
class Response:
    status: int
    message: str = ""
    payload: bytes = b""


def success(payload: bytes = b"") -> Response:
    return Response(OK, "", payload)


def error_response(message: str) -> Response:
    return Response(ERROR, message)


class Chaincode(Protocol):
    def init(self, stub: "ChaincodeStub") -> Response: ...

    def invoke(self, stub: "ChaincodeStub") -> Response: ...


class ChaincodeStub:
    """Per-invocation API surface (shim.ChaincodeStubInterface)."""

    def __init__(
        self,
        namespace: str,
        channel_id: str,
        tx_id: str,
        args: List[bytes],
        simulator: TxSimulator,
        creator: bytes = b"",
        transient: Optional[Dict[str, bytes]] = None,
        support: Optional["object"] = None,  # ChaincodeSupport, for cc2cc
    ):
        self._ns = namespace
        self.channel_id = channel_id
        self.tx_id = tx_id
        self._args = args
        self._sim = simulator
        self._creator = creator
        self._transient = dict(transient or {})
        self._support = support
        self._event: Optional[dict] = None

    # -- invocation context --
    def get_args(self) -> List[bytes]:
        return list(self._args)

    def get_function_and_parameters(self) -> Tuple[str, List[str]]:
        if not self._args:
            return "", []
        return self._args[0].decode(), [a.decode() for a in self._args[1:]]

    def get_creator(self) -> bytes:
        return self._creator

    def get_transient(self) -> Dict[str, bytes]:
        return dict(self._transient)

    # -- world state --
    def get_state(self, key: str) -> Optional[bytes]:
        return self._sim.get_state(self._ns, key)

    def put_state(self, key: str, value: bytes) -> None:
        self._sim.set_state(self._ns, key, value)

    def del_state(self, key: str) -> None:
        self._sim.delete_state(self._ns, key)

    def get_state_by_range(
        self, start_key: str, end_key: str
    ) -> Iterator[Tuple[str, bytes]]:
        return self._sim.get_state_range_scan_iterator(
            self._ns, start_key, end_key
        )

    def get_state_by_partial_composite_key(
        self, object_type: str, attributes: List[str]
    ) -> Iterator[Tuple[str, bytes]]:
        start = create_composite_key(object_type, attributes)
        return self._sim.get_state_range_scan_iterator(
            self._ns, start, start + "\U0010ffff"
        )

    def get_query_result(self, query) -> Iterator[Tuple[str, bytes]]:
        """Rich selector query over this namespace's JSON state
        (reference shim GetQueryResult -> statecouchdb.go:695; not
        phantom-protected, like the reference)."""
        return iter(self._sim.execute_query(self._ns, query))

    def get_query_result_with_pagination(
        self, query, page_size: int, bookmark: str = ""
    ) -> Tuple[List[Tuple[str, bytes]], str]:
        """Shim GetQueryResultWithPagination: (page, next bookmark);
        read-only transactions only (simulator enforces)."""
        return self._sim.execute_query_with_pagination(
            self._ns, query, page_size, bookmark
        )

    def get_state_by_range_with_pagination(
        self, start_key: str, end_key: str, page_size: int, bookmark: str = ""
    ) -> Tuple[List[Tuple[str, bytes]], str]:
        """Shim GetStateByRangeWithPagination: bookmark = next key."""
        return self._sim.get_state_range_with_pagination(
            self._ns, start_key, end_key, page_size, bookmark
        )

    # -- key-level endorsement (SBE) --
    def set_state_validation_parameter(self, key: str, policy: bytes) -> None:
        self._sim.set_state_metadata(
            self._ns, key, {"VALIDATION_PARAMETER": policy}
        )

    def get_state_validation_parameter(self, key: str) -> Optional[bytes]:
        meta = deserialize_metadata(self._sim.get_state_metadata(self._ns, key))
        if not meta:
            return None
        return meta.get("VALIDATION_PARAMETER")

    # -- private data --
    def get_private_data(self, collection: str, key: str) -> Optional[bytes]:
        return self._sim.get_private_data(self._ns, collection, key)

    def get_private_data_hash(self, collection: str, key: str) -> Optional[bytes]:
        return self._sim.get_private_data_hash(self._ns, collection, key)

    def put_private_data(self, collection: str, key: str, value: bytes) -> None:
        self._sim.set_private_data(self._ns, collection, key, value)

    def del_private_data(self, collection: str, key: str) -> None:
        self._sim.delete_private_data(self._ns, collection, key)

    # -- composite keys --
    def create_composite_key(self, object_type: str, attributes: List[str]) -> str:
        return create_composite_key(object_type, attributes)

    def split_composite_key(self, key: str) -> Tuple[str, List[str]]:
        return split_composite_key(key)

    # -- events --
    def set_event(self, name: str, payload: bytes) -> None:
        if not name:
            raise ValueError("event name cannot be empty")
        self._event = {"chaincode_id": self._ns, "tx_id": self.tx_id,
                       "event_name": name, "payload": payload}

    @property
    def chaincode_event(self) -> Optional[dict]:
        """The ChaincodeEvent message the invocation set, if any."""
        return self._event

    # -- chaincode-to-chaincode --
    def invoke_chaincode(
        self, chaincode_name: str, args: List[bytes], channel: str = ""
    ) -> Response:
        """Same-channel cc2cc shares this tx's simulator (writes merge into
        one rwset under the callee's namespace); cross-channel calls are
        read-only against the other channel per the reference's rule
        (handler.go handleInvokeChaincode)."""
        if self._support is None:
            return error_response("chaincode support not wired for cc2cc")
        return self._support.invoke_cc2cc(self, chaincode_name, args, channel)
