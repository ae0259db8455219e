"""External chaincode-side shim: connect to the peer, REGISTER, serve
transactions (reference fabric-chaincode-go shim.Start + the handler's
chat protocol, run from the chaincode process).

Usage from a packaged chaincode's entry point:

    from fabric_tpu_torch.chaincode import extshim
    extshim.start(MyChaincode(), peer_address, chaincode_id)

The port's counterpart of the JAX package's `chaincode/extshim.py`: the
stream's messages are dicts under `protos/chaincode.py`'s schemas, byte for
byte what the JAX shim sends, so a port chaincode serves a JAX peer and the
reverse. It imports no torch. Departure: `CcaasServer.stop()` and
`_Session.stop()` join the session's reader and transaction threads with no
time limit (the JAX ones wait 2 s for the reader and not for a transaction).
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Iterator, List, Optional, Tuple

from fabric_tpu_torch.chaincode.shim import Response, error_response
from fabric_tpu_torch.comm.server import channel_to, wire_codec
from fabric_tpu_torch.protos import chaincode as ccm
from fabric_tpu_torch.protos import fabric, wire

CCM_CODEC = wire_codec(ccm.CHAINCODE_MESSAGE)


def _rows(raw: bytes) -> list:
    resp = wire.decode(ccm.QUERY_RESPONSE, raw)
    out = []
    for r in resp.get("results", []):
        doc = json.loads(r.get("resultBytes", b""))
        out.append((doc["key"], doc["value"].encode()))
    return out


class ShimError(Exception):
    pass


class ProxyStub:
    """The chaincode-side stub: every state access is a stream round-trip
    (GET_STATE -> RESPONSE), mirroring the reference shim handler."""

    def __init__(self, session: "_Session", tx_id: str, channel_id: str, args: List[bytes]):
        self._session = session
        self.tx_id = tx_id
        self.channel_id = channel_id
        self._args = args
        self._event: Optional[dict] = None

    # -- args ------------------------------------------------------------
    def get_args(self) -> List[bytes]:
        return list(self._args)

    def get_function_and_parameters(self) -> Tuple[str, List[str]]:
        args = self.get_args()
        if not args:
            return "", []
        return args[0].decode(), [a.decode() for a in args[1:]]

    # -- state round-trips -------------------------------------------------
    def _roundtrip(self, mtype, payload: bytes) -> bytes:
        return self._session.roundtrip(self, mtype, payload)

    def get_state(self, key: str) -> Optional[bytes]:
        out = self._roundtrip(ccm.GET_STATE, wire.encode(ccm.GET_STATE_MSG, {"key": key}))
        return out or None

    def put_state(self, key: str, value: bytes) -> None:
        self._roundtrip(ccm.PUT_STATE, wire.encode(ccm.PUT_STATE_MSG, {"key": key, "value": value}))

    def del_state(self, key: str) -> None:
        self._roundtrip(ccm.DEL_STATE, wire.encode(ccm.DEL_STATE_MSG, {"key": key}))

    def get_private_data(self, collection: str, key: str) -> Optional[bytes]:
        out = self._roundtrip(ccm.GET_STATE, wire.encode(
            ccm.GET_STATE_MSG, {"key": key, "collection": collection}))
        return out or None

    def put_private_data(self, collection: str, key: str, value: bytes) -> None:
        self._roundtrip(ccm.PUT_STATE, wire.encode(
            ccm.PUT_STATE_MSG, {"key": key, "value": value, "collection": collection}))

    def get_state_by_range(self, start: str, end: str):
        raw = self._roundtrip(ccm.GET_STATE_BY_RANGE, wire.encode(
            ccm.GET_STATE_BY_RANGE_MSG, {"startKey": start, "endKey": end}))
        return iter(_rows(raw))

    def get_query_result(self, query) -> Iterator[Tuple[str, bytes]]:
        q = query if isinstance(query, str) else json.dumps(query)
        raw = self._roundtrip(ccm.GET_QUERY_RESULT, wire.encode(ccm.GET_QUERY_RESULT_MSG, {"query": q}))
        return iter(_rows(raw))

    def _paginated(self, msg_type, schema, req: dict, page_size: int, bookmark: str):
        if page_size <= 0:
            # QueryMetadata(0, "") serializes to zero bytes, which the
            # server would read as "not paginated" — reject here so both
            # deployment modes behave like the in-process shim
            raise ValueError("pageSize must be a positive integer")
        req["metadata"] = wire.encode(ccm.QUERY_METADATA, {"pageSize": page_size, "bookmark": bookmark})
        raw = self._roundtrip(msg_type, wire.encode(schema, req))
        resp = wire.decode(ccm.QUERY_RESPONSE, raw)
        rm = wire.decode(ccm.QUERY_RESPONSE_METADATA, resp.get("metadata", b""))
        return _rows(raw), rm.get("bookmark", "")

    def get_state_by_range_with_pagination(
        self, start: str, end: str, page_size: int, bookmark: str = ""
    ):
        return self._paginated(ccm.GET_STATE_BY_RANGE, ccm.GET_STATE_BY_RANGE_MSG,
                               {"startKey": start, "endKey": end}, page_size, bookmark)

    def get_query_result_with_pagination(
        self, query, page_size: int, bookmark: str = ""
    ):
        q = query if isinstance(query, str) else json.dumps(query)
        return self._paginated(ccm.GET_QUERY_RESULT, ccm.GET_QUERY_RESULT_MSG,
                               {"query": q}, page_size, bookmark)

    def set_event(self, name: str, payload: bytes) -> None:
        self._event = {"event_name": name, "payload": payload}


class _Session:
    """One Register stream connection."""

    def __init__(
        self,
        chaincode,
        peer_address: Optional[str],
        chaincode_id: str,
        root_ca=None,
    ):
        self.chaincode = chaincode
        self.chaincode_id = chaincode_id
        self.out_q: "queue.Queue[Optional[dict]]" = queue.Queue()
        self.resp_q: "queue.Queue[dict]" = queue.Queue()
        # ccaas mode serves instead of dialing: no peer channel
        self.channel = (
            channel_to(peer_address, root_ca) if peer_address else None
        )
        self.ready = threading.Event()
        self.stopped = threading.Event()
        # the serve thread when start(block=False) spawned one; stop()
        # reaps it so a torn-down session leaves no reader behind
        self._thread: Optional[threading.Thread] = None
        self._tx_threads: List[threading.Thread] = []

    def _gen(self):
        yield {"type": ccm.REGISTER,
               "payload": wire.encode(fabric.CHAINCODE_ID, {"name": self.chaincode_id})}
        while True:
            msg = self.out_q.get()
            if msg is None:
                return
            yield msg

    def roundtrip(self, stub: ProxyStub, mtype, payload: bytes) -> bytes:
        self.out_q.put({"type": mtype, "payload": payload, "txid": stub.tx_id,
                        "channel_id": stub.channel_id})
        reply = self.resp_q.get(timeout=30.0)
        if reply.get("type", 0) == ccm.ERROR:
            raise ShimError(reply.get("payload", b"").decode("utf-8", "replace"))
        return reply.get("payload", b"")

    def _run_tx(self, msg: dict) -> None:
        inp = wire.decode(fabric.CHAINCODE_INPUT, msg.get("payload", b""))
        txid, channel_id = msg.get("txid", ""), msg.get("channel_id", "")
        stub = ProxyStub(self, txid, channel_id, list(inp.get("args", [])))
        try:
            if msg.get("type", 0) == ccm.INIT:
                resp = self.chaincode.init(stub)
            else:
                resp = self.chaincode.invoke(stub)
            if not isinstance(resp, Response):
                resp = error_response("chaincode returned no Response")
        except Exception as exc:  # noqa: BLE001 - user chaincode panic
            resp = error_response(f"chaincode failed: {exc}")
        out = {
            "type": ccm.COMPLETED,
            "payload": wire.encode(fabric.RESPONSE, {"status": resp.status,
                                                     "message": resp.message,
                                                     "payload": resp.payload}),
            "txid": txid,
            "channel_id": channel_id,
        }
        if stub._event is not None:
            out["chaincode_event"] = stub._event
        self.out_q.put(out)

    def _dispatch(self, msg: dict) -> None:
        """One peer->chaincode message (shared by the dial-out Register
        stream and the chaincode-as-a-service Connect stream — the
        protocol is identical, only the transport direction flips)."""
        mtype = msg.get("type", 0)
        if mtype == ccm.REGISTERED:
            return
        if mtype == ccm.READY:
            self.ready.set()
            return
        if mtype in (ccm.INIT, ccm.TRANSACTION):
            t = threading.Thread(target=self._run_tx, args=(msg,), daemon=True)
            self._tx_threads = [x for x in self._tx_threads if x.is_alive()] + [t]
            t.start()
        elif mtype in (ccm.RESPONSE, ccm.ERROR):
            self.resp_q.put(msg)

    def serve(self) -> None:
        try:
            stream = self.channel.stream_stream(
                "/protos.ChaincodeSupport/Register",
                request_serializer=CCM_CODEC[1],
                response_deserializer=CCM_CODEC[0],
            )(self._gen())
            for msg in stream:
                self._dispatch(msg)
                if self.stopped.is_set():
                    break
        except Exception:
            # stop() closes the channel under the reader: the resulting
            # CANCELLED is the teardown handshake, not an error — but a
            # live session's stream failure must stay loud
            if not self.stopped.is_set():
                raise

    def stop(self) -> None:
        self.stopped.set()
        self.out_q.put(None)
        if self.channel is not None:
            self.channel.close()
        for _ in self._tx_threads:  # a transaction waiting on a reply ends
            self.resp_q.put({"type": ccm.ERROR, "payload": b"session stopped"})
        for t in [self._thread, *self._tx_threads]:
            if t is not None and t is not threading.current_thread():
                t.join()


class CcaasServer:
    """Chaincode-as-a-service: the chaincode HOSTS `protos.Chaincode/
    Connect` and the PEER dials in (reference fabric-chaincode-go
    shim.ChaincodeServer; ccaas external builder). The message protocol
    is byte-identical to the Register stream — REGISTER first from the
    chaincode side, then the normal chat — only who dials whom flips."""

    def __init__(self, chaincode, chaincode_id: str, listen_address: str = "127.0.0.1:0"):
        from fabric_tpu_torch.comm.server import STREAM_STREAM, GRPCServer

        self.chaincode = chaincode
        self.chaincode_id = chaincode_id
        self._sessions: List[_Session] = []
        # appended by gRPC handler threads, pruned by per-session read
        # threads, iterated by stop() (fabdep unguarded-shared-write):
        # an unlocked remove during stop()'s iteration silently skips a
        # session, leaving its reader thread alive after shutdown
        self._sessions_lock = threading.Lock()
        self.server = GRPCServer(listen_address)
        self.server.register(
            "protos.Chaincode",
            {
                "Connect": (STREAM_STREAM, self._connect, CCM_CODEC[0], CCM_CODEC[1])
            },
        )

    def _connect(self, request_iterator, context):
        session = _Session(self.chaincode, None, self.chaincode_id)
        with self._sessions_lock:
            self._sessions.append(session)

        def read_loop():
            try:
                for msg in request_iterator:
                    session._dispatch(msg)
            except Exception:  # noqa: BLE001 - peer went away
                pass
            finally:
                session.stopped.set()
                session.out_q.put(None)
                # finished sessions leave the registry (a reconnecting
                # peer must not accumulate dead queues for the process
                # lifetime)
                with self._sessions_lock:
                    try:
                        self._sessions.remove(session)
                    except ValueError:
                        pass

        rt = threading.Thread(
            target=read_loop, name=f"ccaas-read-{self.chaincode_id}", daemon=True
        )
        session._thread = rt  # session.stop() reaps its reader
        rt.start()
        # response stream: REGISTER first, then the session's replies
        yield from session._gen()

    def start(self) -> str:
        return self.server.start()

    def stop(self) -> None:
        with self._sessions_lock:
            sessions = list(self._sessions)
        for s in sessions:
            s.stop()
        self.server.stop()

    @property
    def addr(self) -> str:
        return self.server.addr


def start(
    chaincode,
    peer_address: str,
    chaincode_id: str,
    block: bool = True,
    root_ca=None,
) -> Optional[_Session]:
    """Connect to the peer's chaincode listener and serve transactions.
    With block=False, serves on a daemon thread and returns the session."""
    session = _Session(chaincode, peer_address, chaincode_id, root_ca)
    if block:
        session.serve()
        return None
    t = threading.Thread(
        target=session.serve, name=f"ccshim-{chaincode_id}", daemon=True
    )
    session._thread = t
    t.start()
    return session
