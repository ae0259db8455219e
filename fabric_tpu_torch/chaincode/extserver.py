"""Peer-side external chaincode runtime (reference core/chaincode/
handler.go message loop + chaincode_support.go Launch/Execute, with the
chaincode running OUT of process and connecting back over gRPC).

An external chaincode process opens the `protos.ChaincodeSupport/Register`
bidi stream, REGISTERs with its package-id, and then serves transactions:
the peer sends INIT/TRANSACTION, the chaincode answers with state-access
messages (GET_STATE/PUT_STATE/... — each applied to the executing tx's
simulator, exactly where the reference's handler.go calls back into the
ledger) and finishes with COMPLETED carrying its Response.

The port's counterpart of the JAX package's `chaincode/extserver.py`: the
stream's messages are dicts under `protos/chaincode.py`'s schemas, carried
by the wire codec (`comm/server.wire_codec`), and byte for byte what the
JAX peer sends; the stub is the port's `chaincode/shim.ChaincodeStub`. The
port's `ChaincodeSupport` takes a listener as its `listener=`. Departure:
`ChaincodeListener.stop()` ends every stream (the JAX listener has no stop),
so a node that stops leaves no reader thread behind.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Dict, Iterator, Optional

from fabric_tpu_torch.chaincode.shim import ERROR, Response, error_response
from fabric_tpu_torch.comm.server import STREAM_STREAM, GRPCServer, wire_codec
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.protos import chaincode as ccm
from fabric_tpu_torch.protos import fabric, wire

logger = must_get_logger("chaincode.extserver")

SERVICE_NAME = "protos.ChaincodeSupport"
CCM_CODEC = wire_codec(ccm.CHAINCODE_MESSAGE)


def _rows(rows) -> list:
    return [{"resultBytes": json.dumps(
        {"key": key, "value": value.decode("utf-8", "replace")}).encode()}
        for key, value in rows]


class ExternalChaincodeError(Exception):
    pass


class _StreamHandler:
    """One connected chaincode process."""

    def __init__(self, name: str):
        self.name = name
        self.out_q: "queue.Queue[Optional[dict]]" = queue.Queue()
        # one transaction at a time per chaincode stream; the reference
        # multiplexes by txid, the serialization keeps bookkeeping simple
        self._tx_lock = threading.Lock()
        self._stub = None
        self._done: "queue.Queue[dict]" = queue.Queue()
        self.closed = threading.Event()
        self.cancel = None  # a dialed (ccaas) stream's cancel, for stop()

    # -- peer -> chaincode -----------------------------------------------
    def execute(self, stub, args, is_init: bool, timeout: float = 60.0) -> Response:
        if self.closed.is_set():
            return error_response(f"chaincode {self.name} disconnected")
        with self._tx_lock:
            self._stub = stub
            msg = {
                "type": ccm.INIT if is_init else ccm.TRANSACTION,
                "payload": wire.encode(fabric.CHAINCODE_INPUT, {"args": list(args)}),
                "txid": stub.tx_id,
                "channel_id": stub.channel_id,
            }
            self.out_q.put(msg)
            try:
                final = self._done.get(timeout=timeout)
            except queue.Empty:
                self.closed.set()
                return error_response(f"chaincode {self.name} timed out")
            finally:
                self._stub = None
            if final.get("type", 0) == ccm.ERROR:
                return Response(ERROR, final.get("payload", b"").decode("utf-8", "replace"), b"")
            resp = wire.decode(fabric.RESPONSE, final.get("payload", b""))
            out = Response(resp.get("status", 0), resp.get("message", ""),
                           resp.get("payload", b""))
            if "chaincode_event" in final:
                event = final["chaincode_event"]
                stub.set_event(event.get("event_name", ""), event.get("payload", b""))
            return out

    # -- chaincode -> peer (the handler.go message loop) -------------------
    def on_message(self, msg: dict) -> None:
        mtype = msg.get("type", 0)
        if mtype in (ccm.COMPLETED, ccm.ERROR):
            self._done.put(msg)
            return
        if mtype == ccm.KEEPALIVE:
            return
        stub = self._stub
        txid = msg.get("txid", "")
        reply = {"txid": txid, "channel_id": msg.get("channel_id", "")}
        if stub is None or txid != stub.tx_id:
            reply["type"] = ccm.ERROR
            reply["payload"] = b"no transaction in flight"
            self.out_q.put(reply)
            return
        try:
            reply["payload"] = self._handle_state_op(stub, msg)
            reply["type"] = ccm.RESPONSE
        except Exception as exc:  # noqa: BLE001 - simulator errors -> shim error
            reply["type"] = ccm.ERROR
            reply["payload"] = str(exc).encode()
        self.out_q.put(reply)

    def _handle_state_op(self, stub, msg: dict) -> bytes:
        t = msg.get("type", 0)
        payload = msg.get("payload", b"")
        if t == ccm.GET_STATE:
            req = wire.decode(ccm.GET_STATE_MSG, payload)
            if req.get("collection"):
                value = stub.get_private_data(req["collection"], req.get("key", ""))
            else:
                value = stub.get_state(req.get("key", ""))
            return value or b""
        if t == ccm.GET_PRIVATE_DATA_HASH:
            req = wire.decode(ccm.GET_STATE_MSG, payload)
            return stub.get_private_data_hash(req.get("collection", ""), req.get("key", "")) or b""
        if t == ccm.PUT_STATE:
            req = wire.decode(ccm.PUT_STATE_MSG, payload)
            if req.get("collection"):
                stub.put_private_data(req["collection"], req.get("key", ""), req.get("value", b""))
            else:
                stub.put_state(req.get("key", ""), req.get("value", b""))
            return b""
        if t == ccm.DEL_STATE:
            req = wire.decode(ccm.DEL_STATE_MSG, payload)
            if req.get("collection"):
                stub.del_private_data(req["collection"], req.get("key", ""))
            else:
                stub.del_state(req.get("key", ""))
            return b""
        if t in (ccm.GET_STATE_BY_RANGE, ccm.GET_QUERY_RESULT):
            by_range = t == ccm.GET_STATE_BY_RANGE
            req = wire.decode(ccm.GET_STATE_BY_RANGE_MSG if by_range else ccm.GET_QUERY_RESULT_MSG,
                              payload)
            out: dict = {}
            if req.get("metadata"):  # paginated form (QueryMetadata present)
                qm = wire.decode(ccm.QUERY_METADATA, req["metadata"])
                page, mark = qm.get("pageSize", 0), qm.get("bookmark", "")
                if by_range:
                    rows, bookmark = stub.get_state_by_range_with_pagination(
                        req.get("startKey", ""), req.get("endKey", ""), page, mark)
                else:
                    rows, bookmark = stub.get_query_result_with_pagination(
                        req.get("query", ""), page, mark)
                out["metadata"] = wire.encode(ccm.QUERY_RESPONSE_METADATA, {
                    "fetched_records_count": len(rows), "bookmark": bookmark})
            elif by_range:
                rows = stub.get_state_by_range(req.get("startKey", ""), req.get("endKey", ""))
            else:
                rows = stub.get_query_result(req.get("query", ""))
            out["results"] = _rows(rows)
            return wire.encode(ccm.QUERY_RESPONSE, out)
        if t == ccm.GET_STATE_METADATA:
            req = wire.decode(ccm.GET_STATE_METADATA_MSG, payload)
            vp = stub.get_state_validation_parameter(req.get("key", ""))
            entries = [] if vp is None else [{"metakey": "VALIDATION_PARAMETER", "value": vp}]
            return wire.encode(ccm.STATE_METADATA_RESULT, {"entries": entries})
        if t == ccm.PUT_STATE_METADATA:
            req = wire.decode(ccm.PUT_STATE_METADATA_MSG, payload)
            stub.set_state_validation_parameter(
                req.get("key", ""), req.get("metadata", {}).get("value", b""))
            return b""
        raise ExternalChaincodeError(f"unsupported shim message type {t}")

    def close(self) -> None:
        self.closed.set()
        self.out_q.put(None)


class ExternalChaincode:
    """Chaincode-protocol adapter over a connected stream handler, so
    ChaincodeSupport.execute treats out-of-process chaincodes uniformly."""

    def __init__(self, handler: _StreamHandler):
        self._handler = handler

    def init(self, stub) -> Response:
        return self._handler.execute(stub, stub.get_args(), is_init=True)

    def invoke(self, stub) -> Response:
        return self._handler.execute(stub, stub.get_args(), is_init=False)


class ChaincodeListener:
    """The peer's chaincode-support gRPC service: accepts Register
    streams from external chaincode processes."""

    def __init__(self):
        self._handlers: Dict[str, _StreamHandler] = {}
        self._cv = threading.Condition()
        self._readers: list = []  # every reader thread, joined by stop()
        self._stopped = False

    def register(self, server: GRPCServer) -> None:
        server.register(
            SERVICE_NAME,
            {
                "Register": (STREAM_STREAM, self._serve, CCM_CODEC[0], CCM_CODEC[1])
            },
        )

    # -- service -----------------------------------------------------------
    def _serve(self, request_iterator, context) -> Iterator[dict]:
        try:
            first = next(request_iterator)
        except StopIteration:
            return
        if first.get("type", 0) != ccm.REGISTER:
            return
        name = wire.decode(fabric.CHAINCODE_ID, first.get("payload", b"")).get("name", "")
        handler = _StreamHandler(name)
        if not self._add(handler, self._read_loop, (handler, request_iterator),
                         f"cc-read-{name}"):
            return
        yield {"type": ccm.REGISTERED}
        yield {"type": ccm.READY}
        while True:
            msg = handler.out_q.get()
            if msg is None:
                return
            yield msg

    def _add(self, handler: _StreamHandler, target, args, thread_name: str) -> bool:
        """Register a connected handler and start its reader; False once
        the listener has stopped."""
        reader = threading.Thread(target=target, args=args, name=thread_name, daemon=True)
        with self._cv:
            if self._stopped:
                return False
            self._handlers[handler.name] = handler
            self._readers.append((reader, handler))
            self._cv.notify_all()
        reader.start()
        return True

    def _read_loop(self, handler: _StreamHandler, request_iterator, on_end=None) -> None:
        try:
            for msg in request_iterator:
                handler.on_message(msg)
        except Exception as exc:
            logger.debug("chaincode stream ended: %s", exc)
        finally:
            handler.close()
            with self._cv:
                if self._handlers.get(handler.name) is handler:
                    del self._handlers[handler.name]
            if on_end is not None:
                on_end()

    # -- chaincode-as-a-service (peer dials the chaincode) -----------------
    def connect_ccaas(
        self,
        address: str,
        timeout: float = 10.0,
        root_ca=None,
        expected_name: Optional[str] = None,
    ) -> str:
        """Dial a chaincode server's `protos.Chaincode/Connect` stream
        (reference ccaas external builder / chaincode_server.go): the
        chaincode sends REGISTER as its first response, then the normal
        chat runs with roles unchanged — only the transport direction is
        reversed.

        `timeout` bounds BOTH channel readiness and the REGISTER
        handshake (a service that accepts the connection but never
        registers must not hang the invoking transaction thread). With
        `expected_name`, the handler registers under that name — the
        lifecycle package-id — regardless of what the server called
        itself (reference convention CORE_CHAINCODE_ID_NAME=package-id),
        so disconnect cleanup removes the right registry entry. The
        channel closes on handshake failure and when the stream dies."""
        import grpc

        from fabric_tpu_torch.comm.server import channel_to

        conn = channel_to(address, root_ca)
        out_q: "queue.Queue[Optional[dict]]" = queue.Queue()

        def outgoing():
            while True:
                m = out_q.get()
                if m is None:
                    return
                yield m

        try:
            grpc.channel_ready_future(conn).result(timeout=timeout)
            responses = conn.stream_stream(
                "/protos.Chaincode/Connect",
                request_serializer=CCM_CODEC[1],
                response_deserializer=CCM_CODEC[0],
            )(outgoing())
            # bounded REGISTER wait: next() has no deadline of its own;
            # stream errors (UNIMPLEMENTED target, reset) surface through
            # the queue too — a fast failure must not become a full-
            # timeout hang with a misleading message
            first_q: "queue.Queue" = queue.Queue()

            def _take_first():
                try:
                    first_q.put(next(iter(responses), None))
                except Exception as exc:  # noqa: BLE001 - RpcError et al.
                    first_q.put(exc)

            poke = threading.Thread(target=_take_first, daemon=True)
            poke.start()
            try:
                first = first_q.get(timeout=timeout)
            except queue.Empty:
                responses.cancel()
                raise ExternalChaincodeError(
                    f"ccaas server at {address}: no REGISTER in {timeout}s"
                )
            finally:
                poke.join()
            if isinstance(first, BaseException):
                raise ExternalChaincodeError(
                    f"ccaas server at {address}: {first}"
                ) from first
            if first is None or first.get("type", 0) != ccm.REGISTER:
                raise ExternalChaincodeError(
                    f"ccaas server at {address} did not REGISTER"
                )
            ccid = wire.decode(fabric.CHAINCODE_ID, first.get("payload", b""))
        except Exception:
            out_q.put(None)
            conn.close()
            raise
        name = expected_name or ccid.get("name", "")
        handler = _StreamHandler(name)
        handler.out_q = out_q  # peer->cc messages ride the request stream
        handler.cancel = responses.cancel
        if not self._add(handler, self._read_loop, (handler, responses, conn.close),
                         f"ccaas-read-{name}"):
            out_q.put(None)
            responses.cancel()
            conn.close()
            raise ExternalChaincodeError("chaincode listener stopped")
        out_q.put({"type": ccm.REGISTERED})
        out_q.put({"type": ccm.READY})
        return name

    # -- lookups -----------------------------------------------------------
    def wait_for(self, name: str, timeout: float = 10.0) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: name in self._handlers, timeout)

    def connected(self, name: str) -> bool:
        with self._cv:
            return name in self._handlers

    def chaincode(self, name: str) -> ExternalChaincode:
        with self._cv:
            handler = self._handlers.get(name)
        if handler is None:
            raise ExternalChaincodeError(f"chaincode {name} is not connected")
        return ExternalChaincode(handler)

    def stop(self) -> None:
        """End every chaincode stream and join its reader."""
        with self._cv:
            self._stopped = True
            readers, self._readers = self._readers, []
        for reader, handler in readers:
            handler.close()
            if handler.cancel is not None:
                handler.cancel()
        for reader, _handler in readers:
            if reader is not threading.current_thread():
                reader.join()
