"""gRPC service adapters: AtomicBroadcast (orderer), Endorser + Deliver
(peer), Snapshot, wired onto the in-process handlers (reference
orderer/common/server/server.go Broadcast/Deliver,
core/peer/deliverevents.go, core/endorser as a gRPC service,
core/ledger/snapshotgrpc).

Service/method names and message framing match fabric-protos, so stock
SDK clients interoperate: /orderer.AtomicBroadcast/{Broadcast,Deliver},
/protos.Endorser/ProcessProposal, /protos.Deliver/{Deliver,
DeliverFiltered, DeliverWithPrivateData}, /protos.Snapshot/{Generate,
Cancel, QueryPendings}.

The port's counterpart of the JAX package's `comm/services.py`: messages are
the port's dicts, read and written by its wire codec (`comm/server.
wire_codec`), and the handlers are the port's `DeliverHandler`,
`BroadcastHandler`, `Endorser` and `SnapshotRequestManager`. An addition:
`DeliverEndpoint`, a deliver stream in the shape `deliver/client.
BlockDeliverer` takes, whose failed or cancelled call ends as the
ConnectionError the deliverer fails over on.
"""

from __future__ import annotations

import threading
from typing import Iterator

import grpc

from fabric_tpu_torch.comm.server import STREAM_STREAM, UNARY, GRPCServer, wire_codec
from fabric_tpu_torch.deliver.server import DeliverHandler, deliver_filtered, deliver_with_pvtdata
from fabric_tpu_torch.policy.manager import SignedData
from fabric_tpu_torch.protos import ab, fabric, protoutil

_ENVELOPE = wire_codec(fabric.ENVELOPE)
_DELIVER_RESPONSE = wire_codec(ab.DELIVER_RESPONSE)
_BROADCAST_RESPONSE = wire_codec(ab.BROADCAST_RESPONSE)
_SIGNED_PROPOSAL = wire_codec(fabric.SIGNED_PROPOSAL)
_PROPOSAL_RESPONSE = wire_codec(fabric.PROPOSAL_RESPONSE)
_SIGNED_SNAPSHOT_REQUEST = wire_codec(fabric.SIGNED_SNAPSHOT_REQUEST)
_EMPTY = wire_codec(fabric.EMPTY)
_PENDINGS = wire_codec(fabric.QUERY_PENDING_SNAPSHOTS_RESPONSE)


def register_atomic_broadcast(
    server: GRPCServer,
    broadcast_handler,  # orderer.broadcast.BroadcastHandler
    deliver_handler: DeliverHandler,
) -> None:
    def broadcast(request_iterator, context) -> Iterator[dict]:
        for env in request_iterator:
            status, info = broadcast_handler.process_message(env)
            yield {"status": status, "info": info}

    def deliver(request_iterator, context) -> Iterator[dict]:
        for env in request_iterator:
            yield from deliver_handler.deliver_blocks(env)

    server.register(
        "orderer.AtomicBroadcast",
        {
            "Broadcast": (STREAM_STREAM, broadcast, _ENVELOPE[0], _BROADCAST_RESPONSE[1]),
            "Deliver": (STREAM_STREAM, deliver, _ENVELOPE[0], _DELIVER_RESPONSE[1]),
        },
    )


def register_endorser(server: GRPCServer, endorser) -> None:
    def process_proposal(request: dict, context):
        return endorser.process_proposal(request)

    server.register(
        "protos.Endorser",
        {"ProcessProposal": (UNARY, process_proposal, _SIGNED_PROPOSAL[0],
                             _PROPOSAL_RESPONSE[1])},
    )


def register_peer_deliver(
    server: GRPCServer,
    deliver_handler: DeliverHandler,
    pvt_entries=None,
    pvt_policy_checker=None,
) -> None:
    """The peer's Deliver service (block + filtered-block +
    block-and-private-data events to SDKs, core/peer/deliverevents.go:239
    and :270).  `pvt_entries(channel_id, block_num) -> [PvtEntry]` backs
    DeliverWithPrivateData; when absent that method serves empty maps.
    `pvt_policy_checker(channel_id, SignedData)` raises to deny access to
    the private-data stream (required signed requests)."""

    def deliver(request_iterator, context):
        for env in request_iterator:
            yield from deliver_handler.deliver_blocks(env)

    def deliver_filtered_rpc(request_iterator, context):
        for env in request_iterator:
            yield from deliver_filtered(deliver_handler, env)

    def deliver_pvt_rpc(request_iterator, context):
        source = pvt_entries or (lambda ch, num: [])
        for env in request_iterator:
            yield from deliver_with_pvtdata(deliver_handler, env, source, pvt_policy_checker)

    server.register(
        "protos.Deliver",
        {
            "Deliver": (STREAM_STREAM, deliver, _ENVELOPE[0], _DELIVER_RESPONSE[1]),
            "DeliverFiltered": (STREAM_STREAM, deliver_filtered_rpc, _ENVELOPE[0],
                                _DELIVER_RESPONSE[1]),
            "DeliverWithPrivateData": (STREAM_STREAM, deliver_pvt_rpc, _ENVELOPE[0],
                                       _DELIVER_RESPONSE[1]),
        },
    )


# ---------------------------------------------------------------------------
# Client helpers (SDK-side: broadcast a tx, pull blocks)
# ---------------------------------------------------------------------------


def broadcast_envelope(channel, env: dict) -> dict:
    """One-shot Broadcast over a grpc.Channel."""
    stub = channel.stream_stream(
        "/orderer.AtomicBroadcast/Broadcast",
        request_serializer=_ENVELOPE[1],
        response_deserializer=_BROADCAST_RESPONSE[0],
    )
    return next(stub(iter([env])))


def deliver_stream(
    channel,
    envelope: dict,
    service: str = "orderer.AtomicBroadcast",
    method: str = "Deliver",
):
    """The DeliverResponse stream of one seek envelope: an iterator of
    dicts that is also the gRPC call (`cancel()` ends it)."""
    stub = channel.stream_stream(
        f"/{service}/{method}",
        request_serializer=_ENVELOPE[1],
        response_deserializer=_DELIVER_RESPONSE[0],
    )
    return stub(iter([envelope]))


class DeliverEndpoint:
    """A deliver endpoint for `deliver/client.BlockDeliverer`: a callable
    (seek envelope) -> iterator of DeliverResponse dicts over
    `deliver_stream`. A call that fails or is cancelled raises
    ConnectionError, the error the deliverer fails over on; `close()`
    cancels the open call, so a deliverer waiting on a block returns."""

    def __init__(self, channel, service: str = "orderer.AtomicBroadcast",
                 method: str = "Deliver"):
        self._channel = channel
        self._service = service
        self._method = method
        self._lock = threading.Lock()
        self._call = None
        self._closed = False

    def __call__(self, envelope: dict) -> Iterator[dict]:
        with self._lock:
            if self._closed:
                raise ConnectionError("deliver endpoint closed")
            call = deliver_stream(self._channel, envelope, self._service, self._method)
            self._call = call
        try:
            yield from call
        except grpc.RpcError as exc:
            raise ConnectionError(f"deliver stream: {exc.code()}") from exc

    def close(self) -> None:
        with self._lock:
            self._closed = True
            call = self._call
        if call is not None:
            call.cancel()


def process_proposal(channel, signed: dict) -> dict:
    stub = channel.unary_unary(
        "/protos.Endorser/ProcessProposal",
        request_serializer=_SIGNED_PROPOSAL[1],
        response_deserializer=_PROPOSAL_RESPONSE[0],
    )
    return stub(signed)


def register_snapshot_service(
    server: GRPCServer,
    managers,
    policy_checker=None,
) -> None:
    """The peer's Snapshot admin service (reference
    core/ledger/snapshotgrpc/snapshot_service.go:25-87: Generate, Cancel,
    QueryPendings over SignedSnapshotRequest).

    ``managers(channel_id)`` resolves the channel's
    SnapshotRequestManager; ``policy_checker(channel_id, SignedData)``
    raises to deny (the reference checks the snapshot/* ACL resources
    against the channel admins)."""

    def _open(signed: dict, schema):
        req = protoutil.unmarshal(schema, signed.get("request", b""))
        if policy_checker is not None:
            shdr = protoutil.unmarshal(fabric.SIGNATURE_HEADER, req.get("signature_header", b""))
            policy_checker(
                req.get("channel_id", ""),
                SignedData(signed.get("request", b""), shdr.get("creator", b""),
                           signed.get("signature", b"")),
            )
        mgr = managers(req.get("channel_id", ""))
        if mgr is None:
            raise KeyError(f"channel {req.get('channel_id', '')} not found")
        return req, mgr

    def generate(signed, context):
        req, mgr = _open(signed, fabric.SNAPSHOT_REQUEST)
        mgr.submit(req.get("block_number", 0))
        return {}

    def cancel(signed, context):
        req, mgr = _open(signed, fabric.SNAPSHOT_REQUEST)
        mgr.cancel(req.get("block_number", 0))
        return {}

    def query_pendings(signed, context):
        _req, mgr = _open(signed, fabric.SNAPSHOT_QUERY)
        return {"block_numbers": mgr.pending()}

    server.register(
        "protos.Snapshot",
        {
            "Generate": (UNARY, generate, _SIGNED_SNAPSHOT_REQUEST[0], _EMPTY[1]),
            "Cancel": (UNARY, cancel, _SIGNED_SNAPSHOT_REQUEST[0], _EMPTY[1]),
            "QueryPendings": (UNARY, query_pendings, _SIGNED_SNAPSHOT_REQUEST[0], _PENDINGS[1]),
        },
    )

