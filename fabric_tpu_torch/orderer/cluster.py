"""Orderer-to-orderer cluster communication (reference orderer/common/
cluster/comm.go:117,127: per-channel DispatchSubmit / DispatchConsensus
behind the Step RPC).

Two paths, like the reference:

- Consensus: raft wire messages between cluster members, carried on a
  long-lived Step stream (fire-and-forget; raft handles loss by
  retransmission on the next tick/append).
- Submit: transaction forwarding from a follower to the raft leader, a
  unary call that returns the leader's Broadcast status (reference
  SubmitRequest/SubmitResponse on the Step stream).

The client keeps one sender thread + queue per remote node; broken
connections drop queued messages and reconnect lazily (raft tolerates
this: lost appends retransmit, lost votes retrigger elections).

The port's counterpart of the JAX package's `orderer/cluster.py`: messages
are the port's dicts under the schemas of `protos/cluster.py`, carried by
the wire codec (`comm/server.wire_codec`), and the chains are the port's
`orderer/raft_chain.RaftChain`. `ClusterClient.transport_factory` is what a
`Registrar` takes as `raft_transport_factory=`, and `forward_submit` what a
`BroadcastHandler` takes as its `cluster_client`. Departures: a consensus
payload that does not decode as a raft message is dropped and counted
(`ClusterService.dropped`), but an exception of the chain's `step` is kept
in `ClusterService.step_error` and ends the stream (the sender reconnects),
where the JAX service swallows both; `ClusterClient.stop()` joins every
sender thread with no time limit and starts none afterwards (a raft message
sent after it is dropped, a forward answered SERVICE_UNAVAILABLE), where the
JAX client waits 2 s a sender and starts a new one for the next message.
"""

from __future__ import annotations

import queue
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

import grpc

from fabric_tpu_torch.comm.server import STREAM_STREAM, UNARY, GRPCServer, channel_to, wire_codec
from fabric_tpu_torch.orderer.raft import Message, message_from_bytes, message_to_bytes
from fabric_tpu_torch.protos import cluster, fabric

SERVICE_NAME = "orderer.Cluster"

_STEP_REQUEST = wire_codec(cluster.CLUSTER_STEP_REQUEST)
_STEP_RESPONSE = wire_codec(cluster.CLUSTER_STEP_RESPONSE)
_SUBMIT_REQUEST = wire_codec(cluster.CLUSTER_SUBMIT_REQUEST)
_SUBMIT_RESPONSE = wire_codec(cluster.CLUSTER_SUBMIT_RESPONSE)


class ClusterService:
    """Server side: dispatch Step payloads to the local registrar's chains
    (comm.go DispatchSubmit/DispatchConsensus)."""

    def __init__(self, registrar, broadcast_handler=None):
        self.registrar = registrar
        self.broadcast = broadcast_handler
        self.dropped = 0  # consensus payloads that were no raft message
        self.step_error: Optional[BaseException] = None

    # Step: bidi stream of consensus messages (no responses)
    def step(self, request_iterator, context):
        for req in request_iterator:
            if "consensus_request" in req:
                self._dispatch_consensus(req["consensus_request"])
            elif "submit_request" in req:
                sub = req["submit_request"]
                status, info = self._dispatch_submit(sub)
                yield {"submit_res": {"channel": sub.get("channel", ""),
                                      "status": status, "info": info}}

    def submit(self, request: dict, context) -> dict:
        status, info = self._dispatch_submit(request)
        return {"channel": request.get("channel", ""), "status": status, "info": info}

    def _dispatch_consensus(self, req: dict) -> None:
        support = self.registrar.get_chain(req.get("channel", ""))
        if support is None:
            return  # unknown channel: drop (reference logs + errors the stream)
        chain = support.chain
        if not hasattr(chain, "step"):
            return
        try:
            msg = message_from_bytes(req.get("payload", b""))
        except (ValueError, struct.error, IndexError):
            self.dropped += 1
            return
        try:
            chain.step(msg)
        except Exception as exc:
            self.step_error = exc
            raise

    def _dispatch_submit(self, req: dict) -> Tuple[int, str]:
        if self.broadcast is None:
            return fabric.SERVICE_UNAVAILABLE, "no broadcast handler"
        # leader-side processing of a forwarded envelope: same msgprocessor
        # + order path as a direct Broadcast (broadcast.go), minus another
        # forwarding hop (forwarded=True breaks redirect loops).
        return self.broadcast.process_message(req.get("payload", {}), forwarded=True)

    def register(self, server: GRPCServer) -> None:
        server.register(
            SERVICE_NAME,
            {
                "Step": (STREAM_STREAM, self.step, _STEP_REQUEST[0], _STEP_RESPONSE[1]),
                "Submit": (UNARY, self.submit, _SUBMIT_REQUEST[0], _SUBMIT_RESPONSE[1]),
            },
        )


class _Remote:
    """One peer orderer: lazy channel + a sender thread draining a queue
    into the Step stream (reference cluster.RemoteContext/Remote :168)."""

    def __init__(self, addr: str, root_ca: Optional[bytes] = None):
        self.addr = addr
        self.root_ca = root_ca
        self.q: "queue.Queue[dict]" = queue.Queue(maxsize=4096)
        self._channel: Optional[grpc.Channel] = None
        # the sender thread (reconnect path) and submit() callers both
        # create/reset _channel: without the lock two channels can be
        # created and one leaks unclosed
        self._ch_lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"cluster-send-{addr}", daemon=True
        )
        self._thread.start()

    def channel(self) -> grpc.Channel:
        with self._ch_lock:
            if self._channel is None:
                self._channel = channel_to(self.addr, self.root_ca)
            return self._channel

    def _reset_channel(self) -> None:
        with self._ch_lock:
            ch, self._channel = self._channel, None
        if ch is not None:
            ch.close()

    def enqueue_consensus(self, channel_id: str, msg: Message) -> None:
        req = {"consensus_request": {"channel": channel_id,
                                     "payload": message_to_bytes(msg),
                                     "from_node": msg.frm}}
        try:
            self.q.put_nowait(req)
        except queue.Full:
            pass  # backpressure: drop; raft retransmits

    def submit(self, channel_id: str, env: dict, timeout: float = 10.0) -> Tuple[int, str]:
        resp = self.channel().unary_unary(
            f"/{SERVICE_NAME}/Submit",
            request_serializer=_SUBMIT_REQUEST[1],
            response_deserializer=_SUBMIT_RESPONSE[0],
        )({"channel": channel_id, "payload": env}, timeout=timeout)
        return resp.get("status", 0), resp.get("info", "")

    def _next(self, done: threading.Event) -> Optional[dict]:
        """The next queued message, or None once `done` or stop() is set:
        grpc's thread that consumes a dead stream's requests must not stay
        blocked on the queue (it would outlive stop() and take the next
        stream's messages)."""
        while not (done.is_set() or self._stopped.is_set()):
            try:
                return self.q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _run(self) -> None:
        while not self._stopped.is_set():
            done = threading.Event()
            first = self._next(done)
            if first is None:
                return

            def gen(head, done=done):
                yield head
                while True:
                    item = self._next(done)
                    if item is None:
                        return
                    yield item

            try:
                stream = self.channel().stream_stream(
                    f"/{SERVICE_NAME}/Step",
                    request_serializer=_STEP_REQUEST[1],
                    response_deserializer=_STEP_RESPONSE[0],
                )(gen(first))
                for _ in stream:  # drain (submit responses not used here)
                    pass
            except grpc.RpcError:
                # connection lost: reset the channel; messages queued in
                # the meantime go out on the next stream
                self._reset_channel()
                self._stopped.wait(0.05)
            finally:
                done.set()

    def stop(self) -> None:
        self._stopped.set()
        self._reset_channel()
        if self._thread is not threading.current_thread():
            self._thread.join()


class ClusterClient:
    """Client side: the raft transport over real sockets. Endpoint maps
    are PER CHANNEL (each channel's consenter set comes from its own
    config block and channels may disagree about who node N is); remotes
    are shared per address. Gives the Registrar a transport factory and
    the broadcast path a leader-forwarding hook."""

    def __init__(
        self,
        node_id: int,
        endpoints: Optional[Dict[int, str]] = None,
        root_ca: Optional[bytes] = None,
    ):
        self.node_id = node_id
        self._default: Dict[int, str] = dict(endpoints or {})
        self._by_channel: Dict[str, Dict[int, str]] = {}
        self.root_ca = root_ca
        self._remotes: Dict[str, _Remote] = {}  # keyed by address
        self._lock = threading.Lock()
        self._stopped = False

    def set_channel_endpoints(self, channel_id: str, endpoints: Dict[int, str]) -> None:
        """Install/refresh one channel's consenter map (called on channel
        start and on every config block — consensus metadata is the
        source of truth, orderer main.go initializeClusterClientConfig)."""
        with self._lock:
            self._by_channel[channel_id] = dict(endpoints)

    def _addr(self, channel_id: str, to: int) -> Optional[str]:
        with self._lock:
            chan = self._by_channel.get(channel_id)
            if chan is not None and to in chan:
                return chan[to]
            return self._default.get(to)

    def _remote_for(self, addr: str) -> Optional[_Remote]:
        """The remote of `addr`, started on first use; None once stopped."""
        with self._lock:
            if self._stopped:
                return None
            r = self._remotes.get(addr)
            if r is None:
                r = _Remote(addr, self.root_ca)
                self._remotes[addr] = r
            return r

    def transport_factory(self, channel_id: str, node_id: int) -> Callable[[int, Message], None]:
        def send(to: int, msg: Message) -> None:
            if to == self.node_id:
                return
            addr = self._addr(channel_id, to)
            remote = self._remote_for(addr) if addr is not None else None
            if remote is not None:
                remote.enqueue_consensus(channel_id, msg)

        return send

    def forward_submit(self, channel_id: str, env: dict, leader_id: int) -> Tuple[int, str]:
        """Follower -> leader transaction forwarding (comm.go Submit)."""
        addr = self._addr(channel_id, leader_id)
        if addr is None:
            return fabric.SERVICE_UNAVAILABLE, f"no endpoint for leader {leader_id}"
        remote = self._remote_for(addr)
        if remote is None:
            return fabric.SERVICE_UNAVAILABLE, "cluster client stopped"
        try:
            return remote.submit(channel_id, env)
        except grpc.RpcError as e:
            return fabric.SERVICE_UNAVAILABLE, f"leader unreachable: {e.code()}"

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            remotes = list(self._remotes.values())
            self._remotes.clear()
        for r in remotes:
            r.stop()
