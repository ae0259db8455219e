"""Gossip comm over gRPC (reference gossip/comm/comm_impl.go
GossipStream + gossip/gossip_impl.go message routing).

One ``GossipNode`` per peer process:

* serves ``gossip.Gossip/GossipStream`` (client pushes a stream of
  GossipMessages, server replies with its own pending messages — the
  reference's bidi stream collapsed to push + piggyback);
* a tick loop broadcasts SWIM alive messages (gossip/membership)
  carrying ledger heights, pushes freshly committed blocks (DataMessage)
  to other members, and runs anti-entropy: when a taller peer shows up in
  the membership view, request the missing block range directly
  (state.go antiEntropy -> StateRequest/StateResponse).

Blocks flow into the per-channel StateProvider buffer and commit in
order through the peer's commit pipeline.

The port's counterpart of the JAX package's `gossip/comm.py`, over the
port's dict messages (`protos/gossip.py`, read and written by the wire
codec) and blocks; its messages, signed bytes and handshake are the JAX
node's, so nodes of both packages gossip on one channel. It reaches the
card only through the callables it is given (the commit, the verifiers),
and imports no torch. Departures:

* every random choice (the forward subset, the peer of a pull or
  reconcile round) comes from the node's `rng`, a `random.Random` the
  caller gives (an unseeded one by default), where the JAX node draws
  from the global `random`;
* a commit failure is not swallowed: the StateProvider is marked
  `failed`, as in the JAX node, and the node keeps the first one in
  `commit_error`; an exception of a verifier or callback (a provider that
  fails) is kept in `handler_error`, never read as a refusal. `check()`
  raises either. The JAX node logs both at debug level;
* `stop()` joins the tick thread, every send thread and the server, with
  no time limit: no thread of the node outlives it;
* `arrivals` counts the blocks buffered by push, by pull and by state
  transfer;
* the node's alives carry its incarnation (`inc_num`, its start time in
  nanoseconds, as the reference's PeerTime.IncNum), and their freshness is
  (incarnation, sequence) (`gossip/membership`), so peers of the port take
  a restarted node's alives at once. The JAX node sends no incarnation
  and judges by the sequence alone: it ignores a restarted node until the
  new sequence passes the old one;
* an alive that would not advance the membership view (a duplicate, a
  stale sequence number, a forwarded copy already seen) is dropped before
  its signature is checked, where the JAX node checks it and then drops
  it: the outcome is the same, without a verification a copy;
* the TLS certificate a client presented is read with the port's X.509
  reader, where the JAX node uses the cryptography package.
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import grpc

from fabric_tpu_torch.comm.server import STREAM_STREAM, GRPCServer, channel_to, wire_codec
from fabric_tpu_torch.common import x509
from fabric_tpu_torch.common.faults import InjectedFault, fault_point, faults_enabled
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.gossip.membership import LeaderElection, Membership
from fabric_tpu_torch.gossip.msgstore import MessageStore
from fabric_tpu_torch.gossip.pull import PULL_MEMBERSHIP, CertStore, PullMediator
from fabric_tpu_torch.gossip.pvtdata import PvtDataHandler, reconcile_response_entries
from fabric_tpu_torch.gossip.state import CommitFailure, StateProvider
from fabric_tpu_torch.protos import fabric, gossip, wire

logger = must_get_logger("gossip.comm")

_GOSSIP_MESSAGE = wire_codec(gossip.GOSSIP_MESSAGE)
# what a failed send is: the peer is dead, unreachable or speaks garbage
_TRANSPORT_ERRORS = (grpc.RpcError, InjectedFault, ConnectionError, OSError, wire.WireError)


class GossipNode:
    def __init__(
        self,
        self_id: str,
        channel_id: str,
        state: StateProvider,
        get_block: Callable[[int], Optional[dict]],
        height: Callable[[], int],
        listen_address: str = "127.0.0.1:0",
        tick_interval: float = 0.2,
        identity_bytes: bytes = b"",
        verify_identity=None,
        transient_store=None,
        pvt_reader=None,  # (block, tx, ns, coll) -> bytes|None
        pvt_serve_policy=None,  # (ns, coll) -> bool
        # per-requester pvtdata eligibility (pull.go:614,662): requests
        # are authenticated against the certstore and each digest checked
        # against the collection's member-orgs policy for THAT identity
        pvt_verify_member_sig=None,  # (identity, data, sig) -> bool
        pvt_requester_eligible=None,  # (ns, coll, identity) -> bool
        pvt_sign_request=None,  # (data) -> sig, for our reconcile pulls
        # signed membership (reference SignedGossipMessage): we sign our
        # alive messages with sign_message; with require_signed_alive the
        # server drops alives whose signature does not verify against the
        # certstore identity for the claimed pki_id (forged liveness /
        # endpoint / ledger-height claims)
        sign_message=None,  # (data) -> sig
        require_signed_alive: bool = False,
        # mutual-TLS transport + TLS-bound stream handshake (reference
        # comm_impl.go:563 authenticateRemotePeer): tls_server_creds is a
        # grpc.ServerCredentials built with a client CA (mTLS);
        # tls_client = (root_ca_pem, (key_pem, cert_pem)) for outbound;
        # self_tls_cert_der feeds our ConnEstablish tls_cert_hash. With
        # require_handshake the server refuses streams whose first
        # message is not a ConnEstablish whose signature verifies AND
        # whose tls_cert_hash matches the cert actually presented on the
        # mTLS transport.
        tls_server_creds=None,
        tls_client=None,
        self_tls_cert_der: bytes = b"",
        require_handshake: bool = False,
        rng: Optional[random.Random] = None,
    ):
        self.self_id = self_id
        self.channel_id = channel_id
        self.state = state
        self._get_block = get_block
        self._height = height
        self._rng = rng if rng is not None else random.Random()
        self.membership = Membership(self_id, incarnation=time.time_ns())
        self.election = LeaderElection(self.membership)
        # certstore + pull mediator (identity + block anti-entropy)
        self.certstore = CertStore(self_id, identity_bytes, verify_identity)
        self.pull = PullMediator(
            channel_id,
            self.certstore,
            get_block=get_block,
            height=height,
            add_block=self._pull_block_in,
            rng=self._rng,
        )
        # dedup-expiry store (gossip/msgstore/msgs.go): stops data-msg
        # forward loops and re-processing in a mesh
        self._msgstore = MessageStore(ttl_s=30.0)
        self._tls_client = tls_client
        self._self_tls_cert_der = self_tls_cert_der
        self._require_handshake = require_handshake
        # private-data push/pull (None transient store -> disabled)
        self.pvt = (
            PvtDataHandler(
                channel_id,
                transient_store,
                pvt_reader or (lambda *a: None),
                serve_policy=pvt_serve_policy,
                resolve_identity=self.certstore.get,
                verify_member_sig=pvt_verify_member_sig,
                requester_eligible=pvt_requester_eligible,
                self_pki_id=self_id.encode(),
                sign_request=pvt_sign_request,
            )
            if transient_store is not None
            else None
        )
        self._sign_message = sign_message
        self._require_signed_alive = require_signed_alive
        self._verify_member_sig = pvt_verify_member_sig
        self._endpoints: Dict[str, str] = {}  # peer id -> endpoint
        # bootstrap anchors (connect() targets): re-introduced on a
        # paced per-anchor backoff until a member answers from that
        # endpoint, so ONE lost hello on a lossy link cannot partition
        # the pair forever — the backoff caps the redial rate so a
        # permanently-decommissioned anchor is not dialed every tick
        self._anchors: set = set()
        self._anchor_backoff: Dict[str, list] = {}  # ep -> [next_tick, interval]
        self._conns: Dict[str, object] = {}  # endpoint -> grpc channel
        self._lock = threading.Lock()
        # per-endpoint send sequence, so fault decisions key per stream
        # open (a static endpoint key would degenerate a probabilistic
        # plan into a permanent per-peer partition)
        self._send_seq: Dict[str, int] = {}
        self._stop = threading.Event()
        self._tick_interval = tick_interval
        self._reconcile_commit = None
        self._missing_provider = None
        self._tick_count = 0
        self._conn_msg_cache: Optional[dict] = None
        self.commit_error: Optional[BaseException] = None
        self.handler_error: Optional[BaseException] = None
        # blocks taken into the payload buffer, by the way they came
        self.arrivals = {"push": 0, "pull": 0, "state": 0}

        self.server = GRPCServer(listen_address, credentials=tls_server_creds)
        self.server.register(
            "gossip.Gossip",
            {"GossipStream": (STREAM_STREAM, self._gossip_stream, *_GOSSIP_MESSAGE)},
        )
        self._thread: Optional[threading.Thread] = None
        # in-flight fire-and-forget send threads (forward/push/probe):
        # registered so stop() can reap them (pruned on every spawn, so the
        # list is bounded by concurrent sends, not node lifetime)
        self._senders: List[threading.Thread] = []

    # -- errors -------------------------------------------------------------
    def _record(self, attr: str, exc: BaseException) -> None:
        with self._lock:
            if getattr(self, attr) is None:
                setattr(self, attr, exc)
        logger.error("[%s] %s: %s", self.self_id, attr.replace("_", " "), exc)

    def check(self) -> None:
        """Raise the first commit failure or handler error, if any."""
        for exc in (self.commit_error, self.handler_error):
            if exc is not None:
                raise exc

    def _spawn_send(self, endpoint: str, messages) -> None:
        """One async send on its own reaped thread (every push/forward
        path funnels through here: no unowned Thread.start())."""
        t = threading.Thread(target=self._send, args=(endpoint, messages), daemon=True)
        with self._lock:
            if self._stop.is_set():
                return
            self._senders = [s for s in self._senders if s.is_alive()]
            self._senders.append(t)
            t.start()

    def _arrived(self, block: dict, route: str, from_gossip: bool = True) -> bool:
        if self.state.add_payload(block, from_gossip=from_gossip):
            with self._lock:
                self.arrivals[route] += 1
            return True
        return False

    def _pull_block_in(self, block: dict) -> None:
        """Pulled blocks enter through the same ordered payload buffer
        as pushed DataMessages — and mark the msgstore so a later pushed
        copy of the same block is neither re-buffered nor re-forwarded."""
        self._msgstore.add(("data", block.get("header", {}).get("number", 0)))
        if self._arrived(block, "pull"):
            self._drain()

    # -- server side ------------------------------------------------------
    def _gossip_stream(self, request_iterator, context):
        first = True
        for msg in request_iterator:
            if first:
                first = False
                if gossip.content(msg) == "conn":
                    if not self._guarded(self._handshake_ok, msg["conn"], context):
                        if self._require_handshake:
                            return  # refuse the stream (comm_impl.go:563)
                        # permissive mode: an unverifiable handshake is
                        # ignored, the piggybacked messages still flow
                    continue
                if self._require_handshake:
                    return  # strict mode: no handshake, no service
            reply = self._guarded(self._handle, msg)
            if reply is not None:
                yield reply

    def _guarded(self, fn, *args):
        """fn(*args) on a stream thread: an exception (a verifier or a
        callback that failed) is kept in handler_error and ends the stream,
        never answered as a refusal."""
        try:
            return fn(*args)
        except _TRANSPORT_ERRORS:
            raise  # the remote's garbage ends its stream, nothing of ours failed
        except Exception as exc:
            self._record("handler_error", exc)
            raise

    def _handshake_ok(self, conn: dict, context) -> bool:
        """Verify a ConnEstablish: signature over (channel, pki_id,
        tls_cert_hash) against the carried identity, and the hash against
        the TLS cert the client ACTUALLY presented on this connection."""
        pki_id = conn.get("pki_id", b"")
        tls_hash = conn.get("tls_cert_hash", b"")
        identity = conn.get("identity", b"") or self.certstore.get(pki_id)
        if not identity:
            return False
        if self._verify_member_sig is not None:
            signed = _conn_signing_bytes(self.channel_id, pki_id, tls_hash)
            if not self._verify_member_sig(identity, signed, conn.get("signature", b"")):
                return False
        # TLS binding: only checkable when the transport is mTLS (the
        # auth context then carries the verified client cert)
        actual = self._peer_tls_cert_der(context)
        if actual is not None:
            if hashlib.sha256(actual).digest() != tls_hash:
                return False
        elif self._require_handshake and self._self_tls_cert_der:
            # we are TLS-configured but the client came in without a
            # client cert: refuse rather than accept an unbindable claim
            return False
        # pki_id <-> identity binding: the certstore's verify hook is the
        # binding authority; a rejected or conflicting bind refuses the
        # stream, so a valid member cannot authenticate under another
        # peer's pki_id or pre-poison the first-bind-wins store.
        if not self.certstore.put(pki_id, identity):
            if self.certstore.get(pki_id) != identity:
                return False
        return True

    @staticmethod
    def _peer_tls_cert_der(context) -> Optional[bytes]:
        try:
            auth = context.auth_context()
        except AttributeError:  # a test context without an auth context
            return None
        pems = auth.get("x509_pem_cert") if auth else None
        if not pems:
            return None
        try:
            der = x509.pem_decode("CERTIFICATE", pems[0])
            x509.Certificate.from_der(der)
            return der
        except ValueError:  # X509Error: not a certificate
            return None

    def _handle(self, msg: dict) -> Optional[dict]:
        # per-channel routing: this node serves ONE channel; foreign
        # channel traffic is dropped (gossip channel.go eligibility)
        if msg.get("channel") and msg["channel"] != self.channel_id:
            return None
        kind = gossip.content(msg)
        if kind == "alive_msg":
            alive = msg["alive_msg"]
            member = alive.get("membership", {})
            pki_id = member.get("pki_id", b"")
            try:
                pid = pki_id.decode()
            except UnicodeDecodeError:
                return None  # no peer of ours has such an id
            inc = alive.get("inc_num", 0)
            if not self.membership.is_fresh(pid, alive.get("seq_num", 0), inc):
                return None  # ours, a duplicate or stale: no signature to check
            if not self._alive_signature_ok(alive):
                return None
            endpoint = member.get("endpoint", "")
            advanced = self.membership.handle_alive({
                "id": pid,
                "endpoint": endpoint,
                "seq": alive.get("seq_num", 0),
                "inc": inc,
                "metadata": member.get("ledger_height", 0).to_bytes(8, "big"),
            })
            if advanced:
                # endpoint map follows only FRESH alives — a replayed old
                # (validly signed) alive must not roll the endpoint back
                with self._lock:
                    self._endpoints[pid] = endpoint
                # push-forward fresh alive messages so the view spreads
                # transitively; seq dedup stops loops. The originator's
                # identity rides along so strict-mode third parties can
                # verify the forwarded signature.
                fwd = [msg]
                origin_identity = self.certstore.get(pki_id)
                if origin_identity:
                    intro = {"channel": self.channel_id,
                             "peer_identity": {"pki_id": pki_id, "cert": origin_identity}}
                    fwd = [intro, msg]
                for ep in self._peer_endpoints():
                    if ep != endpoint:
                        self._spawn_send(ep, fwd)
        elif kind == "data_msg":
            data = msg["data_msg"]
            # msgstore dedup: a block seen within the TTL is neither
            # re-buffered nor re-forwarded (gossip_impl.go handleMessage)
            if not self._msgstore.add(("data", data.get("seq_num", 0))):
                return None
            block = wire.decode(fabric.BLOCK, data.get("block", b""))
            if self._arrived(block, "push"):
                self._drain()
            # push-forward to a bounded random subset (PropagatePeerNum)
            peers = self._peer_endpoints()
            self._rng.shuffle(peers)
            for ep in peers[:3]:
                self._spawn_send(ep, [msg])
        elif kind == "state_request":
            req = msg["state_request"]
            blocks = self.state.handle_state_request(
                req.get("start_seq_num", 0), req.get("end_seq_num", 0), self._get_block)
            return {"channel": self.channel_id,
                    "state_response": {"blocks": [wire.encode(fabric.BLOCK, b) for b in blocks]}}
        elif kind == "state_response":
            for raw in msg["state_response"].get("blocks", ()):
                self._arrived(wire.decode(fabric.BLOCK, raw), "state", from_gossip=False)
            self._drain()
        elif kind in ("hello", "data_dig", "data_req", "data_update", "peer_identity"):
            if kind == "hello" and msg["hello"].get("msg_type", 0) == PULL_MEMBERSHIP:
                # direct membership probe of a suspect: answer with OUR
                # fresh alive so the prober refutes the suspicion
                return self._alive_message(probe_reply=True)
            return self.pull.handle(msg)
        elif kind in ("private_data", "private_req"):
            if self.pvt is not None:
                return self.pvt.handle(msg)
        elif kind == "private_res":
            if self.pvt is not None and self._reconcile_commit is not None:
                try:
                    self._reconcile_commit(reconcile_response_entries(msg))
                except Exception as exc:
                    self._record("commit_error", exc)
        return None

    def _drain(self) -> None:
        try:
            self.state.deliver_payloads()
        except CommitFailure as exc:
            self._record("commit_error", exc)

    def _alive_signature_ok(self, alive: dict) -> bool:
        """Membership authentication (reference aliveMsgStore validation):
        verify the signature over the alive content against the certstore
        identity for the claimed pki_id.  Unsigned alives pass only in
        permissive mode (unit-test topologies without signers); a PRESENT
        signature is always checked when a verifier is configured."""
        signature = alive.get("signature", b"")
        if not signature:
            return not self._require_signed_alive
        if self._verify_member_sig is None:
            return True  # no verifier configured: nothing to check against
        identity = self.certstore.get(alive.get("membership", {}).get("pki_id", b""))
        if identity is None:
            # identity not yet learned (certstore anti-entropy catches up);
            # strict mode refuses rather than trusting the claim
            return not self._require_signed_alive
        return self._verify_member_sig(
            identity, _alive_signing_bytes(alive, self.channel_id), signature)

    # -- push side --------------------------------------------------------
    def _alive_message(self, probe_reply: bool = False) -> dict:
        if probe_reply:
            # a probe answer needs a FRESH seq (the prober dedups by
            # seq) but must not advance our own membership clock
            tick = self.membership.bump_seq()
        else:
            tick = self.membership.tick()
            self.election.evaluate()
        alive = {"membership": {"endpoint": self.server.addr, "pki_id": self.self_id.encode(),
                                "ledger_height": self._height()},
                 "seq_num": tick["seq"], "inc_num": self.membership.incarnation}
        if self._sign_message is not None:
            alive["signature"] = self._sign_message(_alive_signing_bytes(alive, self.channel_id))
        return {"channel": self.channel_id, "alive_msg": alive}

    def _conn(self, endpoint: str):
        """One cached channel per peer (reference comm_impl connStore)."""
        with self._lock:
            conn = self._conns.get(endpoint)
            if conn is None:
                if self._tls_client is not None:
                    root_ca, client_pair = self._tls_client
                    conn = channel_to(endpoint, root_ca_pem=root_ca, client_cert=client_pair)
                else:
                    conn = channel_to(endpoint)
                self._conns[endpoint] = conn
            return conn

    def _conn_establish(self) -> Optional[dict]:
        """Our ConnEstablish for stream openings (None when handshaking
        is not configured). Built once — its inputs (channel, pki_id,
        static TLS cert) never change, and re-signing on every send
        would add one ECDSA op per peer per tick on the hot path."""
        if not (self._require_handshake or self._self_tls_cert_der):
            return None
        if self._conn_msg_cache is not None:
            return self._conn_msg_cache
        conn = {"pki_id": self.self_id.encode(),
                "identity": self.certstore.get(self.self_id.encode()) or b""}
        if self._self_tls_cert_der:
            conn["tls_cert_hash"] = hashlib.sha256(self._self_tls_cert_der).digest()
        if self._sign_message is not None:
            conn["signature"] = self._sign_message(_conn_signing_bytes(
                self.channel_id, conn["pki_id"], conn.get("tls_cert_hash", b"")))
        msg = {"channel": self.channel_id, "conn": conn}
        # sign outside the lock (ECDSA is the expensive part and the inputs
        # are static), publish under it so exactly one message wins and
        # every stream sends the same bytes
        with self._lock:
            if self._conn_msg_cache is None:
                self._conn_msg_cache = msg
            return self._conn_msg_cache

    def _send(self, endpoint: str, messages: Sequence[dict], _depth: int = 0) -> None:
        try:
            # chaos seam: "drop" silently loses the send (membership
            # expiry + pull reconciliation must recover), "raise" takes
            # the dead-peer path below; keyed per (endpoint, stream open)
            if faults_enabled():
                with self._lock:
                    seq = self._send_seq.get(endpoint, 0)
                    self._send_seq[endpoint] = seq + 1
                spec = fault_point("gossip.comm.send", key=(endpoint, seq), interprets=("drop",))
                if spec is not None and spec.action == "drop":
                    return
            stub = self._conn(endpoint).stream_stream(
                "/gossip.Gossip/GossipStream",
                request_serializer=_GOSSIP_MESSAGE[1],
                response_deserializer=_GOSSIP_MESSAGE[0],
            )
            outbound = list(messages)
            hello = self._conn_establish()
            if hello is not None:
                # every stream opening re-authenticates (one stream a send)
                outbound.insert(0, hello)
            try:
                call = stub(iter(outbound))
            except ValueError as exc:  # the channel a failed send to this peer closed
                raise ConnectionError(str(exc)) from exc
            followups = []
            for reply in call:
                out = self._handle(reply)
                if out is not None:
                    followups.append(out)
            if followups and _depth < 3:
                # pull four-step: hello -> digest -> request -> update
                # needs the requester to answer replies with new sends
                self._send(endpoint, followups, _depth + 1)
        except _TRANSPORT_ERRORS:
            # dead peer: drop the cached connection; membership expiry
            # will remove it from the view
            with self._lock:
                conn = self._conns.pop(endpoint, None)
            if conn is not None:
                conn.close()
        except Exception as exc:
            self._record("handler_error", exc)

    def broadcast_block(self, block: dict) -> None:
        """Leader push after pulling from the orderer (gossip DataMsg).
        Fan-out runs on worker threads: the caller is the leader's
        commit path and must not block on a dead follower's connect
        timeout (comm_impl.go sends are async for the same reason)."""
        number = block.get("header", {}).get("number", 0)
        msg = {"channel": self.channel_id,
               "data_msg": {"seq_num": number, "block": wire.encode(fabric.BLOCK, block)}}
        # mark our own broadcast seen so a forwarded copy is not
        # re-buffered or re-forwarded by us
        self._msgstore.add(("data", number))
        for endpoint in self._peer_endpoints():
            self._spawn_send(endpoint, [msg])

    def _peer_endpoints(self) -> List[str]:
        with self._lock:
            return [self._endpoints[pid] for pid in self.membership.alive_peers()
                    if pid in self._endpoints and pid != self.self_id]

    def _peer_heights(self) -> List[int]:
        out = []
        for pid in self.membership.alive_peers():
            meta = self.membership.metadata_of(pid)
            if meta and len(meta) == 8:
                out.append(int.from_bytes(meta, "big"))
        return out

    # pull/reconcile cadence in ticks (the reference pulls on a ~4s
    # interval vs 5 alive ticks/s — running the 4-step exchange every
    # tick would open streams constantly for nothing)
    PULL_EVERY = 5
    RECONCILE_EVERY = 5
    #: cap on the per-anchor redial backoff (in ticks): a silent
    #: bootstrap anchor is re-dialed at most once per cap window
    ANCHOR_REDIAL_CAP_TICKS = 50

    def _tick_once(self) -> None:
        self._tick_count += 1
        batch = self._intro_messages()
        member_endpoints = self._peer_endpoints()
        for endpoint in member_endpoints:
            self._send(endpoint, batch)
        # bootstrap resilience: an anchor whose hello was lost gets
        # re-introduced until a member answers from that endpoint, paced
        # by a per-anchor exponential backoff in ticks (first retry on the
        # next tick, doubling to ANCHOR_REDIAL_CAP_TICKS)
        known = set(member_endpoints)
        with self._lock:
            silent_anchors = []
            for a in sorted(self._anchors):
                if a in known:
                    # answered: reset the ramp so a future re-silence
                    # (restart, partition) retries fast again
                    self._anchor_backoff.pop(a, None)
                    continue
                nxt = self._anchor_backoff.setdefault(a, [self._tick_count, 1])
                if self._tick_count < nxt[0]:
                    continue
                nxt[1] = min(nxt[1] * 2, self.ANCHOR_REDIAL_CAP_TICKS)
                nxt[0] = self._tick_count + nxt[1]
                silent_anchors.append(a)
        for endpoint in silent_anchors:
            self._send(endpoint, batch)
        # SWIM suspicion: direct-probe peers whose heartbeats stopped
        # reaching us BEFORE expiring them (push loss != death); their
        # reply is a fresh alive that refutes the suspicion
        for pid in self.membership.newly_suspect():
            with self._lock:
                ep = self._endpoints.get(pid)
            if ep:
                self._spawn_send(ep, [self.pull.hello(PULL_MEMBERSHIP)])
        # anti-entropy: ask ONE taller peer for the missing range
        rng = self.state.missing_range(self._peer_heights())
        if rng is not None:
            endpoints = self._taller_peer_endpoints(rng.stop)
            if endpoints:
                req = {"channel": self.channel_id,
                       "state_request": {"start_seq_num": rng.start, "end_seq_num": rng.stop}}
                self._send(endpoints[0], [req])
        endpoints = self._peer_endpoints()
        # identity pull round with one random peer (certstore sync)
        if endpoints and self._tick_count % self.PULL_EVERY == 0:
            self._send(self._rng.choice(endpoints), [self.pull.hello()])
        # block pull round (phase-shifted from the identity round): the
        # digest/request/response path converges peers the push missed
        # even when height metadata never spread (pullstore.go)
        if endpoints and self._tick_count % self.PULL_EVERY == 2:
            self._send(self._rng.choice(endpoints), [self.pull.hello_blocks()])
            self._msgstore.expire_old()
        # pvt-data reconciliation (reconcile.go:104-126): request data the
        # pvt store recorded as missing from one random peer
        if (self.pvt is not None and self._missing_provider is not None and endpoints
                and self._tick_count % self.RECONCILE_EVERY == 0):
            req = self.pvt.reconcile_request(self._missing_provider())
            if req is not None:
                self._send(self._rng.choice(endpoints), [req])
        self._drain()

    # -- pvt data push (DistributePrivateData) ----------------------------
    def disseminate_pvt(self, tx_id: str, pvt_writes) -> None:
        """Endorsement-time push of [(ns, coll, rwset_bytes)] to every
        member's transient store."""
        if self.pvt is None:
            return
        messages = self.pvt.dissemination_messages(tx_id, pvt_writes)
        if not messages:
            return
        for endpoint in self._peer_endpoints():
            self._spawn_send(endpoint, messages)

    def enable_reconciliation(self, missing_provider, reconcile_commit) -> None:
        """missing_provider() -> {block: [MissingEntry]};
        reconcile_commit([(block, tx, ns, coll, payload)])."""
        self._missing_provider = missing_provider
        self._reconcile_commit = reconcile_commit

    def _taller_peer_endpoints(self, needed_height: int) -> List[str]:
        out = []
        with self._lock:
            for pid in self.membership.alive_peers():
                meta = self.membership.metadata_of(pid)
                if (meta and len(meta) == 8 and int.from_bytes(meta, "big") >= needed_height
                        and pid in self._endpoints and pid != self.self_id):
                    out.append(self._endpoints[pid])
        return out

    def _intro_messages(self) -> List[dict]:
        """Identity + alive, in that order: with signed membership the
        receiver must know our certstore identity BEFORE the alive or the
        strict gate drops it."""
        batch: List[dict] = []
        identity = self.certstore.get(self.self_id.encode())
        if identity and self._tick_count % self.PULL_EVERY in (0, 1):
            # identity rides along on bootstrap and then periodically —
            # resending a ~1KB cert to every peer 5x/s would make every
            # receiver re-run cert-chain validation for nothing
            batch.append({"channel": self.channel_id,
                          "peer_identity": {"pki_id": self.self_id.encode(), "cert": identity}})
        batch.append(self._alive_message())
        return batch

    # -- lifecycle --------------------------------------------------------
    def connect(self, endpoint: str) -> None:
        """Bootstrap: introduce ourselves to an anchor peer.  The
        endpoint is remembered: the tick loop re-introduces us until the
        anchor shows up in the member view (lossy-link resilience)."""
        with self._lock:
            self._anchors.add(endpoint)
        self._send(endpoint, self._intro_messages())

    def start(self) -> str:
        addr = self.server.start()

        def loop():
            while not self._stop.wait(self._tick_interval):
                try:
                    self._tick_once()
                except Exception as exc:  # noqa: BLE001 - kept, the loop goes on
                    self._record("handler_error", exc)

        self._thread = threading.Thread(target=loop, name=f"gossip-{self.self_id}", daemon=True)
        self._thread.start()
        return addr

    def stop(self) -> None:
        """Stop ticking and serving; every thread of the node has ended
        when this returns."""
        with self._lock:
            self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
        with self._lock:
            senders = list(self._senders)
            self._senders.clear()
        for s in senders:
            if s is not threading.current_thread():
                s.join()
        self.server.stop()
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.close()

    @property
    def addr(self) -> str:
        return self.server.addr

    @property
    def is_leader(self) -> bool:
        return self.election.is_leader


def _conn_signing_bytes(channel_id: str, pki_id: bytes, tls_hash: bytes) -> bytes:
    """ConnEstablish signed content: channel + pki_id + tls cert hash
    (comm_impl.go createConnectionMsg signs pkiID + certHash)."""
    return b"conn\x00" + channel_id.encode() + b"\x00" + pki_id + b"\x00" + tls_hash


def _alive_signing_bytes(alive: dict, channel_id: str) -> bytes:
    """Deterministic alive content for sign/verify: CHANNEL + (membership,
    seq_num, inc_num) with the signature field excluded.  Binding the
    channel stops cross-channel replay of a validly signed alive (each
    channel has its own GossipNode with independent seq counters and
    ledger heights)."""
    bare = {"membership": alive.get("membership", {}), "seq_num": alive.get("seq_num", 0),
            "inc_num": alive.get("inc_num", 0)}
    return channel_id.encode() + b"\x00" + wire.encode(gossip.ALIVE_MESSAGE, bare)
