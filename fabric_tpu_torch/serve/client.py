"""Client shim: the sidecar as a BCCSP provider rung.

The port's counterpart of the JAX package's `serve/client`.
``SidecarProvider`` speaks the serve protocol to a resident sidecar and
presents the provider SPI, so `peer/pipeline`, the VerifyBatcher and the
block validator route through the sidecar without knowing it exists.
Select it like any other rung::

    provider_from_config({"Default": "SERVE", "SERVE": {"Address": addr}})

The ``SERVE`` block's keys: ``Address`` (one sidecar), ``Endpoints`` (a
list or comma-separated string: a `SidecarRouter` over a fleet),
``QoS`` (an admission class name, ``high``/``normal``/``bulk``, or a
channel -> class map such as ``paychan=high;spam*=bulk;*=normal``),
``Channel`` (the channel id stamped on every batch), ``DeadlineMs`` (a
per-batch wire budget, 0 = none), ``HedgeFraction`` and ``HedgeMinMs``
(the router's hedging). The JAX package's environment readers
(``FABRIC_TPU_SERVE_ADDR``, ``..._ENDPOINTS``, ``..._DEADLINE_MS``,
``..._QOS``, ``..._HEDGE_*``) are not ported: each is one of these keys or
a constructor argument, at the JAX default.

The rescue contract:

- ``ST_BUSY`` is admission control, not failure: the client retries on
  the shared ``common.retry`` pacing, honouring the sidecar's
  ``retry_after_ms`` hint, until the policy budget is spent.
- A sidecar that cannot serve (connect failure, mid-batch socket death,
  ST_STOPPING or ST_ERROR past its retries, busy budget spent, wire
  deadline expired, a malformed reply) hands the batch to the rescue
  provider in this process: the one the caller passed (``fallback=``),
  or else `bccsp.probe_provider()`, a `CUDAProvider` on the card. So a
  rescued batch still runs K2, and its mask is bit-exact. The first
  rescue sets ``degraded``, counts ``fabric_degrade_total{seam=
  "serve.client"}`` and records the ``serve.client_degraded`` event.
- If the rescue provider fails too (or there is no card to build it on),
  the batch raises `SidecarUnavailable`. This departs from the JAX
  client, which answers all-False there (`fabric_tpu/serve/client.py:
  564-575`): a guessed verdict, even a closed one, is not answered.

Hashing, key import, key generation and signing are host work and run
here, as the provider SPI's base methods; a single ``verify()`` runs on
the rescue provider (the card).
"""

from __future__ import annotations

import copy
import json
import select
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.retry import Backoff, CooldownGate, RetryPolicy
from fabric_tpu_torch.crypto.bccsp import Provider
from fabric_tpu_torch.serve import protocol as proto
from fabric_tpu_torch.serve.protocol import parse_address
from fabric_tpu_torch.serve.qos import class_for_channel, parse_qos_map

logger = must_get_logger("serve.client")

#: Admission-control pacing: capped exponential between BUSY retries,
#: bounded total wait before the client rescues the batch in-process.
BUSY_POLICY = RetryPolicy(
    base_s=0.01, multiplier=2.0, cap_s=0.5, deadline_s=10.0, max_attempts=16
)


class SidecarUnavailable(Exception):
    """The sidecar cannot serve this request (dead socket, stopping,
    protocol violation), or neither it nor the rescue provider could."""


class SidecarClient:
    """One pipelined connection to a sidecar.

    ``submit`` writes the request frame and returns a token;
    ``await_reply`` demultiplexes response frames until the token's
    reply arrives — concurrent callers cooperate under the receive lock,
    and replies may arrive in ANY order (the server settles verify
    requests concurrently): each frame is matched to its waiter by
    request id.  Any socket failure fails every pending token with
    :class:`SidecarUnavailable`.
    """

    def __init__(
        self,
        address: str,
        connect_timeout_s: float = 5.0,
        request_timeout_s: float = 120.0,
    ):
        self.address = address
        self.connect_timeout_s = connect_timeout_s
        self.request_timeout_s = request_timeout_s
        # negotiated protocol revision: optimistic current, stepped down
        # when the connect-time hello is refused
        self.version = proto.PROTOCOL_VERSION
        self._sock = None
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._next_id = 0
        # token -> {"event": Event, "reply": payload|None, "error": exc|None}
        self._pending: Dict[int, Dict] = {}
        # failure-driven dial circuit: a dead endpoint costs one
        # connect_timeout_s, then cools down instead of costing it per batch
        self._dial_gate = CooldownGate()

    # -- connection --------------------------------------------------------
    def _connect(self):
        family, target = parse_address(self.address)
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.settimeout(self.connect_timeout_s)
        try:
            sock.connect(target)
        except OSError:
            sock.close()
            raise
        # the hello stays on the CONNECT budget: a gray endpoint that
        # accepts but never answers stalls a dialer for seconds, not the
        # full request timeout
        return self._hello(sock, family, target)

    def _hello(self, sock, family, target):
        """Connect-time version negotiation: one PING at the preferred
        revision.  Only a reply that is not a PING ST_OK (an older
        server answers one ST_ERROR frame before closing) steps the
        revision down, one per refusal (v3 -> v2 -> v1); a silent EOF
        or reset is a transport failure that raises, so a restart window
        never strips a long-lived client's newer fields."""
        while True:
            refusal = False
            try:
                proto.send_frame(sock, proto.OP_PING, 0, b"",
                                 version=self.version)
                reply = proto.recv_frame(sock)
                if reply is not None:
                    opcode, _rid, payload = reply
                    if opcode == proto.OP_PING:
                        status, _, _, _ = proto.decode_verify_response(payload)
                        if status == proto.ST_OK:
                            sock.settimeout(self.request_timeout_s)
                            return sock
                    refusal = True
            except proto.ProtocolError:
                refusal = True  # unparseable reply: not our revision
            except OSError as exc:
                sock.close()
                raise SidecarUnavailable(f"hello transport: {exc}") from exc
            sock.close()
            if not refusal:
                raise SidecarUnavailable("hello: stream closed")
            if self.version <= proto.MIN_PROTOCOL_VERSION:
                raise SidecarUnavailable(
                    f"hello refused at protocol v{self.version}"
                )
            with self._state_lock:
                self.version -= 1
            sock = socket.socket(family, socket.SOCK_STREAM)
            sock.settimeout(self.connect_timeout_s)
            try:
                sock.connect(target)
            except OSError as exc:
                sock.close()
                raise SidecarUnavailable(f"redial: {exc}") from exc

    def _ensure_sock(self):
        with self._state_lock:
            if self._sock is not None:
                return self._sock
            if not self._dial_gate.ready():
                raise SidecarUnavailable(
                    f"connect {self.address}: cooling down after dial failure"
                )
        # dial OUTSIDE the state lock: close()/_fail_all/the demux must
        # not stall behind a dialer blocked in connect()
        try:
            sock = self._connect()
        except (OSError, SidecarUnavailable) as exc:
            self._dial_gate.record_failure()
            raise SidecarUnavailable(f"connect {self.address}: {exc}") from exc
        self._dial_gate.record_success()
        with self._state_lock:
            if self._sock is None:
                self._sock = sock
                return sock
            winner = self._sock
        sock.close()  # a concurrent dialer won the install race
        return winner

    def _fail_all(self, exc: Exception) -> None:
        """Socket death: every pending waiter learns, the connection is
        torn down (the next call reconnects)."""
        with self._state_lock:
            sock, self._sock = self._sock, None
            pending = list(self._pending.values())
            self._pending.clear()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for entry in pending:
            entry["error"] = SidecarUnavailable(str(exc))
            entry["event"].set()

    def close(self) -> None:
        self._fail_all(SidecarUnavailable("client closed"))

    # -- request plumbing --------------------------------------------------
    def submit(self, opcode: int, payload: bytes) -> int:
        """Send one frame; returns the token to await.  Raises
        SidecarUnavailable on any transport failure."""
        sock = self._ensure_sock()
        with self._send_lock:
            with self._state_lock:
                self._next_id = (self._next_id + 1) & 0xFFFFFFFF
                token = self._next_id
                self._pending[token] = {
                    "event": threading.Event(), "reply": None, "error": None,
                }
            try:
                proto.send_frame(sock, opcode, token, payload,
                                 version=self.version)
            except OSError as exc:
                self._fail_all(exc)
                raise SidecarUnavailable(f"send: {exc}") from exc
        return token

    def await_reply(self, token: int, timeout_s: Optional[float] = None) -> bytes:
        """Block until the token's response payload arrives, at most
        ``timeout_s`` (the connection's request timeout by default)."""
        if timeout_s is None:
            timeout_s = self.request_timeout_s
        out = self._demux_wait(
            token, time.monotonic() + max(0.0, timeout_s), give_up=True
        )
        assert out is not None  # give_up=True raises instead
        return out

    def poll_reply(self, token: int, wait_s: float) -> Optional[bytes]:
        """Bounded, NON-consuming wait: the token's payload if it settles
        within ``wait_s``, else None with the token still pending (the
        router's hedging primitive)."""
        return self._demux_wait(
            token, time.monotonic() + max(0.0, wait_s), give_up=False
        )

    def _demux_wait(
        self, token: int, deadline: float, give_up: bool
    ) -> Optional[bytes]:
        while True:
            with self._state_lock:
                entry = self._pending.get(token)
            if entry is None:
                raise SidecarUnavailable("reply already consumed or failed")
            if entry["event"].is_set():
                with self._state_lock:
                    self._pending.pop(token, None)
                if entry["error"] is not None:
                    raise entry["error"]
                return entry["reply"]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if not give_up:
                    return None  # token stays pending (hedge polling)
                # give up on THIS token only: the connection may be
                # healthy and another waiter mid-demux
                with self._state_lock:
                    self._pending.pop(token, None)
                raise SidecarUnavailable("reply timeout")
            if not self._recv_lock.acquire(timeout=min(remaining, 0.1)):
                continue
            try:
                if entry["event"].is_set():
                    continue  # settled while we waited for the lock
                sock = self._sock
                if sock is None:
                    raise SidecarUnavailable("connection lost")
                # select before recv: a select timeout touches nothing,
                # a recv timeout mid-frame would desync the stream
                readable, _, _ = select.select([sock], [], [], min(remaining, 0.1))
                if not readable:
                    continue
                try:
                    frame = proto.recv_frame(sock)
                except (OSError, proto.ProtocolError) as exc:
                    self._fail_all(exc)
                    raise SidecarUnavailable(f"recv: {exc}") from exc
                if frame is None:
                    self._fail_all(ConnectionError("sidecar closed stream"))
                    raise SidecarUnavailable("sidecar closed the stream")
                _opcode, rid, payload = frame
                with self._state_lock:
                    settled = self._pending.get(rid)
                if settled is not None:
                    settled["reply"] = payload
                    settled["event"].set()
                # else: a reply for a token whose waiter gave up — drop
            finally:
                self._recv_lock.release()

    def cancel(self, token: int) -> None:
        """Best-effort abandon of an in-flight request: the local waiter
        state is dropped NOW, and on a rev-3 connection an OP_CANCEL
        frame tells the server to shed or stop replying.  Never raises:
        a cancel races the settlement by design, and both orders are
        correct."""
        with self._state_lock:
            self._pending.pop(token, None)
            sock = self._sock
        if sock is None or self.version < 3:
            return
        try:
            with self._send_lock:
                proto.send_frame(sock, proto.OP_CANCEL, token, b"",
                                 version=self.version)
        except OSError as exc:
            logger.debug("cancel frame for token %d failed: %s", token, exc)

    def request(
        self, opcode: int, payload: bytes = b"",
        timeout_s: Optional[float] = None,
    ) -> bytes:
        return self.await_reply(self.submit(opcode, payload), timeout_s)

    def ensure_connected(self) -> None:
        """Dial (and hello) now if not connected, so a caller encoding a
        version-dependent payload knows the negotiated revision."""
        self._ensure_sock()

    # -- typed helpers -----------------------------------------------------
    def ping(self, timeout_s: Optional[float] = None) -> bool:
        status, _, _, _ = proto.decode_verify_response(
            self.request(proto.OP_PING, timeout_s=timeout_s)
        )
        return status == proto.ST_OK

    def stats(self, timeout_s: Optional[float] = None) -> Dict:
        return json.loads(self.request(proto.OP_STATS, timeout_s=timeout_s).decode())

    def shutdown(self, timeout_s: Optional[float] = None) -> None:
        self.request(proto.OP_SHUTDOWN, timeout_s=timeout_s)


def encode_lanes(
    keys: Sequence, signatures: Sequence[bytes], digests: Sequence[bytes],
    qos_class: Optional[int] = proto.DEFAULT_QOS, channel: str = "",
    deadline_ms: Optional[int] = None,
    version: int = proto.PROTOCOL_VERSION,
) -> bytes:
    """Provider lanes -> wire payload, deduplicating repeated key objects
    into the frame's key table.  A key that is None or cannot serialize
    goes as NO_KEY — the server answers that lane False.  ``version``
    picks the body layout, which MUST match the frame revision the
    payload rides on; ``qos_class=None`` forces the v1 body."""
    from fabric_tpu_torch.common import p256

    table: List[bytes] = []
    index_of: Dict[int, int] = {}
    lanes: List[Tuple[int, bytes, bytes]] = []
    for key, sig, digest in zip(keys, signatures, digests, strict=True):
        idx = proto.NO_KEY
        if key is not None:
            idx = index_of.get(id(key), -1)
            if idx < 0:
                try:
                    raw = p256.pubkey_to_bytes(key.point)
                except (AttributeError, TypeError, ValueError, OverflowError) as exc:
                    logger.debug("unserializable key (%s); lane fails", exc)
                    raw = None
                if raw is None:
                    idx = proto.NO_KEY
                else:
                    idx = len(table)
                    table.append(raw)
                    index_of[id(key)] = idx
        lanes.append((idx, bytes(sig), bytes(digest)))
    if qos_class is None:
        version = 1  # explicit v1 body
    return proto.encode_verify_request(
        table, lanes,
        qos_class=qos_class if version >= 2 else None,
        channel=channel,
        deadline_ms=(
            (deadline_ms if deadline_ms is not None else 0)
            if version >= 3 else None
        ),
    )


def _resolve_qos(qos) -> Tuple[Optional[int], Dict[str, int]]:
    """(explicit class or None, channel map) from a ``QoS`` setting: a
    class id, a class name, a channel -> class map in text, or None."""
    if qos is None or qos == "":
        return None, {}
    if isinstance(qos, int):
        return qos, {}
    if qos in proto.QOS_NAMES:
        return proto.QOS_NAMES.index(qos), {}
    return None, parse_qos_map(str(qos))


class _RescueMixin:
    """The rescue shared by `SidecarProvider` and the router: the
    in-process provider, built on first need, and the double-fault rule."""

    SEAM = "serve.client"

    def _init_rescue(self, fallback) -> None:
        self._fallback = fallback
        self._fallback_lock = threading.Lock()
        self.degraded = False  # latched: a batch was rescued in-process
        self.rescues = 0

    def fallback_provider(self):
        """The caller's provider, else `bccsp.probe_provider()`: the
        card's `CUDAProvider` (FactoryError with no card)."""
        with self._fallback_lock:
            if self._fallback is None:
                from fabric_tpu_torch.crypto.bccsp import probe_provider

                self._fallback = probe_provider()
            return self._fallback

    def _rescue(self, keys, signatures, digests, why) -> List[bool]:
        """Verify the batch on the rescue provider (the JAX client's
        `_degrade`): the mask stays bit-exact.  A lane with no key is
        False, as the sidecar answers it (the protocol's NO_KEY rule),
        and never reaches the provider.  If the rescue provider fails
        too, raise — never a guessed mask."""
        if not self.degraded:
            logger.warning(
                "%s unavailable (%s); rescuing in-process",
                self._rescue_label(), why,
            )
            # the counter counts degrade TRANSITIONS, not batches
            fabobs.obs_count("fabric_degrade_total", seam=self.SEAM)
            fabobs.obs_trigger(self.SEAM + "_degraded")
        self.degraded = True
        self.rescues += 1
        live = [i for i, key in enumerate(keys) if key is not None]
        mask = [False] * len(keys)
        try:
            if live:
                verdicts = self.fallback_provider().batch_verify(
                    [keys[i] for i in live], [signatures[i] for i in live],
                    [digests[i] for i in live])
                for i, ok in zip(live, verdicts, strict=True):
                    mask[i] = bool(ok)
            return mask
        except Exception as exc:  # the double fault: raise, never guess
            raise SidecarUnavailable(
                f"{self._rescue_label()} unavailable ({why}) and the rescue "
                f"provider failed: {type(exc).__name__}: {exc}"
            ) from exc

    def verify(self, key, signature: bytes, digest: bytes) -> bool:
        return self.fallback_provider().verify(key, signature, digest)


class SidecarProvider(_RescueMixin, Provider):
    """BCCSP rung routing batch verification through a resident sidecar
    and rescuing what it cannot serve on an in-process provider."""

    def __init__(
        self,
        address: str,
        fallback=None,
        busy_policy: RetryPolicy = BUSY_POLICY,
        sleeper: Callable[[float], None] = time.sleep,
        qos_class: Optional[int] = None,
        channel: str = "",
        deadline_ms: int = 0,
        qos_map: Optional[Dict[str, int]] = None,
    ):
        if not address:
            raise ValueError("sidecar address required (BCCSP.SERVE.Address)")
        self.client = SidecarClient(address)
        self.busy_policy = busy_policy
        self._sleeper = sleeper
        self._init_rescue(fallback)
        self.busy_rejects = 0  # admission rejections observed
        self.deadline_expired = 0  # budgets that ran out before a verdict
        # per-batch latency budget (protocol rev 3); 0 = no deadline
        self.deadline_ms = deadline_ms
        # admission class (protocol rev 2): explicit class wins, else the
        # channel map, else the wire default
        self.channel = channel
        self.qos_map = dict(qos_map or {})
        self.qos_class = (qos_class if qos_class is not None
                          else class_for_channel(channel, self.qos_map))

    def _rescue_label(self) -> str:
        return f"sidecar {self.client.address}"

    def _encode(self, keys, signatures, digests,
                remaining_s: Optional[float] = None) -> bytes:
        """Lane payload at the negotiated revision, with the budget
        REMAINING at encode time (floored at 1 ms so a nearly spent
        budget never reads as 'no deadline'), or 0 with none."""
        return encode_lanes(
            keys, signatures, digests,
            qos_class=self.qos_class, channel=self.channel,
            deadline_ms=(
                max(1, int(remaining_s * 1000.0))
                if remaining_s is not None else 0
            ),
            version=self.client.version,
        )

    def _deadline(self) -> Optional[float]:
        if not self.deadline_ms:
            return None
        return time.monotonic() + self.deadline_ms / 1000.0

    def _expire(self, keys, signatures, digests, why) -> List[bool]:
        """Budget ran out: rescue the batch NOW instead of parking on a
        dead-slow socket."""
        self.deadline_expired += 1
        fabobs.obs_count("fabric_serve_deadline_expired_total", seam=self.SEAM)
        return self._rescue(keys, signatures, digests, why)

    def _verify_once(self, payload: bytes, timeout_s: Optional[float] = None):
        token = self.client.submit(proto.OP_VERIFY, payload)
        try:
            return proto.decode_verify_response(
                self.client.await_reply(token, timeout_s)
            )
        except SidecarUnavailable:
            # abandoning the wait must TELL the server, so it does not
            # compute a verdict nobody will read
            self.client.cancel(token)
            raise

    def batch_verify(self, keys, signatures, digests) -> List[bool]:
        return self._batch_verify(keys, signatures, digests, self._deadline())

    def _batch_verify(self, keys, signatures, digests,
                      deadline: Optional[float]) -> List[bool]:
        """The verify loop against an ALREADY-STARTED budget: the async
        resolver re-enters here with its original deadline."""
        n = len(keys)
        if n == 0:
            return []
        t0 = time.perf_counter()
        bo = Backoff(self.busy_policy, sleeper=self._sleeper)
        while True:
            remaining: Optional[float] = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._expire(keys, signatures, digests,
                                        "deadline budget expired")
            try:
                # connect (and hello) BEFORE encoding: the body layout
                # follows the negotiated revision
                self.client.ensure_connected()
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return self._expire(keys, signatures, digests,
                                            "deadline expired during connect")
                payload = self._encode(keys, signatures, digests, remaining)
                status, retry_ms, mask, message = self._verify_once(
                    payload, remaining)
            except (SidecarUnavailable, proto.ProtocolError) as exc:
                if deadline is not None and time.monotonic() >= deadline:
                    return self._expire(keys, signatures, digests, exc)
                return self._rescue(keys, signatures, digests, exc)
            if status == proto.ST_OK:
                if mask is None or len(mask) != n:
                    # a length-skewed mask is a protocol violation; never
                    # stretch or truncate verdicts to fit
                    return self._rescue(
                        keys, signatures, digests,
                        f"mask length {0 if mask is None else len(mask)} != {n}",
                    )
                fabobs.obs_count("fabric_verify_lanes_total", n, rung="serve")
                fabobs.obs_observe("fabric_verify_seconds",
                                   time.perf_counter() - t0, rung="serve")
                return mask
            if status == proto.ST_BUSY:
                self.busy_rejects += 1
                delay = bo.next_delay()
                if delay is None:
                    return self._rescue(keys, signatures, digests,
                                        "admission budget spent")
                if deadline is not None and delay >= deadline - time.monotonic():
                    return self._expire(keys, signatures, digests,
                                        "deadline expired during admission backoff")
                bo.sleep()
                # honour the sidecar's hint, clamped to our own policy
                # cap and the remaining deadline: retry_after_ms is a u32
                # off the wire and must never buy an unbounded sleep
                hint_s = min(retry_ms / 1000.0, self.busy_policy.cap_s)
                if deadline is not None:
                    hint_s = min(hint_s, max(0.0, deadline - time.monotonic()))
                if hint_s > delay:
                    self._sleeper(hint_s - delay)
                continue
            if status == proto.ST_ERROR:
                # transient per-request failure (injected fault, launch
                # error): bounded retry like BUSY, then rescue
                delay = bo.next_delay()
                if (delay is not None and deadline is not None
                        and delay >= deadline - time.monotonic()):
                    return self._expire(keys, signatures, digests,
                                        "deadline expired during error backoff")
                if bo.sleep():
                    continue
                return self._rescue(keys, signatures, digests, message)
            # ST_STOPPING or an unknown status: the sidecar is going away
            return self._rescue(keys, signatures, digests,
                                message or f"status {status}")

    def batch_verify_async(self, keys, signatures, digests):
        """Pipelined dispatch: the request frame goes out NOW; the
        resolver demuxes the reply later.  Any failure at either end
        resolves through the same rescue as the sync path."""
        n = len(keys)
        if n == 0:
            return list
        t0 = time.perf_counter()
        deadline = self._deadline()
        try:
            self.client.ensure_connected()
            payload = self._encode(
                keys, signatures, digests,
                None if deadline is None else deadline - time.monotonic(),
            )
            token = self.client.submit(proto.OP_VERIFY, payload)
        except (proto.ProtocolError, SidecarUnavailable) as exc:
            why = exc
            return lambda: self._rescue(keys, signatures, digests, why)

        def resolve() -> List[bool]:
            timeout_s: Optional[float] = None
            if deadline is not None:
                timeout_s = deadline - time.monotonic()
                if timeout_s <= 0:
                    self.client.cancel(token)
                    return self._expire(keys, signatures, digests,
                                        "deadline expired before resolve")
            try:
                status, _, mask, _ = proto.decode_verify_response(
                    self.client.await_reply(token, timeout_s)
                )
            except (SidecarUnavailable, proto.ProtocolError) as exc:
                if deadline is not None and time.monotonic() >= deadline:
                    return self._expire(keys, signatures, digests, exc)
                return self._rescue(keys, signatures, digests, exc)
            if status == proto.ST_OK and mask is not None and len(mask) == n:
                fabobs.obs_count("fabric_verify_lanes_total", n, rung="serve")
                fabobs.obs_observe("fabric_verify_seconds",
                                   time.perf_counter() - t0, rung="serve")
                return mask
            # BUSY/ERROR/STOPPING at resolve time: the sync path owns the
            # retry and rescue ladder, on the ORIGINAL budget
            return self._batch_verify(keys, signatures, digests, deadline)

        return resolve

    def for_channel(self, channel_id: str) -> "SidecarProvider":
        """A channel-bound view of this provider: the SAME connection
        and rescue provider, the channel's admission class from the
        ``QoS`` map stamped on every batch."""
        cls = class_for_channel(channel_id, self.qos_map)
        if channel_id == self.channel and cls == self.qos_class:
            return self
        bound = copy.copy(self)
        bound.channel = channel_id
        bound.qos_class = cls
        return bound

    def describe_backend(self) -> str:
        if self.degraded:
            return f"serve-degraded({self.fallback_provider().describe_backend()})"
        return f"serve:{self.client.address}"

    def stop(self) -> None:
        self.client.close()


def _provider_from_config(cfg: dict):
    """BCCSP factory hook: ``Default: SERVE`` -> SidecarProvider, or the
    multi-endpoint SidecarRouter when ``SERVE.Endpoints`` lists a fleet.
    With neither ``Address`` nor ``Endpoints`` a FactoryError."""
    from fabric_tpu_torch.crypto.factory import FactoryError

    serve_cfg = (cfg or {}).get("SERVE") or {}
    channel = serve_cfg.get("Channel") or ""
    qos_class, qos_map = _resolve_qos(serve_cfg.get("QoS"))
    deadline_ms = int(serve_cfg.get("DeadlineMs", 0) or 0)
    endpoints = serve_cfg.get("Endpoints")
    if isinstance(endpoints, str):
        endpoints = [a.strip() for a in endpoints.split(",") if a.strip()]
    if endpoints:
        from fabric_tpu_torch.serve.router import (
            DEFAULT_HEDGE_FRACTION,
            DEFAULT_HEDGE_MIN_MS,
            SidecarRouter,
        )

        return SidecarRouter(
            endpoints=endpoints, qos_class=qos_class, channel=channel,
            qos_map=qos_map, deadline_ms=deadline_ms,
            hedge_fraction=float(serve_cfg.get("HedgeFraction",
                                               DEFAULT_HEDGE_FRACTION)),
            hedge_min_ms=float(serve_cfg.get("HedgeMinMs", DEFAULT_HEDGE_MIN_MS)),
        )
    address = serve_cfg.get("Address")
    if not address:
        raise FactoryError("BCCSP.SERVE needs an Address or Endpoints")
    return SidecarProvider(
        address=address, qos_class=qos_class, channel=channel,
        qos_map=qos_map, deadline_ms=deadline_ms,
    )


# Dependency inversion keeps the layers acyclic: the rung registers
# itself with the factory instead of the factory importing upward.
from fabric_tpu_torch.crypto import factory as _factory  # noqa: E402

_factory.register_provider_factory("SERVE", _provider_from_config)
