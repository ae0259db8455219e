"""The resident validation sidecar process.

The port's counterpart of the JAX package's `serve/server`. One
long-lived process owns the verify backend (a `CUDAProvider` on the card,
or `SoftwareProvider` on the host ladder when asked for by name), warms
the lane-bucket registry at startup, and serves whole-batch verification
requests over a local socket. What a cold process pays per invocation
(the kernels' build or load, the provider's key combs, the host pools),
the sidecar pays once per process lifetime.

Request flow per VERIFY frame::

    decode -> serve.dispatch fault seam -> QoS CLASS ADMISSION
    (per-class lane quotas, work-conserving borrowing) -> ADMISSION
    (VerifyBatcher bounded lanes, non-blocking) -> coalesced launch ->
    mask reply

A request that does not fit NOW is REJECTED with ``ST_BUSY`` + a
per-class ``retry_after_ms`` instead of blocking the socket thread; the
client paces its retries with ``common.retry``. Every shed is a
protocol-level reply, never a silent drop.

Lanes with no usable key. The protocol says the server MUST verify a
``NO_KEY`` lane as False, never error the whole batch. The JAX server
hands such lanes to its provider as ``None`` keys, where a per-lane tier
raises (`fabric_tpu/serve/server.py:888-912`). Here `_decode_lanes` takes
``NO_KEY`` lanes and keys that do not decode out before the provider and
answers them False; the provider sees only lanes with a key.

Shutdown is fail-closed *and* mask-exact: in-flight requests settled by a
dying batcher are answered ``ST_STOPPING`` (never an OK carrying guessed
verdicts), so the client re-verifies on its rescue provider. ``drain()``
(OP_DRAIN / SIGTERM) is the rolling-restart half: NEW work answers
``ST_STOPPING`` at once while in-flight requests settle with their real
verdicts.

Engines: ``auto`` and ``device`` are the card (`bccsp.probe_provider`,
which raises with no card); ``host`` is `SoftwareProvider` on the host
ladder, only ever by name. Not ported yet: the mounted operations server
(`ops_address`, `mount_operations`, its health checkers), which waits for
`operations/system`.

Run it::

    python -m fabric_tpu_torch.serve --address /path/to/serve.sock \\
        --engine device --warm verify
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.metrics import latency_summary
from fabric_tpu_torch.serve import protocol as proto
from fabric_tpu_torch.serve.qos import ClassLedger
from fabric_tpu_torch.serve.registry import (
    DEFAULT_BUCKETS,
    BucketProgramRegistry,
    demo_limb_program,
    verify_limb_program,
)

logger = must_get_logger("serve.server")

ENGINES = ("auto", "host", "device")
WARM_LADDERS = ("off", "demo", "verify")

parse_address = proto.parse_address


class ServeStats:
    """Request accounting with a dual surface: ``summary()`` is the
    STATS reply (exact, local, provider-free), while every recording
    call also drives the fabobs metric hooks (``fabric_serve_*``)."""

    RESERVOIR = 8192

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.lanes = 0
        self.rejects = 0
        self.errors = 0
        self.degraded_replies = 0
        # tail tolerance (protocol rev 3): work shed because its wire
        # budget provably could not be met, and requests the client
        # abandoned via OP_CANCEL (pre-dispatch sheds vs replies
        # suppressed after the verdict was computed)
        self.deadline_shed = 0
        self.class_deadline_shed: Dict[str, int] = {}
        self.cancelled_pre = 0
        self.cancelled_post = 0
        # monotone per-bucket service-time floor: the fastest this
        # sidecar has EVER served the bucket — the evidence behind the
        # "provably cannot finish" deadline shed (no evidence = serve)
        self.min_service_s: Dict[int, float] = {}
        # newest-win sliding window
        self._latency_s: collections.deque = collections.deque(
            maxlen=self.RESERVOIR
        )
        self.per_bucket: Dict[int, int] = {}
        self.class_served: Dict[str, int] = {}
        self.class_lanes: Dict[str, int] = {}
        self.class_busy: Dict[str, int] = {}
        self._class_latency_s: Dict[str, collections.deque] = {}

    def record(
        self, lanes: int, bucket: int, seconds: float,
        qos_class: int = proto.DEFAULT_QOS,
    ) -> None:
        cls = proto.qos_name(qos_class)
        with self._lock:
            self.requests += 1
            self.lanes += lanes
            self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + 1
            self._latency_s.append(seconds)
            prior = self.min_service_s.get(bucket)
            if prior is None or seconds < prior:
                self.min_service_s[bucket] = seconds
            self.class_served[cls] = self.class_served.get(cls, 0) + 1
            self.class_lanes[cls] = self.class_lanes.get(cls, 0) + lanes
            window = self._class_latency_s.get(cls)
            if window is None:
                window = self._class_latency_s[cls] = collections.deque(
                    maxlen=self.RESERVOIR
                )
            window.append(seconds)
        fabobs.obs_count("fabric_serve_requests_total", status="ok")
        fabobs.obs_count("fabric_serve_lanes_total", lanes)
        fabobs.obs_count("fabric_serve_class_lanes_total", lanes, cls=cls)
        fabobs.obs_count(
            "fabric_serve_bucket_requests_total", bucket=str(bucket)
        )
        fabobs.obs_observe("fabric_serve_request_seconds", seconds)

    def reject(self, qos_class: int = proto.DEFAULT_QOS) -> None:
        cls = proto.qos_name(qos_class)
        with self._lock:
            self.rejects += 1
            self.class_busy[cls] = self.class_busy.get(cls, 0) + 1
        fabobs.obs_count("fabric_serve_requests_total", status="busy")
        fabobs.obs_count("fabric_serve_class_busy_total", cls=cls)

    def error(self) -> None:
        with self._lock:
            self.errors += 1
        fabobs.obs_count("fabric_serve_requests_total", status="error")

    def stopping_reply(self) -> None:
        with self._lock:
            self.degraded_replies += 1
        fabobs.obs_count("fabric_serve_requests_total", status="stopping")

    def deadline_reject(self, qos_class: int = proto.DEFAULT_QOS) -> None:
        """An explicit ST_BUSY shed because the request's wire budget
        provably cannot be met — counted apart from admission rejects
        (the QoS ledger never saw this request)."""
        cls = proto.qos_name(qos_class)
        with self._lock:
            self.deadline_shed += 1
            self.class_deadline_shed[cls] = (
                self.class_deadline_shed.get(cls, 0) + 1
            )
        fabobs.obs_count(
            "fabric_serve_deadline_expired_total", seam="serve.server"
        )
        fabobs.obs_count(
            "fabric_serve_requests_total", status="deadline_shed"
        )

    def cancel(self, pre_dispatch: bool) -> None:
        with self._lock:
            if pre_dispatch:
                self.cancelled_pre += 1
            else:
                self.cancelled_post += 1

    def floor_s(self, bucket: int) -> Optional[float]:
        """The bucket's best-ever service time (evidence floor for the
        deadline shed), or None before the first served request."""
        with self._lock:
            return self.min_service_s.get(bucket)

    def summary(self) -> Dict:
        with self._lock:
            return {
                "requests": self.requests,
                "lanes": self.lanes,
                "rejects": self.rejects,
                "errors": self.errors,
                "degraded_replies": self.degraded_replies,
                "deadline_shed": self.deadline_shed,
                "cancelled_pre": self.cancelled_pre,
                "cancelled_post": self.cancelled_post,
                "per_bucket": {str(k): v for k, v in self.per_bucket.items()},
                "request_latency": latency_summary(list(self._latency_s)),
                "per_class": {
                    cls: {
                        "served": self.class_served.get(cls, 0),
                        "lanes": self.class_lanes.get(cls, 0),
                        "busy": self.class_busy.get(cls, 0),
                        "deadline_shed": self.class_deadline_shed.get(
                            cls, 0
                        ),
                        "latency": latency_summary(
                            list(self._class_latency_s.get(cls, ()))
                        ),
                    }
                    for cls in proto.QOS_NAMES
                    if self.class_served.get(cls, 0)
                    or self.class_busy.get(cls, 0)
                    or self.class_deadline_shed.get(cls, 0)
                },
            }


class _CancelSet:
    """Per-connection registry of OP_CANCELled request ids, shared by
    the read loop (writer) and the verify workers (consumers).  Bounded
    LRU: a cancel that arrives after its request already settled leaves
    an id nobody will ever take — the cap stops a cancel-spamming
    client from growing server memory."""

    MAX = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._ids: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict()
        )

    def add(self, req_id: int) -> None:
        with self._lock:
            self._ids[req_id] = None
            self._ids.move_to_end(req_id)
            while len(self._ids) > self.MAX:
                self._ids.popitem(last=False)

    def take(self, req_id: int) -> bool:
        """True exactly once per cancelled id."""
        with self._lock:
            return self._ids.pop(req_id, 0) is None


def build_provider(engine: str = "auto", device=None):
    """(provider, engine label) of the sidecar's verify backend:
    ``auto`` and ``device`` the card's `CUDAProvider` (on ``device``
    when given; `FactoryError` with no card), ``host`` `SoftwareProvider`
    on the host EC ladder."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (expected {ENGINES})")
    if engine == "host":
        from fabric_tpu_torch.crypto.bccsp import SoftwareProvider

        return SoftwareProvider(), "host"
    from fabric_tpu_torch.crypto.bccsp import probe_provider

    return probe_provider(device), "device"


class SidecarServer:
    """Resident sidecar: socket front, VerifyBatcher middle, the provider
    behind.  Usable in-process (tests, the chip smoke) or as the
    ``python -m fabric_tpu_torch.serve`` daemon."""

    #: distinct keys whose objects are kept across requests (newest win)
    KEY_CACHE = 4096

    def __init__(
        self,
        address: str,
        engine: str = "auto",
        provider=None,
        device=None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_pending_lanes: int = 65536,
        linger_s: float = 0.002,
        warm_ladder: str = "off",
        retry_after_base_ms: int = 25,
        qos_shares: Optional[Dict[str, float]] = None,
        drain_timeout_s: float = 5.0,
        chaos_key: Optional[int] = None,
    ):
        from fabric_tpu_torch.parallel.batcher import VerifyBatcher

        if warm_ladder not in WARM_LADDERS:
            raise ValueError(
                f"unknown warm ladder {warm_ladder!r} (expected {WARM_LADDERS})"
            )
        self.address = address
        self.buckets = tuple(buckets)
        if provider is not None:
            self.provider, self.engine = provider, engine
        else:
            self.provider, self.engine = build_provider(engine, device)
        self.device = device
        self.batcher = VerifyBatcher(
            self.provider,
            max_pending_lanes=max_pending_lanes,
            linger_s=linger_s,
        )
        self.max_pending_lanes = max_pending_lanes
        self.retry_after_base_ms = retry_after_base_ms
        # per-class admission in FRONT of the batcher's global budget:
        # the ledger's lanes are held submit -> dispatch, the SAME
        # window as the batcher's own permits (released through its
        # on_dispatch hook)
        self.qos = ClassLedger(max_pending_lanes, qos_shares)
        self.drain_timeout_s = drain_timeout_s
        # when set, the serve.dispatch fault point is keyed by this int,
        # so a plan's at= pin can fault ONE sidecar of an in-process fleet
        self.chaos_key = chaos_key
        self._draining = False
        self._active_verifies = 0
        self._drain_cv = threading.Condition()
        self.stats = ServeStats()
        self.registry: Optional[BucketProgramRegistry] = None
        self.warm_ladder = warm_ladder
        self.warm_report: Dict = {}
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._stopping = False
        self._started = False
        # SEC1 key bytes -> key object (or None), shared across requests
        self._keys: "collections.OrderedDict[bytes, object]" = collections.OrderedDict()
        self._key_lock = threading.Lock()

    # -- warm-up -----------------------------------------------------------
    def warm(self) -> Dict:
        """Pre-warm before accepting traffic: one small batch through the
        batcher and provider, then the bucket ladder when asked.  Returns
        the warm report."""
        t0 = time.perf_counter()
        report: Dict = {"engine": self.engine, "ladder": self.warm_ladder}
        report["host_warm_ms"] = round(self._warm_host() * 1000.0, 3)
        if self.warm_ladder != "off":
            device = getattr(self.provider, "device", None)
            if device is None:
                from fabric_tpu_torch.ops import cudalib

                device = cudalib.resolve_device(self.device, "serve registry")
            ladder = (demo_limb_program if self.warm_ladder == "demo"
                      else verify_limb_program)
            self.registry = BucketProgramRegistry.for_program(
                *ladder(device), buckets=self.buckets,
                label=f"serve-{self.warm_ladder}",
            )
            self.registry.warm()
            report["per_bucket"] = {
                str(k): v for k, v in self.registry.warm_report.items()
            }
        report["total_warm_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        # the kernel libraries this process loaded so far: built by nvcc,
        # or found in the build cache (a warm start)
        from fabric_tpu_torch.ops import cudalib

        report["library_loads"] = dict(cudalib.LOAD_EVENTS)
        self.warm_report = report
        for bucket, rep in (report.get("per_bucket") or {}).items():
            fabobs.obs_gauge("fabric_serve_bucket_warm_ms", rep["warm_ms"],
                             bucket=bucket)
            fabobs.obs_gauge("fabric_serve_bucket_builds", rep["builds"],
                             bucket=bucket)
        return report

    def _warm_host(self) -> float:
        """One tiny batch through the batcher and provider (a fixed key
        and nonce signed by the oracle) so the provider's first-call
        costs are paid before the first real request."""
        from fabric_tpu_torch.common import der, p256
        from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey

        t0 = time.perf_counter()
        priv = 0x5EA7ED
        digest = hashlib.sha256(b"serve warm lane").digest()
        sig = der.marshal_signature(*p256.sign_digest(priv, digest, 0xBEEF))
        key = ECDSAPublicKey(*p256.base_mult(priv))
        n = 8
        mask = self.batcher.verify_batch([key] * n, [sig] * n, [digest] * n)
        if list(mask) != [True] * n:
            raise RuntimeError("warm-up batch failed verification")
        return time.perf_counter() - t0

    # -- socket front ------------------------------------------------------
    def start(self) -> str:
        """Bind + accept loop; returns the bound address (TCP port
        resolved).  ``warm()`` is NOT implied — call it first so the
        READY line means 'steady state will not build'."""
        family, target = parse_address(self.address)
        listener = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_UNIX:
            try:
                os.unlink(target)
            except FileNotFoundError:
                pass
        else:
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(target)
        listener.listen(64)
        if family != socket.AF_UNIX:
            host, port = listener.getsockname()[:2]
            self.address = f"{host}:{port}"
        self._listener = listener
        self._started = True
        accept = threading.Thread(
            target=self._accept_loop, name="serve-accept", daemon=True
        )
        accept.start()
        with self._conn_lock:
            self._threads.append(accept)
        logger.info("sidecar serving on %s (engine %s)", self.address, self.engine)
        return self.address

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="serve-conn", daemon=True,
            )
            fabobs.obs_count("fabric_serve_connections_total", event="open")
            with self._conn_lock:
                if self._stopping:
                    conn.close()
                    return
                self._conns.append(conn)
                # register BEFORE start: a connection that EOFs at once
                # would otherwise run its cleanup-remove before the append
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            self._serve_conn_inner(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass  # stop() already claimed it
                try:
                    self._threads.remove(threading.current_thread())
                except ValueError:
                    pass
            fabobs.obs_count("fabric_serve_connections_total", event="close")

    def _spawn(self, target: Callable[[], None], name: str) -> None:
        """A stop or drain thread, registered on _threads like every
        other serve thread (stop() skips joining current_thread, so a
        self-stop cannot deadlock on itself)."""
        t = threading.Thread(target=target, name=name, daemon=True)
        with self._conn_lock:
            self._threads.append(t)
        t.start()

    def _serve_conn_inner(self, conn: socket.socket) -> None:
        # one writer lock per connection: verify requests settle on
        # worker threads (the read loop keeps draining frames so a
        # client's pipelined requests coalesce in the batcher), and
        # interleaved sendall calls would corrupt frames
        send_lock = threading.Lock()
        workers: List[threading.Thread] = []
        cancelled = _CancelSet()
        ok = proto.encode_verify_response(proto.ST_OK, mask=[])
        try:
            while True:
                frame = proto.recv_frame_ex(conn)
                if frame is None:
                    return
                opcode, req_id, payload, version = frame
                if opcode == proto.OP_CANCEL:
                    # fire-and-forget by contract: NO reply frame
                    cancelled.add(req_id)
                elif opcode == proto.OP_PING:
                    self._send(conn, proto.OP_PING, req_id, ok, send_lock,
                               version=version)
                elif opcode == proto.OP_STATS:
                    self._send(
                        conn, proto.OP_STATS, req_id,
                        json.dumps(self.describe(), sort_keys=True).encode(),
                        send_lock, version=version,
                    )
                elif opcode == proto.OP_SHUTDOWN:
                    self._send(conn, proto.OP_SHUTDOWN, req_id, ok, send_lock,
                               version=version)
                    self._spawn(self.stop, "serve-shutdown")
                    return
                elif opcode == proto.OP_DRAIN:
                    # the OK goes out before the drain so the restart
                    # orchestrator is not racing its own ack
                    self._send(conn, proto.OP_DRAIN, req_id, ok, send_lock,
                               version=version)
                    self._spawn(self.drain_and_stop, "serve-drain")
                    return
                elif opcode == proto.OP_VERIFY:
                    w = threading.Thread(
                        target=self._handle_verify,
                        args=(conn, req_id, payload, send_lock, version,
                              cancelled),
                        name="serve-verify", daemon=True,
                    )
                    w.start()
                    workers.append(w)
                    workers = [t for t in workers if t.is_alive()]
                else:
                    self._send(
                        conn, opcode, req_id,
                        proto.encode_verify_response(
                            proto.ST_ERROR,
                            message=f"unknown opcode {opcode}",
                        ),
                        send_lock, version=version,
                    )
        except proto.ProtocolError as exc:
            # a desynced STREAM is unusable (bad magic, oversized frame):
            # answer if possible, close.  Payload-level decode failures
            # never reach here; _handle_verify answers them ST_ERROR.
            logger.warning("protocol error on %s: %s", self.address, exc)
            self._try_reply_error(conn, 0, exc, send_lock)
        except OSError:
            pass  # peer went away; nothing to answer
        finally:
            for w in workers:
                w.join(timeout=2.0)
            try:
                conn.close()
            except OSError:
                pass

    # -- the verify path ---------------------------------------------------
    def _handle_verify(
        self, conn, req_id: int, payload: bytes, send_lock=None,
        version: int = 1, cancelled: Optional[_CancelSet] = None,
    ) -> None:
        """Decode, class-admit, admit, launch, reply (on a per-request
        worker thread; replies may interleave out of order — the client
        demuxes by request id).  Every failure path answers a non-OK
        status; this never replies OK with verdicts it did not compute,
        and every shed is an explicit ST_BUSY frame (a cancelled request
        excepted: its client abandoned the reply)."""
        t0 = time.perf_counter()
        qos_class = proto.DEFAULT_QOS
        release_qos: Optional[Callable[[], None]] = None
        entered = False
        try:
            # chaos seam: an injected dispatch fault fails THIS request
            # with ST_ERROR before any batcher state is touched
            fault_point("serve.dispatch", key=self.chaos_key)
            with fabobs.span("serve.decode", req_id=req_id):
                (keys, sigs, digests, live, n, qos_class, channel,
                 deadline_ms) = self._decode_lanes(payload, version)
            if self._stopping or self._draining:
                self.stats.stopping_reply()
                self._reply_status(conn, req_id, proto.ST_STOPPING,
                                   send_lock=send_lock, version=version)
                return
            entered = self._enter_verify()
            if not entered:
                self.stats.stopping_reply()
                self._reply_status(conn, req_id, proto.ST_STOPPING,
                                   send_lock=send_lock, version=version)
                return
            if cancelled is not None and cancelled.take(req_id):
                self.stats.cancel(pre_dispatch=True)
                return
            bucket = self.registry.bucket_for(n) if self.registry is not None else n
            if deadline_ms > 0:
                floor = self.stats.floor_s(bucket)
                if floor is not None and deadline_ms / 1000.0 < floor:
                    # the budget is smaller than the FASTEST this sidecar
                    # has ever served the bucket: provably unfinishable
                    self.stats.deadline_reject(qos_class)
                    self._reply_status(
                        conn, req_id, proto.ST_BUSY,
                        retry_after_ms=self.retry_after_ms(qos_class),
                        send_lock=send_lock, version=version,
                    )
                    return
            verdicts: List[bool] = []
            if keys:
                if not self.qos.try_acquire(qos_class, len(keys)):
                    self.stats.reject(qos_class)
                    self._reply_status(
                        conn, req_id, proto.ST_BUSY,
                        retry_after_ms=self.retry_after_ms(qos_class),
                        send_lock=send_lock, version=version,
                    )
                    return
                # class lanes release when the dispatcher picks the
                # request up (on_dispatch), one-shot so the failure-path
                # release in the finally block can never double-free
                release_qos = self._qos_release_once(qos_class, len(keys))
                resolver = self.batcher.try_submit(
                    keys, sigs, digests, on_dispatch=release_qos,
                    deadline_s=(
                        time.monotonic() + deadline_ms / 1000.0
                        if deadline_ms > 0 else None
                    ),
                )
                if resolver is None:
                    self.stats.reject(qos_class)
                    self._reply_status(
                        conn, req_id, proto.ST_BUSY,
                        retry_after_ms=self.retry_after_ms(qos_class),
                        send_lock=send_lock, version=version,
                    )
                    return
                with fabobs.span(
                    "serve.verify", req_id=req_id, lanes=len(keys),
                    cls=proto.qos_name(qos_class), channel=channel,
                ):
                    verdicts = list(resolver())
                if len(verdicts) != len(keys):
                    raise RuntimeError(
                        f"provider answered {len(verdicts)} verdicts for "
                        f"{len(keys)} lanes"
                    )
            if self._stopping:
                # the batcher may have settled this request fail-closed
                # during shutdown: tell the client to re-verify
                self.stats.stopping_reply()
                self._reply_status(conn, req_id, proto.ST_STOPPING,
                                   send_lock=send_lock, version=version)
                return
            if cancelled is not None and cancelled.take(req_id):
                self.stats.cancel(pre_dispatch=False)
                return
            mask = [False] * n
            for i, ok in zip(live, verdicts):
                mask[i] = ok
            # record BEFORE the reply frame: a client that has seen the
            # OK must also see it in STATS
            self.stats.record(n, bucket, time.perf_counter() - t0, qos_class)
            self._send(
                conn, proto.OP_VERIFY, req_id,
                proto.encode_verify_response(proto.ST_OK, mask=mask),
                send_lock, version=version,
            )
        except Exception as exc:  # per-request fail-closed: ST_ERROR, logged
            # includes a payload-level ProtocolError: recv_frame already
            # consumed the whole frame, so the stream is still in sync
            logger.warning("verify request failed (%s); replying ST_ERROR", exc)
            self.stats.error()
            self._try_reply_error(conn, req_id, exc, send_lock, version)
        finally:
            if release_qos is not None:
                release_qos()
            if entered:
                self._exit_verify()

    def _qos_release_once(
        self, qos_class: int, lanes: int
    ) -> Callable[[], None]:
        """One-shot ledger release shared by the dispatch hook and the
        handler's failure paths (whichever fires first wins)."""
        state = {"done": False}
        state_lock = threading.Lock()

        def release() -> None:
            with state_lock:
                if state["done"]:
                    return
                state["done"] = True
            self.qos.release(qos_class, lanes)

        return release

    def _enter_verify(self) -> bool:
        """Count this worker into the drain barrier; False when the
        sidecar began draining while the worker was being scheduled."""
        with self._drain_cv:
            if self._draining or self._stopping:
                return False
            self._active_verifies += 1
            return True

    def _exit_verify(self) -> None:
        with self._drain_cv:
            self._active_verifies -= 1
            if self._active_verifies <= 0:
                self._drain_cv.notify_all()

    def _key(self, raw: bytes):
        """The key object for a SEC1 key, one per key across requests, or
        None for a key that does not import.  The provider dedups key
        columns by object, so requests the batcher coalesces must share
        their keys' objects: each request's own objects would count a key
        once a request and push a coalesced launch of many requests past
        the 32-column bucket, onto the limb route (K1)."""
        from fabric_tpu_torch.common import p256
        from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey

        with self._key_lock:
            if raw in self._keys:
                self._keys.move_to_end(raw)
                return self._keys[raw]
        try:
            key = ECDSAPublicKey(*p256.pubkey_from_bytes(raw))
        except ValueError as exc:
            logger.debug("unusable key in verify request (%s)", exc)
            key = None
        with self._key_lock:
            key = self._keys.setdefault(raw, key)
            while len(self._keys) > self.KEY_CACHE:
                self._keys.popitem(last=False)
        return key

    def _decode_lanes(self, payload: bytes, version: int = 1):
        """Wire lanes -> the provider's lanes: (keys, sigs, digests, live,
        n, qos_class, channel, deadline_ms).  ``live`` holds the request
        positions of the lanes handed to the provider; a ``NO_KEY`` lane
        or one whose key fails SEC1 import is left out, and answered
        False (the protocol's fail-closed rule), never an error that
        would take down the batch's good lanes."""
        (key_bytes, lanes, qos_class, channel,
         deadline_ms) = proto.decode_verify_request(payload, version)
        key_objs = [self._key(raw) for raw in key_bytes]
        keys, sigs, digests, live = [], [], [], []
        for i, (idx, sig, digest) in enumerate(lanes):
            key = key_objs[idx] if idx != proto.NO_KEY else None
            if key is None:
                continue
            keys.append(key)
            sigs.append(sig)
            digests.append(digest)
            live.append(i)
        return (keys, sigs, digests, live, len(lanes), qos_class, channel,
                deadline_ms)

    def retry_after_ms(self, qos_class: Optional[int] = None) -> int:
        """Admission-control hint: scale the base backoff by queue
        fill; with a class, the CLASS's quota fill is the signal."""
        fill = self.batcher.pending_lanes / max(self.max_pending_lanes, 1)
        if qos_class is not None:
            fill = max(fill, self.qos.fill(qos_class))
        return max(5, int(self.retry_after_base_ms * (1.0 + 3.0 * fill)))

    @staticmethod
    def _send(
        conn, opcode: int, req_id: int, payload: bytes, send_lock=None,
        version: int = proto.PROTOCOL_VERSION,
    ):
        """One frame out, serialized under the connection's writer lock
        when given.  Replies echo the REQUEST frame's version so a v1
        client never sees a header its recv loop would refuse."""
        if send_lock is not None:
            with send_lock:
                proto.send_frame(conn, opcode, req_id, payload, version=version)
        else:
            proto.send_frame(conn, opcode, req_id, payload, version=version)

    def _reply_status(
        self, conn, req_id: int, status: int, retry_after_ms: int = 0,
        send_lock=None, version: int = 1,
    ) -> None:
        reply = proto.encode_verify_response(
            status, message="", retry_after_ms=retry_after_ms
        )
        try:
            self._send(conn, proto.OP_VERIFY, req_id, reply, send_lock,
                       version=version)
        except OSError as exc:
            logger.warning("reply failed (%s); the client will rescue", exc)

    def _try_reply_error(
        self, conn, req_id: int, exc: BaseException, send_lock=None,
        version: int = 1,
    ) -> None:
        reply = proto.encode_verify_response(
            proto.ST_ERROR, message=f"{type(exc).__name__}: {exc}"
        )
        try:
            self._send(conn, proto.OP_VERIFY, req_id, reply, send_lock,
                       version=version)
        except OSError as send_exc:
            logger.warning(
                "error reply failed (%s) after %s; the client will rescue",
                send_exc, exc,
            )

    # -- introspection -----------------------------------------------------
    def describe(self) -> Dict:
        out = {
            "address": self.address,
            "engine": self.engine,
            "backend": self.provider.describe_backend(),
            "buckets": list(self.buckets),
            "max_pending_lanes": self.max_pending_lanes,
            "pending_lanes": self.batcher.pending_lanes,
            "launches": self.batcher.launches,
            "batched_lanes": self.batcher.lanes,
            "warm": self.warm_report,
            "stats": self.stats.summary(),
            "qos": self.qos.snapshot(),
            "stopping": self._stopping,
            "draining": self._draining,
        }
        if self.registry is not None:
            out["registry"] = self.registry.stats()
        return out

    # -- drain (rolling restart) -------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Refuse NEW verify work (``ST_STOPPING``) while in-flight
        requests settle with their real verdicts; True when the last
        in-flight request settled inside the timeout.  The batcher stays
        alive, so nothing settles fail-closed."""
        if timeout_s is None:
            timeout_s = self.drain_timeout_s
        with self._drain_cv:
            self._draining = True
        logger.info("sidecar on %s draining (timeout %.1fs)",
                    self.address, timeout_s)
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._drain_cv:
            while self._active_verifies > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    logger.warning(
                        "drain timed out with %d verify worker(s) in "
                        "flight; stop() will settle them ST_STOPPING",
                        self._active_verifies,
                    )
                    return False
                self._drain_cv.wait(min(remaining, 0.2))
        return True

    def drain_and_stop(self) -> None:
        """The OP_DRAIN / SIGTERM path: settle in-flight, then exit."""
        self.drain()
        self.stop()

    # -- shutdown ----------------------------------------------------------
    def stop(self) -> None:
        """Idempotent: refuse new work, settle the batcher (fail-closed),
        close the socket front.  In-flight verify handlers observe
        ``_stopping`` and answer ST_STOPPING, never guessed verdicts."""
        with self._conn_lock:
            if self._stopping:
                return
            self._stopping = True
        if self._listener is not None:
            # close() alone does not wake a thread blocked in accept():
            # shut the listener down, then poke it with a throwaway
            # connect so the accept loop observes the stop now
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                family, target = parse_address(self.address)
                poke = socket.socket(family, socket.SOCK_STREAM)
                poke.settimeout(0.2)
                try:
                    poke.connect(target)
                except OSError:
                    pass
                finally:
                    poke.close()
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        self.batcher.stop()
        with self._conn_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        with self._conn_lock:
            threads = list(self._threads)
        for t in threads:
            if t is not threading.current_thread():
                try:
                    t.join(timeout=2.0)
                except RuntimeError:
                    pass  # registered but not yet started
        family, target = parse_address(self.address)
        if family == socket.AF_UNIX and self._started:
            try:
                os.unlink(target)
            except OSError:
                pass
        logger.info("sidecar on %s stopped", self.address)


# ---------------------------------------------------------------------------
# CLI entrypoint: python -m fabric_tpu_torch.serve
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="fabric_tpu_torch.serve",
        description="resident validation sidecar: admission-controlled "
        "batch verify serving from a warm process on the card",
    )
    ap.add_argument(
        "--address", required=True,
        help="unix socket path (contains '/') or host:port",
    )
    ap.add_argument("--engine", default="auto", choices=ENGINES)
    ap.add_argument(
        "--device", default=None,
        help="the card the device engine runs on (default: cuda)",
    )
    ap.add_argument(
        "--buckets", default="",
        help="comma-separated lane bucket ladder (default: "
        + ",".join(str(b) for b in DEFAULT_BUCKETS) + ")",
    )
    ap.add_argument(
        "--warm", default="off", choices=WARM_LADDERS,
        help="bucket ladder to warm: 'verify' = K1 at each bucket, "
        "'demo' = the ops.bignum exponentiation, 'off' = one small batch "
        "through the provider only",
    )
    ap.add_argument("--max-pending-lanes", type=int, default=65536)
    ap.add_argument("--linger-ms", type=float, default=2.0)
    ap.add_argument(
        "--qos-shares", default="",
        help="per-class admission lane shares, e.g. "
        "'high=0.5,normal=0.35,bulk=0.15' (empty = defaults)",
    )
    ap.add_argument(
        "--drain-timeout-s", type=float, default=5.0,
        help="rolling-restart drain budget: how long SIGTERM/OP_DRAIN "
        "waits for in-flight requests to settle with real verdicts",
    )
    args = ap.parse_args(argv)

    from fabric_tpu_torch.serve.qos import parse_shares

    buckets = (
        tuple(int(b) for b in args.buckets.split(",") if b.strip())
        if args.buckets else DEFAULT_BUCKETS
    )
    server = SidecarServer(
        args.address,
        engine=args.engine,
        device=args.device,
        buckets=buckets,
        max_pending_lanes=args.max_pending_lanes,
        linger_s=args.linger_ms / 1000.0,
        warm_ladder=args.warm,
        qos_shares=parse_shares(args.qos_shares) if args.qos_shares else None,
        drain_timeout_s=args.drain_timeout_s,
    )
    warm = server.warm()
    addr = server.start()
    # the READY line: one JSON line on stdout once warm-up is done
    print("SERVE_READY " + json.dumps({"address": addr, "warm": warm},
                                      sort_keys=True), flush=True)

    done = threading.Event()

    def _stop(signum, frame):  # signal handler signature
        done.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        while not done.is_set() and not server._stopping:
            done.wait(0.2)
    finally:
        if not server._stopping:
            # SIGTERM/SIGINT: drain first, so a rolling restart under
            # load never turns a computed mask into a fail-closed one
            server.drain()
        server.stop()
        print("SERVE_EXIT " + json.dumps(server.stats.summary(),
                                         sort_keys=True), flush=True)
    return 0
