"""Cross-channel verify coalescing with bounded-queue backpressure.

The port's counterpart of the JAX package's `parallel/batcher`. The card
wants few, large launches; a peer produces many small, bursty verify
requests (one per block, per channel). This batcher sits between them:

- requests enqueue onto ONE bounded queue (backpressure: submitters block
  when the device is behind; admission is all-or-nothing per request);
- the serve sidecar's front door, `try_submit`, admits NOW or refuses
  (the sidecar turns a refusal into ST_BUSY), fires the request's
  `on_dispatch` hook when its lane permits are released, and caps the
  coalescing linger by the request's `deadline_s`; `pending_lanes` is
  the fill signal its retry-after hint scales with;
- a dispatcher thread drains the queue into batches: it takes whatever is
  queued, lingers a few ms for stragglers while the batch is small, then
  launches ONE provider batch (K2 through `CUDAProvider`) for all of it via
  the provider's async path, keeping up to three launches in flight;
- each request gets a resolver for exactly its lanes;
- a failed launch is retried under `common/retry.DISPATCH_POLICY` before
  the error reaches every resolver; `stop` settles what is still
  outstanding all-False, never True.

Transport-regime auto-detection: the batcher measures the time from
dispatch to verdicts of its own small launches (at most `RTT_PROBE_LANES`
lanes, so compute is negligible) and switches between

- "coalesce": linger + merge (low round-trip time);
- "passthrough": every request launches at once as its own batch,
  overlapping in flight like independent callers,

with the bounded-lane admission in force in both. FABRIC_TPU_BATCHER_MODE=
coalesce|passthrough|auto (default auto) forces a mode;
FABRIC_TPU_BATCHER_RTT_MS (default 25) is the auto threshold, with
hysteresis against flapping. A card attached to its host is the low
round-trip case. The threshold is a guess carried from the JAX package:
chip_smoke.py prints the mode and `rtt_ema_ms` the card's runs reach.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.retry import DISPATCH_POLICY, RetryPolicy, call_with_retry

logger = must_get_logger("batcher")


class _Request:
    __slots__ = (
        "keys", "sigs", "digests", "event", "result", "error", "permits",
        "t_submit", "on_dispatch", "deadline_s",
    )

    def __init__(self, keys, sigs, digests, on_dispatch=None,
                 deadline_s=None):
        self.keys = keys
        self.sigs = sigs
        self.digests = digests
        self.event = threading.Event()
        self.result: Optional[List[bool]] = None
        self.error: Optional[BaseException] = None
        self.permits = 0
        self.t_submit = time.perf_counter()
        # fired exactly when this request's lane permits are released
        # (dispatcher pickup) — the serve sidecar's per-class QoS
        # ledger mirrors the batcher's admission window through it
        self.on_dispatch = on_dispatch
        # wire-deadline discipline (serve protocol rev 3): the absolute
        # time.monotonic() moment this request's budget expires, or
        # None.  The dispatcher caps its coalescing linger by the
        # TIGHTEST deadline in the batch.
        self.deadline_s = deadline_s

    def resolve(self) -> List[bool]:
        self.event.wait()  # bounded by the batcher lifetime: stop() settles every admitted request fail-closed (event.set), so this wait can never outlive the batcher
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result

    def fail_closed(self) -> None:
        """Settle with all-False verdicts — a stopped/hung batcher must
        never leave resolve() blocked and must never guess True.  A race
        with a real settlement is benign: whichever lands first wins and
        both outcomes are fail-closed (real verdicts or all-False)."""
        if not self.event.is_set():
            self.result = [False] * len(self.keys)  # documented benign race: both settlements are fail-closed, event.set publishes
            self.event.set()


class VerifyBatcher:
    """submit() returns a resolver; call it to block for the verdicts of
    exactly the submitted lanes."""

    def __init__(
        self,
        provider,
        max_batch: int = 16384,
        linger_s: float = 0.002,
        max_pending_lanes: int = 65536,
        dispatch_retry: Optional[RetryPolicy] = None,
        join_timeout_s: float = 10.0,
    ):
        self.provider = provider
        self.max_batch = max_batch
        self.linger_s = linger_s
        # stop()'s patience for the dispatcher thread before settling
        # stragglers fail-closed (shorten in tests with hung resolvers)
        self.join_timeout_s = join_timeout_s
        # bounded transient retry for a failed launch (pool hiccup,
        # injected fault) before the error fans out to every resolver
        self.dispatch_retry = dispatch_retry or DISPATCH_POLICY
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stop_lock = threading.Lock()
        # every admitted-but-unsettled request, so stop() can settle
        # stragglers fail-closed; guarded by its own lock (stop() holds
        # _stop_lock around the sentinel put — reusing it here would
        # deadlock the dispatcher's settle path against stop's join)
        self._req_lock = threading.Lock()
        self._inflight: set = set()
        self._max_pending_lanes = max_pending_lanes
        # all-or-nothing admission under one condition variable: a
        # per-lane semaphore loop would let two concurrent large submits
        # each grab a partial allocation and deadlock
        self._lanes_cv = threading.Condition()
        self._lanes_free = max_pending_lanes
        self._stopped = False
        self.launches = 0  # introspection: device programs dispatched
        self.lanes = 0  # total lanes verified
        # transport-regime detection (see module docstring)
        self._forced_mode = os.environ.get("FABRIC_TPU_BATCHER_MODE", "auto")
        self._rtt_threshold_ms = float(
            os.environ.get("FABRIC_TPU_BATCHER_RTT_MS", "25")
        )
        self.rtt_ema_ms: Optional[float] = None
        # today _observe_rtt runs only on the dispatcher thread (every
        # _settle call site is inside _run); the lock pins the EWMA
        # read-modify-write as the invariant rather than an accident of
        # the current call graph, so a future settle-from-elsewhere
        # cannot silently introduce the race
        self._rtt_lock = threading.Lock()
        # probe only launches small enough that device compute is
        # negligible next to transport RTT even on an attached card: a
        # large coalesced launch's COMPUTE time would mis-flip a low-RTT
        # card into passthrough
        self.RTT_PROBE_LANES = 64
        self._thread = threading.Thread(
            target=self._run, name="verify-batcher", daemon=True
        )
        self._thread.start()

    @property
    def mode(self) -> str:
        if self._forced_mode in ("coalesce", "passthrough"):
            return self._forced_mode
        if self.rtt_ema_ms is None:
            return "coalesce"  # no signal yet: original default
        # hysteresis band around the threshold stops mode flapping
        if self.rtt_ema_ms > self._rtt_threshold_ms * 1.2:
            return "passthrough"
        if self.rtt_ema_ms < self._rtt_threshold_ms * 0.8:
            return "coalesce"
        return self._last_mode

    _last_mode = "coalesce"

    def _observe_rtt(self, lanes: int, elapsed_s: float) -> None:
        if lanes > self.RTT_PROBE_LANES:
            return
        ms = elapsed_s * 1000.0
        with self._rtt_lock:
            self.rtt_ema_ms = (
                ms
                if self.rtt_ema_ms is None
                else 0.8 * self.rtt_ema_ms + 0.2 * ms
            )
            self._last_mode = self.mode

    @property
    def pending_lanes(self) -> int:
        """Lanes currently admitted but not yet dispatched — the
        admission-control fill signal the serve sidecar scales its
        retry_after hint by."""
        with self._lanes_cv:
            return self._max_pending_lanes - self._lanes_free

    def submit(
        self,
        keys: Sequence,
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
    ) -> Callable[[], List[bool]]:
        """Admit the request's lanes, blocking while the lane budget is
        spent, and return its resolver."""
        resolver = self._admit(keys, signatures, digests, block=True)
        assert resolver is not None  # blocking admission never rejects
        return resolver

    def try_submit(
        self,
        keys: Sequence,
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
        on_dispatch: Optional[Callable[[], None]] = None,
        deadline_s: Optional[float] = None,
    ) -> Optional[Callable[[], List[bool]]]:
        """Non-blocking admission (the serve sidecar's front door): the
        resolver when the lane budget admits the request NOW, else None
        — the caller turns that into an explicit reject-with-retry-after
        instead of stalling a socket thread on the condition variable.
        ``on_dispatch`` fires when the dispatcher picks the request up
        (the moment its lane permits are released) — callers keeping a
        parallel admission ledger release theirs in the same window.
        ``deadline_s`` (absolute ``time.monotonic()``) caps how long the
        dispatcher may linger this request for coalescing company."""
        return self._admit(
            keys, signatures, digests, block=False, on_dispatch=on_dispatch,
            deadline_s=deadline_s,
        )

    def _admit(
        self,
        keys: Sequence,
        signatures: Sequence[bytes],
        digests: Sequence[bytes],
        block: bool,
        on_dispatch: Optional[Callable[[], None]] = None,
        deadline_s: Optional[float] = None,
    ) -> Optional[Callable[[], List[bool]]]:
        n = len(keys)
        if n == 0:
            return list
        # chaos seam: an injected submit fault fails the CALLER before
        # any batcher state is touched (no lanes to leak); unkeyed — a
        # per-site seeded stream, not all-or-nothing per request size
        fault_point("batcher.submit")
        # bounded admission: lanes are taken atomically (all or nothing)
        # and released at dispatch. An oversized request is capped so it
        # can't demand more lanes than exist.
        req = _Request(
            list(keys), list(signatures), list(digests),
            on_dispatch=on_dispatch, deadline_s=deadline_s,
        )
        req.permits = min(n, self._max_pending_lanes)
        with self._lanes_cv:
            while self._lanes_free < req.permits:
                # stop() notifies this cv: an admission-blocked submitter
                # must not wait forever on permits a wedged dispatcher
                # will never release
                if self._stopped:
                    raise RuntimeError("batcher stopped")
                if not block:
                    fabobs.obs_count("fabric_batcher_busy_rejects_total")
                    return None
                self._lanes_cv.wait()  # released by dispatch (lane permits freed) and by stop(), which sets _stopped and notify_all()s this cv — the loop re-checks _stopped every wake, so the wait is bounded by batcher teardown
            self._lanes_free -= req.permits
            pending = self._max_pending_lanes - self._lanes_free
        fabobs.obs_gauge("fabric_batcher_pending_lanes", pending)
        # the stop lock orders every put against the stop sentinel: no
        # request can land behind the None the dispatcher exits on
        with self._stop_lock:
            if self._stopped:
                with self._lanes_cv:
                    self._lanes_free += req.permits
                    self._lanes_cv.notify_all()
                raise RuntimeError("batcher stopped")
            with self._req_lock:
                self._inflight.add(req)
            self._q.put(req)
        return req.resolve

    def verify_batch(self, keys, signatures, digests) -> List[bool]:
        return self.submit(keys, signatures, digests)()

    # -- dispatcher ------------------------------------------------------
    def _take_batch(self) -> Optional[List[_Request]]:
        first = self._q.get()  # the dispatcher's idle park, not a request hop: stop() posts the None sentinel this get() returns on, after settling in-flight work fail-closed
        if first is None:
            return None
        batch = [first]
        lanes = len(first.keys)
        if self.mode == "passthrough":
            # high-RTT regime: dispatch immediately, one launch per
            # request, overlapping in flight (admission control already
            # happened at submit)
            return batch
        waiter = (
            threading.Event()
        )  # fresh event as a precise, interruptible sleep
        while lanes < self.max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                if lanes >= self.max_batch // 2:
                    break  # big enough: don't trade latency for lanes
                # the linger window respects the TIGHTEST wire deadline
                # in the batch: a budgeted request is dispatched, never
                # lingered past the moment its client walks away
                linger = self.linger_s
                tightest = min(
                    (r.deadline_s for r in batch
                     if r.deadline_s is not None),
                    default=None,
                )
                if tightest is not None:
                    linger = min(linger, tightest - time.monotonic())
                if linger > 0:
                    waiter.wait(linger)
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
            if nxt is None:
                self._q.put(None)  # re-post the stop token
                break
            batch.append(nxt)
            lanes += len(nxt.keys)
        return batch

    def _run(self) -> None:
        # entries: (requests, resolver, dispatch_time, lanes)
        pending: List[Tuple] = []
        while True:
            batch = self._take_batch()
            if batch is None:
                for entry in pending:
                    self._settle(*entry)
                return
            keys: List = []
            sigs: List[bytes] = []
            digests: List[bytes] = []
            for r in batch:
                keys.extend(r.keys)
                sigs.extend(r.sigs)
                digests.extend(r.digests)
            with self._lanes_cv:
                self._lanes_free += sum(r.permits for r in batch)
                self._lanes_cv.notify_all()
                released = self._max_pending_lanes - self._lanes_free
            fabobs.obs_gauge("fabric_batcher_pending_lanes", released)
            for r in batch:
                if r.on_dispatch is not None:
                    try:
                        r.on_dispatch()
                    except Exception as exc:  # a ledger hook must never kill the dispatcher
                        logger.warning("on_dispatch hook failed: %s", exc)
            try:
                with fabobs.span(
                    "batcher.launch", lanes=len(keys), requests=len(batch)
                ):
                    resolver = self._launch(keys, sigs, digests)
            except BaseException as exc:  # error propagated to every waiting caller via r.error
                for r in batch:
                    self._settle_error(r, exc)
                if self._q.empty():
                    # mirror the success path's idle drain: without it,
                    # earlier launches still in `pending` would strand
                    # their resolvers behind the blocking q.get() until
                    # unrelated traffic (or stop) arrived
                    while pending:
                        self._settle(*pending.pop(0))
                continue
            self.launches += 1
            self.lanes += len(keys)
            fabobs.obs_count("fabric_batcher_launches_total", mode=self.mode)
            fabobs.obs_observe("fabric_batcher_batch_lanes", len(keys))
            pending.append((batch, resolver, time.perf_counter(), len(keys)))
            # depth-4 pipeline: keep up to three launches in flight before
            # settling the oldest — on high-RTT transports serializing
            # launches costs more than coalescing saves, so small
            # batches overlap like independent callers would while
            # large ones still coalesce
            while len(pending) > 3:
                self._settle(*pending.pop(0))
            if self._q.empty():
                # idle: drain so callers aren't left waiting on us
                while pending:
                    self._settle(*pending.pop(0))

    def _launch(self, keys: List, sigs: List[bytes], digests: List[bytes]):
        """One device/provider launch with bounded transient retry: a
        flapping backend (pool hiccup, injected fault) gets
        dispatch_retry's capped-backoff attempts before the failure fans
        out to every waiting resolver.  The fault site is unkeyed: the
        per-site seeded stream re-rolls the decision on every attempt,
        so a probabilistic plan models a flap the retry can ride out
        (a batch-content key would re-fire identically per attempt)."""
        dispatch = getattr(self.provider, "batch_verify_async", None)

        def attempt(n: int):
            fault_point("batcher.dispatch")
            if dispatch is None:
                # provider without an async seam: compute now, hand back
                # a trivial resolver (CUDAProvider has the seam: it
                # launches and resolves later)
                verdicts = self.provider.batch_verify(keys, sigs, digests)
                return lambda v=verdicts: v
            return dispatch(keys, sigs, digests)

        def on_retry(exc: BaseException, attempt_n: int) -> None:
            fabobs.obs_count("fabric_batcher_dispatch_retries_total")
            fabobs.obs_event(
                "batcher.dispatch_retry",
                attempt=attempt_n, error=type(exc).__name__,
            )

        return call_with_retry(
            attempt, policy=self.dispatch_retry, on_retry=on_retry
        )

    def _settle_error(self, r: _Request, exc: BaseException) -> None:
        if not r.event.is_set():
            r.error = exc
            r.event.set()
        with self._req_lock:
            self._inflight.discard(r)

    def _settle(
        self,
        reqs: List[_Request],
        resolver: Callable,
        t0: float = 0.0,
        lanes: int = 0,
    ) -> None:
        try:
            with fabobs.span("batcher.settle", lanes=lanes):
                out = list(resolver())
            if t0:
                self._observe_rtt(lanes, time.perf_counter() - t0)
        except BaseException as exc:  # error propagated to every waiting caller via r.error
            for r in reqs:
                self._settle_error(r, exc)
            return
        now = time.perf_counter()
        off = 0
        for r in reqs:
            n = len(r.keys)
            if not r.event.is_set():  # stop() may have settled fail-closed
                r.result = out[off : off + n]
                r.event.set()
                fabobs.obs_observe(
                    "fabric_batcher_submit_wait_seconds", now - r.t_submit
                )
            off += n
            with self._req_lock:
                self._inflight.discard(r)

    def stop(self) -> None:
        """Idempotent shutdown.  After the dispatcher exits (or the join
        times out on a hung resolver), every still-unsettled request is
        settled fail-closed (all-False verdicts) so no resolve() caller
        blocks forever and no lane is ever guessed VALID."""
        with self._stop_lock:
            first = not self._stopped
            self._stopped = True
            if first:
                self._q.put(None)
        # wake submitters blocked on lane admission so they observe the
        # stop instead of waiting for permits that will never come back
        with self._lanes_cv:
            self._lanes_cv.notify_all()
        self._thread.join(timeout=self.join_timeout_s)
        with self._req_lock:
            leftovers = list(self._inflight)
            self._inflight.clear()
        for r in leftovers:
            r.fail_closed()
        if leftovers:
            # a fail-closed settlement is exactly the moment worth a
            # flight-recorder snapshot: what led up to the hang is in
            # the ring right now
            fabobs.obs_count(
                "fabric_batcher_fail_closed_total", len(leftovers)
            )
            fabobs.obs_trigger(
                "batcher.fail_closed", requests=len(leftovers)
            )


class BatchingProvider:
    """BCCSP-provider adapter over a shared VerifyBatcher: every channel
    validator on the node funnels its batch_verify through ONE batcher
    (and thus one device-launch queue), while single verify/sign/hash
    calls pass straight through to the wrapped provider."""

    def __init__(self, provider, **batcher_kwargs):
        self._provider = provider
        self.batcher = VerifyBatcher(provider, **batcher_kwargs)

    def batch_verify(self, keys, signatures, digests):
        return self.batcher.verify_batch(keys, signatures, digests)

    def batch_verify_async(self, keys, signatures, digests):
        return self.batcher.submit(keys, signatures, digests)

    def stop(self) -> None:
        self.batcher.stop()

    def __getattr__(self, name):
        return getattr(self._provider, name)
