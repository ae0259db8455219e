"""Multi-sidecar router: peer-side load balancing with failover and
tail tolerance.

The port's counterpart of the JAX package's `serve/router`, less its
environment readers (``FABRIC_TPU_SERVE_ENDPOINTS``,
``FABRIC_TPU_SERVE_HEDGE_FRACTION``, ``FABRIC_TPU_SERVE_HEDGE_MIN_MS``,
``FABRIC_TPU_SERVE_DEADLINE_MS``): endpoints, hedging and the deadline
come from the factory's ``SERVE`` block (``Endpoints``,
``HedgeFraction``, ``HedgeMinMs``, ``DeadlineMs``) or the constructor,
at the JAX defaults.

One sidecar is a warm appliance; a fleet needs several behind every peer
so a single sidecar death is a *routing* event, not a rescue event.
:class:`SidecarRouter` presents the same provider SPI as
``SidecarProvider`` and spreads a peer's batches across N endpoints:

- **bucket-aware placement**: a batch's lane bucket picks its endpoint
  by rendezvous hash (``sha256(bucket | address)``), so each sidecar
  sees a stable subset of shapes, while any endpoint can serve any
  bucket when its preferred one dies;
- **health-probe eviction**: every endpoint carries its own
  ``CooldownGate`` — a dead endpoint is skipped for exponentially longer
  cooldowns and re-probed with a cheap short-timeout PING before it gets
  a real batch again;
- **hedged verification**: every endpoint carries a latency tracker
  (EWMA + bounded reservoir); when the preferred endpoint has not
  answered within a hedge delay derived from its own OBSERVED quantiles,
  the router fires the same batch at the next-ranked endpoint — first
  verdict wins, the loser is cancelled best-effort over OP_CANCEL, and a
  count-based token bucket (default <= 5% extra requests) bounds the
  amplification.  Verification is pure, so first-wins is mask-safe;
- **gray-failure eviction**: an endpoint that is alive but a latency
  outlier (its EWMA far above the fleet's best, or it keeps losing its
  own hedges) is evicted through the same CooldownGate ladder;
- **wire deadlines**: with a per-batch budget every per-hop wait derives
  from the REMAINING budget; an expired budget rescues the batch;
- **re-verify on kill, across endpoints**: a kill or drain mid-batch
  (ST_STOPPING, a dead socket) re-verifies on the next healthy
  endpoint, and only when EVERY endpoint has refused does the router
  rescue the batch in-process, with the client's rule: the rescue
  provider is the caller's or the card's `CUDAProvider`, and a double
  fault raises `SidecarUnavailable`, never a guessed mask;
- **rolling-restart support**: a draining sidecar answers ST_STOPPING,
  the router routes around it, and the restart finds its way back in
  after one successful probe.

``fault_point("serve.route")`` arms each dispatch attempt.  Endpoint
health transitions drive the ``fabric_serve_endpoint_healthy`` gauge;
hedges, wins and evictions drive ``fabric_serve_hedges_total``,
``fabric_serve_hedge_wins_total`` and
``fabric_serve_slow_evictions_total``.
"""

from __future__ import annotations

import collections
import copy
import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.retry import Backoff, CooldownGate, RetryPolicy
from fabric_tpu_torch.crypto.bccsp import Provider
from fabric_tpu_torch.serve import protocol as proto
from fabric_tpu_torch.serve.client import (
    BUSY_POLICY,
    SidecarClient,
    SidecarUnavailable,
    _RescueMixin,
    encode_lanes,
)
from fabric_tpu_torch.serve.qos import class_for_channel

logger = must_get_logger("serve.router")

#: endpoint serving-failure circuit: faster ramp than the default
#: rebuild gate — a routing decision is cheap, a wrong one costs one
#: failed request, and a restarted sidecar should be back in rotation
#: within seconds
ENDPOINT_GATE_POLICY = RetryPolicy(
    base_s=0.25, multiplier=2.0, cap_s=5.0, deadline_s=float("inf")
)

#: lane-bucket ladder for placement (the registry's shape discipline;
#: placement only needs stability, not agreement with any one sidecar's
#: configured ladder)
ROUTE_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)

#: default global hedge budget: extra (hedged) requests as a fraction
#: of primary requests.  5% bounds the amplification an overloaded
#: fleet can see from its own tail-chasing.
DEFAULT_HEDGE_FRACTION = 0.05

#: floor on the derived hedge delay (ms): below this the hedge would
#: race ordinary jitter, not a gray failure
DEFAULT_HEDGE_MIN_MS = 20.0


def _route_bucket(n: int) -> int:
    for b in ROUTE_BUCKETS:
        if n <= b:
            return b
    return ROUTE_BUCKETS[-1]


class _LatencyTracker:
    """Per-endpoint observed service latency: EWMA for the outlier
    signal, a bounded newest-win reservoir for quantiles (the hedge
    delay derives from the endpoint's OWN p9x, not a static knob)."""

    WINDOW = 128

    def __init__(self):
        self._lock = threading.Lock()
        self._window: collections.deque = collections.deque(
            maxlen=self.WINDOW
        )
        self.ewma_s: Optional[float] = None
        self.samples = 0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._window.append(seconds)
            self.samples += 1
            self.ewma_s = (
                seconds
                if self.ewma_s is None
                else 0.8 * self.ewma_s + 0.2 * seconds
            )

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._window:
                return None
            xs = sorted(self._window)
            return xs[min(len(xs) - 1, int(q * (len(xs) - 1)))]


class _HedgeBudget:
    """Count-based token bucket bounding hedges to a fraction of
    primary requests: each primary dispatch earns ``fraction`` tokens
    (capped at ``burst``), each hedge spends one.  No clocks — the
    bound holds per request count, so an overloaded fleet cannot be
    amplified past ``burst + fraction * requests`` extra lanes and the
    chaos scorecard replays bit-identically."""

    def __init__(self, fraction: float, burst: float = 2.0):
        self.fraction = max(0.0, fraction)
        self.burst = max(1.0, burst)
        self._lock = threading.Lock()
        self._tokens = min(1.0, self.burst) if self.fraction > 0 else 0.0
        self.earned = 0  # primary requests seen

    def earn(self) -> None:
        if self.fraction <= 0:
            return
        with self._lock:
            self.earned += 1
            self._tokens = min(self.burst, self._tokens + self.fraction)

    def try_spend(self) -> bool:
        if self.fraction <= 0:
            return False
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class _Endpoint:
    """One sidecar endpoint: pipelined client + serving-failure gate +
    latency tracker.  All mutable health state is guarded by the
    endpoint's lock."""

    def __init__(self, address: str, gate_policy: RetryPolicy,
                 clock: Callable[[], float] = time.monotonic):
        self.address = address
        self.client = SidecarClient(address)
        self.gate = CooldownGate(policy=gate_policy, clock=clock)
        self.tracker = _LatencyTracker()
        self._lock = threading.Lock()
        self._healthy = True
        # consecutive hedges this endpoint lost while primary — the
        # gray-failure signal for an endpoint that never answers first
        # (its latencies never land in the tracker at all)
        self.hedge_losses = 0
        fabobs.obs_gauge(
            "fabric_serve_endpoint_healthy", 1.0, endpoint=address
        )

    @property
    def healthy(self) -> bool:
        with self._lock:
            return self._healthy

    def mark_up(self) -> None:
        self.gate.record_success()
        with self._lock:
            flipped = not self._healthy
            self._healthy = True
        if flipped:
            logger.info("sidecar endpoint %s is healthy again", self.address)
            fabobs.obs_gauge(
                "fabric_serve_endpoint_healthy", 1.0, endpoint=self.address
            )

    def mark_down(self, why: object) -> None:
        self.gate.record_failure()
        with self._lock:
            flipped = self._healthy
            self._healthy = False
            self.hedge_losses = 0
        if flipped:
            logger.warning(
                "sidecar endpoint %s evicted (%s); cooling down",
                self.address, why,
            )
            fabobs.obs_gauge(
                "fabric_serve_endpoint_healthy", 0.0, endpoint=self.address
            )

    def hedge_delay_s(self, floor_s: float) -> float:
        """The wait before this endpoint's unanswered batch is hedged:
        2x its own observed p95 (a healthy endpoint almost never takes
        that long, so hedges fire on genuine tail events), floored so
        ordinary jitter never triggers one.  Before any sample exists
        the delay is a multiple of the floor — conservative until the
        endpoint has shown its shape."""
        q95 = self.tracker.quantile(0.95)
        if q95 is None:
            return floor_s * 5.0
        return max(floor_s, 2.0 * q95)


class SidecarRouter(_RescueMixin, Provider):
    """Provider SPI over N sidecar endpoints with peer-side failover,
    hedging and wire deadlines.

    Hashing and key work run here and a single ``verify()`` on the
    rescue provider, exactly like ``SidecarProvider``."""

    SEAM = "serve.router"

    #: health probes get their OWN short budget: a gray endpoint that
    #: answers nothing must cost the probe path seconds, never the full
    #: request timeout
    PROBE_TIMEOUT_S = 2.0
    #: demux poll slice while a hedge race is in flight
    POLL_SLICE_S = 0.02
    #: gray-failure eviction: an endpoint whose EWMA exceeds
    #: SLOW_FACTOR x the best peer EWMA (and the absolute floor) after
    #: SLOW_MIN_SAMPLES, or that loses HEDGE_LOSS_EVICT consecutive
    #: hedges, is evicted through the cooldown ladder
    SLOW_FACTOR = 4.0
    SLOW_FLOOR_S = 0.05
    SLOW_MIN_SAMPLES = 8
    HEDGE_LOSS_EVICT = 2

    def __init__(
        self,
        endpoints: Sequence[str],
        fallback=None,
        busy_policy: RetryPolicy = BUSY_POLICY,
        sleeper: Callable[[float], None] = time.sleep,
        qos_class: Optional[int] = None,
        channel: str = "",
        gate_policy: RetryPolicy = ENDPOINT_GATE_POLICY,
        clock: Callable[[], float] = time.monotonic,
        deadline_ms: int = 0,
        hedge_fraction: float = DEFAULT_HEDGE_FRACTION,
        hedge_min_ms: float = DEFAULT_HEDGE_MIN_MS,
        qos_map: Optional[Dict[str, int]] = None,
    ):
        if isinstance(endpoints, str):
            endpoints = [a.strip() for a in endpoints.split(",") if a.strip()]
        if not endpoints:
            raise ValueError(
                "router needs at least one sidecar endpoint "
                "(BCCSP SERVE.Endpoints)"
            )
        self.endpoints: List[_Endpoint] = [
            _Endpoint(addr, gate_policy, clock=clock) for addr in endpoints
        ]
        self.busy_policy = busy_policy
        self._sleeper = sleeper
        self._init_rescue(fallback)
        self.busy_rejects = 0
        self.deadline_expired = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.slow_evictions = 0
        self.deadline_ms = deadline_ms
        self.hedge_min_s = max(0.0, hedge_min_ms) / 1000.0
        self.hedge_budget = _HedgeBudget(min(1.0, max(0.0, hedge_fraction)))
        self.channel = channel
        self.qos_map = dict(qos_map or {})
        self.qos_class = (qos_class if qos_class is not None
                          else class_for_channel(channel, self.qos_map))

    # -- placement ---------------------------------------------------------
    def _order(self, lanes: int) -> List[_Endpoint]:
        """Endpoint preference for a batch: rendezvous-hashed on the
        lane bucket over SELECTABLE endpoints (gate ready), so buckets
        spread across the fleet and a cooling endpoint is skipped
        without a dial.  Every selectable endpoint stays in the list —
        positions 2..N are the failover (and hedge) ladder."""
        bucket = _route_bucket(lanes)
        ready = [e for e in self.endpoints if e.gate.ready()]  # a selection filter: mark_up/mark_down record the gate's verdicts
        if not ready:
            return []

        def score(e: _Endpoint) -> bytes:
            return hashlib.sha256(
                f"{bucket}|{e.address}".encode("utf-8", "backslashreplace")
            ).digest()

        return sorted(ready, key=score)

    def _probe_ok(
        self, e: _Endpoint, timeout_s: Optional[float] = None
    ) -> bool:
        """A previously-evicted endpoint earns a real batch back with a
        cheap PING first — a probe failure costs microseconds, a routed
        batch failure costs a re-verify.  The probe rides its OWN short
        timeout (one gray endpoint must never stall the health-probe
        path for the duration of a full request timeout), further
        capped by the caller's remaining wire budget when one exists."""
        if e.healthy:
            return True
        probe_s = self.PROBE_TIMEOUT_S
        if timeout_s is not None:
            probe_s = min(probe_s, max(0.0, timeout_s))
        try:
            if e.client.ping(timeout_s=probe_s):
                e.mark_up()
                return True
        except (SidecarUnavailable, proto.ProtocolError) as exc:
            e.mark_down(exc)
        return False

    # -- deadlines ---------------------------------------------------------
    def _deadline(self) -> Optional[float]:
        if not self.deadline_ms:
            return None
        return time.monotonic() + self.deadline_ms / 1000.0

    def _expire(self, keys, signatures, digests, why) -> List[bool]:
        """The batch's wire budget ran out before any endpoint
        answered: rescue it NOW (bit-exact mask, never a wait past the
        budget)."""
        self.deadline_expired += 1  # stats only
        fabobs.obs_count("fabric_serve_deadline_expired_total", seam=self.SEAM)
        return self._rescue(keys, signatures, digests, why)

    # -- gray-failure eviction ---------------------------------------------
    def _note_latency(self, e: _Endpoint, seconds: float) -> None:
        """A served verdict: record the sample, reset the hedge-loss
        streak, and evict the endpoint if its observed latency is an
        outlier against the fleet's best (the sidecar is alive — it
        answered — but too slow to keep in rotation)."""
        e.tracker.record(seconds)
        with e._lock:
            e.hedge_losses = 0
        # the outlier baseline is the best of the endpoints currently
        # IN ROTATION: a dead/evicted peer's EWMA is frozen at its
        # healthy-era values, and judging the survivor against a
        # ghost's baseline would evict the only live endpoint forever
        best: Optional[float] = None
        for other in self.endpoints:
            if (
                other is e
                or other.tracker.ewma_s is None
                or not other.healthy
                or not other.gate.ready()
            ):
                continue
            if best is None or other.tracker.ewma_s < best:
                best = other.tracker.ewma_s
        if (
            best is not None
            and e.tracker.samples >= self.SLOW_MIN_SAMPLES
            and e.tracker.ewma_s is not None
            and e.tracker.ewma_s > max(self.SLOW_FLOOR_S,
                                       self.SLOW_FACTOR * best)
        ):
            self._evict_slow(
                e,
                f"latency outlier: ewma {e.tracker.ewma_s * 1e3:.1f}ms vs "
                f"fleet best {best * 1e3:.1f}ms",
            )

    def _note_hedge_loss(self, e: _Endpoint) -> None:
        """The primary lost its own hedge: the endpoint is alive (the
        socket is fine) but did not answer inside 2x its own p95 — the
        gray-failure signature.  A short streak evicts it."""
        with e._lock:
            e.hedge_losses += 1
            streak = e.hedge_losses
        if streak >= self.HEDGE_LOSS_EVICT:
            self._evict_slow(
                e, f"lost {streak} consecutive hedges (gray failure)"
            )

    def _evict_slow(self, e: _Endpoint, why: str) -> None:
        # never slow-evict the LAST endpoint in rotation: a slow
        # verdict still beats degrading the whole fleet in-process —
        # gray eviction is a relative judgment and needs a peer to
        # route to (death eviction has no such choice and keeps its
        # own path through mark_down)
        if not any(
            other.healthy and other.gate.ready()
            for other in self.endpoints
            if other is not e
        ):
            logger.warning(
                "endpoint %s is a latency outlier (%s) but the only "
                "one in rotation; keeping it", e.address, why,
            )
            return
        self.slow_evictions += 1  # stats only
        fabobs.obs_count(
            "fabric_serve_slow_evictions_total", endpoint=e.address
        )
        e.mark_down(why)

    def _rescue_label(self) -> str:
        return f"all {len(self.endpoints)} sidecar endpoints"

    # -- one endpoint, one (hedged) attempt --------------------------------
    def _payload_for(
        self, e: _Endpoint, keys, signatures, digests,
        deadline: Optional[float],
    ) -> bytes:
        """Lane payload at THIS endpoint's negotiated revision, with
        the budget REMAINING at encode time when both ends speak v3
        (0 = no budget; the body layout is keyed to the frame rev)."""
        return encode_lanes(
            keys, signatures, digests,
            qos_class=self.qos_class, channel=self.channel,
            deadline_ms=(
                max(1, int((deadline - time.monotonic()) * 1000.0))
                if deadline is not None else 0
            ),
            version=e.client.version,
        )

    def _submit_to(
        self, e: _Endpoint, keys, signatures, digests, attempt: int,
        deadline: Optional[float],
    ) -> Optional[int]:
        """One pipelined dispatch; the token, or None with the endpoint
        marked down (the ladder owns what happens next)."""
        try:
            # chaos seam: an injected routing fault fails THIS attempt
            # on THIS endpoint — the ladder must absorb it
            fault_point("serve.route", key=(e.address, attempt))
            e.client.ensure_connected()
            payload = self._payload_for(e, keys, signatures, digests, deadline)
            return e.client.submit(proto.OP_VERIFY, payload)
        except Exception as exc:  # noqa: BLE001 - endpoint failure (incl. injected) routes to the next rung, never past the mask contract
            logger.debug("endpoint %s submit failed: %s", e.address, exc)
            e.mark_down(exc)
            return None

    def _interpret(
        self, e: _Endpoint, payload: bytes, n: int, t_submit: float,
    ) -> Tuple[str, Optional[List[bool]]]:
        """One reply payload -> ('ok', mask) | ('busy', None) |
        ('dead', None), with health/latency bookkeeping applied."""
        try:
            status, _retry_ms, mask, message = proto.decode_verify_response(
                payload
            )
        except proto.ProtocolError as exc:
            e.mark_down(exc)
            return "dead", None
        if status == proto.ST_OK and mask is not None and len(mask) == n:
            e.mark_up()
            self._note_latency(e, time.monotonic() - t_submit)
            return "ok", mask
        if status == proto.ST_BUSY:
            self.busy_rejects += 1  # stats only
            return "busy", None
        # ST_STOPPING / ST_ERROR / malformed OK: the re-verify-on-kill
        # discipline across endpoints — never trust this settlement,
        # route the batch to the next endpoint
        e.mark_down(message or f"status {status}")
        return "dead", None

    def _try_endpoint(
        self, e: _Endpoint, keys, signatures, digests, attempt: int,
        deadline: Optional[float] = None,
    ) -> Tuple[str, Optional[List[bool]]]:
        """One UN-hedged attempt at one endpoint — the failover
        ladder's unit: ('ok', mask) | ('busy', None) | ('dead', None)
        | ('expired', None).  BUSY is admission control, not endpoint
        failure — the gate only records failures that mean the
        endpoint cannot serve."""
        token = self._submit_to(e, keys, signatures, digests, attempt,
                                deadline)
        if token is None:
            return "dead", None
        return self._await_hedged(
            e, token, time.monotonic(), (), keys, signatures, digests,
            attempt, deadline,
        )

    def _await_hedged(
        self,
        primary: _Endpoint,
        token: int,
        t_submit: float,
        alternates: Sequence[_Endpoint],
        keys, signatures, digests,
        attempt: int,
        deadline: Optional[float],
    ) -> Tuple[str, Optional[List[bool]]]:
        """Wait for the primary's verdict, firing at most ONE hedge at
        the next-ranked endpoint once the primary has been silent for
        its learned hedge delay.  First verdict wins; the loser is
        cancelled best-effort (OP_CANCEL + local demux drop), so a
        verdict from a lost race can never be seen — mask-safety does
        not even depend on verification being pure, though it is.

        Returns ('ok', mask) | ('busy', None) | ('dead', None) |
        ('expired', None)."""
        n = len(keys)
        # overall wall cap: the request timeout (the legacy bound) or
        # the remaining wire budget, whichever is tighter
        stop_at = t_submit + primary.client.request_timeout_s
        if deadline is not None:
            stop_at = min(stop_at, deadline)
        hedge_delay = primary.hedge_delay_s(self.hedge_min_s)
        hedge: Optional[_Endpoint] = None
        hedge_token: Optional[int] = None
        hedge_t0 = 0.0
        hedge_tried = False
        prim_alive = True
        saw_busy = False

        def _drop(e: Optional[_Endpoint], tok: Optional[int]) -> None:
            if e is not None and tok is not None:
                e.client.cancel(tok)

        while True:
            now = time.monotonic()
            if now >= stop_at:
                # walk away from every outstanding socket: the budget
                # (or the request timeout) is the contract, not hope
                _drop(primary if prim_alive else None, token)
                _drop(hedge, hedge_token)
                if deadline is not None and now >= deadline:
                    return "expired", None
                if prim_alive:
                    primary.mark_down("request timeout")
                return ("busy" if saw_busy else "dead"), None
            if not prim_alive and hedge is None:
                return ("busy" if saw_busy else "dead"), None
            # fire the hedge once the primary has been silent too long
            if (
                prim_alive
                and hedge is None
                and not hedge_tried
                and alternates
                and now - t_submit >= hedge_delay
                and (deadline is None or now < deadline)
            ):
                hedge_tried = True
                if self.hedge_budget.try_spend():
                    for alt in alternates:
                        if not alt.healthy:
                            # a hedge goes only to a known-good peer:
                            # dialing a cold/unhealthy alternate here
                            # would stall THIS loop (and the primary's
                            # reply sitting in its socket) for a
                            # connect timeout — the exact tail event
                            # hedging exists to cut
                            continue
                        tok = self._submit_to(
                            alt, keys, signatures, digests, attempt, deadline
                        )
                        if tok is not None:
                            hedge, hedge_token, hedge_t0 = alt, tok, now
                            self.hedges += 1  # stats only
                            fabobs.obs_count("fabric_serve_hedges_total")
                            logger.info(
                                "hedging %d-lane batch: %s silent for "
                                "%.0fms, firing at %s",
                                n, primary.address,
                                (now - t_submit) * 1e3, alt.address,
                            )
                            break
            # poll the primary
            if prim_alive:
                slice_s = min(self.POLL_SLICE_S, max(0.0, stop_at - now))
                if hedge is None:
                    # no race yet: wait in one chunk up to the hedge
                    # fire moment (or the wall cap)
                    slice_s = max(
                        slice_s,
                        min(
                            (t_submit + hedge_delay) - now
                            if alternates and not hedge_tried
                            else self.POLL_SLICE_S * 5,
                            stop_at - now,
                        ),
                    )
                try:
                    payload = primary.client.poll_reply(token, slice_s)
                except SidecarUnavailable as exc:
                    prim_alive = False
                    primary.mark_down(exc)
                    payload = None
                if payload is not None:
                    outcome = self._interpret(primary, payload, n, t_submit)
                    if outcome[0] == "ok":
                        _drop(hedge, hedge_token)
                        return outcome
                    prim_alive = False
                    if outcome[0] == "busy":
                        saw_busy = True
                    if hedge is None:
                        return outcome
            # poll the hedge
            if hedge is not None and hedge_token is not None:
                try:
                    payload = hedge.client.poll_reply(
                        hedge_token, self.POLL_SLICE_S
                    )
                except SidecarUnavailable as exc:
                    hedge.mark_down(exc)
                    hedge, hedge_token = None, None
                    payload = None
                if payload is not None and hedge is not None:
                    outcome = self._interpret(
                        hedge, payload, n, hedge_t0
                    )
                    if outcome[0] == "ok":
                        self.hedge_wins += 1  # stats only
                        fabobs.obs_count("fabric_serve_hedge_wins_total")
                        # the primary lost a race it should have won:
                        # cancel it and score the gray-failure streak
                        if prim_alive:
                            _drop(primary, token)
                            self._note_hedge_loss(primary)
                        return outcome
                    if outcome[0] == "busy":
                        saw_busy = True
                    hedge, hedge_token = None, None

    # -- the batch plane ---------------------------------------------------
    def batch_verify(self, keys, signatures, digests) -> List[bool]:
        return self._batch_verify(keys, signatures, digests,
                                  self._deadline())

    def _batch_verify(
        self, keys, signatures, digests, deadline: Optional[float]
    ) -> List[bool]:
        """The sync ladder against an ALREADY-STARTED budget: the async
        resolver re-enters here with its original deadline, so a
        busy/dead resolve can never restart the per-batch clock."""
        n = len(keys)
        if n == 0:
            return []
        t0 = time.perf_counter()
        bo = Backoff(self.busy_policy, sleeper=self._sleeper)
        attempt = 0
        while True:
            any_busy = False
            for e in self._order(n):
                remaining: Optional[float] = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return self._expire(
                            keys, signatures, digests,
                            "deadline budget expired",
                        )
                # the probe is capped by the remaining budget; the dial
                # inside a submit still rides connect_timeout_s, but a
                # blackholed endpoint pays that once and then cools
                # behind its dial gate, never per batch
                if not self._probe_ok(e, timeout_s=remaining):
                    continue
                attempt += 1
                token = self._submit_to(
                    e, keys, signatures, digests, attempt, deadline
                )
                if token is None:
                    continue
                self.hedge_budget.earn()
                # hedge alternates: the rest of the failover ladder, in
                # preference order (already gate-selected; probed when
                # the hedge actually fires costs a dial we skip — a
                # submit failure just walks to the next alternate)
                outcome, mask = self._await_hedged(
                    e, token, time.monotonic(),
                    [a for a in self._order(n) if a is not e],
                    keys, signatures, digests, attempt, deadline,
                )
                if outcome == "ok":
                    assert mask is not None
                    fabobs.obs_count(
                        "fabric_verify_lanes_total", n, rung="serve"
                    )
                    fabobs.obs_observe(
                        "fabric_verify_seconds",
                        time.perf_counter() - t0, rung="serve",
                    )
                    return mask
                if outcome == "expired":
                    return self._expire(
                        keys, signatures, digests, "deadline budget expired"
                    )
                if outcome == "busy":
                    any_busy = True
            if any_busy:
                delay = bo.next_delay()
                if delay is not None and deadline is not None:
                    # the pacing budget is capped by the remaining wire
                    # budget — fail over or rescue instead of sleeping
                    # past it (the client shim's discipline, fleetwide)
                    if delay >= deadline - time.monotonic():
                        return self._expire(
                            keys, signatures, digests,
                            "deadline expired during admission backoff",
                        )
                if bo.sleep():
                    continue  # every live endpoint is shedding: pace + retry
            return self._rescue(
                keys, signatures, digests,
                "every endpoint busy (budget spent)" if any_busy
                else "no healthy endpoint",
            )

    def batch_verify_async(self, keys, signatures, digests):
        """Pipelined dispatch through the preferred endpoint; the
        resolver waits with the SAME hedged ladder as the sync path,
        and ANY failure re-routes through sync failover (which owns
        the rescue contract)."""
        n = len(keys)
        if n == 0:
            return list
        t0 = time.perf_counter()
        deadline = self._deadline()
        chosen: Optional[_Endpoint] = None
        token = None
        t_submit = 0.0
        for e in self._order(n):
            if not self._probe_ok(e):
                continue
            token = self._submit_to(e, keys, signatures, digests, 0, deadline)
            if token is not None:
                chosen = e
                t_submit = time.monotonic()
                self.hedge_budget.earn()
                break

        def resolve() -> List[bool]:
            if chosen is None or token is None:
                return self._batch_verify(keys, signatures, digests,
                                          deadline)
            outcome, mask = self._await_hedged(
                chosen, token, t_submit,
                [a for a in self._order(n) if a is not chosen],
                keys, signatures, digests, 0, deadline,
            )
            if outcome == "ok":
                assert mask is not None
                fabobs.obs_count("fabric_verify_lanes_total", n, rung="serve")
                fabobs.obs_observe(
                    "fabric_verify_seconds",
                    time.perf_counter() - t0, rung="serve",
                )
                return mask
            if outcome == "expired":
                return self._expire(
                    keys, signatures, digests, "deadline budget expired"
                )
            # busy/dead at resolve time: the sync ladder owns retries,
            # failover and the rescue contract — on the ORIGINAL
            # budget, never a fresh one
            return self._batch_verify(keys, signatures, digests, deadline)

        return resolve

    # -- fleet operations --------------------------------------------------
    def drain_endpoint(self, address: str) -> bool:
        """Ask one sidecar to drain (rolling restart step): True when
        the endpoint acknowledged the OP_DRAIN.  The router marks it
        down immediately so no new batch races the drain."""
        for e in self.endpoints:
            if e.address != address:
                continue
            try:
                reply = e.client.request(proto.OP_DRAIN)
                status, _, _, _ = proto.decode_verify_response(reply)
                e.mark_down("draining (rolling restart)")
                return status == proto.ST_OK
            except (SidecarUnavailable, proto.ProtocolError) as exc:
                e.mark_down(exc)
                return False
        return False

    def for_channel(self, channel_id: str) -> "SidecarRouter":
        """Channel-bound view sharing the endpoint clients, gates and
        hedge budget (one fleet, per-class traffic) — the
        SidecarProvider.for_channel contract over the router."""
        cls = class_for_channel(channel_id, self.qos_map)
        if channel_id == self.channel and cls == self.qos_class:
            return self
        bound = copy.copy(self)
        bound.channel = channel_id
        bound.qos_class = cls
        return bound

    def describe(self) -> dict:
        return {
            "endpoints": [
                {
                    "address": e.address,
                    "healthy": e.healthy,
                    "selectable": e.gate.ready(),
                    "version": e.client.version,
                    "ewma_ms": (
                        round(e.tracker.ewma_s * 1e3, 3)
                        if e.tracker.ewma_s is not None else None
                    ),
                    "p99_ms": (
                        round((e.tracker.quantile(0.99) or 0.0) * 1e3, 3)
                        if e.tracker.samples else None
                    ),
                    "samples": e.tracker.samples,
                }
                for e in self.endpoints
            ],
            "qos_class": proto.qos_name(self.qos_class),
            "channel": self.channel,
            "degraded": self.degraded,
            "rescues": self.rescues,
            "busy_rejects": self.busy_rejects,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "slow_evictions": self.slow_evictions,
            "deadline_expired": self.deadline_expired,
        }

    def describe_backend(self) -> str:
        if self.degraded:
            return (
                "router-degraded("
                f"{self.fallback_provider().describe_backend()})"
            )
        return "serve-router:" + ",".join(e.address for e in self.endpoints)

    def stop(self) -> None:
        for e in self.endpoints:
            e.client.close()
