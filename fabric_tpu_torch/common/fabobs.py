"""fabobs — process-wide observability registry of the commit path.

The part of the JAX package's `common/fabobs` that the port's commit path
calls: `span`, `obs_count`, `obs_gauge`, `obs_observe`, `obs_event`,
`obs_trigger`, the bucket ladders (`STAGE_BUCKETS`), and the registry
behind them. The same discipline holds: with no registry installed a hook
costs one module-global load and a ``None`` check; installed, it drives the
metric families of `CANONICAL_METRICS` (counters, gauges and histograms of
`common/metrics.PrometheusProvider`, read in process through
`ObsRegistry.value`) and records spans and events into a bounded flight
ring, read through `ObsRegistry.trace_events`.

The operations server reads it through the registry's `render` (the
provider's Prometheus text), `snapshot` and `dump` (the flight ring as
Chrome trace-event JSON), and a node shares one registry with its
operations server through `ensure_enabled`.

Left out: the metric families of the JAX serve path's XLA caches and of its
resident MVCC table, automatic dumps to a directory on `obs_trigger` (the
port records the event and writes no file; `dump(path)` writes one on
request), and installation from the environment (``FABRIC_TPU_OBS``): the
port reads no ``FABRIC_TPU_*`` routing, so a caller enables the registry
itself. An observability failure is swallowed with a debug log: a hook can
slow a verify path down, never alter it or fail it.

Enable programmatically (tests and chip_smoke.py use the scoped form)::

    from fabric_tpu_torch.common import fabobs
    reg = fabobs.enable()
    with fabobs.obs_installed() as reg: ...
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.common import metrics as metrics_mod
from fabric_tpu_torch.common.flogging import must_get_logger

logger = must_get_logger("fabobs")

# latency histograms: the shared prometheus-style seconds ladder
LATENCY_BUCKETS = metrics_mod.DEFAULT_BUCKETS
# lane-count histograms (batch sizes): powers of four up to the
# max_pending_lanes default, so bucket edges track the bucket ladder
LANE_BUCKETS = (1.0, 8.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0)
# pipeline-stage latency: the default ladder extended downward — warm
# host-ladder prepare sits in the sub-millisecond range the 5ms lowest
# default bucket would flatten.  ONE definition shared by the /metrics
# series AND peer/pipeline's embedded stage_stats state, so the two
# surfaces can never quantize the same stage differently.
STAGE_BUCKETS = (0.0005, 0.001, 0.0025) + LATENCY_BUCKETS


@dataclass(frozen=True)
class MetricSpec:
    """One canonical family: its name, kind, labels and the seam that
    emits it."""

    name: str
    kind: str  # counter | gauge | histogram
    labels: Tuple[str, ...]
    help: str
    seam: str
    buckets: Tuple[float, ...] = ()


#: The canonical metric-name table of the port: an unknown family is
#: swallowed (debug log), never implicitly registered.
CANONICAL_METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec(
        "fabric_batcher_pending_lanes", "gauge", (),
        "lanes admitted but not yet dispatched (admission-control fill)",
        "parallel/batcher.py submit/_run",
    ),
    MetricSpec(
        "fabric_batcher_batch_lanes", "histogram", (),
        "coalesced lanes per device/provider launch",
        "parallel/batcher.py _run", LANE_BUCKETS,
    ),
    MetricSpec(
        "fabric_batcher_submit_wait_seconds", "histogram", (),
        "submit -> settle latency per request",
        "parallel/batcher.py _settle", LATENCY_BUCKETS,
    ),
    MetricSpec(
        "fabric_batcher_launches_total", "counter", ("mode",),
        "provider launches by transport mode (coalesce|passthrough)",
        "parallel/batcher.py _run",
    ),
    MetricSpec(
        "fabric_batcher_busy_rejects_total", "counter", (),
        "try_submit admissions rejected (ST_BUSY backpressure)",
        "parallel/batcher.py _admit",
    ),
    MetricSpec(
        "fabric_batcher_dispatch_retries_total", "counter", (),
        "transient launch failures retried by the dispatch policy",
        "parallel/batcher.py _launch",
    ),
    MetricSpec(
        "fabric_batcher_fail_closed_total", "counter", (),
        "requests settled all-False by a stopping/hung batcher",
        "parallel/batcher.py stop",
    ),
    # -- backend ladder rungs (crypto/, idemix/batch.py) ---------------
    MetricSpec(
        "fabric_verify_lanes_total", "counter", ("rung",),
        "signature lanes verified per ladder rung "
        "(hostec_np|hostec|p256|device|hostbn|scheme)",
        "crypto/bccsp.py, idemix/batch.py",
    ),
    MetricSpec(
        "fabric_verify_seconds", "histogram", ("rung",),
        "batch verify wall time per ladder rung",
        "crypto/bccsp.py, idemix/batch.py",
        LATENCY_BUCKETS,
    ),
    MetricSpec(
        "fabric_degrade_total", "counter", ("seam",),
        "degrade transitions (pool->inline; a serve client or router "
        "to its rescue provider)",
        "crypto/hostec*.py, idemix/batch.py, serve/client.py, "
        "serve/router.py",
    ),
    MetricSpec(
        "fabric_pool_rebuilds_total", "counter", ("pool",),
        "process-pool constructions (hostec|hostec_np|hostbn)",
        "crypto/hostec.py, crypto/hostec_np.py, idemix/batch.py",
    ),
    MetricSpec(
        "fabric_pool_cooldowns_total", "counter", ("pool",),
        "broken-pool teardowns arming the rebuild cooldown",
        "crypto/hostec.py, crypto/hostec_np.py, idemix/batch.py",
    ),
    # -- the serve sidecar (serve/server.py, client.py, router.py) -------
    MetricSpec(
        "fabric_serve_requests_total", "counter", ("status",),
        "verify requests by reply status (ok|busy|error|stopping|"
        "deadline_shed)",
        "serve/server.py ServeStats",
    ),
    MetricSpec(
        "fabric_serve_lanes_total", "counter", (),
        "lanes served OK by the sidecar",
        "serve/server.py ServeStats",
    ),
    MetricSpec(
        "fabric_serve_request_seconds", "histogram", (),
        "decode -> reply latency of served verify requests",
        "serve/server.py ServeStats", LATENCY_BUCKETS,
    ),
    MetricSpec(
        "fabric_serve_bucket_requests_total", "counter", ("bucket",),
        "served requests per registry lane bucket",
        "serve/server.py ServeStats",
    ),
    MetricSpec(
        "fabric_serve_connections_total", "counter", ("event",),
        "client connection churn (open|close)",
        "serve/server.py _accept_loop/_serve_conn",
    ),
    MetricSpec(
        "fabric_serve_class_lanes_total", "counter", ("cls",),
        "lanes served OK per admission class (high|normal|bulk)",
        "serve/server.py ServeStats",
    ),
    MetricSpec(
        "fabric_serve_class_busy_total", "counter", ("cls",),
        "ST_BUSY sheds per admission class — every rejection is a "
        "protocol-level reply, never a silent drop",
        "serve/server.py ServeStats",
    ),
    MetricSpec(
        "fabric_serve_endpoint_healthy", "gauge", ("endpoint",),
        "router endpoint health (1 = in rotation, 0 = evicted/cooling)",
        "serve/router.py _Endpoint",
    ),
    MetricSpec(
        "fabric_serve_hedges_total", "counter", (),
        "hedged requests fired at a second endpoint after the primary "
        "stayed silent past its learned hedge delay",
        "serve/router.py _await_hedged",
    ),
    MetricSpec(
        "fabric_serve_hedge_wins_total", "counter", (),
        "hedges whose verdict arrived before the primary's (the loser "
        "is cancelled best-effort via OP_CANCEL)",
        "serve/router.py _await_hedged",
    ),
    MetricSpec(
        "fabric_serve_deadline_expired_total", "counter", ("seam",),
        "wire-deadline budgets that ran out (serve.server = provably-"
        "unfinishable work shed ST_BUSY; serve.client / serve.router = "
        "batches handed to the rescue provider)",
        "serve/server.py ServeStats, serve/client.py, serve/router.py",
    ),
    MetricSpec(
        "fabric_serve_slow_evictions_total", "counter", ("endpoint",),
        "gray-failure evictions: endpoints alive but latency outliers "
        "(EWMA far above the fleet best, or consecutive lost hedges) "
        "pulled from rotation through the cooldown ladder",
        "serve/router.py _evict_slow",
    ),
    MetricSpec(
        "fabric_serve_bucket_warm_ms", "gauge", ("bucket",),
        "per-bucket warm wall ms (registry warm report)",
        "serve/server.py warm",
    ),
    MetricSpec(
        "fabric_serve_bucket_builds", "gauge", ("bucket",),
        "nvcc builds the bucket warm paid (0 = the build cache held the "
        "kernel library)",
        "serve/server.py warm",
    ),
    MetricSpec(
        "fabric_pipeline_stage_seconds", "histogram", ("stage",),
        "per-stage latency (prepare|commit) of the two-stage pipeline",
        "peer/pipeline.py", STAGE_BUCKETS,
    ),
    MetricSpec(
        "fabric_pipeline_commit_failures_total", "counter", (),
        "commit-stage exceptions surfaced to the owner",
        "peer/pipeline.py _commit_loop",
    ),
    MetricSpec(
        "fabric_retry_attempts_total", "counter", (),
        "backoff sleeps taken across every retry loop",
        "common/retry.py Backoff.sleep",
    ),
    MetricSpec(
        "fabric_retry_backoff_seconds", "histogram", (),
        "nominal delay per backoff sleep",
        "common/retry.py Backoff.sleep", LATENCY_BUCKETS,
    ),
    MetricSpec(
        "fabric_fault_fired_total", "counter", ("site",),
        "injected faults that actually fired, per site",
        "common/faults.py fault_point",
    ),
    MetricSpec(
        "fabric_ledger_recovered_blocks_total", "counter", (),
        "blocks replayed into state/pvt by restart recovery (the gap "
        "between the block store and the state savepoint)",
        "ledger/kvledger.py _recover",
    ),
    MetricSpec(
        "fabric_ledger_torn_tail_total", "counter", ("store",),
        "torn tail records truncated on recovery (chain|pvtdata)",
        "ledger/blockstore.py _rebuild_index, ledger/pvtdatastore.py "
        "_recover",
    ),
    MetricSpec(
        "fabric_ledger_recovery_refusals_total", "counter", ("reason",),
        "recoveries refused fail-closed (corrupt-chain|corrupt-pvtdata|"
        "statedb-ahead): inconsistency recovery cannot repair forward",
        "ledger/blockstore.py _refuse, ledger/pvtdatastore.py _refuse, "
        "ledger/kvledger.py _recover",
    ),
)


# ---------------------------------------------------------------------------
# Span / flight-recorder layer
# ---------------------------------------------------------------------------

_tls = threading.local()


def _span_stack() -> List["Span"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span() -> Optional["Span"]:
    """The innermost open span on THIS thread (cross-thread hand-offs
    pass it as ``span(..., parent=...)`` explicitly)."""
    stack = _span_stack()
    return stack[-1] if stack else None


class Span:
    """One timed section.  Entering pushes it on the thread's span
    stack; exiting records a Chrome ``ph:"X"`` complete event into the
    registry's flight ring.  Failures inside the obs machinery are
    swallowed (``_swallow``); exceptions from the *wrapped* code
    propagate untouched — a span can never eat a verify error."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "_reg", "_t0")

    def __init__(self, reg: "ObsRegistry", name: str, attrs: Dict,
                 parent: Optional["Span"] = None):
        self._reg = reg
        self.name = name
        self.attrs = attrs
        self.span_id = reg._next_span_id()
        self.parent_id = parent.span_id if parent is not None else 0
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        try:
            if self.parent_id == 0:
                cur = current_span()
                if cur is not None:
                    self.parent_id = cur.span_id
            _span_stack().append(self)
            self._t0 = time.perf_counter()
        except Exception as exc:  # noqa: BLE001 - obs must never raise
            self._reg._swallow("span.enter", exc)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            t1 = time.perf_counter()
            stack = _span_stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:  # tolerate mis-nested exits
                stack.remove(self)
            args = dict(self.attrs)
            args["span_id"] = self.span_id
            if self.parent_id:
                args["parent_id"] = self.parent_id
            if exc_type is not None:
                args["error"] = exc_type.__name__
            self._reg._record_event(
                {
                    "name": self.name,
                    "ph": "X",
                    "ts": self._reg._us(self._t0),
                    "dur": round((t1 - self._t0) * 1e6, 1),
                    "args": args,
                }
            )
        except Exception as swallow_exc:  # noqa: BLE001 - obs must never raise
            self._reg._swallow("span.exit", swallow_exc)
        # never suppress the wrapped code's exception (implicit None)


class _NoopSpan:
    """Shared do-nothing span: what ``span()`` returns when the registry
    is disabled, and what enabled hooks fall back to on internal
    failure.  Reentrant and stateless."""

    __slots__ = ()
    name = "noop"
    span_id = 0
    parent_id = 0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP_SPAN = _NoopSpan()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


class ObsRegistry:
    """One process-wide observability hub: metric instruments for every
    canonical family plus the span flight ring.  All mutable state is
    guarded by ``_lock``;
    metric series carry their own per-family locks inside the SPI."""

    def __init__(
        self,
        provider: Optional[metrics_mod.Provider] = None,
        ring: int = 4096,
    ):
        self.provider = provider or metrics_mod.PrometheusProvider()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(ring)))
        self._epoch = time.perf_counter()
        self._span_seq = 0
        self.dropped = 0  # obs failures swallowed (self-accounting)
        self._warned_families: set = set()
        self._instruments: Dict[str, object] = {}
        for spec in CANONICAL_METRICS:
            try:
                self._instruments[spec.name] = self._build(spec)
            except Exception as exc:  # noqa: BLE001 - obs must never raise
                self._swallow(f"register:{spec.name}", exc)

    # -- instrument construction ----------------------------------------
    def _build(self, spec: MetricSpec):
        if spec.kind == "counter":
            return self.provider.new_counter(
                metrics_mod.CounterOpts(
                    name=spec.name, help=spec.help, label_names=spec.labels
                )
            )
        if spec.kind == "gauge":
            return self.provider.new_gauge(
                metrics_mod.GaugeOpts(
                    name=spec.name, help=spec.help, label_names=spec.labels
                )
            )
        if spec.kind == "histogram":
            return self.provider.new_histogram(
                metrics_mod.HistogramOpts(
                    name=spec.name,
                    help=spec.help,
                    label_names=spec.labels,
                    buckets=spec.buckets or LATENCY_BUCKETS,
                )
            )
        raise ValueError(f"unknown metric kind {spec.kind!r}")

    def _lookup(self, name: str, labels: Dict[str, str]):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                first = name not in self._warned_families
                self._warned_families.add(name)
            if first:
                logger.debug(
                    "obs point %r is not in the canonical metric table; "
                    "dropped", name,
                )
            return None
        if labels:
            flat: List[str] = []
            for k, v in labels.items():
                flat.append(k)
                flat.append(str(v))
            inst = inst.with_labels(*flat)
        return inst

    # -- hot-path sinks (never raise) ------------------------------------
    def count(self, name: str, n: float = 1.0, **labels) -> None:
        try:
            inst = self._lookup(name, labels)
            if inst is not None:
                inst.add(n)
        except Exception as exc:  # noqa: BLE001 - obs must never raise
            self._swallow(name, exc)

    def gauge(self, name: str, value: float, **labels) -> None:
        try:
            inst = self._lookup(name, labels)
            if inst is not None:
                inst.set(value)
        except Exception as exc:  # noqa: BLE001 - obs must never raise
            self._swallow(name, exc)

    def observe(self, name: str, value: float, **labels) -> None:
        try:
            inst = self._lookup(name, labels)
            if inst is not None:
                inst.observe(value)
        except Exception as exc:  # noqa: BLE001 - obs must never raise
            self._swallow(name, exc)

    def span(self, name: str, parent: Optional[Span] = None, **attrs) -> Span:
        try:
            return Span(self, name, attrs, parent=parent)
        except Exception as exc:  # noqa: BLE001 - obs must never raise
            self._swallow(name, exc)
            return _NOOP_SPAN  # type: ignore[return-value]

    def event(self, name: str, **attrs) -> None:
        """Instant flight-recorder mark (Chrome ``ph:"i"``)."""
        try:
            self._record_event(
                {
                    "name": name,
                    "ph": "i",
                    "ts": self._us(time.perf_counter()),
                    "s": "p",
                    "args": attrs,
                }
            )
        except Exception as exc:  # noqa: BLE001 - obs must never raise
            self._swallow(name, exc)

    def trigger(self, reason: str, **attrs) -> None:
        """A degrade/fail-closed moment: the ``trigger:<reason>`` event
        in the flight ring."""
        self.event(f"trigger:{reason}", **attrs)

    # -- flight recorder --------------------------------------------------
    def _us(self, t: float) -> float:
        return round((t - self._epoch) * 1e6, 1)

    def _next_span_id(self) -> int:
        with self._lock:
            self._span_seq += 1
            return self._span_seq

    def _record_event(self, record: Dict) -> None:
        record.setdefault("pid", os.getpid())
        record.setdefault("tid", threading.get_ident())
        with self._lock:
            self._ring.append(record)

    def trace_events(self) -> List[Dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def dump(self, path: Optional[str] = None) -> str:
        """Chrome trace-event JSON of the flight ring (load it in
        ``chrome://tracing`` or Perfetto).  Writes ``path`` when given,
        returns the JSON text either way."""
        payload = json.dumps(
            {
                "traceEvents": self.trace_events(),
                "displayTimeUnit": "ms",
                "otherData": {"source": "fabric_tpu.fabobs"},
            },
            sort_keys=True,
        )
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(payload)
            os.replace(tmp, path)
        return payload

    # -- scrape-side views -------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition of the provider (empty string for
        non-prometheus providers — the ops server answers 404 then)."""
        gather = getattr(self.provider, "gather", None)
        return gather() if callable(gather) else ""

    def snapshot(self) -> Dict:
        """JSON-able {family: {kind, series}} snapshot.  Histogram series
        collapse to the bucket-quantized summary
        (:func:`metrics.summary_from_histogram_state`)."""
        out: Dict[str, Dict] = {}
        prov = self.provider
        if not isinstance(prov, metrics_mod.PrometheusProvider):
            return out
        with prov._lock:
            families = dict(prov._metrics)
        for name, metric in sorted(families.items()):
            with metric.lock:
                series = dict(metric.series)
            rendered: Dict[str, object] = {}
            for labels, value in sorted(series.items()):
                key = ",".join(
                    f"{n}={v}"
                    for n, v in zip(metric.opts.label_names, labels)
                ) or "_"
                if isinstance(value, metrics_mod._HistState):
                    rendered[key] = metrics_mod.summary_from_histogram_state(
                        value, metric.opts.buckets  # type: ignore[attr-defined]
                    )
                else:
                    rendered[key] = value
            if rendered:
                out[name] = {"kind": metric.kind, "series": rendered}
        return out

    def value(self, name: str, **labels) -> float:
        """The current value of one counter or gauge series (0 when the
        series has not been written): what a caller reads back in
        process, as chip_smoke.py reads the batcher's retries and
        fail-closed settlements."""
        inst = self._instruments.get(name)
        if inst is None:
            raise KeyError(f"{name} is not a canonical metric")
        metric = inst._m
        key = tuple(str(labels[n]) for n in metric.opts.label_names)
        with metric.lock:
            return float(metric.series.get(key, 0.0))

    def _swallow(self, where: str, exc: BaseException) -> None:
        """The one rule of this module: an observability failure is
        accounted and debug-logged, NEVER raised into the observed
        code."""
        try:
            with self._lock:
                self.dropped += 1
            logger.debug("obs failure at %s swallowed: %s", where, exc)
        except Exception:  # noqa: BLE001 - last-ditch: even the swallow must not raise into a verify path
            pass


# ---------------------------------------------------------------------------
# Process-wide installation (the faults.py discipline: _OBS is written
# only under _OBS_LOCK; the hot-path read is one GIL-atomic global load)
# ---------------------------------------------------------------------------

_OBS: Optional[ObsRegistry] = None
_OBS_LOCK = threading.Lock()


def enable(
    provider: Optional[metrics_mod.Provider] = None, ring: int = 4096
) -> ObsRegistry:
    """Install a fresh registry process-wide and return it."""
    global _OBS
    reg = ObsRegistry(provider=provider, ring=ring)
    with _OBS_LOCK:
        _OBS = reg
    return reg


def ensure_enabled(
    provider: Optional[metrics_mod.Provider] = None, ring: int = 4096
) -> ObsRegistry:
    """Enable unless a registry is already installed (first enabler
    wins — one process, one obs hub).  Used by the node shells so a
    peer and its ops server share the provider without trampling an
    earlier installation.  The registry is built outside the lock
    (construction registers every canonical family) and installed only
    if no racer got there first."""
    global _OBS
    existing = _OBS
    if existing is None:
        candidate = ObsRegistry(provider=provider, ring=ring)
        with _OBS_LOCK:
            if _OBS is None:
                _OBS = candidate
                return candidate
            existing = _OBS
    if provider is not None and existing.provider is not provider:
        logger.warning(
            "fabobs already enabled; keeping the existing provider "
            "(a second ops surface will not see data-plane series)"
        )
    return existing


def disable() -> None:
    global _OBS
    with _OBS_LOCK:
        _OBS = None


def enabled() -> bool:
    return _OBS is not None


def active() -> Optional[ObsRegistry]:
    return _OBS


class obs_installed:
    """``with obs_installed() as reg:`` — scoped enablement for tests
    and gates; the previous registry (usually None) is restored on exit,
    mirroring ``faults.plan_installed``."""

    def __init__(self, registry: Optional[ObsRegistry] = None, **kwargs):
        self.registry = registry if registry is not None else ObsRegistry(**kwargs)
        self._prev: Optional[ObsRegistry] = None

    def __enter__(self) -> ObsRegistry:
        global _OBS
        with _OBS_LOCK:
            self._prev = _OBS
            _OBS = self.registry
        return self.registry

    def __exit__(self, *exc) -> None:
        global _OBS
        with _OBS_LOCK:
            _OBS = self._prev


# -- the hot-path hooks ------------------------------------------------------


def obs_count(name: str, n: float = 1.0, **labels) -> None:
    """Add ``n`` to a canonical counter.  Disabled cost: one global
    load and a ``None`` check."""
    reg = _OBS
    if reg is None:
        return
    reg.count(name, n, **labels)


def obs_gauge(name: str, value: float, **labels) -> None:
    reg = _OBS
    if reg is None:
        return
    reg.gauge(name, value, **labels)


def obs_observe(name: str, value: float, **labels) -> None:
    reg = _OBS
    if reg is None:
        return
    reg.observe(name, value, **labels)


def span(name: str, parent: Optional[Span] = None, **attrs):
    """Context manager timing one section into the flight ring.
    Disabled: returns the shared no-op span (no allocation)."""
    reg = _OBS
    if reg is None:
        return _NOOP_SPAN
    return reg.span(name, parent=parent, **attrs)


def obs_event(name: str, **attrs) -> None:
    reg = _OBS
    if reg is None:
        return
    reg.event(name, **attrs)


def obs_trigger(reason: str, **attrs) -> None:
    """Degrade/fail-closed mark in the flight ring.  Call it where the
    system gives ground: the batcher's fail-closed settlement."""
    reg = _OBS
    if reg is None:
        return
    reg.trigger(reason, **attrs)


def snapshot() -> Dict:
    """{} when disabled; else the active registry's metric snapshot."""
    reg = _OBS
    return {} if reg is None else reg.snapshot()


def metric_table() -> List[Dict[str, str]]:
    """The canonical table as rows (docs generation and gates)."""
    return [
        {
            "name": s.name,
            "kind": s.kind,
            "labels": ",".join(s.labels),
            "seam": s.seam,
            "help": s.help,
        }
        for s in CANONICAL_METRICS
    ]
