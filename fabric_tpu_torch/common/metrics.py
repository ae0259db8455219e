"""Metrics provider SPI (reference common/metrics/provider.go:11-121).

The port's counterpart of the JAX package's `common/metrics`: the histogram
state that `peer/pipeline.CommitPipeline` keeps per stage
(`new_histogram_state`, `observe_into`, `summary_from_histogram_state`),
`latency_summary` over raw samples (the serve sidecar's `ServeStats`), the
counter, gauge and histogram instruments with their options, and the three
providers of the reference:

* ``PrometheusProvider`` — the in-process registry behind `common/fabobs`
  and `ledger/ledgermetrics.CommitterMetrics`; `gather()` renders the
  Prometheus text exposition that the operations server serves at /metrics.
* ``StatsdProvider`` — formats ``%{#fqname}.%{label}`` style bucket names
  and hands each line to a sink callable (UDP emitter or test buffer).
* ``DisabledProvider`` — no-ops.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def latency_summary(samples_s: Sequence[float]) -> Dict[str, float]:
    """``{n, p50_ms, p99_ms, max_ms}`` over seconds-valued latency
    samples (``{"n": 0}`` when empty) — the one quantile-index
    definition shared by the serve sidecar's ServeStats and the serve
    clients' summaries, so the surfaces can never silently diverge."""
    if not samples_s:
        return {"n": 0}
    s = sorted(samples_s)

    def pct(q: float) -> float:
        return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]

    return {
        "n": len(s),
        "p50_ms": round(pct(0.50) * 1e3, 3),
        "p99_ms": round(pct(0.99) * 1e3, 3),
        "max_ms": round(s[-1] * 1e3, 3),
    }


def summary_from_histogram_state(
    state: "_HistState", buckets: Sequence[float]
) -> Dict[str, float]:
    """A latency summary computed from accumulated histogram state
    instead of raw samples: quantiles are the upper bound of the bucket
    where the cumulative count crosses the rank (bucket-quantized).  The
    top open bucket has no upper bound; ranks landing there report a
    LOWER BOUND on that bucket's mean — ``(sum - bounded_count *
    top_bucket) / inf_count``, clamped to at least the top finite bound
    — so a tail outlier can never be reported below the ladder it
    overflowed.  Keys: ``{n, p50_ms, p99_ms, mean_ms}`` (``{"n": 0}``
    when empty)."""
    if state.total == 0:
        return {"n": 0}

    def pct(q: float) -> float:
        rank = q * (state.total - 1) + 1
        cum = 0
        for ub, c in zip(buckets, state.counts):
            cum += c
            if cum >= rank:
                return ub
        inf_count = state.total - sum(state.counts)
        if not inf_count:
            return buckets[-1]
        # bounded samples contribute at most bounded_count * top bucket
        # to the sum, so this is a conservative mean of the +Inf bucket
        bounded_cap = (state.total - inf_count) * buckets[-1]
        return max(buckets[-1], (state.sum - bounded_cap) / inf_count)

    return {
        "n": state.total,
        "p50_ms": round(pct(0.50) * 1e3, 3),
        "p99_ms": round(pct(0.99) * 1e3, 3),
        "mean_ms": round(state.sum / state.total * 1e3, 3),
    }


@dataclass(frozen=True)
class MetricOpts:
    namespace: str = ""
    subsystem: str = ""
    name: str = ""
    help: str = ""
    label_names: Tuple[str, ...] = ()
    statsd_format: str = ""

    def fq_name(self) -> str:
        parts = [p for p in (self.namespace, self.subsystem, self.name) if p]
        return "_".join(parts)


class CounterOpts(MetricOpts):
    pass


class GaugeOpts(MetricOpts):
    pass


@dataclass(frozen=True)
class HistogramOpts(MetricOpts):
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS


def validate_label_values(
    opts: MetricOpts, label_values: Sequence[str]
) -> Tuple[str, ...]:
    """Name/value pairs -> the series key ordered by ``opts.label_names``.
    Shared by every provider's ``with_labels`` (the statsd path used to
    construct a throwaway ``_Metric`` per call just to run this)."""
    if len(label_values) % 2 != 0:
        raise ValueError("label values must come in name/value pairs")
    pairs = dict(zip(label_values[::2], label_values[1::2]))
    missing = [n for n in opts.label_names if n not in pairs]
    if missing:
        raise ValueError(f"missing label values: {missing}")
    return tuple(pairs[n] for n in opts.label_names)


class _Metric:
    """One named metric family; label-tuple -> series state."""

    def __init__(self, opts: MetricOpts, kind: str):
        self.opts = opts
        self.kind = kind
        self.lock = threading.Lock()
        self.series: Dict[Tuple[str, ...], object] = {}

    def _labels_key(self, label_values: Sequence[str]) -> Tuple[str, ...]:
        return validate_label_values(self.opts, label_values)


class Counter:
    def __init__(self, metric: _Metric, labels: Tuple[str, ...] = ()):
        self._m = metric
        self._labels = labels

    def with_labels(self, *label_values: str) -> "Counter":
        return Counter(self._m, self._m._labels_key(label_values))

    def add(self, delta: float = 1.0) -> None:
        with self._m.lock:
            self._m.series[self._labels] = (
                self._m.series.get(self._labels, 0.0) + delta
            )


class Gauge:
    def __init__(self, metric: _Metric, labels: Tuple[str, ...] = ()):
        self._m = metric
        self._labels = labels

    def with_labels(self, *label_values: str) -> "Gauge":
        return Gauge(self._m, self._m._labels_key(label_values))

    def set(self, value: float) -> None:
        with self._m.lock:
            self._m.series[self._labels] = value

    def add(self, delta: float) -> None:
        with self._m.lock:
            self._m.series[self._labels] = (
                self._m.series.get(self._labels, 0.0) + delta
            )


@dataclass
class _HistState:
    counts: List[int]
    total: int = 0
    sum: float = 0.0


#: Public name for embedders (peer/pipeline keeps per-stage histogram
#: state directly, summarized by ``summary_from_histogram_state``).
HistogramState = _HistState


def new_histogram_state(buckets: Sequence[float]) -> _HistState:
    return _HistState(counts=[0] * len(buckets))


def observe_into(
    state: _HistState, buckets: Sequence[float], value: float
) -> None:
    """The one bucket-accumulation definition (shared by ``Histogram``
    and embedded states).  NOT thread-safe; callers hold their lock."""
    idx = bisect.bisect_left(buckets, value)
    if idx < len(buckets):
        state.counts[idx] += 1
    state.total += 1
    state.sum += value


class Histogram:
    def __init__(self, metric: _Metric, labels: Tuple[str, ...] = ()):
        self._m = metric
        self._labels = labels

    def with_labels(self, *label_values: str) -> "Histogram":
        return Histogram(self._m, self._m._labels_key(label_values))

    def observe(self, value: float) -> None:
        buckets = self._m.opts.buckets  # type: ignore[attr-defined]
        with self._m.lock:
            state = self._m.series.get(self._labels)
            if state is None:
                state = new_histogram_state(buckets)
                self._m.series[self._labels] = state
            observe_into(state, buckets, value)


class Provider:
    """SPI: NewCounter/NewGauge/NewHistogram (provider.go:11-22)."""

    def new_counter(self, opts: MetricOpts) -> Counter:
        raise NotImplementedError

    def new_gauge(self, opts: MetricOpts) -> Gauge:
        raise NotImplementedError

    def new_histogram(self, opts: HistogramOpts) -> Histogram:
        raise NotImplementedError


class PrometheusProvider(Provider):
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, opts: MetricOpts, kind: str) -> _Metric:
        name = opts.fq_name()
        if not name:
            raise ValueError("metric name is required")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind:
                    raise ValueError(
                        f"metric {name} already registered as {existing.kind}"
                    )
                return existing
            metric = _Metric(opts, kind)
            self._metrics[name] = metric
            return metric

    def new_counter(self, opts: MetricOpts) -> Counter:
        return Counter(self._register(opts, "counter"))

    def new_gauge(self, opts: MetricOpts) -> Gauge:
        return Gauge(self._register(opts, "gauge"))

    def new_histogram(self, opts: HistogramOpts) -> Histogram:
        return Histogram(self._register(opts, "histogram"))

    def gather(self) -> str:
        """Prometheus text exposition format, sorted for determinism."""
        out: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, metric in metrics:
            if metric.opts.help:
                out.append(f"# HELP {name} {metric.opts.help}")
            out.append(f"# TYPE {name} {metric.kind}")
            with metric.lock:
                series = sorted(metric.series.items())
                for labels, value in series:
                    label_str = _format_labels(metric.opts.label_names, labels)
                    if metric.kind == "histogram":
                        assert isinstance(value, _HistState)
                        buckets = metric.opts.buckets  # type: ignore
                        cum = 0
                        for ub, c in zip(buckets, value.counts):
                            cum += c
                            le = _format_labels(
                                metric.opts.label_names + ("le",),
                                labels + (_fmt_float(ub),),
                            )
                            out.append(f"{name}_bucket{le} {cum}")
                        inf = _format_labels(
                            metric.opts.label_names + ("le",),
                            labels + ("+Inf",),
                        )
                        out.append(f"{name}_bucket{inf} {value.total}")
                        out.append(f"{name}_sum{label_str} {_fmt_float(value.sum)}")
                        out.append(f"{name}_count{label_str} {value.total}")
                    else:
                        out.append(f"{name}{label_str} {_fmt_float(value)}")
        return "\n".join(out) + ("\n" if out else "")


def _fmt_float(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


def _format_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


class StatsdProvider(Provider):
    """Formats per-event statsd lines into ``sink(line)`` (reference
    common/metrics/statsd). Bucket names come from statsd_format with
    ``%{#fqname}`` and ``%{label}`` substitutions."""

    def __init__(self, sink: Callable[[str], None], prefix: str = ""):
        self._sink = sink
        self._prefix = prefix

    def _bucket(self, opts: MetricOpts, labels: Tuple[str, ...]) -> str:
        fmt = opts.statsd_format or "%{#fqname}"
        name = fmt.replace("%{#fqname}", opts.fq_name().replace("_", "."))
        for label_name, value in zip(opts.label_names, labels):
            name = name.replace("%{" + label_name + "}", value)
        return f"{self._prefix}.{name}" if self._prefix else name

    def new_counter(self, opts: MetricOpts) -> Counter:
        provider = self

        class _C(Counter):
            def __init__(self, labels: Tuple[str, ...] = ()):
                self._labels = labels

            def with_labels(self, *label_values: str) -> "Counter":
                return _C(validate_label_values(opts, label_values))

            def add(self, delta: float = 1.0) -> None:
                provider._sink(
                    f"{provider._bucket(opts, self._labels)}:{_fmt_float(delta)}|c"
                )

        return _C()

    def new_gauge(self, opts: MetricOpts) -> Gauge:
        provider = self

        class _G(Gauge):
            def __init__(self, labels: Tuple[str, ...] = ()):
                self._labels = labels

            def with_labels(self, *label_values: str) -> "Gauge":
                return _G(validate_label_values(opts, label_values))

            def set(self, value: float) -> None:
                provider._sink(
                    f"{provider._bucket(opts, self._labels)}:{_fmt_float(value)}|g"
                )

            def add(self, delta: float) -> None:
                provider._sink(
                    f"{provider._bucket(opts, self._labels)}:{_fmt_float(delta)}|g"
                )

        return _G()

    def new_histogram(self, opts: HistogramOpts) -> Histogram:
        provider = self

        class _H(Histogram):
            def __init__(self, labels: Tuple[str, ...] = ()):
                self._labels = labels

            def with_labels(self, *label_values: str) -> "Histogram":
                return _H(validate_label_values(opts, label_values))

            def observe(self, value: float) -> None:
                provider._sink(
                    f"{provider._bucket(opts, self._labels)}:{_fmt_float(value)}|ms"
                )

        return _H()


class _DisabledCounter(Counter):
    """A no-op whose ``with_labels`` returns itself, so a labelled child
    records nothing either."""

    def __init__(self):  # no backing _Metric: nothing accumulates
        pass

    def with_labels(self, *label_values: str) -> "Counter":
        return self

    def add(self, delta: float = 1.0) -> None:
        return None


class _DisabledGauge(Gauge):
    def __init__(self):
        pass

    def with_labels(self, *label_values: str) -> "Gauge":
        return self

    def set(self, value: float) -> None:
        return None

    def add(self, delta: float) -> None:
        return None


class _DisabledHistogram(Histogram):
    def __init__(self):
        pass

    def with_labels(self, *label_values: str) -> "Histogram":
        return self

    def observe(self, value: float) -> None:
        return None


class DisabledProvider(Provider):
    def new_counter(self, opts: MetricOpts) -> Counter:
        return _DisabledCounter()

    def new_gauge(self, opts: MetricOpts) -> Gauge:
        return _DisabledGauge()

    def new_histogram(self, opts: HistogramOpts) -> Histogram:
        return _DisabledHistogram()
