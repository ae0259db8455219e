"""The rest of `common/metrics` and the `fabobs` the nodes call, against the
JAX package: `PrometheusProvider.gather`'s text exposition, the statsd
lines and the disabled provider after the same seeded instrument calls;
the registry's `render`, `snapshot` and `dump`, `ensure_enabled`,
`disable`, `enabled`, `active` and the module's `snapshot` and
`metric_table` on the same hook calls in both packages."""

import json
import random

import pytest

from fabric_tpu.common import fabobs as jobs
from fabric_tpu.common import metrics as jm
from fabric_tpu_torch.common import fabobs as tobs
from fabric_tpu_torch.common import metrics as tm

PKGS = {"jax": (jm, jobs), "port": (tm, tobs)}


def drive(m, provider, seed=7):
    """The same seeded instrument calls on either package's provider."""
    rng = random.Random(seed)
    c = provider.new_counter(m.CounterOpts(namespace="ns", subsystem="sub", name="calls",
                                           help="calls made", label_names=("svc", "code"),
                                           statsd_format="%{#fqname}.%{svc}.%{code}"))
    g = provider.new_gauge(m.GaugeOpts(namespace="ns", name="depth", help="queue depth"))
    h = provider.new_histogram(m.HistogramOpts(name="lat", help="latency",
                                               label_names=("stage",),
                                               buckets=(0.001, 0.01, 0.1, 1.0)))
    p = provider.new_counter(m.CounterOpts(name="plain_total"))
    for _ in range(40):
        svc, code = rng.choice(["a", "b", "c"]), rng.choice(["OK", "Unknown"])
        c.with_labels("svc", svc, "code", code).add(rng.choice([1, 2, 0.5]))
        g.set(rng.randrange(100))
        g.add(rng.choice([1, -2, 0.25]))
        h.with_labels("stage", rng.choice(["x", "y"])).observe(rng.random() * 2)
        p.add()


def test_prometheus_gather_equals_jax():
    texts = {}
    for name, (m, _) in PKGS.items():
        provider = m.PrometheusProvider()
        drive(m, provider)
        texts[name] = provider.gather()
    assert texts["port"] == texts["jax"]
    assert "# TYPE lat histogram" in texts["port"] and 'lat_bucket{stage="x",le="+Inf"}' in texts[
        "port"]
    assert tm.PrometheusProvider().gather() == jm.PrometheusProvider().gather() == ""


def test_statsd_lines_and_disabled_provider_equal_jax():
    lines = {}
    for name, (m, _) in PKGS.items():
        out = []
        drive(m, m.StatsdProvider(out.append, prefix="fabric"))
        drive(m, m.DisabledProvider())
        lines[name] = out
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 200
    assert lines["port"][0].startswith("fabric.ns.sub.calls.")


@pytest.fixture
def no_registry():
    for _, obs in PKGS.values():
        obs.disable()
    yield
    for _, obs in PKGS.values():
        obs.disable()


def hooks(obs):
    obs.obs_count("fabric_batcher_launches_total", mode="coalesce")
    obs.obs_count("fabric_batcher_launches_total", 3, mode="passthrough")
    obs.obs_gauge("fabric_batcher_pending_lanes", 17)
    for v in (0.0004, 0.003, 0.2, 7.0):
        obs.obs_observe("fabric_batcher_submit_wait_seconds", v)
    obs.obs_count("not_a_canonical_family")


def test_registry_views_equal_jax(no_registry):
    views = {}
    for name, (m, obs) in PKGS.items():
        assert not obs.enabled() and obs.active() is None and obs.snapshot() == {}
        reg = obs.ensure_enabled()
        assert obs.enabled() and obs.active() is reg and obs.ensure_enabled() is reg
        # a second provider does not replace the first enabler's
        assert obs.ensure_enabled(provider=m.PrometheusProvider()) is reg
        hooks(obs)
        with obs.span("stage", block=3):
            pass
        obs.obs_event("mark", k=1)
        trace = json.loads(reg.dump())
        views[name] = {
            "render": reg.render(), "snapshot": reg.snapshot(), "module": obs.snapshot(),
            "table": obs.metric_table(),
            "trace": [(e["name"], e["ph"], e.get("args")) for e in trace["traceEvents"]],
            "trace_keys": sorted(trace), "other": trace["otherData"],
        }
        obs.disable()
        assert not obs.enabled() and obs.active() is None
    port, jax = views["port"], views["jax"]
    assert port["snapshot"] == jax["snapshot"] == port["module"]
    assert port["trace"] == jax["trace"] and port["trace_keys"] == jax["trace_keys"]
    assert port["other"] == jax["other"]
    # the render of every family both packages have, line for line but the
    # help text (the port's help names the port's seams)
    shared = {r["name"] for r in port["table"]} & {r["name"] for r in jax["table"]}

    def series(text):
        return [ln for ln in text.splitlines() if not ln.startswith("# HELP")
                and ln.split()[-2 if ln.startswith("#") else 0].split("{")[0].removesuffix(
                    "_bucket").removesuffix("_sum").removesuffix("_count") in shared]

    assert series(port["render"]) == series(jax["render"]) != []
    assert "fabric_batcher_launches_total{mode=\"passthrough\"} 3" in port["render"]
    jax_rows = {r["name"]: r for r in jax["table"]}
    assert all(jax_rows.get(r["name"], {}).get("kind") == r["kind"] for r in port["table"]
               if r["name"] in jax_rows)
    assert {r["name"] for r in port["table"]} == {s.name for s in tobs.CANONICAL_METRICS}


def test_dump_writes_the_trace(no_registry, tmp_path):
    for name, (_, obs) in PKGS.items():
        reg = obs.ensure_enabled()
        hooks(obs)
        path = tmp_path / name / "trace.json"
        text = reg.dump(str(path))
        assert path.read_text() == text
        obs.disable()


def test_render_is_empty_for_a_provider_without_gather(no_registry):
    for name, (m, obs) in PKGS.items():
        reg = obs.ObsRegistry(provider=m.DisabledProvider())
        assert reg.render() == "" and reg.snapshot() == {}
