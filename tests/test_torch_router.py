"""The port's SidecarRouter (fabric_tpu_torch.serve.router) beside the
JAX package's, with no tolerance: the rendezvous placement order for the
same buckets and addresses, the latency tracker's quantiles and EWMA, the
hedge delay and the hedge budget's decisions from the same samples; then
over a fleet of port sidecars: masks, stable placement, re-verify on kill,
a draining endpoint re-routed, recovery after a restart, OP_DRAIN through
the router, a hedge winning against a gray endpoint (its loser cancelled),
gray-failure eviction, the serve.route fault point, the rescue when every
endpoint is dead (bit-exact through ``fallback=``) and the double fault
raising SidecarUnavailable. Every wait is bounded."""

import os
import time

import numpy as np
import pytest

from fabric_tpu.common.retry import RetryPolicy as JRetryPolicy
from fabric_tpu.serve import router as jrouter
from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.faults import FaultPlan, plan_installed
from fabric_tpu_torch.common.retry import RetryPolicy
from fabric_tpu_torch.crypto import bccsp
from fabric_tpu_torch.serve import protocol as proto
from fabric_tpu_torch.serve import router
from fabric_tpu_torch.serve.client import SidecarUnavailable
from fabric_tpu_torch.serve.router import SidecarRouter
from test_torch_serve import (  # noqa: F401  (fixtures)
    WAIT_S,
    BrokenProvider,
    host_server,
    mixed_lanes,
    sockdir,
    tiers,
)

FAST_GATE = RetryPolicy(base_s=0.05, multiplier=2.0, cap_s=0.5, deadline_s=float("inf"))


# ---------------------------------------------------------------------------
# placement and hedge arithmetic against the JAX router
# ---------------------------------------------------------------------------


def _addresses(seed: int, n: int):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if rng.rand() < 0.5:
            out.append(f"/tmp/fleet{int(rng.randint(1000))}/s{i}.sock")
        else:
            out.append(f"127.0.0.1:{int(rng.randint(1024, 65535))}")
    return out


@pytest.mark.parametrize("seed", range(8))
def test_placement_order_equals_jax(seed):
    """The same addresses give the same endpoint order for every lane
    count (sha256(bucket | address) over the route ladder)."""
    addrs = _addresses(seed, 2 + seed % 5)
    port = SidecarRouter(addrs)
    jax = jrouter.SidecarRouter(endpoints=addrs)
    try:
        assert router.ROUTE_BUCKETS == jrouter.ROUTE_BUCKETS
        for n in (1, 64, 128, 129, 300, 1000, 2048, 5000, 16384, 16385, 100000):
            assert router._route_bucket(n) == jrouter._route_bucket(n)
            assert ([e.address for e in port._order(n)]
                    == [e.address for e in jax._order(n)])
        # a cooling endpoint leaves the order in both
        for r in (port, jax):
            r.endpoints[0].mark_down("test")
        assert ([e.address for e in port._order(300)]
                == [e.address for e in jax._order(300)])
    finally:
        port.stop()
        jax.stop()


@pytest.mark.parametrize("seed", range(6))
def test_tracker_and_hedge_delay_equal_jax(seed):
    rng = np.random.RandomState(seed)
    port, jax = router._LatencyTracker(), jrouter._LatencyTracker()
    gate = RetryPolicy(base_s=0.25, multiplier=2.0, cap_s=5.0, deadline_s=float("inf"))
    jgate = JRetryPolicy(base_s=0.25, multiplier=2.0, cap_s=5.0, deadline_s=float("inf"))
    pe, je = router._Endpoint("/a", gate), jrouter._Endpoint("/a", jgate)
    for floor in (0.0, 0.02, 0.5):
        assert pe.hedge_delay_s(floor) == je.hedge_delay_s(floor)
    for _ in range(int(rng.randint(1, 300))):
        sample = float(rng.lognormal(-4.0, 1.0))
        for t in (port, jax, pe.tracker, je.tracker):
            t.record(sample)
    assert (port.ewma_s, port.samples) == (jax.ewma_s, jax.samples)
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert port.quantile(q) == jax.quantile(q)
    for floor in (0.0, 0.001, 0.02, 0.5):
        assert pe.hedge_delay_s(floor) == je.hedge_delay_s(floor)
    pe.client.close()
    je.client.close()


@pytest.mark.parametrize("fraction,burst", [(0.05, 2.0), (0.5, 2.0), (1.0, 3.0),
                                            (0.0, 2.0), (0.3, 0.5)])
def test_hedge_budget_equals_jax(fraction, burst):
    port = router._HedgeBudget(fraction, burst)
    jax = jrouter._HedgeBudget(fraction, burst)
    rng = np.random.RandomState(int(fraction * 100 + burst))
    spends = 0
    for _ in range(500):
        if rng.rand() < 0.7:
            port.earn()
            jax.earn()
        else:
            got = port.try_spend()
            assert got == jax.try_spend()
            spends += got
    assert port.earned == jax.earned
    assert spends <= port.burst + port.fraction * port.earned


# ---------------------------------------------------------------------------
# a fleet of port sidecars
# ---------------------------------------------------------------------------


@pytest.fixture
def fleet(sockdir, tiers):
    servers = [host_server(os.path.join(sockdir, f"r{i}.sock"), buckets=(64, 256, 1024),
                           chaos_key=i + 1) for i in range(2)]
    rt = SidecarRouter([s.address for s in servers], sleeper=lambda s: None,
                       gate_policy=FAST_GATE, fallback=BrokenProvider())
    try:
        yield servers, rt
    finally:
        rt.stop()
        for s in servers:
            s.stop()


def _server_of(servers, endpoint):
    return next(s for s in servers if s.address == endpoint.address)


def test_batches_spread_and_masks_exact(fleet):
    servers, rt = fleet
    for n in (48, 200, 900):
        lanes = mixed_lanes(n, seed=40 + n)
        assert rt.batch_verify(*lanes.port()) == lanes.expected
        assert rt.batch_verify_async(*lanes.port())() == lanes.expected
    assert not rt.degraded and rt.rescues == 0
    assert sum(s.stats.summary()["requests"] for s in servers) == 6
    assert [e.address for e in rt._order(48)] == [e.address for e in rt._order(48)]
    assert rt.describe_backend() == "serve-router:" + ",".join(s.address for s in servers)


def test_for_channel_binds_the_class_and_shares_endpoints(fleet):
    _servers, rt = fleet
    rt.qos_map = {"paychan": proto.QOS_HIGH, "*": proto.QOS_BULK}
    assert rt.for_channel(rt.channel).qos_class == proto.QOS_BULK
    bound = rt.for_channel("paychan")
    assert bound.qos_class == proto.QOS_HIGH and bound.endpoints is rt.endpoints
    with pytest.raises(ValueError, match="at least one"):
        SidecarRouter([])


def test_kill_one_reverifies_on_survivor(fleet):
    servers, rt = fleet
    lanes = mixed_lanes(128, seed=41)
    assert rt.batch_verify(*lanes.port()) == lanes.expected
    victim = rt._order(128)[0]
    _server_of(servers, victim).stop()
    other = mixed_lanes(128, seed=42)
    assert rt.batch_verify(*other.port()) == other.expected
    assert not rt.degraded and not victim.healthy


def test_stopping_endpoint_reroutes_and_recovers(fleet, sockdir):
    """ST_STOPPING from a draining endpoint is never trusted: the batch
    re-verifies on the other; a sidecar restarted at the address earns
    its way back through a probe."""
    servers, rt = fleet
    preferred = rt._order(64)[0]
    draining = _server_of(servers, preferred)
    with draining._drain_cv:
        draining._draining = True
    lanes = mixed_lanes(64, seed=43)
    assert rt.batch_verify(*lanes.port()) == lanes.expected
    assert not rt.degraded and not preferred.healthy
    draining.stop()
    servers[servers.index(draining)] = host_server(preferred.address, buckets=(64,))
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if preferred.gate.ready() and rt._probe_ok(preferred):
            break
        time.sleep(0.02)
    assert preferred.healthy
    assert rt.batch_verify(*lanes.port()) == lanes.expected


def test_drain_endpoint_acks_and_evicts(fleet):
    servers, rt = fleet
    addr = rt.endpoints[0].address
    assert rt.drain_endpoint(addr)
    assert not rt.endpoints[0].healthy and not rt.drain_endpoint("/nowhere.sock")
    target = next(s for s in servers if s.address == addr)
    deadline = time.monotonic() + WAIT_S
    while not target._stopping and time.monotonic() < deadline:
        time.sleep(0.02)
    assert target._stopping


def test_route_fault_fails_over(fleet):
    """An injected fault at every first attempt on the preferred endpoint
    routes the batch to the next one."""
    servers, rt = fleet
    lanes = mixed_lanes(30, seed=44)
    preferred = rt._order(30)[0]
    plan = FaultPlan.parse("serve.route=raise:1.0:max=1", seed=1)
    with plan_installed(plan):
        assert rt.batch_verify(*lanes.port()) == lanes.expected
    assert plan.fired()["serve.route"] == 1
    assert not preferred.healthy and not rt.degraded
    assert _server_of(servers, preferred).stats.summary()["requests"] == 0


def test_hedge_wins_against_a_gray_endpoint(fleet):
    """One sidecar delayed (alive, slow): after the learned hedge delay
    the batch goes to the other, first verdict wins, the loser is
    cancelled, no lanes leak; two lost hedges evict the gray endpoint."""
    servers, rt = fleet
    rt.hedge_budget = router._HedgeBudget(1.0)
    rt.hedge_min_s = 10.0  # disarmed while the trackers learn
    lanes = mixed_lanes(32, seed=45)
    for _ in range(3):
        assert rt.batch_verify(*lanes.port()) == lanes.expected
    assert rt.hedges == 0
    rt.hedge_min_s = 0.010
    victim = rt._order(32)[0]
    # the tracker learned the three warm batches; their latencies follow the
    # machine's load (a loaded host's 32-lane batch can take hundreds of ms,
    # pushing 2 x p95 past the 1,500 ms gray delay), so the learned window is
    # replaced by three 20 ms samples: the hedge fires at 40 ms whatever the load
    assert victim.tracker.samples == 3
    victim.tracker = router._LatencyTracker()
    for _ in range(3):
        victim.tracker.record(0.020)
    assert victim.hedge_delay_s(rt.hedge_min_s) == 0.040
    gray = _server_of(servers, victim)
    plan = FaultPlan.parse(f"serve.dispatch=delay:1.0:ms=1500:at={gray.chaos_key}", seed=3)
    with fabobs.obs_installed() as obs, plan_installed(plan):
        t0 = time.monotonic()
        assert rt.batch_verify(*lanes.port()) == lanes.expected
        assert time.monotonic() - t0 < 1.5
        assert (rt.hedges, rt.hedge_wins) == (1, 1)
        assert obs.value("fabric_serve_hedge_wins_total") == 1
        assert rt.batch_verify(*lanes.port()) == lanes.expected
        assert rt.slow_evictions == 1 and not victim.healthy
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        st = gray.stats.summary()
        if st["cancelled_pre"] + st["cancelled_post"] >= 2 and not gray.qos.balance()["in_flight"]:
            break
        time.sleep(0.05)
    st = gray.stats.summary()
    assert st["cancelled_pre"] + st["cancelled_post"] == 2
    assert gray.qos.balance()["leaked"] == 0
    assert not rt.degraded


def test_all_endpoints_dead_rescues_bit_exact(sockdir, tiers):
    servers = [host_server(os.path.join(sockdir, f"d{i}.sock")) for i in range(2)]
    rescue = bccsp.SoftwareProvider()
    rt = SidecarRouter([s.address for s in servers], sleeper=lambda s: None,
                       gate_policy=FAST_GATE, fallback=rescue)
    try:
        for s in servers:
            s.stop()
        lanes = mixed_lanes(64, seed=46)
        with fabobs.obs_installed() as obs:
            assert rt.batch_verify(*lanes.port()) == lanes.expected
            assert obs.value("fabric_degrade_total", seam="serve.router") == 1
        assert rt.degraded and rt.rescues == 1
        assert rt.describe_backend() == "router-degraded(sw:hostec_np)"
    finally:
        rt.stop()


def test_double_fault_raises(sockdir):
    rt = SidecarRouter([os.path.join(sockdir, "never.sock")], fallback=BrokenProvider(),
                       sleeper=lambda s: None, gate_policy=FAST_GATE)
    lanes = mixed_lanes(12, seed=47)
    try:
        with pytest.raises(SidecarUnavailable, match="rescue provider failed"):
            rt.batch_verify(*lanes.port())
        with pytest.raises(SidecarUnavailable, match="rescue provider failed"):
            rt.batch_verify_async(*lanes.port())()
    finally:
        rt.stop()
    # the JAX router answers all-False there
    jrt = jrouter.SidecarRouter(endpoints=[os.path.join(sockdir, "never.sock")],
                                fallback=BrokenProvider(), sleeper=lambda s: None)
    try:
        assert jrt.batch_verify(*lanes.jax()) == [False] * 12
    finally:
        jrt.stop()


def test_deadline_expiry_rescues(fleet):
    servers, rt = fleet
    rt.deadline_ms = 80
    rt._fallback = bccsp.SoftwareProvider()
    lanes = mixed_lanes(24, seed=48)
    plan = FaultPlan.parse("serve.dispatch=delay:1.0:ms=600", seed=3)
    with plan_installed(plan):
        t0 = time.monotonic()
        assert rt.batch_verify(*lanes.port()) == lanes.expected
        assert time.monotonic() - t0 < 0.5
    assert rt.deadline_expired == 1 and rt.degraded
    deadline = time.monotonic() + WAIT_S
    for srv in servers:
        while srv.qos.balance()["in_flight"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.qos.balance()["leaked"] == 0
