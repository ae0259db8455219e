"""The port's VerifyBatcher and BatchingProvider beside the JAX package's.

The cases of tests/test_batcher.py, each run on both packages' batchers
with the same scripted providers and the same outcome asserted: slicing,
coalescing, backpressure, the oversized request, stop settling, the RTT
auto mode and the mode forced from the environment, hung resolvers settled
fail-closed, idempotent stop, a retry then success, retry exhaustion, the
injected submit fault, the drain after a launch failure. The case run
through the real provider takes the port's CUDAProvider(device="cpu"), K2's
plain version. Then the retry and fail-closed counters the port's fabobs
keeps, which chip_smoke.py reads on the card."""

import hashlib
import threading
import time
from types import SimpleNamespace

import pytest
from torch_untraced import untraced  # noqa: F401


def _jax():
    from fabric_tpu.common.faults import FaultPlan, InjectedFault, plan_installed
    from fabric_tpu.common.retry import RetryPolicy
    from fabric_tpu.parallel.batcher import BatchingProvider, VerifyBatcher

    return SimpleNamespace(VerifyBatcher=VerifyBatcher, BatchingProvider=BatchingProvider,
                           RetryPolicy=RetryPolicy, FaultPlan=FaultPlan,
                           InjectedFault=InjectedFault, plan_installed=plan_installed)


def _port():
    from fabric_tpu_torch.common.faults import FaultPlan, InjectedFault, plan_installed
    from fabric_tpu_torch.common.retry import RetryPolicy
    from fabric_tpu_torch.parallel.batcher import BatchingProvider, VerifyBatcher

    return SimpleNamespace(VerifyBatcher=VerifyBatcher, BatchingProvider=BatchingProvider,
                           RetryPolicy=RetryPolicy, FaultPlan=FaultPlan,
                           InjectedFault=InjectedFault, plan_installed=plan_installed)


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return _port() if request.param == "port" else _jax()


class FakeProvider:
    """Verdict = (key == b"ok"); records launch sizes."""

    def __init__(self, gate=None):
        self.launch_sizes = []
        self.gate = gate

    def batch_verify_async(self, keys, sigs, digests):
        if self.gate is not None:
            self.gate.wait()
        self.launch_sizes.append(len(keys))
        out = [k == b"ok" for k in keys]
        return lambda: out


def test_slicing_returns_each_requests_own_lanes(pkg):
    b = pkg.VerifyBatcher(FakeProvider(), linger_s=0.001)
    try:
        r1 = b.submit([b"ok", b"bad"], [b"s"] * 2, [b"d"] * 2)
        r2 = b.submit([b"bad", b"ok", b"ok"], [b"s"] * 3, [b"d"] * 3)
        assert r1() == [True, False]
        assert r2() == [False, True, True]
        assert b.lanes == 5
    finally:
        b.stop()


def test_concurrent_submissions_coalesce(pkg):
    prov = FakeProvider()
    b = pkg.VerifyBatcher(prov, linger_s=0.02)
    results = {}
    try:
        def worker(i):
            n = 1 + (i % 4)
            keys = [b"ok" if (i + j) % 2 == 0 else b"no" for j in range(n)]
            results[i] = (keys, b.submit(keys, [b"s"] * n, [b"d"] * n)())

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(40)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        b.stop()
    for keys, out in results.values():
        assert out == [k == b"ok" for k in keys]
    assert len(results) == 40
    # 40 requests from racing threads must NOT mean 40 launches
    assert b.launches < 40, prov.launch_sizes
    assert sum(prov.launch_sizes) == b.lanes


def test_backpressure_bounds_pending_lanes(pkg):
    gate = threading.Event()
    b = pkg.VerifyBatcher(FakeProvider(gate=gate), linger_s=0.0, max_pending_lanes=4)
    try:
        # the dispatcher picks this up and stalls inside the provider; its
        # permits were released at dispatch
        first = b.submit([b"ok"], [b"s"], [b"d"])
        time.sleep(0.05)
        # these 4 hold every permit while queued behind the stalled launch
        second = b.submit([b"ok"] * 4, [b"s"] * 4, [b"d"] * 4)
        blocked, unblocked = threading.Event(), threading.Event()

        def overflow():
            blocked.set()
            r = b.submit([b"ok"], [b"s"], [b"d"])
            unblocked.set()
            r()

        t = threading.Thread(target=overflow, daemon=True)
        t.start()
        assert blocked.wait(1.0)
        time.sleep(0.1)
        assert not unblocked.is_set()  # backpressured while the device stalls
        gate.set()
        assert unblocked.wait(2.0)
        assert first() == [True]
        assert second() == [True] * 4
        t.join(timeout=2.0)
    finally:
        gate.set()
        b.stop()


def test_oversized_request_does_not_deadlock(pkg):
    b = pkg.VerifyBatcher(FakeProvider(), linger_s=0.0, max_pending_lanes=4)
    try:
        assert b.submit([b"ok"] * 10, [b"s"] * 10, [b"d"] * 10)() == [True] * 10
    finally:
        b.stop()


def test_stop_settles_outstanding_requests(pkg):
    b = pkg.VerifyBatcher(FakeProvider(), linger_s=0.001)
    r = b.submit([b"ok"], [b"s"], [b"d"])
    b.stop()
    assert r() == [True]


def _signed_lanes(n, tag):
    """n (key, DER signature, digest) lanes signed by the port's oracle
    with one fixed key."""
    from fabric_tpu_torch.common import der, p256
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey

    priv = 0x1234567890ABCDEF1234567890ABCDEF
    x, y = p256.base_mult(priv)
    key = ECDSAPublicKey(x, y)
    lanes = []
    for i in range(n):
        digest = hashlib.sha256(b"%s %d" % (tag, i)).digest()
        r, s = p256.sign_digest(priv, digest, 0xC0FFEE + i)
        lanes.append((key, der.marshal_signature(r, s), digest))
    return lanes


def test_with_cuda_provider_plain_route():
    """Mixed-size concurrent requests through CUDAProvider(device="cpu"),
    the route the card takes with K2's plain version: one verdict a lane,
    the tampered digest False, equal to the oracle's."""
    import torch

    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.parallel.batcher import VerifyBatcher

    torch.set_num_threads(1)
    lanes = _signed_lanes(6, b"batcher")
    b = VerifyBatcher(CUDAProvider(device="cpu"), linger_s=0.01)
    try:
        good = b.submit(*map(list, zip(*lanes)))
        bad = b.submit([lanes[0][0]], [lanes[0][1]], [hashlib.sha256(b"tampered").digest()])
        assert good() == [True] * 6
        assert bad() == [False]
        assert 1 <= b.launches <= 2
    finally:
        b.stop()


def test_batching_provider_adapter(pkg):
    prov = FakeProvider()
    bp = pkg.BatchingProvider(prov, linger_s=0.001)
    try:
        assert bp.batch_verify([b"ok", b"no"], [b"s"] * 2, [b"d"] * 2) == [True, False]
        assert bp.batch_verify_async([b"ok"], [b"s"], [b"d"])() == [True]
        # passthrough of non-batch attributes
        assert bp.launch_sizes == prov.launch_sizes
        assert bp.batcher.lanes == 3
    finally:
        bp.stop()


class SlowResolveProvider:
    """Fixed per-launch round-trip time in the resolver."""

    def __init__(self, rtt_s):
        self.rtt_s = rtt_s
        self.launch_sizes = []

    def batch_verify_async(self, keys, sigs, digests):
        self.launch_sizes.append(len(keys))
        out = [k == b"ok" for k in keys]

        def resolve():
            time.sleep(self.rtt_s)
            return out

        return resolve


def test_rtt_autodetect_switches_to_passthrough(pkg):
    prov = SlowResolveProvider(rtt_s=0.08)  # 80ms >> 25ms threshold
    b = pkg.VerifyBatcher(prov, linger_s=0.005)
    try:
        assert b.mode == "coalesce"  # no signal yet: default
        for _ in range(4):
            b.submit([b"ok"] * 8, [b""] * 8, [b""] * 8)()
        assert b.rtt_ema_ms is not None and b.rtt_ema_ms > 30
        assert b.mode == "passthrough"
        # in passthrough, concurrent submissions do NOT merge
        prov.launch_sizes.clear()
        rs = [b.submit([b"ok"] * 8, [b""] * 8, [b""] * 8) for _ in range(3)]
        for r in rs:
            r()
        assert all(s == 8 for s in prov.launch_sizes)
    finally:
        b.stop()


def test_rtt_autodetect_stays_coalescing_when_fast(pkg):
    b = pkg.VerifyBatcher(SlowResolveProvider(rtt_s=0.0), linger_s=0.005)
    try:
        for _ in range(6):
            b.submit([b"ok"] * 8, [b""] * 8, [b""] * 8)()
        assert b.rtt_ema_ms is not None and b.rtt_ema_ms < 20
        assert b.mode == "coalesce"
    finally:
        b.stop()


@pytest.mark.parametrize("mode", ["passthrough", "coalesce"])
def test_forced_mode_env(pkg, monkeypatch, mode):
    monkeypatch.setenv("FABRIC_TPU_BATCHER_MODE", mode)
    monkeypatch.setenv("FABRIC_TPU_BATCHER_RTT_MS", "0.000001")
    b = pkg.VerifyBatcher(SlowResolveProvider(rtt_s=0.01), linger_s=0.005)
    try:
        b.submit([b"ok"] * 8, [b""] * 8, [b""] * 8)()
        assert b.mode == mode
    finally:
        b.stop()


class HangingResolveProvider:
    """The resolver blocks until released: a wedged device."""

    def __init__(self):
        self.release = threading.Event()

    def batch_verify_async(self, keys, sigs, digests):
        def resolve():
            self.release.wait(30)
            return [True] * len(keys)

        return resolve


def test_stop_settles_hung_resolver_fail_closed(pkg):
    prov = HangingResolveProvider()
    b = pkg.VerifyBatcher(prov, linger_s=0.0, join_timeout_s=0.2)
    r = b.submit([b"ok", b"ok"], [b"s"] * 2, [b"d"] * 2)
    time.sleep(0.05)  # let the dispatcher pick it up and hang
    t0 = time.monotonic()
    try:
        b.stop()
        out = r()
    finally:
        prov.release.set()
    assert out == [False, False]
    assert time.monotonic() - t0 < 5


def test_stop_is_idempotent(pkg):
    b = pkg.VerifyBatcher(FakeProvider(), linger_s=0.001)
    r = b.submit([b"ok"], [b"s"], [b"d"])
    b.stop()
    b.stop()
    assert r() == [True]


def test_stop_then_submit_raises_and_leaks_nothing(pkg):
    b = pkg.VerifyBatcher(FakeProvider(), linger_s=0.001)
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit([b"ok"], [b"s"], [b"d"])
    assert b._lanes_free == b._max_pending_lanes  # admission released
    assert not b._inflight


class FlakyDispatchProvider:
    """The first dispatches raise ConnectionError, then succeed."""

    def __init__(self, failures):
        self.failures = failures
        self.attempts = 0

    def batch_verify_async(self, keys, sigs, digests):
        self.attempts += 1
        if self.attempts <= self.failures:
            raise ConnectionError("transient flap")
        out = [k == b"ok" for k in keys]
        return lambda: out


def test_dispatch_retries_transient_then_succeeds(pkg):
    prov = FlakyDispatchProvider(failures=2)
    b = pkg.VerifyBatcher(prov, linger_s=0.0, dispatch_retry=pkg.RetryPolicy(
        base_s=0.001, multiplier=2, cap_s=0.01, deadline_s=1, max_attempts=3))
    try:
        assert b.submit([b"ok", b"no"], [b"s"] * 2, [b"d"] * 2)() == [True, False]
        assert prov.attempts == 3
    finally:
        b.stop()


def test_dispatch_retry_budget_exhausted_propagates(pkg):
    prov = FlakyDispatchProvider(failures=100)
    b = pkg.VerifyBatcher(prov, linger_s=0.0, dispatch_retry=pkg.RetryPolicy(
        base_s=0.001, multiplier=2, cap_s=0.01, deadline_s=1, max_attempts=2))
    try:
        r = b.submit([b"ok"], [b"s"], [b"d"])
        with pytest.raises(ConnectionError):
            r()
        assert prov.attempts == 3  # 1 try + 2 retries
    finally:
        b.stop()


def test_injected_submit_fault_fails_caller_without_leaking_lanes(pkg):
    b = pkg.VerifyBatcher(FakeProvider(), linger_s=0.001, max_pending_lanes=8)
    try:
        with pkg.plan_installed(pkg.FaultPlan.parse("batcher.submit=raise:1.0")):
            with pytest.raises(pkg.InjectedFault):
                b.submit([b"ok"], [b"s"], [b"d"])
        assert b._lanes_free == 8  # nothing admitted, nothing leaked
        assert b.submit([b"ok"], [b"s"], [b"d"])() == [True]
    finally:
        b.stop()


def test_stop_wakes_admission_blocked_submitter(pkg):
    prov = HangingResolveProvider()
    b = pkg.VerifyBatcher(prov, linger_s=0.0, max_pending_lanes=2, join_timeout_s=0.2)
    b.submit([b"ok", b"ok"], [b"s"] * 2, [b"d"] * 2)
    time.sleep(0.05)
    b.submit([b"ok", b"ok"], [b"s"] * 2, [b"d"] * 2)  # queued: holds both permits
    outcome = []

    def blocked_submit():
        try:
            b.submit([b"ok"], [b"s"], [b"d"])
            outcome.append("admitted")
        except RuntimeError:
            outcome.append("stopped")

    t = threading.Thread(target=blocked_submit, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not outcome  # genuinely blocked in admission
    try:
        b.stop()
        t.join(timeout=2.0)
    finally:
        prov.release.set()
    assert outcome == ["stopped"]


class HoldFirstThenFailProvider:
    """Launch 1 blocks until released, launch 2 raises a hard error."""

    def __init__(self):
        self.n = 0
        self.release = threading.Event()

    def batch_verify_async(self, keys, sigs, digests):
        self.n += 1
        if self.n == 1:
            self.release.wait(5)
            out = [k == b"ok" for k in keys]
            return lambda: out
        raise ValueError("hard provider error")


def test_launch_failure_drains_pending_resolvers(pkg):
    prov = HoldFirstThenFailProvider()
    b = pkg.VerifyBatcher(prov, linger_s=0.0)
    try:
        ra = b.submit([b"ok"], [b"s"], [b"d"])
        time.sleep(0.05)  # the dispatcher takes A and blocks in its launch
        rb = b.submit([b"ok"], [b"s"], [b"d"])
        prov.release.set()  # A launches; B's launch then hard-fails
        done = []
        t = threading.Thread(target=lambda: done.append(ra()), daemon=True)
        t.start()
        t.join(timeout=3.0)
        assert done == [[True]]
        with pytest.raises(ValueError):
            rb()
    finally:
        b.stop()


def test_port_counters_read_retries_and_fail_closed_settlements():
    """The port's fabobs counts each dispatch retry and each fail-closed
    settlement, readable in process (chip_smoke.py's pipeline phase
    requires both at zero); a clean run counts none and one launch."""
    from fabric_tpu_torch.common import fabobs
    from fabric_tpu_torch.common.retry import RetryPolicy
    from fabric_tpu_torch.parallel.batcher import VerifyBatcher

    policy = RetryPolicy(base_s=0.001, multiplier=2, cap_s=0.01, deadline_s=1, max_attempts=3)
    with fabobs.obs_installed() as reg:
        b = VerifyBatcher(FakeProvider(), linger_s=0.0)
        assert b.submit([b"ok"], [b"s"], [b"d"])() == [True]
        b.stop()
        assert reg.value("fabric_batcher_dispatch_retries_total") == 0
        assert reg.value("fabric_batcher_fail_closed_total") == 0
        assert reg.value("fabric_batcher_launches_total", mode="coalesce") == 1
        b = VerifyBatcher(FlakyDispatchProvider(failures=2), linger_s=0.0, dispatch_retry=policy)
        assert b.submit([b"ok"], [b"s"], [b"d"])() == [True]
        b.stop()
        assert reg.value("fabric_batcher_dispatch_retries_total") == 2
        prov = HangingResolveProvider()
        b = VerifyBatcher(prov, linger_s=0.0, join_timeout_s=0.2)
        r = b.submit([b"ok"] * 3, [b"s"] * 3, [b"d"] * 3)
        time.sleep(0.05)
        b.stop()
        prov.release.set()
        assert r() == [False] * 3
        assert reg.value("fabric_batcher_fail_closed_total") == 1
        assert any(e["name"] == "trigger:batcher.fail_closed" for e in reg.trace_events())
