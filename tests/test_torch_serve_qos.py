"""The port's per-class admission (fabric_tpu_torch.serve.qos) and the
sidecar's QoS, deadline, cancel and drain paths beside the JAX package's,
with no tolerance: ClassLedger's admit and release decisions and its
snapshots over seeded sequences of requests, `parse_shares`,
`parse_qos_map` and `class_for_channel` on the same inputs (errors
included), the retry-after hint, per-class accounting through the sidecar,
the v1 client served as the default class, the deadline shed, OP_CANCEL
before dispatch, drain and OP_DRAIN. Every wait is bounded."""

import os
import threading
import time

import numpy as np
import pytest

from fabric_tpu.serve import qos as jqos
from fabric_tpu_torch.crypto import bccsp
from fabric_tpu_torch.serve import protocol as proto
from fabric_tpu_torch.serve import qos
from fabric_tpu_torch.serve.client import SidecarClient, SidecarProvider, encode_lanes
from fabric_tpu_torch.serve.server import SidecarServer
from test_torch_serve import (  # noqa: F401  (fixtures)
    WAIT_S,
    BrokenProvider,
    GatedProvider,
    mixed_lanes,
    sidecar,
    sockdir,
    tiers,
)

SHARES = [None, {"high": 0.5, "normal": 0.3, "bulk": 0.2}, {"high": 0.6, "bulk": 0.1},
          {"normal": 1.0}, {"high": 0.0, "normal": 0.0, "bulk": 0.0}]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shares", range(len(SHARES)))
def test_ledger_decisions_equal_jax(shares, seed):
    """A seeded sequence of acquires (classes, sizes up to past the
    total, an out-of-range class) and releases of what was admitted:
    every decision, fill and snapshot equal to the JAX ledger's."""
    rng = np.random.RandomState(seed)
    total = int(rng.choice([1, 7, 96, 100, 4096]))
    port = qos.ClassLedger(total, SHARES[shares])
    jax = jqos.ClassLedger(total, SHARES[shares])
    held = []
    for _ in range(300):
        if held and rng.rand() < 0.4:
            cls, lanes = held.pop(int(rng.randint(len(held))))
            port.release(cls, lanes)
            jax.release(cls, lanes)
        else:
            cls = int(rng.choice([0, 1, 2, 2, 5]))
            lanes = int(rng.randint(0, total + total // 2 + 2))
            decision = port.try_acquire(cls, lanes)
            assert decision == jax.try_acquire(cls, lanes)
            if decision:
                held.append((cls, lanes))
        assert port.snapshot() == jax.snapshot()
        assert port.fill() == jax.fill()
        assert [port.fill(c) for c in (0, 1, 2, 9)] == [jax.fill(c) for c in (0, 1, 2, 9)]
        assert port.balance() == jax.balance()
    assert port.quota == jax.quota


def test_rejection_latches_the_reservation():
    """After ONE high-priority rejection bulk can no longer borrow the
    high quota; the high retry admits in full (both ledgers)."""
    for mod in (qos, jqos):
        led = mod.ClassLedger(100, {"high": 0.5, "normal": 0.3, "bulk": 0.2})
        assert led.try_acquire(proto.QOS_BULK, 100)
        assert not led.try_acquire(proto.QOS_HIGH, 50)
        led.release(proto.QOS_BULK, 100)
        assert led.try_acquire(proto.QOS_BULK, 50)
        assert not led.try_acquire(proto.QOS_BULK, 10)
        assert led.try_acquire(proto.QOS_HIGH, 50)
        assert led.snapshot()["high"]["waiting"] is False


@pytest.mark.parametrize("text", [
    "high=0.6,bulk=0.1", "high=0.5;normal=0.35;bulk=0.15", " normal = 1 ", "",
    "vip=0.5", "high=0.9,normal=0.9", "high", "high=1.5", "high=x", "bulk=-0.1",
])
def test_parse_shares_as_jax(text):
    outcomes = []
    for mod in (qos, jqos):
        try:
            outcomes.append(mod.parse_shares(text))
        except ValueError as exc:
            outcomes.append(("ValueError", type(exc).__name__))
    assert outcomes[0] == outcomes[1]


MAPS = ["paychan=high;spam*=bulk;*=normal", "spam*=bulk;spamvip*=high",
        "a=high,b=bulk", "", "chan=vip", "=high", "*=bulk", "x*=high;x=bulk",
        "chan==nope=="]
CHANNELS = [None, "", "paychan", "spam42", "spamvip1", "other", "x", "xy", "a", "b"]


@pytest.mark.parametrize("text", MAPS)
def test_qos_map_and_class_for_channel_as_jax(text):
    outcomes = []
    for mod in (qos, jqos):
        try:
            m = mod.parse_qos_map(text)
            outcomes.append((m, [mod.class_for_channel(c, m) for c in CHANNELS]))
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]


def test_no_environment_map(monkeypatch):
    """The JAX package reads FABRIC_TPU_SERVE_QOS; the port's map comes
    from the factory's SERVE block only."""
    assert not hasattr(qos, "qos_map_from_env")
    monkeypatch.setenv("FABRIC_TPU_SERVE_QOS", "*=bulk")
    p = SidecarProvider("/tmp/none.sock")
    try:
        assert p.qos_class == proto.DEFAULT_QOS
        assert jqos.qos_map_from_env() == {"*": proto.QOS_BULK}
    finally:
        p.stop()


class _FakeBatcher:
    pending_lanes = 0


@pytest.mark.parametrize("pending", [0, 16, 32, 64])
def test_retry_after_scales_with_fill_as_jax(pending):
    """The hint's formula on the same fills (the batcher's pending lanes
    and a class's quota fill), both servers built without sockets."""
    from fabric_tpu.serve.server import SidecarServer as JServer

    port, jax = SidecarServer.__new__(SidecarServer), JServer.__new__(JServer)
    for srv, mod in ((port, qos), (jax, jqos)):
        srv.batcher = _FakeBatcher()
        srv.batcher.pending_lanes = pending
        srv.max_pending_lanes = 64
        srv.retry_after_base_ms = 25
        srv.qos = mod.ClassLedger(64)
        srv.qos.try_acquire(proto.QOS_BULK, pending // 2)
    for cls in (None, proto.QOS_HIGH, proto.QOS_BULK):
        assert port.retry_after_ms(cls) == jax.retry_after_ms(cls)


def test_classed_requests_land_in_class_stats(sidecar):
    provider = SidecarProvider(sidecar.address, qos_class=proto.QOS_HIGH,
                               channel="paychan", fallback=BrokenProvider())
    lanes = mixed_lanes(20, seed=30)
    try:
        assert provider.batch_verify(*lanes.port()) == lanes.expected
    finally:
        provider.stop()
    summary = sidecar.stats.summary()
    assert summary["per_class"]["high"]["served"] == 1
    assert summary["per_class"]["high"]["lanes"] == 20
    assert summary["per_class"]["high"]["latency"]["n"] == 1
    assert sidecar.qos.balance()["leaked"] == 0


def test_v1_client_served_as_the_default_class(sidecar):
    import socket

    family, target = proto.parse_address(sidecar.address)
    lanes = mixed_lanes(10, seed=31)
    with socket.socket(family, socket.SOCK_STREAM) as sock:
        sock.settimeout(WAIT_S)
        sock.connect(target)
        proto.send_frame(sock, proto.OP_VERIFY, 7, encode_lanes(*lanes.port(), qos_class=None),
                         version=1)
        _op, rid, reply, version = proto.recv_frame_ex(sock)
    assert (rid, version) == (7, 1)  # the reply echoes v1
    status, _, mask, _ = proto.decode_verify_response(reply)
    assert (status, mask) == (proto.ST_OK, lanes.expected)
    assert sidecar.stats.summary()["per_class"]["normal"]["served"] == 1


def test_drain_refuses_new_work_and_settles_in_flight(sockdir, tiers):
    gated = GatedProvider()
    server = SidecarServer(os.path.join(sockdir, "drain.sock"), engine="host", provider=gated,
                           buckets=(64,), linger_s=0.0)
    server.start()
    client = SidecarClient(server.address)
    try:
        lanes = mixed_lanes(30, seed=32)
        token = client.submit(proto.OP_VERIFY, encode_lanes(*lanes.port()))
        assert gated.entered.wait(WAIT_S)
        drainer = threading.Thread(target=server.drain, kwargs={"timeout_s": WAIT_S},
                                   daemon=True)
        drainer.start()
        deadline = time.monotonic() + WAIT_S
        while not server._draining and time.monotonic() < deadline:
            time.sleep(0.01)
        other = mixed_lanes(10, seed=33)
        tok2 = client.submit(proto.OP_VERIFY, encode_lanes(*other.port()))
        assert proto.decode_verify_response(
            client.await_reply(tok2, WAIT_S))[0] == proto.ST_STOPPING
        gated.gate.set()
        status, _, mask, _ = proto.decode_verify_response(client.await_reply(token, WAIT_S))
        assert (status, mask) == (proto.ST_OK, lanes.expected)
        drainer.join(WAIT_S)
        assert not drainer.is_alive()
        assert server.stats.summary()["degraded_replies"] == 1
    finally:
        gated.gate.set()
        client.close()
        server.stop()


def test_op_drain_acks_then_stops(sidecar):
    client = SidecarClient(sidecar.address)
    try:
        status = proto.decode_verify_response(
            client.request(proto.OP_DRAIN, timeout_s=WAIT_S))[0]
    finally:
        client.close()
    assert status == proto.ST_OK
    deadline = time.monotonic() + WAIT_S
    while not sidecar._stopping and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sidecar._stopping


def test_deadline_shed_and_client_expiry(sidecar):
    """With a served bucket's floor on record, a budget below it is shed
    ST_BUSY (provably unfinishable, counted apart from admission); the
    client then rescues the batch when its budget runs out."""
    lanes = mixed_lanes(20, seed=34)
    client = SidecarClient(sidecar.address)
    try:
        status = proto.decode_verify_response(client.request(
            proto.OP_VERIFY, encode_lanes(*lanes.port(), deadline_ms=0), timeout_s=WAIT_S))[0]
        assert status == proto.ST_OK
        sidecar.stats.min_service_s[20] = 10.0  # the floor: 10 s for this bucket
        status = proto.decode_verify_response(client.request(
            proto.OP_VERIFY, encode_lanes(*lanes.port(), deadline_ms=50), timeout_s=WAIT_S))[0]
        assert status == proto.ST_BUSY
        stats = sidecar.stats.summary()
        assert stats["deadline_shed"] == 1 and stats["rejects"] == 0
    finally:
        client.close()
    provider = SidecarProvider(sidecar.address, deadline_ms=50,
                               fallback=bccsp.SoftwareProvider())
    try:
        assert provider.batch_verify(*lanes.port()) == lanes.expected
        assert provider.deadline_expired == 1 and provider.degraded
    finally:
        provider.stop()


def test_cancel_before_dispatch_sheds_uncomputed(sockdir, tiers):
    """A request cancelled while the dispatcher is busy with another is
    shed without a reply; the connection keeps serving."""
    gated = GatedProvider()
    server = SidecarServer(os.path.join(sockdir, "c.sock"), engine="host", provider=gated,
                           buckets=(64,), linger_s=0.0)
    server.start()
    client = SidecarClient(server.address)
    first, second = mixed_lanes(8, seed=35), mixed_lanes(9, seed=36)
    try:
        t1 = client.submit(proto.OP_VERIFY, encode_lanes(*first.port()))
        assert gated.entered.wait(WAIT_S)
        # a cancel that arrives before the VERIFY it names: the worker
        # takes it at its pre-dispatch check and sheds the request
        client.cancel(client._next_id + 1)
        t2 = client.submit(proto.OP_VERIFY, encode_lanes(*second.port()))
        deadline = time.monotonic() + WAIT_S
        while (server.stats.summary()["cancelled_pre"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        gated.gate.set()
        status, _, mask, _ = proto.decode_verify_response(client.await_reply(t1, WAIT_S))
        assert (status, mask) == (proto.ST_OK, first.expected)
        assert client.poll_reply(t2, 0.3) is None  # shed: no reply, ever
        assert server.stats.summary()["cancelled_pre"] == 1
        assert client.ping(timeout_s=WAIT_S)
        assert server.qos.balance()["leaked"] == 0
    finally:
        gated.gate.set()
        client.close()
        server.stop()
