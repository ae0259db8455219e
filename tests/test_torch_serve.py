"""The port's serve sidecar (fabric_tpu_torch.serve) beside the JAX
package's, with no tolerance: the wire protocol byte for byte (frames,
requests of revisions 1-3 with NO_KEY, responses, the error cases of
tests/test_serve.py::TestProtocol), the lane-bucket ladder and the
registry's warm-once contract, the batcher's front door (try_submit,
pending_lanes, on_dispatch), sidecar masks over seeded mixed lanes, a port
client against a JAX server and a JAX client against a port server at
every protocol revision (the step-down included), the NO_KEY repair (the
port server answers lanes with no usable key False where the JAX per-lane
tier raises), admission control, the rescue (bit-exact through a
``fallback=`` provider; a double fault raises SidecarUnavailable), the
factory's SERVE rung, a Channel committing through a port sidecar, the
daemon as a subprocess, and fleetload.

Lanes are signed by the port's P-256 oracle with keys and nonces drawn
from numpy seeds. Both packages' host EC tiers are pinned for the tests
that run a server (the JAX package's tier decides how it treats a None
key) and restored, with their pools shut down, afterwards. Every socket
wait, join and event wait is bounded."""

import hashlib
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fabric_tpu.crypto import bccsp as jbccsp
from fabric_tpu.crypto import hostec as jhostec
from fabric_tpu.crypto import hostec_np as jhostec_np
from fabric_tpu.serve import client as jclient
from fabric_tpu.serve import protocol as jproto
from fabric_tpu.serve import registry as jregistry
from fabric_tpu.serve import server as jserver
from fabric_tpu_torch.common import der, fabobs, p256
from fabric_tpu_torch.common.faults import FaultPlan, plan_installed
from fabric_tpu_torch.common.retry import CooldownGate
from fabric_tpu_torch.crypto import bccsp, hostec, hostec_np
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.crypto.factory import FactoryError, provider_from_config
from fabric_tpu_torch.serve import protocol as proto
from fabric_tpu_torch.serve import registry
from fabric_tpu_torch.serve import server as tserver
from fabric_tpu_torch.serve.client import (
    SidecarClient,
    SidecarProvider,
    SidecarUnavailable,
    encode_lanes,
)
from fabric_tpu_torch.serve.server import SidecarServer
from test_torch_commit_pipeline import world  # noqa: F401  (the config #2 network)
from torch_untraced import untraced  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 20.0  # the bound of every event wait and join here

# ---------------------------------------------------------------------------
# workload material
# ---------------------------------------------------------------------------

LANE_KINDS = ("good", "bad_sig", "high_s", "garbage", "no_key")


class Lanes:
    """Seeded lanes in both packages' key objects: ``keys`` (the port's
    ECDSAPublicKey, None for a no_key lane), ``jkeys`` (the JAX one),
    ``sigs``, ``digests``, ``expected`` (by construction)."""

    def __init__(self, keys, jkeys, sigs, digests, expected):
        self.keys, self.jkeys = keys, jkeys
        self.sigs, self.digests, self.expected = sigs, digests, expected

    def port(self):
        return self.keys, self.sigs, self.digests

    def jax(self):
        return self.jkeys, self.sigs, self.digests


_UNIQUE = {}


def _unique_lanes(seed: int, unique: int):
    """`unique` signed lanes under two keys from numpy seed `seed`."""
    if (seed, unique) not in _UNIQUE:
        rng = np.random.RandomState(seed)
        privs = [int(v) for v in rng.randint(1, 2**31 - 1, size=2)]
        pubs = [p256.base_mult(d) for d in privs]
        out = []
        for i in range(unique):
            digest = hashlib.sha256(rng.bytes(16)).digest()
            nonce = int.from_bytes(rng.bytes(32), "big") % (p256.N - 1) + 1
            k = i % 2
            r, s = p256.sign_digest(privs[k], digest, nonce)
            out.append((pubs[k], r, s, digest))
        _UNIQUE[(seed, unique)] = out
    return _UNIQUE[(seed, unique)]


def mixed_lanes(n: int, seed: int = 0, unique: int = 40) -> Lanes:
    """n lanes cycling the kinds of LANE_KINDS (parse, low-S, curve and
    key paths), tiled from `unique` signatures."""
    base = _unique_lanes(seed, unique)
    pkeys, jkeys = {}, {}
    keys, jks, sigs, digests, expected = [], [], [], [], []
    for i in range(n):
        pub, r, s, digest = base[i % unique]
        kind = LANE_KINDS[i % len(LANE_KINDS)]
        sig = der.marshal_signature(r, s)
        if kind == "bad_sig":
            sig = sig[:-1] + bytes([sig[-1] ^ 0x5A])
        elif kind == "high_s":
            sig = der.marshal_signature(r, p256.N - s)
        elif kind == "garbage":
            sig = b"\x00\x01garbage"
        if kind == "no_key":
            keys.append(None)
            jks.append(None)
        else:
            keys.append(pkeys.setdefault(pub, bccsp.ECDSAPublicKey(*pub)))
            jks.append(jkeys.setdefault(pub, jbccsp.ECDSAPublicKey(*pub)))
        sigs.append(sig)
        digests.append(digest)
        expected.append(kind == "good")
    return Lanes(keys, jks, sigs, digests, expected)


def short_dir() -> str:
    """A short socket directory: AF_UNIX paths are limited to 107 bytes."""
    return tempfile.mkdtemp(prefix="fts")


@pytest.fixture
def sockdir():
    d = short_dir()
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def tiers():
    """Both packages' host EC tiers pinned (the JAX one decides how its
    server treats a None key), restored with their pools shut down."""
    prev_port, prev_jax = bccsp.ec_backend_name(), jbccsp.ec_backend_name()
    bccsp.select_ec_backend("hostec_np")
    jbccsp.select_ec_backend("hostec_np")
    try:
        yield
    finally:
        for mod in (hostec_np, hostec, jhostec_np, jhostec):
            mod.shutdown_pool()
        bccsp.select_ec_backend(prev_port)
        jbccsp.select_ec_backend(prev_jax)


def host_server(address, **kw):
    kw.setdefault("buckets", (64, 256))
    server = SidecarServer(address, engine="host", **kw)
    server.warm()
    server.start()
    return server


def jax_server(address, **kw):
    kw.setdefault("buckets", (64, 256))
    server = jserver.SidecarServer(address, engine="host", warm_ladder="off", **kw)
    server.warm()
    server.start()
    return server


@pytest.fixture
def sidecar(sockdir, tiers):
    server = host_server(os.path.join(sockdir, "s.sock"))
    try:
        yield server
    finally:
        server.stop()


class GatedProvider(bccsp.SoftwareProvider):
    """Computes verdicts eagerly but stalls the batcher's dispatcher on a
    gate, so admitted-but-undispatched lanes accumulate."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()
        self.entered = threading.Event()

    def batch_verify_async(self, keys, sigs, digests):
        out = bccsp.SoftwareProvider.batch_verify(self, keys, sigs, digests)
        self.entered.set()
        self.gate.wait(WAIT_S)
        return lambda: out


class BrokenProvider(bccsp.Provider):
    def batch_verify(self, keys, sigs, digests):
        raise RuntimeError("rescue provider broken too")


# ---------------------------------------------------------------------------
# protocol: byte for byte against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("opcode", [proto.OP_PING, proto.OP_VERIFY, proto.OP_STATS,
                                    proto.OP_SHUTDOWN, proto.OP_DRAIN, proto.OP_CANCEL])
def test_frames_equal_jax(opcode, version):
    payload = np.random.RandomState(opcode * 10 + version).bytes(37)
    assert (proto.pack_frame(opcode, 0x1_0000_0007, payload, version=version)
            == jproto.pack_frame(opcode, 0x1_0000_0007, payload, version=version))
    assert (proto.OP_CANCEL, proto.NO_KEY, proto.MAX_PAYLOAD, proto.QOS_NAMES) == (
        jproto.OP_CANCEL, jproto.NO_KEY, jproto.MAX_PAYLOAD, jproto.QOS_NAMES)
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(WAIT_S)
        proto.send_frame(a, opcode, 7, payload, version=version)
        assert jproto.recv_frame_ex(b) == (opcode, 7, payload, version)
        jproto.send_frame(a, opcode, 8, payload, version=version)
        assert proto.recv_frame_ex(b) == (opcode, 8, payload, version)
        a.close()
        assert proto.recv_frame(b) is None  # clean EOF


REQUEST_CASES = [
    dict(),
    dict(qos_class=proto.QOS_HIGH, channel="paychan"),
    dict(qos_class=proto.QOS_BULK, channel="spam-é" * 60),  # truncated at 255 bytes
    dict(qos_class=proto.QOS_NORMAL, channel="c", deadline_ms=0),
    dict(qos_class=proto.QOS_HIGH, channel="c", deadline_ms=1234),
]


@pytest.mark.parametrize("case", range(len(REQUEST_CASES)))
def test_verify_requests_equal_jax(case):
    kw = REQUEST_CASES[case]
    rng = np.random.RandomState(case)
    table = [b"\x04" + rng.bytes(64) for _ in range(3)]
    lanes = [(int(rng.randint(0, 3)) if i % 4 else proto.NO_KEY, rng.bytes(70 + i % 3),
              rng.bytes(32)) for i in range(17)]
    got = proto.encode_verify_request(table, lanes, **kw)
    assert got == jproto.encode_verify_request(table, lanes, **kw)
    version = 1 if "qos_class" not in kw else (3 if "deadline_ms" in kw else 2)
    want = jproto.decode_verify_request(got, version)
    assert proto.decode_verify_request(got, version) == want
    assert want[0] == table and want[1] == lanes


@pytest.mark.parametrize("version", [1, 2, 3])
def test_encode_lanes_equal_jax(version):
    """The client's payload: keys deduplicated by object, None keys as
    NO_KEY, the body the negotiated revision picks."""
    lanes = mixed_lanes(23, seed=1)
    kw = dict(qos_class=proto.QOS_HIGH, channel="paychan", deadline_ms=250,
              version=version)
    got = encode_lanes(*lanes.port(), **kw)
    assert got == jclient.encode_lanes(*lanes.jax(), **kw)
    table, wire_lanes, qos, chan, dl = jproto.decode_verify_request(got, version)
    assert len(table) == 2
    assert [i for i, _, _ in wire_lanes].count(proto.NO_KEY) == lanes.keys.count(None)
    assert (qos, chan, dl) == ((proto.QOS_HIGH, "paychan", 250) if version == 3 else
                               (proto.QOS_HIGH, "paychan", 0) if version == 2 else
                               (proto.DEFAULT_QOS, "", 0))
    v1 = encode_lanes(*lanes.port(), qos_class=None)
    assert v1 == jclient.encode_lanes(*lanes.jax(), qos_class=None)


@pytest.mark.parametrize("args", [
    (proto.ST_OK, [True, False, True, True], "", 0),
    (proto.ST_OK, [], "", 0),
    (proto.ST_BUSY, None, "full", 40),
    (proto.ST_ERROR, None, "x" * 5000, 0),
    (proto.ST_STOPPING, None, "", 0xFFFFFFFF + 3),
])
def test_verify_responses_equal_jax(args):
    status, mask, message, retry = args
    got = proto.encode_verify_response(status, mask=mask, message=message,
                                       retry_after_ms=retry)
    assert got == jproto.encode_verify_response(status, mask=mask, message=message,
                                                retry_after_ms=retry)
    assert proto.decode_verify_response(got) == jproto.decode_verify_response(got)


def _bad_magic(pkg):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(b"XX" + b"\x00" * (pkg.HEADER_SIZE - 2))
        pkg.recv_frame(b)


def _truncated(pkg):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(pkg.pack_frame(pkg.OP_PING, 1, b"full payload here")[:-5])
        a.close()
        pkg.recv_frame(b)


def _oversized(pkg):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(struct.pack(">2sBBII", pkg.MAGIC, pkg.PROTOCOL_VERSION,
                              pkg.OP_VERIFY, 1, pkg.MAX_PAYLOAD + 1))
        pkg.recv_frame(b)


def _bad_version(pkg):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(struct.pack(">2sBBII", pkg.MAGIC, 4, pkg.OP_PING, 1, 0))
        pkg.recv_frame(b)


def _bad_key_index(pkg):
    bad = bytearray(pkg.encode_verify_request([b"k"], [(0, b"s", b"d")]))
    struct.pack_into(">H", bad, 2 + 2 + 1 + 4, 5)
    pkg.decode_verify_request(bytes(bad))


PROTOCOL_ERRORS = {
    "bad_magic": (_bad_magic, "magic"),
    "truncated": (_truncated, "mid-frame|payload"),
    "oversized": (_oversized, "MAX_PAYLOAD"),
    "version": (_bad_version, "unsupported protocol version"),
    "key_index": (_bad_key_index, "out of range"),
    "trailing": (lambda pkg: pkg.decode_verify_request(
        pkg.encode_verify_request([], []) + b"x"), "trailing"),
    "truncated_payload": (lambda pkg: pkg.decode_verify_request(
        pkg.encode_verify_request([b"k"], [(0, b"s", b"d")])[:-1]), "truncated"),
    "qos_range": (lambda pkg: pkg.decode_verify_request(b"\x07\x00", 2), "out of range"),
    "qos_encode": (lambda pkg: pkg.encode_verify_request([], [], qos_class=9), "out of range"),
    "deadline_without_qos": (lambda pkg: pkg.encode_verify_request([], [], deadline_ms=5),
                             "requires the rev-2"),
    "response_trailing": (lambda pkg: pkg.decode_verify_response(
        pkg.encode_verify_response(pkg.ST_OK, mask=[True]) + b"\x00"), "trailing"),
    "too_many_keys": (lambda pkg: pkg.encode_verify_request([b"k"] * 0xFFFF, []),
                      "too many distinct keys"),
    "oversized_payload": (lambda pkg: pkg.pack_frame(1, 1, b"\x00" * (pkg.MAX_PAYLOAD + 1)),
                          "exceeds MAX_PAYLOAD"),
}


@pytest.mark.parametrize("name", sorted(PROTOCOL_ERRORS))
def test_protocol_errors_as_jax(name):
    fn, match = PROTOCOL_ERRORS[name]
    for pkg in (proto, jproto):
        with pytest.raises(pkg.ProtocolError, match=match):
            fn(pkg)


@pytest.mark.parametrize("address", ["/tmp/x.sock", "127.0.0.1:0", "localhost:9",
                                     "nocolon", ":9"])
def test_parse_address_as_jax(address):
    outcomes = []
    for pkg in (proto, jproto):
        try:
            outcomes.append(pkg.parse_address(address))
        except ValueError as exc:
            outcomes.append(("ValueError", str(exc)))
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# registry: the ladder and the warm-once contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ladder", [(128, 256), registry.DEFAULT_BUCKETS, (8,)])
def test_bucket_for_equals_jax(ladder):
    assert registry.DEFAULT_BUCKETS == jregistry.DEFAULT_BUCKETS
    for n in list(range(0, 300)) + [4095, 4096, 4097, 16384, 16385, 40000, 65537]:
        assert registry.bucket_for(n, ladder) == jregistry.bucket_for(n, ladder)


def test_registry_warm_once_with_the_demo_ladder():
    """Every bucket warmed once (a demo launch each, checked against
    Python's pow); a lookup in a warmed bucket never builds; an
    unwarmed bucket is a KeyError, never a build."""
    torch.set_num_threads(1)
    fn, inputs_for, check = registry.demo_limb_program("cpu")
    calls = []

    def counting(*args):
        calls.append(args[0].shape[1])
        return fn(*args)

    reg = registry.BucketProgramRegistry.for_program(counting, inputs_for, check,
                                                     buckets=(8, 16), label="demo")
    with pytest.raises(KeyError, match="not warmed"):
        reg.program_for(3)  # nothing warmed yet
    report = reg.warm()
    assert sorted(report) == [8, 16] and calls == [8, 16]
    assert all(r["builds"] == 0 and "launch_ms" in r for r in report.values())
    assert reg.warm() is report and calls == [8, 16]  # idempotent
    assert reg.program_for(9) == (16, counting) and calls == [8, 16]
    with pytest.raises(KeyError, match="bucket 32 not warmed"):
        reg.program_for(17)
    stats = reg.stats()
    assert stats["warmed"] and stats["buckets"] == [8, 16]
    assert set(stats["per_bucket"]) == {"8", "16"}
    assert {"process_builds", "process_cache_hits"} <= set(stats)
    with pytest.raises(RuntimeError, match="demo program wrong"):
        check(torch.zeros_like(inputs_for(8)[0]), 8)


@pytest.mark.parametrize("ladder", [(256, 128), (128, 128), ()])
def test_registry_ladder_must_be_sorted_unique(ladder):
    for mod in (registry, jregistry):
        with pytest.raises(ValueError, match="sorted unique"):
            mod.BucketProgramRegistry(ladder, lambda b: (None, {}))


# ---------------------------------------------------------------------------
# the batcher's front door
# ---------------------------------------------------------------------------


def _front_door_pkgs():
    from fabric_tpu.parallel.batcher import VerifyBatcher as JBatcher
    from fabric_tpu_torch.parallel.batcher import VerifyBatcher

    return {"port": VerifyBatcher, "jax": JBatcher}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_try_submit_rejects_when_full_and_recovers(pkg):
    """Full: try_submit refuses (None, never a block); the dispatcher's
    pickup fires on_dispatch once and frees the budget; the retry admits."""
    gate, entered = threading.Event(), threading.Event()

    class Gated:
        def batch_verify_async(self, keys, sigs, digests):
            entered.set()
            gate.wait(WAIT_S)
            out = [True] * len(keys)
            return lambda: out

    fired = []
    b = _front_door_pkgs()[pkg](Gated(), max_pending_lanes=8, linger_s=0.0)
    try:
        with fabobs.obs_installed() as obs:
            r1 = b.try_submit([object()] * 8, [b"s"] * 8, [b"d"] * 8,
                              on_dispatch=lambda: fired.append(1))
            assert r1 is not None
            assert entered.wait(WAIT_S)
            assert fired == [1] and b.pending_lanes == 0
            r2 = b.try_submit([object()] * 6, [b"s"] * 6, [b"d"] * 6)
            assert r2 is not None and b.pending_lanes == 6
            assert b.try_submit([object()] * 3, [b"s"] * 3, [b"d"] * 3) is None
            if pkg == "port":
                assert obs.value("fabric_batcher_busy_rejects_total") == 1
            gate.set()
            assert r1() == [True] * 8 and r2() == [True] * 6
            deadline = time.monotonic() + WAIT_S
            while b.pending_lanes and time.monotonic() < deadline:
                time.sleep(0.01)
            r3 = b.try_submit([object()] * 8, [b"s"] * 8, [b"d"] * 8)
            assert r3 is not None and r3() == [True] * 8
    finally:
        gate.set()
        b.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_try_submit_deadline_caps_the_linger(pkg):
    """A request with a tight deadline is dispatched without waiting out
    a long linger; an unbudgeted one waits for company."""
    seen = []

    class Recording:
        def batch_verify_async(self, keys, sigs, digests):
            seen.append(time.monotonic())
            out = [True] * len(keys)
            return lambda: out

    b = _front_door_pkgs()[pkg](Recording(), linger_s=2.0)
    try:
        t0 = time.monotonic()
        r = b.try_submit([object()], [b"s"], [b"d"], deadline_s=t0 + 0.05)
        assert r() == [True]
        assert seen[0] - t0 < 1.0
    finally:
        b.stop()


# ---------------------------------------------------------------------------
# the sidecar: masks, connections, stats
# ---------------------------------------------------------------------------


def test_mixed_batch_bit_exact(sidecar):
    lanes = mixed_lanes(60, seed=2)
    provider = SidecarProvider(sidecar.address, fallback=BrokenProvider())
    try:
        assert provider.batch_verify(*lanes.port()) == lanes.expected
        assert provider.batch_verify_async(*lanes.port())() == lanes.expected
        assert provider.batch_verify([], [], []) == []
        assert not provider.degraded
        assert provider.describe_backend() == f"serve:{sidecar.address}"
    finally:
        provider.stop()
    stats = sidecar.stats.summary()
    assert stats["requests"] == 2 and stats["lanes"] == 120
    assert stats["per_bucket"] == {"60": 2}  # no registry: the lane count, as JAX


def test_pipelined_requests_and_concurrent_connections(sidecar):
    sets = [mixed_lanes(10 + 7 * i, seed=3 + i) for i in range(4)]
    provider = SidecarProvider(sidecar.address, fallback=BrokenProvider())
    try:
        resolvers = [provider.batch_verify_async(*s.port()) for s in sets]
        assert [r() for r in reversed(resolvers)] == [s.expected for s in reversed(sets)]
    finally:
        provider.stop()
    results, errors = {}, []

    def worker(i):
        p = SidecarProvider(sidecar.address, fallback=BrokenProvider())
        try:
            for _ in range(3):
                results.setdefault(i, []).append(p.batch_verify(*sets[i].port()))
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))
        finally:
            p.stop()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(results[i] == [sets[i].expected] * 3 for i in range(4))


def test_stats_ping_and_tcp(tiers):
    server = host_server("127.0.0.1:0")
    client = SidecarClient(server.address)
    try:
        assert server.address.startswith("127.0.0.1:") and not server.address.endswith(":0")
        assert client.ping(timeout_s=WAIT_S)
        desc = client.stats(timeout_s=WAIT_S)
        assert desc["engine"] == "host" and desc["backend"] == "sw:hostec_np"
        assert desc["warm"]["ladder"] == "off" and desc["stats"]["requests"] == 0
        assert desc["max_pending_lanes"] == 65536 and desc["launches"] >= 1
    finally:
        client.close()
        server.stop()


def test_garbage_frame_kills_connection_not_server(sidecar):
    family, target = proto.parse_address(sidecar.address)
    with socket.socket(family, socket.SOCK_STREAM) as raw:
        raw.settimeout(WAIT_S)
        raw.connect(target)
        raw.sendall(b"NOPE" * 8)
        reply = proto.recv_frame(raw)
        assert reply is not None
        assert proto.decode_verify_response(reply[2])[0] == proto.ST_ERROR
        try:
            assert proto.recv_frame(raw) is None  # the server closed it
        except ConnectionResetError:
            pass  # closed with the rest of the garbage unread: a reset
    lanes = mixed_lanes(5)
    p = SidecarProvider(sidecar.address, fallback=BrokenProvider())
    try:
        assert p.batch_verify(*lanes.port()) == lanes.expected
    finally:
        p.stop()


def test_malformed_payload_fails_request_not_connection(sidecar):
    client = SidecarClient(sidecar.address)
    try:
        status, _, mask, message = proto.decode_verify_response(
            client.request(proto.OP_VERIFY, b"\x00\x01", timeout_s=WAIT_S))
        assert status == proto.ST_ERROR and mask is None and "ProtocolError" in message
        lanes = mixed_lanes(5)
        status, _, mask, _ = proto.decode_verify_response(client.request(
            proto.OP_VERIFY, encode_lanes(*lanes.port()), timeout_s=WAIT_S))
        assert (status, mask) == (proto.ST_OK, lanes.expected)
        status, _, _, message = proto.decode_verify_response(
            client.request(99, b"", timeout_s=WAIT_S))
        assert status == proto.ST_ERROR and "unknown opcode 99" in message
    finally:
        client.close()
    assert sidecar.stats.summary()["errors"] == 1


def test_injected_dispatch_fault_rides_retry(sidecar):
    lanes = mixed_lanes(25)
    provider = SidecarProvider(sidecar.address, fallback=BrokenProvider(),
                               sleeper=lambda s: None)
    plan = FaultPlan.parse("serve.dispatch=raise:0.5", seed=3)
    try:
        with plan_installed(plan):
            for _ in range(4):
                assert provider.batch_verify(*lanes.port()) == lanes.expected
        assert plan.fired().get("serve.dispatch", 0) >= 1
        assert not provider.degraded
    finally:
        provider.stop()


# ---------------------------------------------------------------------------
# interop: both directions, every revision, the step-down included
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("server_rev", [1, 2, 3])
def test_port_client_against_jax_server(sockdir, tiers, monkeypatch, server_rev):
    """A JAX server capped at `server_rev` (an older server refuses a newer
    frame with one ST_ERROR frame, then closes); the port client steps
    down to it and its masks equal the expected ones and the JAX client's."""
    monkeypatch.setattr(jproto, "PROTOCOL_VERSION", server_rev)
    server = jax_server(os.path.join(sockdir, "j.sock"))
    lanes = mixed_lanes(45, seed=5)
    port = SidecarProvider(server.address, fallback=BrokenProvider(),
                           qos_class=proto.QOS_HIGH, channel="paychan")
    jax = jclient.SidecarProvider(address=server.address, fallback=jbccsp.SoftwareProvider())
    try:
        assert port.batch_verify(*lanes.port()) == lanes.expected
        assert port.client.version == server_rev and not port.degraded
        assert jax.batch_verify(*lanes.jax()) == lanes.expected
        per_class = server.stats.summary()["per_class"]
        assert per_class[("high" if server_rev >= 2 else "normal")]["served"] >= 1
    finally:
        port.stop()
        jax.stop()
        server.stop()


@pytest.mark.parametrize("server_rev", [1, 2, 3])
def test_jax_client_against_port_server(sockdir, tiers, monkeypatch, server_rev):
    monkeypatch.setattr(proto, "PROTOCOL_VERSION", server_rev)
    server = host_server(os.path.join(sockdir, "p.sock"))
    lanes = mixed_lanes(45, seed=6)
    jax = jclient.SidecarProvider(address=server.address, fallback=jbccsp.SoftwareProvider(),
                                  qos_class=proto.QOS_BULK, channel="spam")
    try:
        assert jax.batch_verify(*lanes.jax()) == lanes.expected
        assert jax.batch_verify_async(*lanes.jax())() == lanes.expected
        assert jax.client.version == server_rev and not jax.degraded
        per_class = server.stats.summary()["per_class"]
        assert per_class[("bulk" if server_rev >= 2 else "normal")]["served"] == 2
    finally:
        jax.stop()
        server.stop()


# ---------------------------------------------------------------------------
# lanes with no usable key: the repair, against the JAX server
# ---------------------------------------------------------------------------


V3 = dict(qos_class=proto.DEFAULT_QOS, channel="", deadline_ms=0)  # the client's frame revision


def _no_key_payload(n: int, seed: int):
    """A VERIFY payload of n lanes: the mixed kinds, 10 more lanes as
    NO_KEY and 5 under undecodable keys (off the curve, a compressed
    point), and the mask the protocol requires."""
    lanes = mixed_lanes(n, seed=seed)
    raw = encode_lanes(*lanes.port(), version=1)
    table, wire_lanes, _, _, _ = proto.decode_verify_request(raw, 1)
    table = table + [b"\x04" + b"\x01" * 64, b"\x02" + b"\x07" * 32]
    expected = list(lanes.expected)
    good = [i for i, ok in enumerate(expected) if ok]
    for j, i in enumerate(good[:15]):
        _, sig, digest = wire_lanes[i]
        wire_lanes[i] = (proto.NO_KEY if j < 10 else len(table) - 1 - j % 2, sig, digest)
        expected[i] = False
    return proto.encode_verify_request(table, wire_lanes, **V3), expected


def _raw_verify(address, payload):
    client = SidecarClient(address)
    try:
        status, _, mask, message = proto.decode_verify_response(
            client.request(proto.OP_VERIFY, payload, timeout_s=120.0))
    finally:
        client.close()
    assert status == proto.ST_OK, message
    return mask


@pytest.mark.parametrize("n", [2, 3000])
def test_no_key_lanes_false_as_the_jax_vectorized_tier(sockdir, tiers, n):
    """The port server takes NO_KEY lanes and undecodable keys out before
    its provider and answers them False; at 3,000 lanes (past the JAX
    hostec_np tier's NP_MIN_LANES, its vectorized engine) the JAX server's
    mask is the same. At 2 lanes the port server runs CUDAProvider's
    plain version (the device engine's provider, which would raise on a
    None key), one lane NO_KEY."""
    if n == 2:
        lanes = mixed_lanes(1, seed=7)
        payload = proto.encode_verify_request(
            [p256.pubkey_to_bytes(lanes.keys[0].point)],
            [(0, lanes.sigs[0], lanes.digests[0]), (proto.NO_KEY, lanes.sigs[0],
                                                    lanes.digests[0])], **V3)
        expected = [True, False]
        torch.set_num_threads(1)
        server = SidecarServer(os.path.join(sockdir, "d.sock"), engine="device",
                               provider=CUDAProvider(device="cpu"), buckets=(128,))
        server.start()  # no warm(): one plain K2 run is enough here
    else:
        payload, expected = _no_key_payload(n, seed=8)
        assert jhostec_np.NP_MIN_LANES < n
        server = host_server(os.path.join(sockdir, "p.sock"))
    try:
        assert _raw_verify(server.address, payload) == expected
        assert server.stats.summary()["errors"] == 0
    finally:
        server.stop()
    if n == 2:
        return
    jax = jax_server(os.path.join(sockdir, "j.sock"))
    try:
        assert _raw_verify(jax.address, payload) == expected
    finally:
        jax.stop()


def test_requests_share_their_keys_objects(sidecar):
    """Two requests naming one key get one key object, so a launch that
    coalesces them keeps one key column (the provider dedups by object);
    a key that does not import is None in both."""
    lanes = mixed_lanes(6, seed=21)
    table = [p256.pubkey_to_bytes(lanes.keys[0].point), b"\x04" + b"\x01" * 64]
    body = [(0, lanes.sigs[0], lanes.digests[0]), (1, lanes.sigs[0], lanes.digests[0])]
    first = sidecar._decode_lanes(proto.encode_verify_request(table, body), 1)
    second = sidecar._decode_lanes(proto.encode_verify_request(table[::-1], body), 1)
    assert first[0][0] is second[0][0] and first[3] == [0] and second[3] == [1]
    assert sidecar._keys[table[1]] is None and len(sidecar._keys) == 2


def test_shared_counts_and_keys_under_threads(sidecar):
    """Two sidecars' dispatchers and a rescue share one process: the
    process-wide launch counts lose no update and every thread decoding a
    key gets the one object (16 threads, a short switch interval)."""
    from fabric_tpu_torch.ops import p256_kernel as pk

    raws = [p256.pubkey_to_bytes(p256.base_mult(7 + i)) for i in range(4)]
    before = pk.LAUNCHES["p256_verify_bytes"]
    seen, errors = [], []
    barrier = threading.Barrier(16)

    def hammer():
        try:
            barrier.wait(WAIT_S)
            for i in range(500):
                pk._launch_check("p256_verify_bytes", 0)
                seen.append(sidecar._key(raws[i % 4]))
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, daemon=True) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(switch)
        counted = pk.LAUNCHES["p256_verify_bytes"] - before
        pk.LAUNCHES["p256_verify_bytes"] = before
    assert not errors and not any(t.is_alive() for t in threads)
    assert counted == 16 * 500
    assert len({id(k) for k in seen}) == 4


def test_the_per_lane_tiers_raise_on_a_none_key():
    """The fault the repair keeps away from the providers: the JAX
    per-lane tier (here its oracle rung) and the port's CUDAProvider
    both raise on a lane whose key is None."""
    lanes = mixed_lanes(2, seed=9)
    prev = jbccsp.ec_backend_name()
    jbccsp.select_ec_backend("p256")
    try:
        with pytest.raises(AttributeError, match="point"):
            jbccsp.SoftwareProvider().batch_verify([lanes.jkeys[0], None], lanes.sigs,
                                                   lanes.digests)
    finally:
        jbccsp.select_ec_backend(prev)
    with pytest.raises(AttributeError, match="ski"):
        CUDAProvider(device="cpu").prep_bytes([lanes.keys[0], None], lanes.sigs,
                                              lanes.digests)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def _squeezed(sockdir):
    provider = GatedProvider()
    server = SidecarServer(os.path.join(sockdir, "busy.sock"), engine="host",
                           provider=provider, buckets=(64,), max_pending_lanes=96,
                           linger_s=0.0)
    server.start()  # no warm(): the gate would stall the warm batch
    return server, provider


def _fill(server, provider):
    a = SidecarProvider(server.address, fallback=BrokenProvider(), sleeper=lambda s: None)
    b = SidecarProvider(server.address, fallback=BrokenProvider(), sleeper=lambda s: None)
    l1, l2 = mixed_lanes(64, seed=11), mixed_lanes(64, seed=12)
    r1 = a.batch_verify_async(*l1.port())
    assert provider.entered.wait(WAIT_S)
    r2 = b.batch_verify_async(*l2.port())
    deadline = time.monotonic() + WAIT_S
    while server.batcher.pending_lanes < 51 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.batcher.pending_lanes >= 51  # l2's live lanes (13 are NO_KEY)
    return (a, b), (r1, l1.expected), (r2, l2.expected)


def test_full_sidecar_rejects_with_retry_after(sockdir, tiers):
    server, provider = _squeezed(sockdir)
    clients = ()
    try:
        clients, (r1, e1), (r2, e2) = _fill(server, provider)
        raw = SidecarClient(server.address)
        lanes = mixed_lanes(64, seed=13)
        payload = encode_lanes(*lanes.port())
        status, retry_ms, mask, _ = proto.decode_verify_response(
            raw.request(proto.OP_VERIFY, payload, timeout_s=WAIT_S))
        assert status == proto.ST_BUSY and retry_ms >= 5 and mask is None
        provider.gate.set()
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            status, _, mask, _ = proto.decode_verify_response(
                raw.request(proto.OP_VERIFY, payload, timeout_s=WAIT_S))
            if status == proto.ST_OK:
                break
            time.sleep(0.02)
        assert (status, mask) == (proto.ST_OK, lanes.expected)
        assert r1() == e1 and r2() == e2
        raw.close()
        stats = server.stats.summary()
        assert stats["rejects"] >= 1 and stats["per_class"]["normal"]["busy"] >= 1
    finally:
        provider.gate.set()
        for c in clients:
            c.stop()
        server.stop()


def test_client_retries_busy_then_rescues(sockdir, tiers):
    server, provider = _squeezed(sockdir)
    clients = ()
    try:
        clients, (r1, e1), (r2, e2) = _fill(server, provider)
        third = SidecarProvider(server.address, fallback=bccsp.SoftwareProvider(),
                                sleeper=lambda s: None)
        lanes = mixed_lanes(64, seed=14)
        with fabobs.obs_installed() as obs:
            assert third.batch_verify(*lanes.port()) == lanes.expected
            assert obs.value("fabric_degrade_total", seam="serve.client") == 1
        assert third.busy_rejects >= 1 and third.degraded and third.rescues == 1
        provider.gate.set()
        assert r1() == e1 and r2() == e2
        third.stop()
    finally:
        provider.gate.set()
        for c in clients:
            c.stop()
        server.stop()


def test_op_shutdown_acks_then_stops(sidecar):
    client = SidecarClient(sidecar.address)
    try:
        client.shutdown(timeout_s=WAIT_S)
    finally:
        client.close()
    deadline = time.monotonic() + WAIT_S
    while not sidecar._stopping and time.monotonic() < deadline:
        time.sleep(0.02)
    assert sidecar._stopping
    with pytest.raises(ValueError, match="address required"):
        SidecarProvider("")


def test_retry_after_scales_with_fill(sidecar):
    assert sidecar.retry_after_ms() == 25
    assert sidecar.retry_after_ms(proto.QOS_HIGH) == 25


# ---------------------------------------------------------------------------
# the rescue: bit-exact through fallback=, a double fault raises
# ---------------------------------------------------------------------------


def test_kill_mid_batch_rescues_bit_exact(sockdir, tiers):
    """The sidecar stopped with the batch in its dispatcher: ST_STOPPING,
    the batch re-verified on the caller's provider, the mask exact, the
    degrade counted once, the client alone degraded."""
    gated = GatedProvider()
    server = SidecarServer(os.path.join(sockdir, "kill.sock"), engine="host",
                           provider=gated, buckets=(64,))
    server.start()
    rescue = bccsp.SoftwareProvider()
    provider = SidecarProvider(server.address, fallback=rescue, sleeper=lambda s: None)
    bystander = SidecarProvider(server.address, fallback=BrokenProvider())
    lanes = mixed_lanes(30, seed=15)
    try:
        with fabobs.obs_installed() as obs:
            resolver = provider.batch_verify_async(*lanes.port())
            assert gated.entered.wait(WAIT_S)
            stopper = threading.Thread(target=server.stop, daemon=True)
            stopper.start()
            time.sleep(0.2)
            gated.gate.set()
            assert resolver() == lanes.expected
            stopper.join(WAIT_S)
            assert not stopper.is_alive()
            assert provider.batch_verify(*lanes.port()) == lanes.expected  # the dead socket
            assert obs.value("fabric_degrade_total", seam="serve.client") == 1
        assert provider.degraded and provider.rescues == 2
        assert provider.fallback_provider() is rescue
        assert provider.describe_backend() == "serve-degraded(sw:hostec_np)"
        assert not bystander.degraded
    finally:
        gated.gate.set()
        provider.stop()
        bystander.stop()
        server.stop()


def test_double_fault_raises_never_a_guessed_mask(sockdir):
    lanes = mixed_lanes(15, seed=16)
    dead = os.path.join(sockdir, "nothing.sock")
    broken = SidecarProvider(dead, fallback=BrokenProvider())
    with pytest.raises(SidecarUnavailable, match="rescue provider failed"):
        broken.batch_verify(*lanes.port())
    with pytest.raises(SidecarUnavailable, match="rescue provider failed"):
        broken.batch_verify_async(*lanes.port())()
    assert broken.degraded
    # no caller's provider and no card: probe_provider() raises, so does the batch
    no_card = SidecarProvider(dead)
    with pytest.raises(SidecarUnavailable, match="FactoryError"):
        no_card.batch_verify(*lanes.port())
    # the JAX client answers all-False there
    jax = jclient.SidecarProvider(address=dead, fallback=BrokenProvider())
    assert jax.batch_verify(*lanes.jax()) == [False] * 15


def test_dead_address_rescued_and_dial_cooldown(sockdir, monkeypatch):
    lanes = mixed_lanes(10, seed=17)
    provider = SidecarProvider(os.path.join(sockdir, "nothing.sock"),
                               fallback=bccsp.PurePythonProvider())
    calls = []
    orig = provider.client._connect
    monkeypatch.setattr(provider.client, "_connect",
                        lambda: calls.append(1) or orig())
    # the dial gate's cooldown on a clock that stands still: a loaded host's
    # rescue can outlast the cooldown's 0.5 s on the wall clock
    provider.client._dial_gate = CooldownGate(provider.client._dial_gate.policy,
                                              clock=lambda: 0.0)
    try:
        assert provider.batch_verify(*lanes.port()) == lanes.expected
        assert len(calls) == 1 and not provider.client._dial_gate.ready()
        assert provider.batch_verify(*lanes.port()) == lanes.expected
        assert len(calls) == 1  # cooling down: no new dial
    finally:
        provider.stop()


def test_mask_length_skew_is_rescued(sidecar, monkeypatch):
    provider = SidecarProvider(sidecar.address, fallback=bccsp.SoftwareProvider())
    real = proto.decode_verify_response

    def skewed(payload):
        status, retry, mask, msg = real(payload)
        return status, retry, (mask[:-1] if status == proto.ST_OK and mask else mask), msg

    monkeypatch.setattr("fabric_tpu_torch.serve.client.proto.decode_verify_response", skewed)
    lanes = mixed_lanes(10, seed=18)
    try:
        assert provider.batch_verify(*lanes.port()) == lanes.expected
        assert provider.degraded
    finally:
        provider.stop()


def test_no_serve_path_lands_on_the_cpu():
    """With no card: probe_provider(), the sidecar's auto and device
    engines raise; device="cpu" is how a test asks for the plain versions."""
    assert not torch.cuda.is_available()
    with pytest.raises(FactoryError, match="no CUDA device"):
        bccsp.probe_provider()
    assert bccsp.probe_provider("cpu").describe_backend() == "cpu-reference"
    for engine in ("auto", "device"):
        with pytest.raises(FactoryError):
            SidecarServer("/nonexistent/s.sock", engine=engine)
    provider, label = tserver.build_provider("device", "cpu")
    assert (type(provider).__name__, label) == ("CUDAProvider", "device")
    assert tserver.build_provider("host")[1] == "host"
    with pytest.raises(ValueError, match="unknown engine"):
        tserver.build_provider("tpu")


# ---------------------------------------------------------------------------
# the factory's SERVE rung
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("serve", [
    {"Address": "/tmp/a.sock"},
    {"Address": "/tmp/a.sock", "QoS": "high", "Channel": "paychan"},
    {"Address": "/tmp/a.sock", "QoS": "bulk"},
])
def test_serve_rung_builds_as_jax(serve):
    cfg = {"Default": "SERVE", "SERVE": serve}
    port = provider_from_config(cfg)
    from fabric_tpu.crypto.factory import provider_from_config as jfactory

    jax = jfactory(cfg)
    try:
        assert type(port).__name__ == type(jax).__name__ == "SidecarProvider"
        assert (port.qos_class, port.channel, port.client.address) == (
            jax.qos_class, jax.channel, jax.client.address)
        assert port.deadline_ms == 0 and not port.degraded
    finally:
        port.stop()
        jax.stop()


def test_serve_rung_keys_of_the_port(monkeypatch):
    """QoS as a channel map, DeadlineMs, Endpoints (a router with the
    hedge keys); the JAX environment variables are not read."""
    monkeypatch.setenv("FABRIC_TPU_SERVE_DEADLINE_MS", "77")
    monkeypatch.setenv("FABRIC_TPU_SERVE_ENDPOINTS", "/tmp/x.sock")
    p = provider_from_config({"Default": "SERVE", "SERVE": {
        "Address": "/tmp/a.sock", "QoS": "paychan=high;spam*=bulk;*=normal",
        "Channel": "spam7", "DeadlineMs": 250}})
    assert type(p).__name__ == "SidecarProvider"
    assert (p.qos_class, p.deadline_ms) == (proto.QOS_BULK, 250)
    assert p.for_channel("paychan").qos_class == proto.QOS_HIGH
    assert p.for_channel("other").qos_class == proto.QOS_NORMAL
    assert p.for_channel("spam7") is p
    r = provider_from_config({"Default": "SERVE", "SERVE": {
        "Endpoints": "/tmp/a.sock, /tmp/b.sock", "HedgeFraction": 0.2, "HedgeMinMs": 7.5}})
    assert type(r).__name__ == "SidecarRouter"
    assert [e.address for e in r.endpoints] == ["/tmp/a.sock", "/tmp/b.sock"]
    assert (r.hedge_budget.fraction, r.hedge_min_s) == (0.2, 0.0075)
    p.stop()
    r.stop()


@pytest.mark.parametrize("cfg", [
    {"Default": "SERVE"},
    {"Default": "SERVE", "SERVE": {}},
    {"Default": "SERVE", "SERVE": {"QoS": "high"}},
])
def test_serve_without_address_is_a_factory_error(cfg, monkeypatch):
    from fabric_tpu.crypto.factory import FactoryError as JFactoryError
    from fabric_tpu.crypto.factory import provider_from_config as jfactory

    monkeypatch.delenv("FABRIC_TPU_SERVE_ADDR", raising=False)
    monkeypatch.delenv("FABRIC_TPU_SERVE_ENDPOINTS", raising=False)
    with pytest.raises(FactoryError, match="Address or Endpoints"):
        provider_from_config(cfg)
    with pytest.raises(JFactoryError):
        jfactory(cfg)


def test_serve_rung_malformed_qos_is_a_factory_error():
    with pytest.raises(FactoryError, match="failed to build"):
        provider_from_config({"Default": "SERVE", "SERVE": {"Address": "/a", "QoS": "x=gold"}})


def test_default_serve_routes_a_pipeline_batch(sidecar):
    provider = provider_from_config({"Default": "SERVE", "SERVE": {"Address": sidecar.address}})
    provider._fallback = BrokenProvider()
    lanes = mixed_lanes(16, seed=19)
    try:
        assert provider.batch_verify_async(*lanes.port())() == lanes.expected
        assert sidecar.stats.summary()["requests"] == 1
        assert provider.hash(b"m") == hashlib.sha256(b"m").digest()
        assert provider.batch_hash([b"a", b"b"]) == [hashlib.sha256(x).digest()
                                                     for x in (b"a", b"b")]
    finally:
        provider.stop()


# ---------------------------------------------------------------------------
# a Channel through a port sidecar
# ---------------------------------------------------------------------------


def test_channel_commits_through_the_sidecar(tmp_path, sockdir, world):
    """The port's Channel over the factory's SERVE provider stores the
    same filters and commit hashes as over its in-process provider (the
    memoized oracle, behind the sidecar too), and as the JAX Channel; the
    Channel binds its admission class from the SERVE block's QoS map."""
    from test_torch_commit_pipeline import ORACLE, chain, jax_serial, port_block, port_channel

    raws = chain(world, 3, corrupt_last=True)
    server = SidecarServer(os.path.join(sockdir, "ch.sock"), engine="host", provider=ORACLE,
                           buckets=(64,))
    server.start()
    serve = provider_from_config({"Default": "SERVE", "SERVE": {
        "Address": server.address, "QoS": "pipechan=high;*=bulk"}})
    serve._fallback = BrokenProvider()
    got, want = [], []
    try:
        for provider, out, sub in ((serve, got, "serve"), (ORACLE, want, "local")):
            ch = port_channel(world, tmp_path / sub, provider=provider)
            try:
                for raw in raws:
                    block = port_block(raw)
                    flags = ch.store_block(block).tobytes()
                    out.append((flags, block["metadata"]["metadata"][4]))
            finally:
                ch.ledger.close()
        stats = server.stats.summary()
        # the Channel bound its admission class, as the JAX Channel does
        assert stats["requests"] == stats["per_class"]["high"]["served"] == 3
        assert not serve.degraded
    finally:
        serve.stop()
        server.stop()
    assert got == want == jax_serial(world, tmp_path / "jax", raws)
    assert all(f.endswith(b"\x04") for f, _ in got)  # each block's flipped creator


# ---------------------------------------------------------------------------
# the daemon and fleetload
# ---------------------------------------------------------------------------


def _read_line(proc, prefix: str, deadline: float) -> str:
    """The first stdout line starting with `prefix`, waiting no later
    than `deadline` (a reader thread keeps the wait bounded)."""
    lines = []

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(prefix):
                return

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    t.join(max(0.0, deadline - time.monotonic()))
    found = [ln for ln in lines if ln.startswith(prefix)]
    assert found, f"no {prefix} line: {lines!r}"
    return found[0]


def test_daemon_serves_then_drains_on_sigterm(sockdir, tiers):
    address = os.path.join(sockdir, "d.sock")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fabric_tpu_torch.serve", "--address", address,
         "--engine", "host", "--warm", "demo", "--device", "cpu", "--buckets", "8,16"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ready = json.loads(_read_line(proc, "SERVE_READY ", time.monotonic() + 120)
                           .split(" ", 1)[1])
        assert ready["address"] == address and ready["warm"]["ladder"] == "demo"
        assert sorted(ready["warm"]["per_bucket"]) == ["16", "8"]
        lanes = mixed_lanes(12, seed=20)
        p = SidecarProvider(address, fallback=BrokenProvider())
        try:
            assert p.batch_verify(*lanes.port()) == lanes.expected
        finally:
            p.stop()
        proc.send_signal(signal.SIGTERM)
        exit_line = _read_line(proc, "SERVE_EXIT ", time.monotonic() + 60)
        assert json.loads(exit_line.split(" ", 1)[1])["requests"] == 1
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_fleetload_against_a_sidecar(sidecar):
    from fabric_tpu_torch.serve import fleetload

    summary = fleetload.run(address=sidecar.address, channel="paychan", qos="high",
                            n_requests=3, lanes=24, seed=2, fallback=BrokenProvider())
    assert (summary["ok"], summary["mask_mismatches"], summary["degraded"]) == (3, 0, False)
    assert summary["cls"] == "high" and summary["busy_rejects"] == 0
    keys, sigs, digests, expected = fleetload.build_lanes(8, 2)
    assert expected == [True, False, False, False] * 2
    assert bccsp.PurePythonProvider().batch_verify(keys, sigs, digests) == expected
    assert sidecar.stats.summary()["per_class"]["high"]["served"] == 3
