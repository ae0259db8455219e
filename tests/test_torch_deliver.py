"""The port's block delivery (fabric_tpu_torch.deliver.{server,client})
against the JAX package's, with no tolerance. The engine: seek ranges
(specified, oldest, newest, next commit, no stop, the "max" stop, a stop
before the start), FAIL_IF_NOT_READY and a wait that times out, unknown
channels, malformed requests, an expired signer, the channel's Readers
policy admitting a member and refusing a stranger and an unsigned request;
every DeliverResponse of each session is the same bytes in both packages.
Filtered blocks and DeliverFiltered, `pvt_data_map` and
DeliverWithPrivateData (tests/test_deliver_pvtdata.py's cases) the same
bytes. The client: `seek_envelope` bytes, and tests/test_deliver_faults.py's
fault plans on both BlockDeliverers (the endpoints called, the blocks
taken and the seeded sleeps equal). The port's departures: a session that
expires mid-stream on the caller's clock, and a failing provider raising
out of DeliverHandler and DeliverWithPrivateData instead of a FORBIDDEN."""

import datetime
from typing import List

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import torch_orderer_world as W  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.common import faults as jfaults  # noqa: E402
from fabric_tpu.common.retry import RetryPolicy as JRetryPolicy  # noqa: E402
from fabric_tpu.deliver import client as jcl  # noqa: E402
from fabric_tpu.deliver import server as jsrv  # noqa: E402
from fabric_tpu.ledger.pvtdatastore import PvtEntry as JPvtEntry  # noqa: E402
from fabric_tpu.protos import ab_pb2  # noqa: E402
from fabric_tpu.protos import protoutil as jpu  # noqa: E402
from fabric_tpu_torch.channelconfig import bundle as tbundle  # noqa: E402
from fabric_tpu_torch.common import faults as tfaults  # noqa: E402
from fabric_tpu_torch.common.retry import RetryPolicy  # noqa: E402
from fabric_tpu_torch.deliver import client as tcl  # noqa: E402
from fabric_tpu_torch.deliver import server as tsrv  # noqa: E402
from fabric_tpu_torch.ledger.pvtdatastore import PvtEntry  # noqa: E402
from fabric_tpu_torch.protos import ab, fabric, protoutil, wire  # noqa: E402

CHANNEL = "ch"


@pytest.fixture(scope="module")
def world():
    w = W.World(1703)
    raw = w.genesis(CHANNEL)
    w.tbundle = tbundle.bundle_from_genesis_block(W.port_block(raw), w.provider)
    w.jbundle = jbundle.bundle_from_genesis_block(W.jax_block(raw), W.SW)
    return w


@pytest.fixture(autouse=True)
def _deterministic_maps(monkeypatch):
    W.deterministic_jax_maps(monkeypatch)


def chain_raws(world, n=5, txs=3):
    """`n` linked blocks of `txs` signed envelopes each, block k's filter
    the codes (k + j) % 3."""
    out, prev = [], b""
    writer = world.signer(world.org1.users[0])
    for k in range(n):
        block = protoutil.new_block(k, prev)
        block["data"]["data"] = [W.envelope(writer, CHANNEL, b"tx-%d-%d" % (k, j))
                                 for j in range(txs)]
        if k % 2:  # a block that carries no filter reads as NOT_VALIDATED
            block["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER] = bytes(
                (k + j) % 3 for j in range(txs))
        protoutil.seal_block(block)
        prev = protoutil.block_header_hash(block["header"])
        out.append(wire.encode(fabric.BLOCK, block))
    return out


def handlers(raws, checker=None, jchecker=None, clock=None, height=None):
    """A DeliverHandler of each package over the same blocks; `height`
    caps what the source has yet (a wait for more times out at once)."""
    tblocks = [W.port_block(r) for r in raws]
    jblocks = [W.jax_block(r) for r in raws]
    h = len(raws) if height is None else height

    def tsource(cid):
        if cid != CHANNEL:
            return None
        return tsrv.BlockSource(lambda n: tblocks[n] if n < h else None, lambda: h,
                                lambda n, t: n < h)

    def jsource(cid):
        if cid != CHANNEL:
            return None
        return jsrv.BlockSource(lambda n: jblocks[n] if n < h else None, lambda: h,
                                lambda n, t: n < h)

    return (tsrv.DeliverHandler(tsource, policy_checker=checker, wait_timeout=0.01,
                                clock=clock),
            jsrv.DeliverHandler(jsource, policy_checker=jchecker, wait_timeout=0.01))


def seek_raw(channel, start, stop="absent", behavior=0, signer=None):
    seek = {"start": start, "behavior": behavior}
    if stop != "absent":
        seek["stop"] = stop
    chdr = wire.encode(fabric.CHANNEL_HEADER, protoutil.make_channel_header(
        fabric.DELIVER_SEEK_INFO, channel))
    shdr = (wire.encode(fabric.SIGNATURE_HEADER, protoutil.make_signature_header(
        signer.serialize(), signer.new_nonce())) if signer is not None else b"")
    payload = wire.encode(fabric.PAYLOAD, {"header": {"channel_header": chdr,
                                                       "signature_header": shdr},
                                            "data": wire.encode(ab.SEEK_INFO, seek)})
    env = {"payload": payload}
    if signer is not None:
        env["signature"] = signer.sign(payload)
    return wire.encode(fabric.ENVELOPE, env)


def session(pair, raw, stream="blocks"):
    """Both sessions' responses as bytes, asserted equal."""
    th, jh = pair
    if stream == "blocks":
        t, j = th.deliver_blocks(W.port_env(raw)), jh.deliver_blocks(W.jax_env(raw))
    else:
        t = tsrv.deliver_filtered(th, W.port_env(raw))
        j = jsrv.deliver_filtered(jh, W.jax_env(raw))
    got = [W.response_bytes(r) for r in t]
    assert got == [W.response_bytes(r) for r in j]
    return [wire.decode(ab.DELIVER_RESPONSE, r) for r in got]


def spec(n):
    return {"specified": {"number": n}}


SEEKS = {
    "range": (spec(1), spec(3), 0),
    "single": (spec(2), "absent", 0),
    "oldest_newest": ({"oldest": {}}, {"newest": {}}, 0),
    "newest_only": ({"newest": {}}, {"newest": {}}, 0),
    "zero": (spec(0), spec(0), 0),
    "stop_before_start": (spec(3), spec(1), 0),
    "past_the_end_fail": (spec(3), spec(9), ab.FAIL_IF_NOT_READY),
    "past_the_end_wait": (spec(4), spec(7), 0),
    "max_stop_fail": (spec(2), spec(ab.SEEK_MAX), ab.FAIL_IF_NOT_READY),
    "next_commit_fail": ({"next_commit": {}}, "absent", ab.FAIL_IF_NOT_READY),
    "empty_start": ({}, "absent", 0),
}


@pytest.mark.parametrize("name", sorted(SEEKS))
def test_seek_ranges_equal_jax(world, name):
    start, stop, behavior = SEEKS[name]
    pair = handlers(chain_raws(world), height=5)
    out = session(pair, seek_raw(CHANNEL, start, stop, behavior))
    statuses = [r["status"] for r in out if "status" in r]
    assert len(statuses) == 1 and "status" in out[-1]
    want = {"range": [1, 2, 3], "single": [2], "oldest_newest": [0, 1, 2, 3, 4],
            "newest_only": [4], "zero": [0]}
    if name in want:
        assert [r["block"]["header"].get("number", 0) for r in out[:-1]] == want[name]
        assert statuses == [fabric.SUCCESS]


def test_requests_refused_alike(world):
    pair = handlers(chain_raws(world, n=2))
    cases = {
        "unknown channel": (seek_raw("nochannel", spec(0)), fabric.NOT_FOUND),
        "garbage payload": (wire.encode(fabric.ENVELOPE, {"payload": b"\xff\xff"}),
                            fabric.BAD_REQUEST),
        "no channel header": (wire.encode(fabric.ENVELOPE, {"payload": wire.encode(
            fabric.PAYLOAD, {"data": b""})}), fabric.BAD_REQUEST),
        "bad seek": (wire.encode(fabric.ENVELOPE, {"payload": wire.encode(fabric.PAYLOAD, {
            "header": {"channel_header": wire.encode(fabric.CHANNEL_HEADER, {
                "type": fabric.DELIVER_SEEK_INFO, "channel_id": CHANNEL})},
            "data": b"\x0a\xff"})}), fabric.BAD_REQUEST),
        "expired signer": (seek_raw(CHANNEL, spec(0), signer=world.signer(world.expired_node)),
                           fabric.FORBIDDEN),
    }
    for what, (raw, status) in cases.items():
        assert session(pair, raw) == [{"status": status}], what


def readers(bundle):
    def check(channel_id, sd):
        policy, _ = bundle.policy_manager.get_policy("/Channel/Readers")
        policy.evaluate_signed_data([sd])

    return check


def test_readers_policy_admits_and_refuses_alike(world):
    """A member of the channel reads; a stranger (Org1MSP under another CA)
    and an unsigned request are FORBIDDEN with no block."""
    pair = handlers(chain_raws(world, n=3), checker=readers(world.tbundle),
                    jchecker=readers(world.jbundle))
    member = world.signer(world.org2.users[0])
    out = session(pair, seek_raw(CHANNEL, {"oldest": {}}, {"newest": {}}, signer=member))
    assert len(out) == 4 and out[-1] == {"status": fabric.SUCCESS}
    stranger = world.signer(world.stranger_org.users[0])
    assert session(pair, seek_raw(CHANNEL, spec(0), signer=stranger)) == [
        {"status": fabric.FORBIDDEN}]
    assert session(pair, seek_raw(CHANNEL, spec(0))) == [{"status": fabric.FORBIDDEN}]
    flipped = W.flip_signature(seek_raw(CHANNEL, spec(0), signer=member))
    assert session(pair, flipped) == [{"status": fabric.FORBIDDEN}]


def test_session_expires_mid_stream_on_the_callers_clock(world):
    """The port's clock: a session admitted at t0 ends FORBIDDEN once the
    clock passes the signer's notAfter, after the blocks before it."""
    signer = world.signer(world.org1.users[0])
    not_after = tsrv.identity_expiration(signer.serialize())
    ticks = iter([not_after - datetime.timedelta(seconds=2),
                  not_after - datetime.timedelta(seconds=1),
                  not_after - datetime.timedelta(seconds=1),
                  not_after + datetime.timedelta(seconds=1)])
    th, _ = handlers(chain_raws(world), clock=lambda: next(ticks))
    out = list(th.deliver_blocks(W.port_env(seek_raw(CHANNEL, spec(0), spec(4),
                                                     signer=signer))))
    assert [ab.response_type(r) for r in out] == ["block", "block", "status"]
    assert out[-1] == {"status": fabric.FORBIDDEN}


def test_filtered_blocks_equal_jax(world):
    raws = chain_raws(world, n=4)
    raws.append(wire.encode(fabric.BLOCK, protoutil.seal_block(protoutil.new_block(4, b""))))
    odd = protoutil.new_block(5, b"")
    odd["data"]["data"] = [wire.encode(fabric.ENVELOPE, {"payload": b"\xff\xff"}),
                           W.port_block(raws[0])["data"]["data"][0]]
    raws.append(wire.encode(fabric.BLOCK, protoutil.seal_block(odd)))
    for raw in raws:
        fb = tsrv.filter_block(W.port_block(raw), CHANNEL)
        jfb = jsrv.filter_block(W.jax_block(raw), CHANNEL)
        assert wire.encode(ab.FILTERED_BLOCK, fb) == jfb.SerializeToString()
    assert len(tsrv.filter_block(W.port_block(raws[-1]), CHANNEL)["filtered_transactions"]) == 1
    # data that is no Envelope at all is skipped too (the JAX engine lets
    # protobuf's DecodeError out there)
    odd["data"]["data"][0] = b"\xff\xff"
    assert tsrv.filter_block(odd, CHANNEL)["filtered_transactions"] == tsrv.filter_block(
        W.port_block(raws[-1]), CHANNEL)["filtered_transactions"]
    out = session(handlers(raws), seek_raw(CHANNEL, {"oldest": {}}, {"newest": {}}),
                  stream="filtered")
    assert [ab.response_type(r) for r in out] == ["filtered_block"] * 6 + ["status"]
    txs = out[1]["filtered_block"]["filtered_transactions"]
    codes = [t.get("tx_validation_code", 0) for t in txs]
    assert codes == [1, 2, 0]
    assert {t.get("tx_validation_code") for t in out[0]["filtered_block"][
        "filtered_transactions"]} == {254}


def _pvt(cls):
    return [cls(0, "cc", "collB", b"rw-b"), cls(0, "cc", "collA", b"rw-a"),
            cls(2, "other", "c", b"rw-c"), cls(2, "cc", "z", b"rw-z"), cls(11, "cc", "a", b"")]


def test_pvt_data_map_equals_jax():
    tmap, jmap = tsrv.pvt_data_map(_pvt(PvtEntry)), jsrv.pvt_data_map(_pvt(JPvtEntry))
    assert sorted(tmap) == sorted(jmap) == [0, 2, 11]
    for k in tmap:
        assert wire.encode(wire.TX_PVT_RWSET, tmap[k]) == jmap[k].SerializeToString()
    colls = [c["collection_name"] for c in tmap[0]["ns_pvt_rwset"][0]["collection_pvt_rwset"]]
    assert colls == ["collA", "collB"]


def test_deliver_with_pvtdata_equals_jax(world):
    raws = chain_raws(world, n=3)
    th, jh = handlers(raws)
    stored = {1: _pvt(PvtEntry), 2: _pvt(PvtEntry)[:1]}
    jstored = {1: _pvt(JPvtEntry), 2: _pvt(JPvtEntry)[:1]}
    member = world.signer(world.org1.users[0])
    raw = seek_raw(CHANNEL, spec(0), spec(2), signer=member)
    for tcheck, jcheck in ((None, None), (readers(world.tbundle), readers(world.jbundle))):
        t = list(tsrv.deliver_with_pvtdata(th, W.port_env(raw),
                                           lambda c, n: stored.get(n, []), tcheck))
        j = list(jsrv.deliver_with_pvtdata(jh, W.jax_env(raw),
                                           lambda c, n: jstored.get(n, []), jcheck))
        assert [W.response_bytes(r) for r in t] == [W.response_bytes(r) for r in j]
        assert [ab.response_type(r) for r in t] == ["block_and_private_data"] * 3 + ["status"]
        assert sorted(t[1]["block_and_private_data"]["private_data_map"]) == [0, 2, 11]
        assert t[0]["block_and_private_data"]["private_data_map"] == {}
    # unsigned, or a stranger: FORBIDDEN and no block, alike
    stranger = world.signer(world.stranger_org.users[0])
    for raw in (seek_raw(CHANNEL, spec(0)), seek_raw(CHANNEL, spec(0), signer=stranger)):
        t = list(tsrv.deliver_with_pvtdata(th, W.port_env(raw), lambda c, n: [],
                                           readers(world.tbundle)))
        j = list(jsrv.deliver_with_pvtdata(jh, W.jax_env(raw), lambda c, n: [],
                                           readers(world.jbundle)))
        assert [W.response_bytes(r) for r in t] == [W.response_bytes(r) for r in j]
        assert t == [{"status": fabric.FORBIDDEN}]
    garbage = wire.encode(fabric.ENVELOPE, {"payload": b"\xff"})
    assert list(tsrv.deliver_with_pvtdata(th, W.port_env(garbage), lambda c, n: [])) == [
        {"status": fabric.BAD_REQUEST}]


@pytest.mark.parametrize("error", [RuntimeError, ValueError])
def test_failing_provider_raises_not_forbidden(error, world):
    """Departure: a provider that fails (not a verdict) raises out of the
    port's deliver session and DeliverWithPrivateData; the JAX engine reads
    it as FORBIDDEN."""
    class Broken(type(world.provider)):
        def verify(self, key, signature, digest):
            raise error("device lost")

        def batch_verify(self, keys, signatures, digests):
            raise error("device lost")

    bundle = tbundle.bundle_from_genesis_block(W.port_block(world.genesis(CHANNEL)), Broken())
    th, _ = handlers(chain_raws(world, n=2), checker=readers(bundle))
    raw = seek_raw(CHANNEL, spec(0), signer=world.signer(world.org1.users[0]))
    with pytest.raises(error, match="device lost"):
        list(th.deliver_blocks(W.port_env(raw)))
    with pytest.raises(error, match="device lost"):
        list(tsrv.deliver_with_pvtdata(th, W.port_env(raw), lambda c, n: [], readers(bundle)))
    # the JAX engine's reading of the same failure
    class JBroken:
        def __call__(self, channel_id, sd):
            raise error("device lost")

    _, jh = handlers(chain_raws(world, n=2), jchecker=JBroken())
    assert [r.status for r in jh.deliver_blocks(W.jax_env(raw))] == [fabric.FORBIDDEN]


@pytest.mark.parametrize("start,stop,signed", [(0, ab.SEEK_MAX, False), (7, 9, True),
                                               ("oldest", "newest", False),
                                               ("newest", 3, True)])
def test_seek_envelope_bytes_equal_jax(world, start, stop, signed):
    """seek_envelope under stand-in signers (one each, the same nonces)."""
    t = tcl.seek_envelope(CHANNEL, start, W.StandIn() if signed else None, stop=stop)
    j = jcl.seek_envelope(CHANNEL, start, W.StandIn() if signed else None, stop=stop)
    assert wire.encode(fabric.ENVELOPE, t) == j.SerializeToString()


# -- tests/test_deliver_faults.py's plans on both deliverers -----------------


def _seek_start(pkg, env) -> int:
    if pkg == "port":
        payload = wire.decode(fabric.PAYLOAD, env["payload"])
        return wire.decode(ab.SEEK_INFO, payload["data"])["start"]["specified"].get("number", 0)
    payload = jpu.unmarshal(jsrv.common_pb2.Payload, env.payload)
    return jpu.unmarshal(ab_pb2.SeekInfo, payload.data).start.specified.number


def _endpoint(pkg, name, n_blocks, calls: List[str]):
    def serve(env):
        calls.append(name)
        for k in range(_seek_start(pkg, env), n_blocks):
            if pkg == "port":
                yield {"block": protoutil.new_block(k, b"")}
            else:
                resp = ab_pb2.DeliverResponse()
                resp.block.CopyFrom(jpu.new_block(k, b""))
                yield resp

    return serve


def _run(pkg, plan, n_blocks, max_blocks, endpoints=2, policy=None, refresh=False,
         jax_kw=None, **kw):
    calls, got, sleeps, fresh = [], [], [], []
    mod, faults = (tcl, tfaults) if pkg == "port" else (jcl, jfaults)
    number = (lambda b: b["header"].get("number", 0)) if pkg == "port" else (
        lambda b: b.header.number)
    if pkg == "jax" and jax_kw is not None:
        kw.update(jax_kw)
    elif policy is not None:
        kw["retry_policy"] = (RetryPolicy if pkg == "port" else JRetryPolicy)(**policy)
    d = mod.BlockDeliverer(
        "testchan", [_endpoint(pkg, f"ep{i}", n_blocks, calls) for i in range(endpoints)],
        on_block=lambda b: got.append(number(b)), next_block=lambda: len(got),
        sleeper=lambda s: sleeps.append(round(s, 9)), **kw)
    if refresh:
        def refresh_then_sleep(s):
            d.update_endpoints([_endpoint(pkg, "fresh", n_blocks, fresh)])
            sleeps.append(round(s, 9))

        d._sleeper = refresh_then_sleep
    with faults.plan_installed(faults.FaultPlan.parse(plan, seed=1)) if plan else _null():
        received = d.run(max_blocks=max_blocks)
    return {"received": received, "got": got, "calls": calls, "fresh": fresh, "sleeps": sleeps,
            "stats": (d.stats.connect_attempts, d.stats.blocks_received, d.stats.failures)}


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


RAMP = dict(base_s=0.05, multiplier=2.0, cap_s=0.4, deadline_s=30.0)
PLANS = {
    "flap_then_failover": dict(plan="deliver.pull=raise:1.0:max=3", n_blocks=6, max_blocks=6,
                               policy=RAMP),
    "deadline": dict(plan="deliver.pull=raise:1.0", n_blocks=2, max_blocks=2,
                     policy=dict(RAMP, deadline_s=1.0)),
    "max_attempts": dict(plan="deliver.pull=raise:1.0", n_blocks=2, max_blocks=2,
                         policy=dict(base_s=0.01, multiplier=2.0, cap_s=1.0, deadline_s=60.0,
                                     max_attempts=3)),
    # the JAX client's legacy caps against the port's one RetryPolicy
    "legacy_knobs": dict(plan="deliver.pull=raise:1.0", n_blocks=1, max_blocks=1, endpoints=1,
                         policy=dict(base_s=0.06, multiplier=1.2, cap_s=0.08, deadline_s=0.3),
                         jax_kw=dict(max_retry_delay=0.08, max_total_delay=0.3)),
    "clean": dict(plan=None, n_blocks=5, max_blocks=5, policy=RAMP),
    "refresh_midstream": dict(plan="deliver.pull=raise:1.0:max=2", n_blocks=4, max_blocks=4,
                              endpoints=1, policy=RAMP, refresh=True),
    "seeded_jitter": dict(plan="deliver.pull=raise:1.0:max=4", n_blocks=1, max_blocks=1,
                          endpoints=1, retry_seed=42),
    "probabilistic": dict(plan="deliver.pull=raise:0.5", n_blocks=8, max_blocks=8,
                          policy=RAMP),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_deliverer_fault_plans_equal_jax(name):
    t = _run("port", **PLANS[name])
    assert t == _run("jax", **PLANS[name])
    if name == "flap_then_failover":
        assert t["sleeps"] == [0.05, 0.1, 0.2] and t["calls"] == ["ep1"]
        assert t["got"] == [0, 1, 2, 3, 4, 5]
    if name == "deadline":
        assert t["received"] == 0 and t["sleeps"] == [0.05, 0.1, 0.2, 0.4]
    if name == "refresh_midstream":
        assert t["fresh"] == ["fresh"] and t["got"] == [0, 1, 2, 3]


def test_deliverer_refuses_bad_streams_alike():
    """A status instead of a block, a block out of order and a block that
    fails verification each fail over; a verifier that raises (no verdict)
    ends the port's pull with its error."""
    def status_ep(env):
        yield {"status": fabric.SERVICE_UNAVAILABLE}

    def skip_ep(env):
        yield {"block": protoutil.new_block(3, b"")}

    got, sleeps = [], []
    policy = RetryPolicy(base_s=0.01, multiplier=1.0, cap_s=0.01, deadline_s=0.035)
    d = tcl.BlockDeliverer("c", [status_ep, skip_ep], on_block=got.append,
                           next_block=lambda: 0, sleeper=sleeps.append, retry_policy=policy)
    assert d.run() == 0 and d.stats.failures == 4 and len(sleeps) == 3
    d = tcl.BlockDeliverer("c", [_endpoint("port", "ep", 2, [])], on_block=got.append,
                           next_block=lambda: len(got), sleeper=sleeps.append,
                           retry_policy=policy, verify_block=lambda b: False)
    assert d.run() == 0 and d.stats.failures == 4

    def broken(block):
        raise RuntimeError("device lost")

    d = tcl.BlockDeliverer("c", [_endpoint("port", "ep", 2, [])], on_block=got.append,
                           next_block=lambda: len(got), verify_block=broken)
    with pytest.raises(RuntimeError, match="device lost"):
        d.run()
