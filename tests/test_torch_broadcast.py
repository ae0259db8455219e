"""The port's ordering front door (fabric_tpu_torch.orderer.{broadcast,
msgprocessor,multichannel}) against the JAX package's, with no tolerance:
tests/test_orderer.py's cases through a Registrar and a BroadcastHandler of
each package over the same genesis bytes (the port's encoder), every
envelope signed once by a port signer and handed to both as the same bytes.
Each envelope's (status, info) pair is equal, and so are the blocks each
chain writes (a stand-in signer for the orderer), the heights, the
hot-swapped bundles and the channels the system channel creates, including
its creation policy's refusals. Beyond test_orderer.py: the size filter,
an expired signer, a CONFIG envelope resubmitted, the classification of
every header type, a raft cluster's follower forwarding to its leader
through a duck-typed `cluster_client` (and refusing a second hop), the
port's `clock=` on the expiration filter, and a failing provider raising
through the port's SigFilter where the JAX one reads a denial. The JAX
package's configuration messages are written in protobuf's deterministic
map order for these tests (`torch_orderer_world.deterministic_jax_maps`)."""

import datetime

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import torch_orderer_world as W  # noqa: E402
from fabric_tpu.orderer import broadcast as jbc  # noqa: E402
from fabric_tpu.orderer import msgprocessor as jmp  # noqa: E402
from fabric_tpu.orderer import multichannel as jmc  # noqa: E402
from fabric_tpu.protos import common_pb2  # noqa: E402
from fabric_tpu_torch.channelconfig import configtx as tcfgtx  # noqa: E402
from fabric_tpu_torch.channelconfig import encoder as tenc  # noqa: E402
from fabric_tpu_torch.orderer import broadcast as tbc  # noqa: E402
from fabric_tpu_torch.orderer import msgprocessor as tmp  # noqa: E402
from fabric_tpu_torch.orderer import multichannel as tmc  # noqa: E402
from fabric_tpu_torch.protos import configtx as cfgpb  # noqa: E402
from fabric_tpu_torch.protos import fabric, protoutil, wire  # noqa: E402

CHANNEL = "mychannel"


@pytest.fixture(scope="module")
def world():
    return W.World(1702)


@pytest.fixture(autouse=True)
def _deterministic_maps(monkeypatch):
    W.deterministic_jax_maps(monkeypatch)


class Pair:
    """A Registrar and BroadcastHandler of each package; `send(raw)` gives
    both the same envelope bytes and returns the port's (status, info)
    after asserting the JAX handler's is the same."""

    def __init__(self, world, path, genesis=None, system=None, **kw):
        self.blocks = {"port": [], "jax": []}
        self.treg = tmc.Registrar(str(path / "port"), signer=W.StandIn(),
                                  provider=world.provider, system_channel_id=system, **kw)
        self.jreg = jmc.Registrar(str(path / "jax"), signer=W.StandIn(), provider=W.SW,
                                  system_channel_id=system, **kw)
        self.treg.on_block(lambda ch, b: self.blocks["port"].append(
            (ch, wire.encode(fabric.BLOCK, b))))
        self.jreg.on_block(lambda ch, b: self.blocks["jax"].append((ch, b.SerializeToString())))
        if genesis is not None:
            self.treg.join_channel(W.port_block(genesis))
            self.jreg.join_channel(W.jax_block(genesis))
        self.th = tbc.BroadcastHandler(self.treg, signer=W.StandIn())
        self.jh = jbc.BroadcastHandler(self.jreg, signer=W.StandIn())

    def send(self, raw):
        got = self.th.process_message(W.port_env(raw))
        want = self.jh.process_message(W.jax_env(raw))
        assert got == (int(want[0]), want[1])
        return got

    def check_chains(self):
        assert self.blocks["port"] == self.blocks["jax"]
        assert self.treg.channel_list() == self.jreg.channel_list()
        for ch in self.treg.channel_list():
            t, j = self.treg.get_chain(ch), self.jreg.get_chain(ch)
            assert t.height == j.height
            assert [wire.encode(fabric.BLOCK, t.get_block(n)) for n in range(t.height)] == [
                j.get_block(n).SerializeToString() for n in range(j.height)]
            assert t.validator.sequence == j.validator.sequence
            assert t.bundle.orderer.batch_size_max_messages == \
                j.bundle.orderer.batch_size_max_messages
            assert self.treg.channel_info(ch) == self.jreg.channel_info(ch)


def test_broadcast_orders_signed_envelopes(world, tmp_path):
    pair = Pair(world, tmp_path, world.genesis(CHANNEL))
    writer = world.signer(world.org1.peers[0])
    assert pair.send(W.envelope(writer, CHANNEL, b"tx1")) == (fabric.SUCCESS, "")
    assert pair.send(W.envelope(writer, CHANNEL, b"tx2")) == (fabric.SUCCESS, "")
    # max_message_count=2: genesis + one cut block, both through the sink
    assert pair.treg.get_chain(CHANNEL).height == 2
    assert [b["header"].get("number", 0) for b in (
        W.port_block(raw) for _, raw in pair.blocks["port"])] == [0, 1]
    pair.check_chains()


def test_broadcast_rejects_unsigned_and_unknown(world, tmp_path):
    pair = Pair(world, tmp_path, world.genesis(CHANNEL))
    writer = world.signer(world.org1.peers[0])
    garbage = wire.encode(fabric.ENVELOPE, {"payload": b"garbage"})
    assert pair.send(garbage)[0] == fabric.BAD_REQUEST
    no_header = wire.encode(fabric.ENVELOPE, {"payload": wire.encode(fabric.PAYLOAD, {
        "data": b"x"})})
    assert pair.send(no_header) == (fabric.BAD_REQUEST, "missing channel header")
    assert pair.send(W.envelope(writer, "nochannel", b"tx")) == (
        fabric.NOT_FOUND, "channel nochannel not found")
    status, info = pair.send(W.flip_signature(W.envelope(writer, CHANNEL, b"tx")))
    assert status == fabric.FORBIDDEN and info.startswith("implicit policy evaluation failed")
    assert pair.send(W.envelope(None, CHANNEL, b"tx")) == (
        fabric.BAD_REQUEST, "missing signature header")
    bad_der = W.port_env(W.envelope(writer, CHANNEL, b"tx"))
    bad_der["signature"] = b"\x30\x06\x02\x01\x01\x02\x01\x01"
    assert pair.send(wire.encode(fabric.ENVELOPE, bad_der))[0] == fabric.FORBIDDEN
    assert pair.treg.get_chain(CHANNEL).height == 1
    pair.check_chains()


def test_stranger_and_expired_cannot_write(world, tmp_path):
    pair = Pair(world, tmp_path, world.genesis(CHANNEL))
    stranger = world.signer(world.stranger_org.peers[0])  # Org1MSP under another CA
    assert pair.send(W.envelope(stranger, CHANNEL, b"tx"))[0] == fabric.FORBIDDEN
    expired = world.signer(world.expired_node)
    assert pair.send(W.envelope(expired, CHANNEL, b"tx")) == (
        fabric.BAD_REQUEST, "identity expired")
    pair.check_chains()


def test_size_filter(world, tmp_path):
    """An envelope past AbsoluteMaxBytes is REQUEST_ENTITY_TOO_LARGE with
    the same info; one just under it is ordered."""
    genesis = W.port_block(world.genesis(CHANNEL))
    raw_cfg = wire.decode(fabric.PAYLOAD, wire.decode(fabric.ENVELOPE, genesis["data"]["data"][0])[
        "payload"])
    cenv = wire.decode(cfgpb.CONFIG_ENVELOPE, raw_cfg["data"])
    values = cenv["config"]["channel_group"]["groups"]["Orderer"]["values"]
    values["BatchSize"]["value"] = wire.encode(cfgpb.BATCH_SIZE, {
        "max_message_count": 1, "absolute_max_bytes": 3000, "preferred_max_bytes": 2000})
    block = protoutil.new_block(0, b"")
    raw_cfg["data"] = wire.encode(cfgpb.CONFIG_ENVELOPE, cenv)
    block["data"]["data"] = [wire.encode(fabric.ENVELOPE, {
        "payload": wire.encode(fabric.PAYLOAD, raw_cfg)})]
    pair = Pair(world, tmp_path, wire.encode(fabric.BLOCK, protoutil.seal_block(block)))
    writer = world.signer(world.org1.peers[0])
    status, info = pair.send(W.envelope(writer, CHANNEL, b"x" * 4000))
    assert status == fabric.REQUEST_ENTITY_TOO_LARGE and "exceeds maximum allowed 3000" in info
    assert pair.send(W.envelope(writer, CHANNEL, b"x" * 100)) == (fabric.SUCCESS, "")
    assert pair.treg.get_chain(CHANNEL).height == 2
    pair.check_chains()


def _batch_size_update(world, max_count, signer_node):
    update = {"channel_id": CHANNEL,
              "read_set": {"groups": {"Orderer": {"values": {"BatchSize": {}}}}},
              "write_set": {"groups": {"Orderer": {"values": {"BatchSize": {
                  "version": 1, "mod_policy": "Admins",
                  "value": wire.encode(cfgpb.BATCH_SIZE, {
                      "max_message_count": max_count, "absolute_max_bytes": 1 << 20,
                      "preferred_max_bytes": 1 << 19})}}}}}}
    cue = {"config_update": wire.encode(cfgpb.CONFIG_UPDATE, update)}
    signer = world.signer(signer_node)
    tcfgtx.sign_config_update(cue, signer)
    return W.envelope(signer, CHANNEL, wire.encode(cfgpb.CONFIG_UPDATE_ENVELOPE, cue),
                      header_type=fabric.CONFIG_UPDATE)


def test_config_update_via_broadcast(world, tmp_path):
    """The orderer admin bumps BatchSize: the CONFIG block is written alone
    and carries last_update; both processors hot-swap to the new bundle;
    the same update again is refused (stale read set) in both; the CONFIG
    envelope resubmitted takes the config path again."""
    pair = Pair(world, tmp_path, world.genesis(CHANNEL))
    assert pair.send(_batch_size_update(world, 3, world.oorg.admin)) == (fabric.SUCCESS, "")
    support = pair.treg.get_chain(CHANNEL)
    assert support.height == 2 and support.validator.sequence == 1
    assert support.bundle.orderer.batch_size_max_messages == 3
    config_block = support.get_block(1)
    env = W.port_env(config_block["data"]["data"][0])
    payload = wire.decode(fabric.PAYLOAD, env["payload"])
    assert "last_update" in wire.decode(cfgpb.CONFIG_ENVELOPE, payload["data"])
    pair.check_chains()
    # a client of Org1 cannot change the orderer's batch size
    with pytest.raises(Exception) as texc:
        pair.th.process_message(W.port_env(_batch_size_update(world, 4, world.org1.users[0])))
    assert type(texc.value).__name__ == "ConfigTxError"
    # the CONFIG envelope itself resubmitted: re-validated from last_update,
    # whose read set is now stale, refused alike
    with pytest.raises(Exception) as exc:
        pair.send(wire.encode(fabric.ENVELOPE, env))
    assert type(exc.value).__name__ == "ConfigTxError"


def _creation_envelope(world, channel, signer_node, sign_with=None):
    update = tenc.channel_creation_config_update(channel, "SampleConsortium",
                                                 tenc.ApplicationProfile(organizations=[
                                                     tenc.OrganizationProfile(
                                                         "Org1MSP", world.org1.msp_config()),
                                                     tenc.OrganizationProfile(
                                                         "Org2MSP", world.org2.msp_config())]))
    cue = {"config_update": wire.encode(cfgpb.CONFIG_UPDATE, update)}
    if sign_with is not None:
        tcfgtx.sign_config_update(cue, world.signer(sign_with))
    signer = world.signer(signer_node) if signer_node is not None else None
    return W.envelope(signer, channel, wire.encode(cfgpb.CONFIG_UPDATE_ENVELOPE, cue),
                      header_type=fabric.CONFIG_UPDATE)


def test_system_channel_creates_channel(world, tmp_path):
    pair = Pair(world, tmp_path, world.system_genesis("syschannel"), system="syschannel")
    raw = _creation_envelope(world, "appchannel", world.org1.admin, sign_with=world.org1.admin)
    assert pair.send(raw) == (fabric.SUCCESS, "")
    assert "appchannel" in pair.treg.channel_list()
    app = pair.treg.get_chain("appchannel")
    assert app.height == 1
    assert {o.msp_id for o in app.bundle.application.orgs} == {"Org1MSP", "Org2MSP"}
    # the new channel accepts writes from consortium members
    writer = world.signer(world.org1.peers[0])
    assert pair.send(W.envelope(writer, "appchannel", b"tx")) == (fabric.SUCCESS, "")
    # the same update again reaches the new channel's own config path,
    # whose Application admins (MAJORITY) it does not satisfy: both raise
    for handler, env in ((pair.th, W.port_env(raw)), (pair.jh, W.jax_env(raw))):
        with pytest.raises(Exception, match="not authorized by mod policy") as exc:
            handler.process_message(env)
        assert type(exc.value).__name__ == "ConfigTxError"
    pair.check_chains()


def test_channel_creation_requires_creation_policy_signature(world, tmp_path):
    """An unsigned update, and one signed by a peer (ANY Admins wants an
    admin), create no channel; the statuses and info strings are equal."""
    pair = Pair(world, tmp_path, world.system_genesis("syschannel"), system="syschannel")
    status, info = pair.send(_creation_envelope(world, "rogue", None))
    assert status == fabric.BAD_REQUEST and "failed authorization" in info
    status, info = pair.send(_creation_envelope(world, "rogue", world.org1.peers[0],
                                                sign_with=world.org1.peers[0]))
    assert status == fabric.BAD_REQUEST and "failed authorization" in info
    assert "rogue" not in pair.treg.channel_list()
    # no system channel: channel creation is refused
    solo = Pair(world, tmp_path / "solo", world.genesis(CHANNEL))
    assert solo.send(_creation_envelope(world, "other", world.org1.admin,
                                        sign_with=world.org1.admin)) == (
        fabric.BAD_REQUEST, "no system channel: create channels via join_channel")
    pair.check_chains()


@pytest.mark.parametrize("header_type", [0, 1, 2, 3, 4, 5, 6, 77])
def test_classify_equals_jax(header_type):
    chdr = protoutil.make_channel_header(header_type, "ch")
    jchdr = common_pb2.ChannelHeader.FromString(wire.encode(fabric.CHANNEL_HEADER, chdr))
    assert tmp.classify(chdr) == jmp.classify(jchdr)


def test_raft_forwarding_through_the_cluster_client(world, tmp_path):
    """Envelopes sent to a follower are refused with NotLeaderError there
    and forwarded to the leader with forwarded=True; a forwarded envelope
    that meets a follower again is SERVICE_UNAVAILABLE, as is one without a
    cluster client. Every node of both clusters writes the same blocks."""
    genesis = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7001, 7002, 7003],
                            max_message_count=2)
    tc, jc = (W.RaftCluster("port", world, genesis, tmp_path / "port"),
              W.RaftCluster("jax", world, genesis, tmp_path / "jax"))
    for c in (tc, jc):
        c.run(30, CHANNEL)
    leader = tc.leader(CHANNEL)
    assert jc.leader(CHANNEL) == leader
    follower = next(i for i in (1, 2, 3) if i != leader)
    writer = world.signer(world.org1.users[0])
    for k in range(4):
        raw = W.envelope(writer, CHANNEL, b"tx%d" % k)
        got = tc.handlers[follower].process_message(W.port_env(raw))
        want = jc.handlers[follower].process_message(W.jax_env(raw))
        assert got == (int(want[0]), want[1]) == (fabric.SUCCESS, "")
    assert tc.forwards == jc.forwards == [leader] * 4
    raw = W.envelope(writer, CHANNEL, b"hop")
    got = tc.handlers[follower].process_message(W.port_env(raw), forwarded=True)
    want = jc.handlers[follower].process_message(W.jax_env(raw), forwarded=True)
    assert got == (int(want[0]), want[1]) == (
        fabric.SERVICE_UNAVAILABLE, f"not leader; current leader is {leader}")
    lone = tbc.BroadcastHandler(tc.regs[follower])
    assert lone.process_message(W.port_env(raw))[0] == fabric.SERVICE_UNAVAILABLE
    for c in (tc, jc):
        c.run(10, CHANNEL)
    for i in (1, 2, 3):
        assert tc.ledger(i, CHANNEL) == jc.ledger(i, CHANNEL)
        assert len(tc.ledger(i, CHANNEL)) == 3
        assert tc.regs[i].channel_info(CHANNEL) == jc.regs[i].channel_info(CHANNEL)


def test_expiration_filter_reads_the_callers_clock(world, tmp_path):
    """The port's `clock=`: a signer valid now is refused once the clock
    passes its notAfter, and one that expired is admitted before it."""
    writer = world.signer(world.org1.peers[0])
    env = W.port_env(W.envelope(writer, CHANNEL, b"tx"))
    not_after = tmp.identity_expiration(world.signer(world.org1.peers[0]).serialize())
    assert not_after is not None
    tmp.ExpirationFilter(clock=lambda: not_after - datetime.timedelta(seconds=1)).apply(env)
    with pytest.raises(tmp.MsgProcessorError, match="identity expired"):
        tmp.ExpirationFilter(clock=lambda: not_after + datetime.timedelta(seconds=1)).apply(env)
    expired = W.port_env(W.envelope(world.signer(world.expired_node), CHANNEL, b"tx"))
    then = datetime.datetime(2000, 1, 1, tzinfo=datetime.timezone.utc)
    tmp.ExpirationFilter(clock=lambda: then).apply(expired)
    reg = tmc.Registrar(str(tmp_path), provider=world.provider, clock=lambda: then)
    reg.join_channel(W.port_block(world.genesis(CHANNEL)))
    # the registrar's clock reaches its processors: the expiration filter
    # lets the envelope by, and the MSP (on its own clock) refuses it
    status, info = tbc.BroadcastHandler(reg).process_message(expired)
    assert status == fabric.FORBIDDEN and info.startswith("implicit policy evaluation failed")
    # no X.509 identity: not judged here
    assert tmp.identity_expiration(b"\xff\xfe") is None


@pytest.mark.parametrize("error", [RuntimeError, ValueError])
def test_failing_provider_raises_through_sigfilter(error, world, tmp_path):
    """Departure: a provider that fails (not a verdict) raises out of the
    port's SigFilter and BroadcastHandler, never a FORBIDDEN."""
    class Broken(type(world.provider)):
        def verify(self, key, signature, digest):
            raise error("device lost")

        def batch_verify(self, keys, signatures, digests):
            raise error("device lost")

    reg = tmc.Registrar(str(tmp_path), provider=Broken())
    reg.join_channel(W.port_block(world.genesis(CHANNEL)))
    env = W.port_env(W.envelope(world.signer(world.org1.peers[0]), CHANNEL, b"tx"))
    with pytest.raises(error, match="device lost"):
        tbc.BroadcastHandler(reg).process_message(env)
    with pytest.raises(error, match="device lost"):
        tmp.SigFilter(reg.get_chain(CHANNEL).bundle).apply(env)
    assert reg.get_chain(CHANNEL).height == 1
