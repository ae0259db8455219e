"""The port's follower chain and onboarding (fabric_tpu_torch.orderer.
{follower,multichannel}) against the JAX package's, with no tolerance and
no sockets: tests/test_follower.py's unit promotion over fake deliver
endpoints; a non-consenter orderer joining a three-node raft cluster of
each package and replicating it through the consenters' DeliverHandlers
(its ledger the consenters' blocks, the same bytes in both packages; its
channel_info onboarding then active); test_follower.py:229's consenter-set
growth bridged into a raft membership change; and the whole onboarding
path: a follower promoted to a raft member by a config block that adds it,
then consenting on the next blocks. Waits are on the follower's height
with a deadline, never a bare sleep."""

import threading
import time

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import torch_orderer_world as W  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.orderer import follower as jfol  # noqa: E402
from fabric_tpu.orderer import multichannel as jmc  # noqa: E402
from fabric_tpu.protos import ab_pb2  # noqa: E402
from fabric_tpu.protos import protoutil as jpu  # noqa: E402
from fabric_tpu_torch.channelconfig import bundle as tbundle  # noqa: E402
from fabric_tpu_torch.orderer import follower as tfol  # noqa: E402
from fabric_tpu_torch.orderer import multichannel as tmc  # noqa: E402
from fabric_tpu_torch.protos import ab, fabric, protoutil, wire  # noqa: E402

CHANNEL = "followchan"


@pytest.fixture(scope="module")
def world():
    return W.World(1704)


@pytest.fixture(autouse=True)
def _deterministic_maps(monkeypatch):
    W.deterministic_jax_maps(monkeypatch)


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    event = threading.Event()
    while not pred():
        if time.monotonic() > deadline:
            return False
        event.wait(0.01)
    return True


def renumbered(raw_config_block: bytes, number: int, prev_hash: bytes) -> bytes:
    """A config block's envelope re-chained at a later height (a committed
    config update's stand-in)."""
    block = protoutil.new_block(number, prev_hash)
    block["data"]["data"] = list(W.port_block(raw_config_block)["data"]["data"])
    return wire.encode(fabric.BLOCK, protoutil.seal_block(block))


def test_follower_unit_promotion(world, tmp_path):
    """Fake deliver endpoints: each package's follower replicates the chain
    and promotes itself when block 1 adds it to the consenter set; both
    ledgers are the same bytes."""
    gen = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7201])
    grown = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7201, 7202])
    block1 = renumbered(grown, 1, protoutil.block_header_hash(W.port_block(gen)["header"]))
    chain = [gen, block1]
    ledgers = {}
    for pkg in ("port", "jax"):
        def endpoint_factory(addrs, pkg=pkg):
            def endpoint(env):
                if pkg == "port":
                    payload = wire.decode(fabric.PAYLOAD, env["payload"])
                    start = wire.decode(ab.SEEK_INFO, payload["data"])["start"]["specified"].get(
                        "number", 0)
                    for raw in chain[start:]:
                        yield {"block": W.port_block(raw)}
                else:
                    payload = jpu.unmarshal(jfol.common_pb2.Payload, env.payload)
                    start = jpu.unmarshal(ab_pb2.SeekInfo, payload.data).start.specified.number
                    for raw in chain[start:]:
                        resp = ab_pb2.DeliverResponse()
                        resp.block.CopyFrom(W.jax_block(raw))
                        yield resp

            return [endpoint]

        promoted, done = [], threading.Event()

        def on_member(f, promoted=promoted, done=done):
            promoted.append(f)
            done.set()

        if pkg == "port":
            bundle = tbundle.bundle_from_genesis_block(W.port_block(gen), world.provider)
            assert not tfol.is_member(bundle, 2)
            f = tfol.FollowerChain(CHANNEL, W.port_block(gen), bundle, node_id=2,
                                   wal_dir=str(tmp_path / pkg), endpoint_factory=endpoint_factory,
                                   on_become_member=on_member, provider=world.provider)
        else:
            bundle = jbundle.bundle_from_genesis_block(W.jax_block(gen), W.SW)
            f = jfol.FollowerChain(CHANNEL, W.jax_block(gen), bundle, node_id=2,
                                   wal_dir=str(tmp_path / pkg), endpoint_factory=endpoint_factory,
                                   on_become_member=on_member, provider=W.SW)
        # a genesis join block seeds the ledger at once: active, not onboarding
        assert (f.status, f.height, f.consensus_relation) == ("active", 1, "follower")
        f.start()
        assert done.wait(20.0)
        assert promoted[0].height == 2
        assert tfol.is_member(promoted[0].bundle, 2) if pkg == "port" else jfol.is_member(
            promoted[0].bundle, 2)
        enc = (lambda b: wire.encode(fabric.BLOCK, b)) if pkg == "port" else (
            lambda b: b.SerializeToString())
        ledgers[pkg] = [enc(f.get_block(n)) for n in range(f.height)]
        f.stop()
    assert ledgers["port"] == ledgers["jax"] == chain
    with pytest.raises(ValueError, match="needs the provider"):
        tfol.FollowerChain(CHANNEL, W.port_block(gen), None, 2, str(tmp_path / "x"),
                           lambda a: [], lambda f: None)


def test_consenter_addresses_and_membership_equal_jax(world):
    for consenters in ([], [7301], [7301, 7302, 7303]):
        raw = world.genesis(CHANNEL, orderer_type="etcdraft" if consenters else "solo",
                            consenters=consenters)
        tb = tbundle.bundle_from_genesis_block(W.port_block(raw), world.provider)
        jb = jbundle.bundle_from_genesis_block(W.jax_block(raw), W.SW)
        assert tfol.consenter_addresses(tb) == jfol.consenter_addresses(jb)
        for node_id in range(5):
            assert tfol.is_member(tb, node_id) == jfol.is_member(jb, node_id)


def _endpoints(cluster, ids):
    """addresses -> the DeliverHandlers of the consenters at them."""
    def factory(addrs):
        by_addr = {f"127.0.0.1:{7400 + i}": cluster.delivers[i].deliver_blocks for i in ids}
        return [by_addr[a] for a in addrs if a in by_addr]

    return factory


def test_follower_replicates_a_raft_cluster(world, tmp_path):
    """A fourth orderer joins a three-node cluster as a non-consenter and
    replicates every block through the consenters' DeliverHandlers, in
    both packages; its blocks after the genesis are the consenters' bytes,
    and both packages' followers hold the same ledger."""
    gen = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7401, 7402, 7403],
                        max_message_count=2)
    writer = world.signer(world.org1.users[0])
    raws = [W.envelope(writer, CHANNEL, b"tx%d" % k) for k in range(6)]
    out = {}
    for pkg in ("port", "jax"):
        cluster = W.RaftCluster(pkg, world, gen, tmp_path / pkg)
        cluster.run(30, CHANNEL)
        reg = cluster.registrar(4, follower_endpoint_factory=_endpoints(cluster, (1, 2, 3)))
        follower = reg.join_channel(W.port_block(gen) if pkg == "port" else W.jax_block(gen))
        assert type(follower).__name__ == "FollowerChain"
        assert reg.channel_info(CHANNEL) == {"name": CHANNEL, "height": 1, "status": "active",
                                             "consensusRelation": "follower"}
        assert reg.channel_list() == [CHANNEL]
        leader = cluster.leader(CHANNEL)
        for raw in raws:
            env = W.port_env(raw) if pkg == "port" else W.jax_env(raw)
            assert cluster.handlers[leader].process_message(env)[0] == fabric.SUCCESS
        cluster.run(10, CHANNEL)
        assert wait_until(lambda: follower.height == 4), follower.height
        consenters = [cluster.ledger(i, CHANNEL) for i in (1, 2, 3)]
        assert consenters[0] == consenters[1] == consenters[2]
        mine = cluster.ledger(1, CHANNEL)
        theirs = [follower.get_block(n) for n in range(follower.height)]
        enc = (lambda b: wire.encode(fabric.BLOCK, b)) if pkg == "port" else (
            lambda b: b.SerializeToString())
        # block 0 is the join block as given; the consenters stored it
        # stamped with the consenter ids
        assert [enc(b) for b in theirs[1:]] == mine[1:]
        assert enc(theirs[0]) == gen
        out[pkg] = [enc(b) for b in theirs]
        follower.stop()
    assert out["port"] == out["jax"]


def test_consenter_set_config_update_bridges_to_raft(world, tmp_path):
    """test_follower.py:229 in both packages: a committed config block that
    grows the consenter set becomes a raft membership change on the chain
    (configure -> commit -> apply -> on_config_block -> propose)."""
    gen = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7501],
                        max_message_count=1)
    grown = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7501, 7502],
                          max_message_count=1)
    env_raw = W.port_block(grown)["data"]["data"][0]
    results = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            reg = tmc.Registrar(str(tmp_path / pkg), signer=W.StandIn(), raft_node_id=1,
                                provider=world.provider)
            support = reg.join_channel(W.port_block(gen))
            env = W.port_env(env_raw)
        else:
            reg = jmc.Registrar(str(tmp_path / pkg), signer=W.StandIn(), raft_node_id=1,
                                provider=W.SW)
            support = reg.join_channel(W.jax_block(gen))
            env = W.jax_env(env_raw)
        chain = support.chain
        for _ in range(30):
            chain.tick()
        assert chain.node.role == "leader" and chain.node.peers == {1}
        chain.configure(env)
        for _ in range(30):
            chain.tick()
        assert chain.node.peers == {1, 2} and chain.height == 2
        enc = (lambda b: wire.encode(fabric.BLOCK, b)) if pkg == "port" else (
            lambda b: b.SerializeToString())
        addrs = (tfol if pkg == "port" else jfol).consenter_addresses(support.bundle)
        results[pkg] = ([enc(chain.get_block(n)) for n in range(2)], addrs)
    assert results["port"] == results["jax"]
    assert results["port"][1] == ["127.0.0.1:7501", "127.0.0.1:7502"]


def test_follower_promoted_by_a_config_block(world, tmp_path):
    """Onboarding end to end, in both packages: node 2 joins a one-node
    cluster as a follower; the leader commits a config block that adds
    node 2's endpoint; the follower replicates it, reads its own id (2)
    from the block's consenter ids, hands the ledger to a RaftChain
    (channel_info: consenter) and the two nodes then order blocks
    together. Both packages' ledgers are the same bytes."""
    gen = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7401],
                        max_message_count=1)
    grown = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7401, 7402],
                          max_message_count=1)
    env_raw = W.port_block(grown)["data"]["data"][0]
    writer = world.signer(world.org1.users[0])
    raws = [W.envelope(writer, CHANNEL, b"after-%d" % k) for k in range(2)]
    out = {}
    for pkg in ("port", "jax"):
        cluster = W.RaftCluster(pkg, world, gen, tmp_path / pkg, ids=(1,))
        cluster.run(30, CHANNEL)
        reg = cluster.registrar(2, follower_endpoint_factory=_endpoints(cluster, (1,)))
        cluster.queues[2] = []
        cluster.regs[2] = reg
        follower = reg.join_channel(W.port_block(gen) if pkg == "port" else W.jax_block(gen))
        assert reg.channel_info(CHANNEL)["consensusRelation"] == "follower"
        chain1 = cluster.chain(1, CHANNEL)
        chain1.configure(W.port_env(env_raw) if pkg == "port" else W.jax_env(env_raw))
        assert wait_until(lambda: reg.get_chain(CHANNEL) is not None), follower.height
        assert reg.channel_info(CHANNEL)["consensusRelation"] == "consenter"
        assert reg.followers == {}
        cluster.run(40, CHANNEL)
        chain2 = cluster.chain(2, CHANNEL)
        assert chain1.node.peers == chain2.node.peers == {1, 2}
        assert chain2.tracker.ids == {"127.0.0.1:7401": 1, "127.0.0.1:7402": 2}
        leader = cluster.leader(CHANNEL)
        for raw in raws:
            env = W.port_env(raw) if pkg == "port" else W.jax_env(raw)
            assert cluster.handlers[leader].process_message(env)[0] == fabric.SUCCESS
        cluster.run(20, CHANNEL)
        assert chain1.height == chain2.height == 4
        out[pkg] = (cluster.ledger(1, CHANNEL), cluster.ledger(2, CHANNEL)[1:])
    assert out["port"] == out["jax"]

    def unsigned(raw):  # each node signs its own blocks: all but that slot
        block = W.port_block(raw)
        return block["header"], block["data"], block["metadata"]["metadata"][1:]

    assert [unsigned(r) for r in out["port"][0][1:]] == [unsigned(r) for r in out["port"][1]]
