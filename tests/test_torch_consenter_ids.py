"""The port's stable consenter -> raft-id tracking
(fabric_tpu_torch.orderer.consenter_ids) against the JAX package's, with no
tolerance: tests/test_consenter_ids.py's tracker cases on both trackers with
the ORDERER slot's RaftBlockMetadata bytes equal, `from_block` on blocks of
either package, `consenters_from_config_block` on config blocks and on the
blocks it refuses, and the chain's apply path (a non-tail removal written
through each package's Registrar and RaftChain, the written blocks' bytes
equal under a stand-in signer, a restart recovering the peers from the
metadata)."""

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import torch_orderer_world as W  # noqa: E402
from fabric_tpu.orderer import consenter_ids as jci  # noqa: E402
from fabric_tpu.orderer import multichannel as jmc  # noqa: E402
from fabric_tpu.orderer import raft as jraft  # noqa: E402
from fabric_tpu.orderer import raft_chain as jrc  # noqa: E402
from fabric_tpu.protos import common_pb2  # noqa: E402
from fabric_tpu.protos import protoutil as jpu  # noqa: E402
from fabric_tpu_torch.orderer import consenter_ids as tci  # noqa: E402
from fabric_tpu_torch.orderer import multichannel as tmc  # noqa: E402
from fabric_tpu_torch.orderer import raft as traft  # noqa: E402
from fabric_tpu_torch.orderer import raft_chain as trc  # noqa: E402
from fabric_tpu_torch.protos import fabric, protoutil, wire  # noqa: E402

CHANNEL = "idtrackchan"

# (start, [consenter sets applied in turn]) of tests/test_consenter_ids.py
HISTORIES = {
    "bootstrap": (["a:1", "b:2", "c:3"], []),
    "non_tail_removal": (["a:1", "b:2", "c:3"], [["b:2", "c:3"]]),
    "reorder": (["a:1", "b:2", "c:3"], [["c:3", "a:1", "b:2"]]),
    "readd": (["a:1", "b:2"], [["b:2"], ["b:2", "a:1"]]),
    "grow_and_shrink": (["a:1", "b:2", "c:3"], [["b:2", "c:3", "d:4"], ["d:4"],
                                                ["e:5", "d:4", "f:6"]]),
    "empty": ([], [["x:9"]]),
}


def _pair(history):
    start, steps = HISTORIES[history]
    t, j = tci.ConsenterIdTracker.bootstrap(start), jci.ConsenterIdTracker.bootstrap(start)
    yield t, j
    for step in steps:
        t.apply(step)
        j.apply(step)
        yield t, j


@pytest.mark.parametrize("history", sorted(HISTORIES))
def test_tracker_equals_jax(history):
    """After every step: ids, next id, peer ids, membership, and the
    metadata bytes; a block stamped by each reads back in the other."""
    for t, j in _pair(history):
        assert (t.ids, t.next_id, t.peer_ids()) == (j.ids, j.next_id, j.peer_ids())
        for node_id in range(0, 8):
            assert t.is_member(node_id) == j.is_member(node_id)
        for addr in ("a:1", "b:2", "x:9", "nope"):
            assert t.id_for(addr) == j.id_for(addr)
        assert t.to_bytes() == j.to_bytes()
        block = protoutil.seal_block(protoutil.new_block(5, b"\x00" * 32))
        t.stamp(block)
        jblock = jpu.seal_block(jpu.new_block(5, b"\x00" * 32))
        j.stamp(jblock)
        assert wire.encode(fabric.BLOCK, block) == jblock.SerializeToString()
        back = tci.ConsenterIdTracker.from_block(W.port_block(jblock.SerializeToString()))
        jback = jci.ConsenterIdTracker.from_block(W.jax_block(wire.encode(fabric.BLOCK, block)))
        if t.ids:
            assert (back.ids, back.next_id) == (jback.ids, jback.next_id) == (t.ids, t.next_id)
        else:  # no ids: the metadata reads as none
            assert back is None and jback is None


def test_tracker_semantics():
    """tests/test_consenter_ids.py's expectations, on the port."""
    t = tci.ConsenterIdTracker.bootstrap(["a:1", "b:2", "c:3"])
    assert t.ids == {"a:1": 1, "b:2": 2, "c:3": 3} and t.next_id == 4
    t.apply(["b:2", "c:3"])  # remove the FIRST consenter
    assert t.peer_ids() == [2, 3] and not t.is_member(1)
    t = tci.ConsenterIdTracker.bootstrap(["a:1", "b:2"])
    t.apply(["b:2"])
    t.apply(["b:2", "a:1"])  # a returns: retired id 1 is not reused
    assert t.ids == {"b:2": 2, "a:1": 3} and t.next_id == 4


def test_from_block_refusals():
    """No block, no metadata slot, an empty slot, bytes that do not parse,
    ids without addresses: none in both packages."""
    assert tci.ConsenterIdTracker.from_block(None) is None
    bare = protoutil.seal_block(protoutil.new_block(0, b""))
    raws = [wire.encode(fabric.BLOCK, bare)]
    short = protoutil.seal_block(protoutil.new_block(0, b""))
    short["metadata"]["metadata"] = short["metadata"]["metadata"][:2]
    raws.append(wire.encode(fabric.BLOCK, short))
    for slot in (b"\xff\xff", wire.encode(tci.cfgpb.RAFT_BLOCK_METADATA, {
            "consenter_addresses": ["a:1"], "consenter_ids": [1, 2]})):
        b = protoutil.seal_block(protoutil.new_block(0, b""))
        b["metadata"]["metadata"][fabric.ORDERER_METADATA] = slot
        raws.append(wire.encode(fabric.BLOCK, b))
    for raw in raws:
        assert tci.ConsenterIdTracker.from_block(W.port_block(raw)) is None
        assert jci.ConsenterIdTracker.from_block(W.jax_block(raw)) is None
    # next_consenter_id absent: one past the largest id, in both
    b = protoutil.seal_block(protoutil.new_block(0, b""))
    b["metadata"]["metadata"][fabric.ORDERER_METADATA] = wire.encode(
        tci.cfgpb.RAFT_BLOCK_METADATA,
        {"consenter_addresses": ["a:1", "b:2"], "consenter_ids": [4, 2]})
    raw = wire.encode(fabric.BLOCK, b)
    t, j = (tci.ConsenterIdTracker.from_block(W.port_block(raw)),
            jci.ConsenterIdTracker.from_block(W.jax_block(raw)))
    assert (t.ids, t.next_id) == (j.ids, j.next_id) == ({"a:1": 4, "b:2": 2}, 5)


@pytest.fixture(scope="module")
def world():
    return W.World(1701)


def test_consenters_from_config_block(world):
    """Raft config blocks give their endpoints; a solo config block, a
    normal block and a block of garbage give none, in both."""
    cases = [
        world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7101, 7102, 7103]),
        world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7102]),
        world.genesis(CHANNEL),
    ]
    normal = protoutil.seal_block(protoutil.new_block(1, b""))
    normal["data"]["data"] = [W.envelope(world.signer(world.org1.users[0]), CHANNEL, b"tx")]
    garbage = protoutil.seal_block(protoutil.new_block(1, b""))
    garbage["data"]["data"] = [b"\xff\x00junk"]
    cases += [wire.encode(fabric.BLOCK, protoutil.seal_block(normal)),
              wire.encode(fabric.BLOCK, protoutil.seal_block(garbage))]
    got = [tci.consenters_from_config_block(W.port_block(r)) for r in cases]
    assert got == [jci.consenters_from_config_block(W.jax_block(r)) for r in cases]
    assert got[:3] == [["127.0.0.1:7101", "127.0.0.1:7102", "127.0.0.1:7103"],
                       ["127.0.0.1:7102"], None]


def test_chain_applies_and_stamps_stable_ids(world, tmp_path):
    """tests/test_consenter_ids.py's chain case in both packages: a config
    block that drops the FIRST consenter, written through each chain's
    apply path; the survivors keep ids 2 and 3; the stamped genesis and the
    config block are the same bytes; a restarted chain recovers its peers
    from the last block's metadata, not positionally."""
    gen = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7101, 7102, 7103],
                        max_message_count=1)
    shrunk = world.genesis(CHANNEL, orderer_type="etcdraft", consenters=[7102, 7103],
                           max_message_count=1)
    treg = tmc.Registrar(str(tmp_path / "port"), signer=W.StandIn(), raft_node_id=1,
                         provider=world.provider)
    jreg = jmc.Registrar(str(tmp_path / "jax"), signer=W.StandIn(), raft_node_id=1,
                         provider=W.SW)
    tchain = treg.join_channel(W.port_block(gen)).chain
    jchain = jreg.join_channel(W.jax_block(gen)).chain
    assert tchain.node.peers == jchain.node.peers == {1, 2, 3}
    assert wire.encode(fabric.BLOCK, tchain.get_block(0)) == jchain.get_block(
        0).SerializeToString()
    assert tci.ConsenterIdTracker.from_block(tchain.get_block(0)).ids == tchain.tracker.ids

    config_block = protoutil.new_block(1, tchain.block_store.last_block_hash)
    config_block["data"]["data"] = list(W.port_block(shrunk)["data"]["data"])
    raw = wire.encode(fabric.BLOCK, protoutil.seal_block(config_block))
    tchain._apply_entry(traft.Entry(1, 1, traft.ENTRY_NORMAL, b"\x01" + raw))
    jchain._apply_entry(jraft.Entry(1, 1, jraft.ENTRY_NORMAL, b"\x01" + raw))
    assert tchain.height == jchain.height == 2
    assert tchain.tracker.peer_ids() == jchain.tracker.peer_ids() == [2, 3]
    assert wire.encode(fabric.BLOCK, tchain.get_block(1)) == jchain.get_block(
        1).SerializeToString()
    stamped = tci.ConsenterIdTracker.from_block(tchain.get_block(1))
    assert stamped.ids == {"127.0.0.1:7102": 2, "127.0.0.1:7103": 3}
    # the registrar hot-swapped the bundle to the shrunk consenter set
    assert treg.get_chain(CHANNEL).bundle.orderer.consensus_metadata == jreg.get_chain(
        CHANNEL).bundle.orderer.consensus_metadata

    addrs = ["127.0.0.1:7102", "127.0.0.1:7103"]
    t2 = trc.RaftChain(CHANNEL, 2, [1, 2], wal_dir=str(tmp_path / "port" / "etcdraft"),
                       initial_consenters=addrs)
    j2 = jrc.RaftChain(CHANNEL, 2, [1, 2], wal_dir=str(tmp_path / "jax" / "etcdraft"),
                       initial_consenters=addrs)
    assert t2.node.peers == j2.node.peers == {2, 3}
    assert t2.tracker.ids == j2.tracker.ids == stamped.ids
    assert trc._last_config_index(t2.get_block(1)) == jrc._last_config_index(
        j2.get_block(1)) == 1
    assert isinstance(j2.get_block(1), common_pb2.Block)
