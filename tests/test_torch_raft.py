"""The port's raft orderer (fabric_tpu_torch.orderer.{raft,raft_chain})
against the JAX package's, with no tolerance. Each of tests/test_raft.py's
cases runs on a cluster of each package in lockstep: the same ticks, the
same deliveries, the same partitions and envelopes. After every tick round
and every delivery round the nodes' roles, terms, votes, leaders, commit
indexes, logs and snapshot state are equal, every message in flight is the
same bytes (`message_to_bytes`), every WAL and snapshot file holds the same
bytes, and every block written is the same bytes (no signer: the SIGNATURES
slot holds LastConfig alone). Also the WAL and snapshot codecs on their own,
the message codec on seeded messages and its refusal of inflated lengths,
and a few seeds of tests/test_raft_fuzz.py's adversarial network (S1/S2
while it runs, L1/L2 after it heals) on the port, in lockstep with the JAX
nodes under one schedule."""

import os
import random
import struct
from types import SimpleNamespace

import pytest

from fabric_tpu.orderer import blockcutter as jcut
from fabric_tpu.orderer import raft as jraft
from fabric_tpu.orderer import raft_chain as jrc
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch.orderer import blockcutter as tcut
from fabric_tpu_torch.orderer import raft as traft
from fabric_tpu_torch.orderer import raft_chain as trc
from fabric_tpu_torch.protos import fabric, protoutil, wire
from torch_untraced import untraced  # noqa: F401

PORT = SimpleNamespace(
    name="port", raft=traft, rc=trc, cut=tcut,
    env=lambda payload: {"payload": payload},
    block_bytes=lambda b: wire.encode(fabric.BLOCK, b),
)
JAX = SimpleNamespace(
    name="jax", raft=jraft, rc=jrc, cut=jcut,
    env=lambda payload: common_pb2.Envelope(payload=payload),
    block_bytes=lambda b: b.SerializeToString(),
)


class Cluster:
    """tests/test_raft.py's deterministic in-memory cluster over one
    package's RaftChain."""

    def __init__(self, pkg, base, ids=(1, 2, 3), max_message_count=2, snapshot_interval=0):
        self.pkg = pkg
        self.base = str(base)
        self.partitioned = set()
        self.queues = {i: [] for i in ids}
        self.chains = {}
        for i in ids:
            self.chains[i] = pkg.rc.RaftChain(
                "ch", i, ids, wal_dir=os.path.join(self.base, f"node{i}"),
                batch_config=pkg.cut.BatchConfig(max_message_count=max_message_count),
                snapshot_interval=snapshot_interval, transport=self._make_transport(i))

    def _make_transport(self, frm):
        def send(to, msg):
            if frm in self.partitioned or to in self.partitioned:
                return
            if to in self.queues:
                self.queues[to].append(msg)

        return send

    def tick_round(self):
        for i, chain in self.chains.items():
            if i not in self.partitioned:
                chain.tick()

    def deliver_round(self) -> bool:
        moved = False
        for i, chain in self.chains.items():
            q, self.queues[i] = self.queues[i], []
            for m in q:
                if i in self.partitioned:
                    continue
                chain.step(m)
                moved = True
        return moved

    @property
    def leader(self):
        for i, c in self.chains.items():
            if c.node.role == "leader" and i not in self.partitioned:
                return c
        return None

    def files(self):
        """Every WAL and snapshot file's bytes under the cluster's root."""
        out = {}
        for root, _, names in os.walk(self.base):
            for name in names:
                if name in ("wal.log", "snapshot"):
                    path = os.path.join(root, name)
                    with open(path, "rb") as f:
                        out[os.path.relpath(path, self.base)] = f.read()
        return out

    def state(self):
        """Per node: raft state, log, snapshot state, height and the bytes
        of every block; the bytes of every queued message."""
        nodes = {}
        for i, c in self.chains.items():
            n = c.node
            nodes[i] = (n.role, n.term, n.voted_for, n.leader_id, n.commit_index, n.evicted,
                        sorted(n.peers), n.snap_index, n.snap_term, n.snap_data,
                        [(e.index, e.term, e.type, e.data) for e in n.log],
                        c.height, [self.pkg.block_bytes(c.get_block(k)) for k in range(c.height)])
        queues = {i: [self.pkg.raft.message_to_bytes(m) for m in q]
                  for i, q in self.queues.items()}
        return nodes, queues


class Lockstep:
    """A cluster of each package driven together, compared after every
    round."""

    def __init__(self, tmp_path, **kw):
        self.port = Cluster(PORT, tmp_path / "port", **kw)
        self.jax = Cluster(JAX, tmp_path / "jax", **kw)
        self.rounds = 0

    def both(self):
        return (self.port, self.jax)

    def check(self):
        assert self.port.state() == self.jax.state(), f"round {self.rounds}"
        assert self.port.files() == self.jax.files(), f"round {self.rounds}"
        self.rounds += 1

    def deliver(self, rounds=20):
        for _ in range(rounds):
            moved = [c.deliver_round() for c in self.both()]
            assert moved[0] == moved[1]
            self.check()
            if not moved[0]:
                return

    def run(self, ticks=50):
        for _ in range(ticks):
            for c in self.both():
                c.tick_round()
            self.check()
            self.deliver()

    def partition(self, *ids):
        for c in self.both():
            c.partitioned.update(ids)

    def heal(self):
        for c in self.both():
            c.partitioned.clear()

    def order(self, node_id, payload):
        for c in self.both():
            c.chains[node_id].order(c.pkg.env(payload))
        self.check()

    def leader_id(self):
        ids = {c.leader.node.id if c.leader else None for c in self.both()}
        assert len(ids) == 1
        return ids.pop()


def test_election_and_replication(tmp_path):
    ls = Lockstep(tmp_path)
    ls.run(30)
    leader = ls.leader_id()
    assert leader is not None
    ls.order(leader, b"tx1")
    ls.order(leader, b"tx2")  # max_message_count=2: one block everywhere
    ls.run(10)
    for c in ls.both():
        assert all(ch.height == 1 for ch in c.chains.values())
    assert len(ls.port.chains[leader].get_block(0)["data"]["data"]) == 2


def test_followers_reject_order(tmp_path):
    ls = Lockstep(tmp_path)
    ls.run(30)
    leader = ls.leader_id()
    follower = next(i for i in ls.port.chains if i != leader)
    for c in ls.both():
        with pytest.raises(c.pkg.rc.NotLeaderError, match=f"current leader is {leader}") as exc:
            c.chains[follower].order(c.pkg.env(b"tx"))
        assert exc.value.leader_id == leader
    ls.check()


def test_leader_failover_preserves_chain(tmp_path):
    ls = Lockstep(tmp_path)
    ls.run(30)
    old = ls.leader_id()
    ls.order(old, b"a")
    ls.order(old, b"b")
    ls.run(10)
    ls.partition(old)  # the remaining two elect a new leader
    ls.run(60)
    new = ls.leader_id()
    assert new not in (None, old)
    ls.order(new, b"c")
    ls.order(new, b"d")
    ls.run(10)
    live = [ch for i, ch in ls.port.chains.items() if i != old]
    assert all(ch.height == 2 for ch in live)
    b0, b1 = live[0].get_block(0), live[0].get_block(1)
    assert b1["header"]["previous_hash"] == protoutil.block_header_hash(b0["header"])
    ls.heal()  # the old leader catches up
    ls.run(30)
    assert ls.port.chains[old].height == ls.jax.chains[old].height == 2


def _wal_pair(tmp_path, name):
    return (traft.WAL(str(tmp_path / "port" / name / "wal.log")),
            jraft.WAL(str(tmp_path / "jax" / name / "wal.log")))


def test_wal_recovery_and_torn_tail(tmp_path):
    twal, jwal = _wal_pair(tmp_path, "w")
    for wal, mod in ((twal, traft), (jwal, jraft)):
        wal.save((3, 2), [mod.Entry(1, 1, 0, b"x"), mod.Entry(2, 3, 0, b"y")])
        wal.save(None, [mod.Entry(3, 3, 0, b"z")])
        wal.close()
    assert open(twal.path, "rb").read() == open(jwal.path, "rb").read()
    hard, entries = twal.replay()
    assert hard == (3, 2) and [(e.index, e.data) for e in entries] == [
        (1, b"x"), (2, b"y"), (3, b"z")]
    for wal in (twal, jwal):  # a torn tail is dropped
        with open(wal.path, "ab") as f:
            f.write(b"\x99\x00\x00\x00partial")
    assert [(e.index, e.term, e.data) for e in twal.replay()[1]] == [
        (e.index, e.term, e.data) for e in jwal.replay()[1]]
    assert len(twal.replay()[1]) == 3
    # a flipped byte ends the replay at the record before it
    for wal in (twal, jwal):
        raw = bytearray(open(wal.path, "rb").read())
        raw[30] ^= 1
        open(wal.path, "wb").write(bytes(raw))
    (th, te), (jh, je) = twal.replay(), jwal.replay()
    assert (th, [(e.index, e.term, e.type, e.data) for e in te]) == (
        jh, [(e.index, e.term, e.type, e.data) for e in je])
    assert len(te) < 3


def test_wal_conflicting_rewrite_keeps_latest(tmp_path):
    twal, jwal = _wal_pair(tmp_path, "w2")
    for wal, mod in ((twal, traft), (jwal, jraft)):
        wal.save(None, [mod.Entry(1, 1, 0, b"old1"), mod.Entry(2, 1, 0, b"old2")])
        wal.save(None, [mod.Entry(2, 2, 0, b"new2")])  # a term-2 leader overwrote index 2
    assert open(twal.path, "rb").read() == open(jwal.path, "rb").read()
    assert [(e.index, e.data) for e in twal.replay()[1]] == [(1, b"old1"), (2, b"new2")]
    # rotate rewrites the file to the hard state and the live entries alone
    twal.rotate((5, 1), [traft.Entry(2, 2, 0, b"new2")])
    jwal.rotate((5, 1), [jraft.Entry(2, 2, 0, b"new2")])
    assert open(twal.path, "rb").read() == open(jwal.path, "rb").read()
    assert twal.replay() == ((5, 1), [traft.Entry(2, 2, 0, b"new2")])


def test_snapshot_file_bytes(tmp_path):
    ts = traft.SnapshotFile(str(tmp_path / "port" / "s" / "snapshot"))
    js = jraft.SnapshotFile(str(tmp_path / "jax" / "s" / "snapshot"))
    for s in (ts, js):
        assert s.load() is None
        s.save(7, 2, b"state")
    assert open(ts.path, "rb").read() == open(js.path, "rb").read()
    assert ts.load() == js.load() == (7, 2, b"state")
    for s in (ts, js):  # a bad checksum reads as no snapshot
        raw = bytearray(open(s.path, "rb").read())
        raw[-1] ^= 1
        open(s.path, "wb").write(bytes(raw))
    assert ts.load() is None and js.load() is None


class SoloLockstep:
    """A one-node chain of each package, ticked and driven together."""

    def __init__(self, path, snapshot_interval):
        self.path = path
        self.snapshot_interval = snapshot_interval
        self.open()

    def open(self):
        self.chains = [pkg.rc.RaftChain(
            "ch", 1, (1,), wal_dir=str(self.path / pkg.name),
            batch_config=pkg.cut.BatchConfig(max_message_count=1),
            snapshot_interval=self.snapshot_interval) for pkg in (PORT, JAX)]

    def tick(self, n=30):
        for _ in range(n):
            for c in self.chains:
                c.tick()
        assert [c.node.role for c in self.chains] == ["leader"] * 2

    def order(self, payload):
        for c, pkg in zip(self.chains, (PORT, JAX)):
            c.order(pkg.env(payload))
            c._pump()
        self.check()

    def check(self):
        t, j = self.chains
        assert t.height == j.height
        assert [PORT.block_bytes(t.get_block(k)) for k in range(t.height)] == [
            JAX.block_bytes(j.get_block(k)) for k in range(j.height)]
        assert (t.node.term, t.node.commit_index, t.node.snap_index, t.needs_catch_up) == (
            j.node.term, j.node.commit_index, j.node.snap_index, j.needs_catch_up)
        for name in ("wal.log", "snapshot"):
            files = [self.path / pkg.name / "ch" / name for pkg in (PORT, JAX)]
            port, jax = (f.read_bytes() if f.exists() else None for f in files)
            assert port == jax

    def restart(self):
        for c in self.chains:
            c.wal.close()
            c.block_store.close()
        self.open()
        self.check()


def test_chain_restart_recovers_from_wal(tmp_path):
    solo = SoloLockstep(tmp_path, snapshot_interval=0)
    solo.tick()
    solo.order(b"tx1")
    solo.order(b"tx2")
    assert solo.chains[0].height == 2
    solo.restart()
    solo.tick()  # committed entries replay once the node re-commits them
    solo.order(b"tx3")
    assert solo.chains[0].height == 3 and solo.chains[0].get_block(2) is not None


def test_chain_restart_with_snapshot_keeps_height(tmp_path):
    """A restart with an on-disk snapshot resumes from the persisted block
    ledger instead of re-minting used block numbers."""
    solo = SoloLockstep(tmp_path, snapshot_interval=2)
    solo.tick()
    for i in range(6):
        solo.order(f"tx{i}".encode())
    assert solo.chains[0].height == 6 and solo.chains[0].node.snap_index > 0
    solo.restart()
    assert solo.chains[0].height == 6 and solo.chains[0].needs_catch_up is None
    solo.tick()
    solo.order(b"tx-after-restart")
    t = solo.chains[0]
    assert t.height == 7
    assert t.get_block(6)["header"]["previous_hash"] == protoutil.block_header_hash(
        t.get_block(5)["header"])


def test_snapshot_compaction_and_catch_up(tmp_path):
    ls = Lockstep(tmp_path, snapshot_interval=2)
    ls.run(30)
    leader = ls.leader_id()
    lagger = next(i for i in ls.port.chains if i != leader)
    ls.partition(lagger)
    for i in range(6):
        ls.order(leader, b"x%d" % i)
    ls.run(15)
    assert ls.port.chains[leader].height >= 3
    assert ls.port.chains[leader].node.snap_index > 0  # compaction happened
    ls.heal()
    ls.run(40)
    # the lagger's raft log caught up through a snapshot; pull the blocks
    targets = {c.chains[lagger].needs_catch_up for c in ls.both()}
    assert len(targets) == 1
    target = targets.pop()
    if target is not None:
        for c in ls.both():
            lag, lead = c.chains[lagger], c.chains[leader]
            lag.catch_up([b for b in (lead.get_block(n) for n in range(lag.height, target))
                          if b is not None])
        ls.check()
    ls.order(leader, b"y0")
    ls.order(leader, b"y1")
    ls.run(10)
    assert ls.port.chains[lagger].height == ls.port.chains[leader].height


def test_membership_eviction(tmp_path):
    ls = Lockstep(tmp_path)
    ls.run(30)
    leader = ls.leader_id()
    victim = next(i for i in ls.port.chains if i != leader)
    keep = [i for i in ls.port.chains if i != victim]
    for c in ls.both():
        c.chains[leader].propose_conf_change(keep)
    ls.check()
    ls.run(10)
    assert ls.port.chains[victim].node.evicted and ls.jax.chains[victim].node.evicted
    ls.order(leader, b"p")
    ls.order(leader, b"q")
    ls.run(10)
    assert all(ls.port.chains[i].height >= 1 for i in keep)
    # a follower refuses a conf change as it refuses an envelope
    other = next(i for i in keep if i != leader)
    for c in ls.both():
        with pytest.raises(c.pkg.rc.NotLeaderError):
            c.chains[other].propose_conf_change(keep)


def _random_message(mod, rng):
    entries = tuple(mod.Entry(rng.randrange(1, 10**6), rng.randrange(10**4), rng.randrange(2),
                              rng.randbytes(rng.randrange(40)))
                    for _ in range(rng.randrange(4)))
    return mod.Message(
        kind=rng.choice(["vote_req", "vote_resp", "append", "append_resp", "snap"]),
        term=rng.randrange(2**40), frm=rng.randrange(1, 9), to=rng.randrange(1, 9),
        prev_index=rng.randrange(2**20), prev_term=rng.randrange(2**20), entries=entries,
        commit=rng.randrange(2**20), last_index=rng.randrange(2**20),
        last_term=rng.randrange(2**20), granted=rng.random() < 0.5, success=rng.random() < 0.5,
        match_index=rng.randrange(2**20), snap_index=rng.randrange(2**20),
        snap_term=rng.randrange(2**20), snap_data=rng.randbytes(rng.randrange(30)))


@pytest.mark.parametrize("seed", range(3))
def test_message_codec_bytes_equal_jax(seed):
    trng, jrng = random.Random(seed), random.Random(seed)
    for _ in range(40):
        tm, jm = _random_message(traft, trng), _random_message(jraft, jrng)
        raw = traft.message_to_bytes(tm)
        assert raw == jraft.message_to_bytes(jm)
        assert traft.message_from_bytes(raw) == tm


def test_message_codec_rejects_inflated_wire_lengths():
    """Every decoded length is checked against the payload: an inflated
    snapshot length, entry count or entry data length is refused, as the
    JAX codec refuses it."""
    m = traft.Message(kind="snap", term=3, frm=1, to=2, snap_index=7, snap_term=2,
                      snap_data=b"snapshot-bytes", entries=(traft.Entry(8, 3, 0, b"payload"),))
    raw = traft.message_to_bytes(m)
    assert traft.message_from_bytes(raw) == m
    head_len = struct.calcsize("<BQQQQQQBBQQQQ")
    n_off = head_len + struct.calcsize("<QI") + len(m.snap_data)
    dlen_off = n_off + 4 + struct.calcsize("<QQB")
    cases = {
        "snapshot length": raw[:head_len] + struct.pack("<QI", m.snap_term, len(raw))
        + raw[head_len + struct.calcsize("<QI"):],
        "entry count": raw[:n_off] + struct.pack("<I", 2**31) + raw[n_off + 4:],
        "data length": raw[:dlen_off] + struct.pack("<I", len(raw)) + raw[dlen_off + 4:],
    }
    for what, torn in cases.items():
        for mod in (traft, jraft):
            with pytest.raises(ValueError, match=what):
                mod.message_from_bytes(torn)


# -- tests/test_raft_fuzz.py's adversarial network, both packages in lockstep --


class SimNode:
    """RaftNode + WAL/snapshot persistence + apply loop (test_raft_fuzz's
    SimNode) over one package's raft module."""

    def __init__(self, mod, node_id, peers, base_dir, seed):
        self.mod = mod
        self.id = node_id
        self.peers = peers
        self.dir = os.path.join(base_dir, f"n{node_id}")
        self.wal = mod.WAL(os.path.join(self.dir, "wal.log"))
        self.snap = mod.SnapshotFile(os.path.join(self.dir, "snapshot"))
        self.seed = seed
        self.applied = {}
        self.applied_index = 0
        self._boot()

    def _boot(self):
        self.node = self.mod.RaftNode(self.id, self.peers, rng=random.Random(self.seed))
        snap = self.snap.load()
        if snap is not None:
            index, term, data = snap
            self.node.snap_index, self.node.snap_term, self.node.snap_data = index, term, data
            self.node.commit_index = index
            self.applied_index = index
        hard, entries = self.wal.replay()
        self.node.term, self.node.voted_for = max((self.node.term, self.node.voted_for), hard)
        for e in entries:
            if e.index > self.node.snap_index:
                self.node.log.append(e)
        self._persisted_snap = self.node.snap_index

    def crash_restart(self):
        self.wal.close()
        self.applied = {i: d for i, d in self.applied.items() if i <= self._persisted_snap}
        self.applied_index = 0
        self._boot()

    def pump(self):
        msgs, hard, new_entries = self.node.ready()
        if hard is not None or new_entries:
            self.wal.save(hard, new_entries)
        if self.node.applied_snapshot is not None and self.node.snap_index > self._persisted_snap:
            self.snap.save(self.node.snap_index, self.node.snap_term, self.node.snap_data)
            self._persisted_snap = self.node.snap_index
            self.wal.rotate((self.node.term, self.node.voted_for), self.node.log)
        n = self.node
        while self.applied_index < n.commit_index:
            idx = self.applied_index + 1
            if idx <= n.snap_index or n._term_at(idx) is None:
                self.applied_index = n.snap_index
                continue
            e = n.log[idx - n.snap_index - 1]
            if e.type == self.mod.ENTRY_NORMAL and e.data:
                self.applied[idx] = e.data
            self.applied_index = idx
        return msgs

    def compact(self):
        if self.applied_index > self.node.snap_index:
            self.node.compact(self.applied_index, b"snap")
            self.snap.save(self.node.snap_index, self.node.snap_term, b"snap")
            self._persisted_snap = self.node.snap_index
            self.wal.rotate((self.node.term, self.node.voted_for), self.node.log)

    def view(self):
        n = self.node
        return (n.role, n.term, n.voted_for, n.commit_index, n.snap_index, self.applied_index,
                [(e.index, e.term, e.data) for e in n.log], sorted(self.applied.items()))


class FuzzPair:
    """One schedule (test_raft_fuzz's Cluster.step) played on a 3-node
    cluster of each package; the checks of S1 and S2 on the port's nodes
    and lockstep equality with the JAX nodes after every step."""

    def __init__(self, base, seed):
        self.rng = random.Random(seed)
        peers = [1, 2, 3]
        seeds = {i: self.rng.randrange(2**31) for i in peers}
        self.sides = [{i: SimNode(mod, i, peers, os.path.join(base, name), seeds[i])
                       for i in peers} for mod, name in ((traft, "port"), (jraft, "jax"))]
        self.inflight = [[], []]
        self.cut = set()
        self.committed, self.leaders_by_term, self.proposed = {}, {}, 0

    def check(self):
        port, jax = self.sides
        assert [n.view() for n in port.values()] == [n.view() for n in jax.values()]
        assert [[traft.message_to_bytes(m) for m in self.inflight[0]]] == [
            [jraft.message_to_bytes(m) for m in self.inflight[1]]]
        for node in port.values():
            if node.node.role == "leader":  # S2: one leader a term
                assert self.leaders_by_term.setdefault(node.node.term, node.id) == node.id
            for idx, data in node.applied.items():  # S1: one entry an index
                assert self.committed.setdefault(idx, data) == data

    def pump_all(self):
        for side, inflight in zip(self.sides, self.inflight):
            for node in side.values():
                inflight.extend(m for m in node.pump() if (m.frm, m.to) not in self.cut)

    def each(self, fn):
        for side in self.sides:
            fn(side)

    def step(self):
        roll = self.rng.random()
        if roll < 0.50:
            if self.inflight[0]:
                i = self.rng.randrange(len(self.inflight[0]))
                drop = self.rng.random() < 0.05
                dup = not drop and self.rng.random() < 0.05
                for side, inflight in zip(self.sides, self.inflight):
                    m = inflight.pop(i)
                    if drop:
                        continue
                    if dup:
                        inflight.append(m)
                    if (m.frm, m.to) not in self.cut:
                        side[m.to].node.step(m)
        elif roll < 0.80:
            k = self.rng.randrange(1, 4)
            self.each(lambda side: side[k].node.tick())
        elif roll < 0.90:
            leaders = [n.id for n in self.sides[0].values() if n.node.role == "leader"]
            if leaders:
                self.proposed += 1
                cmd = b"cmd-%d" % self.proposed
                self.each(lambda side: side[leaders[0]].node.propose(cmd))
        elif roll < 0.94:
            k = self.rng.randrange(1, 4)
            self.each(lambda side: side[k].crash_restart())
        elif roll < 0.97:
            k = self.rng.randrange(1, 4)
            self.each(lambda side: side[k].compact())
        elif self.cut:
            self.cut = set()
        else:
            victim = self.rng.randrange(1, 4)
            self.cut = {(a, b) for a in (1, 2, 3) for b in (1, 2, 3)
                        if (a == victim) != (b == victim)}
        self.pump_all()
        self.check()

    def drain(self):
        while self.inflight[0]:
            for side, inflight in zip(self.sides, self.inflight):
                m = inflight.pop(0)
                side[m.to].node.step(m)
            self.pump_all()
        self.check()

    def converge(self, max_rounds=6000):
        self.cut = set()
        for _ in range(max_rounds):
            self.drain()
            port = self.sides[0].values()
            if (len({n.node.commit_index for n in port}) == 1
                    and len({n.applied_index for n in port}) == 1
                    and any(n.node.role == "leader" for n in port)):
                return
            self.each(lambda side: [n.node.tick() for n in side.values()])
            self.pump_all()
        raise AssertionError("no convergence")


@pytest.mark.parametrize("seed", [11, 47])
def test_raft_fuzz_lockstep(tmp_path, seed):
    pair = FuzzPair(str(tmp_path), seed)
    for _ in range(700):
        pair.step()
    pair.converge()
    port = pair.sides[0]
    union = {}  # L1: the applied logs agree and leave no gap to disagree on
    for node in port.values():
        for idx, data in node.applied.items():
            assert union.setdefault(idx, data) == data
    leader = next(n.id for n in port.values() if n.node.role == "leader")
    pair.each(lambda side: side[leader].node.propose(b"final"))  # L2
    for _ in range(200):
        pair.pump_all()
        pair.drain()
        if all(b"final" in n.applied.values() for n in port.values()):
            break
        pair.each(lambda side: [n.node.tick() for n in side.values()])
    assert all(b"final" in n.applied.values() for n in port.values())
    assert pair.proposed > 10
