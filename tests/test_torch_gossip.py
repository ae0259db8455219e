"""The port's gossip schemas and gossip modules held to the JAX package.

- `protos/gossip.py` against protobuf's `gossip_pb2`: every member of
  GossipMessage.content built with seeded values, written and read both
  ways; unknown fields kept as protobuf keeps them; every truncation and
  seeded byte mutations parse, or fail, as protobuf's parse does, and what
  parses is written back as protobuf writes it.
- `gossip/{msgstore,membership,state,pull,pvtdata,coordinator}` in lockstep
  with the JAX objects on seeded operation sequences (the same inputs, every
  result equal, messages byte for byte): tests/test_gossip.py's cases,
  tests/test_gossip_pull.py's TestMessageStore and TestSuspicion on a
  stepped clock, the pull rounds under one seed, the private-data request's
  signed bytes, its replay window and the requester's eligibility.
"""

import random

import numpy as np
import pytest
from torch_untraced import untraced  # noqa: F401

from fabric_tpu.gossip import coordinator as jcoord
from fabric_tpu.gossip import membership as jmem
from fabric_tpu.gossip import msgstore as jms
from fabric_tpu.gossip import pull as jpull
from fabric_tpu.gossip import pvtdata as jpvt
from fabric_tpu.gossip import state as jstate
from fabric_tpu.ledger.pvtdatastore import MissingEntry as JMissing
from fabric_tpu.protos import common_pb2, gossip_pb2, protoutil
from fabric_tpu_torch.gossip import coordinator as tcoord
from fabric_tpu_torch.gossip import membership as tmem
from fabric_tpu_torch.gossip import msgstore as tms
from fabric_tpu_torch.gossip import pull as tpull
from fabric_tpu_torch.gossip import pvtdata as tpvt
from fabric_tpu_torch.gossip import state as tstate
from fabric_tpu_torch.ledger.pvtdatastore import MissingEntry as TMissing
from fabric_tpu_torch.protos import fabric, gossip, wire

# ---------------------------------------------------------------------------
# The schemas against protobuf
# ---------------------------------------------------------------------------


def _rand_value(field, rng):
    if field.kind == "string":
        return "".join(rng.choice("abcé-_0") for _ in range(rng.randrange(0, 6)))
    if field.kind == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.randrange(0, 8)))
    if field.kind == "int32":
        return rng.choice([0, 1, 2, 3, -1, -(2 ** 31), 2 ** 31 - 1])
    if field.kind == "uint64":
        return rng.choice([0, 1, 127, 128, 2 ** 63, 2 ** 64 - 1, rng.randrange(2 ** 40)])
    raise AssertionError(field.kind)


def _rand_message(schema, rng, depth=0):
    """A dict of `schema` with seeded values; message-typed bytes fields
    (a block, a pulled item) are plain bytes here."""
    out = {}
    for field in schema.values():
        if field.oneof is not None or rng.random() < 0.2:
            continue
        if field.kind == "message":
            if field.repeated:
                out[field.name] = [_rand_message(field.message, rng, depth + 1)
                                   for _ in range(rng.randrange(0, 3))]
            else:
                out[field.name] = _rand_message(field.message, rng, depth + 1)
        elif field.repeated:
            out[field.name] = [_rand_value(field, rng) for _ in range(rng.randrange(0, 4))]
        else:
            out[field.name] = _rand_value(field, rng)
    return out


MEMBERS = list(gossip.CONTENT)


@pytest.mark.parametrize("member", MEMBERS)
def test_every_content_member_equals_protobuf(member):
    """Written by the port, read by protobuf and written again, the same
    bytes; and protobuf's bytes read by the port and written again."""
    rng = random.Random(f"gossip schema {member}")
    field = next(f for f in gossip.GOSSIP_MESSAGE.values() if f.name == member)
    for _ in range(40):
        msg = _rand_message(gossip.GOSSIP_MESSAGE, rng)
        msg[member] = _rand_message(field.message, rng)
        raw = wire.encode(gossip.GOSSIP_MESSAGE, msg)
        pb = gossip_pb2.GossipMessage.FromString(raw)
        assert pb.WhichOneof("content") == member
        assert pb.SerializeToString() == raw
        back = wire.decode(gossip.GOSSIP_MESSAGE, raw)
        assert gossip.content(back) == member
        assert wire.encode(gossip.GOSSIP_MESSAGE, back) == raw


def test_oneof_last_member_wins_as_protobuf():
    """Two members on the wire: the last one is kept, as protobuf keeps it."""
    a = wire.encode(gossip.GOSSIP_MESSAGE, {"hello": {"nonce": 5, "msg_type": 2}})
    b = wire.encode(gossip.GOSSIP_MESSAGE, {"conn": {"pki_id": b"p"}})
    for raw in (a + b, b + a, a + b + a):
        pb = gossip_pb2.GossipMessage.FromString(raw)
        got = wire.decode(gossip.GOSSIP_MESSAGE, raw)
        assert gossip.content(got) == pb.WhichOneof("content")
        assert wire.encode(gossip.GOSSIP_MESSAGE, got) == pb.SerializeToString()


def _outcome_pb(raw):
    try:
        return ("ok", gossip_pb2.GossipMessage.FromString(raw).SerializeToString())
    except Exception:  # protobuf's DecodeError
        return ("raises", None)


def _outcome_port(raw):
    try:
        msg = wire.decode(gossip.GOSSIP_MESSAGE, raw, keep_unknown=True)
    except wire.WireError:
        return ("raises", None)
    return ("ok", wire.encode(gossip.GOSSIP_MESSAGE, msg))


def _sample(rng, member):
    field = next(f for f in gossip.GOSSIP_MESSAGE.values() if f.name == member)
    msg = {"channel": "ch", member: _rand_message(field.message, rng)}
    return wire.encode(gossip.GOSSIP_MESSAGE, msg)


@pytest.mark.parametrize("member", MEMBERS)
def test_unknown_fields_truncation_and_fuzz_as_protobuf(member):
    rng = random.Random(f"gossip fuzz {member}")
    nrng = np.random.default_rng(MEMBERS.index(member) + 7000)
    raised = 0
    for _ in range(3):
        raw = _sample(rng, member)
        # unknown fields: a varint 30, a length-delimited 31, a fixed32 and
        # a fixed64 at the top level, and one inside the member
        unknown = bytes.fromhex("f00105" "fa010261" "fd0101020304" "f901" + "00" * 8)
        inner = wire.encode(gossip.GOSSIP_MESSAGE, {})
        variants = [raw, raw + unknown, unknown + raw, inner + unknown]
        member_no = next(n for n, f in gossip.GOSSIP_MESSAGE.items() if f.name == member)
        variants.append(raw + bytes([member_no << 3 | 2 if member_no < 16 else 0x8a]) +
                        (b"\x01" if member_no >= 16 else b"") + bytes([len(unknown)]) + unknown)
        variants += [raw[:n] for n in range(len(raw))]
        for _ in range(150):
            b = bytearray(raw)
            for _ in range(int(nrng.integers(1, 3))):
                pos = int(nrng.integers(0, len(b) + 1))
                op = nrng.random()
                if op < 0.45 and pos < len(b):
                    b[pos] = int(nrng.integers(0, 256))
                elif op < 0.6 and pos < len(b):
                    b[pos] ^= 0x07
                elif op < 0.85:
                    b[pos:pos] = bytes(nrng.integers(0, 256, int(nrng.integers(1, 4)),
                                                     dtype=np.uint8))
                elif pos < len(b):
                    del b[pos]
            variants.append(bytes(b))
        for v in variants:
            want = _outcome_pb(v)
            assert _outcome_port(v) == want, v.hex()
            raised += want[0] == "raises"
    assert raised > 0


# ---------------------------------------------------------------------------
# Blocks of both packages
# ---------------------------------------------------------------------------


def block_raw(n: int, prev: bytes = b"\x00" * 32) -> bytes:
    b = protoutil.new_block(n, prev)
    b.data.data.append(b"tx")
    return protoutil.seal_block(b).SerializeToString()


def jblock(raw):
    return common_pb2.Block.FromString(raw)


def tblock(raw):
    return wire.decode(fabric.BLOCK, raw)


def number(block):
    return block["header"].get("number", 0) if isinstance(block, dict) else block.header.number


def raw_of(block):
    return wire.encode(fabric.BLOCK, block) if isinstance(block, dict) else block.SerializeToString()


def pb_bytes(msg):
    """A message of either package as bytes (None stays None)."""
    if msg is None:
        return None
    if isinstance(msg, dict):
        return wire.encode(gossip.GOSSIP_MESSAGE, msg)
    return msg.SerializeToString()


def as_jax(raw):
    return gossip_pb2.GossipMessage.FromString(raw)


def as_port(raw):
    return wire.decode(gossip.GOSSIP_MESSAGE, raw)


# ---------------------------------------------------------------------------
# MessageStore: TestMessageStore on a stepped clock, and seeded sequences
# ---------------------------------------------------------------------------


class SteppedClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    """One stepped clock for both packages: the port's store takes it, the
    JAX module's `time` is replaced in the test."""
    c = SteppedClock()
    monkeypatch.setattr(jms, "time", c)
    return c


def stores(clock, **kw):
    return jms.MessageStore(**kw), tms.MessageStore(clock=clock.monotonic, **kw)


def test_message_store_dedup_and_rank(clock):
    for s in stores(clock, ttl_s=30.0):
        assert s.add(("alive", "p1"), rank=1)
        assert not s.add(("alive", "p1"), rank=1)
        assert not s.add(("alive", "p1"), rank=0)
        assert s.add(("alive", "p1"), rank=2)
        assert s.add(("data", 7))
        assert not s.add(("data", 7))
        assert s.seen(("data", 7))


def test_message_store_ttl_expiry(clock):
    pair = stores(clock, ttl_s=0.05)
    for s in pair:
        assert s.add("k")
        assert not s.add("k")
    clock.now += 0.08
    for s in pair:
        assert s.add("k")


def test_message_store_bounded(clock):
    for s in stores(clock, ttl_s=300.0, max_entries=64):
        for i in range(200):
            s.add(("k", i))
        assert len(s) <= 64


@pytest.mark.parametrize("seed", range(4))
def test_message_store_lockstep(clock, seed):
    rng = random.Random(seed)
    j, t = stores(clock, ttl_s=5.0, max_entries=16)
    for _ in range(600):
        op = rng.random()
        key = ("k", rng.randrange(24))
        rank = rng.randrange(4)
        if op < 0.5:
            assert j.add(key, rank) == t.add(key, rank)
        elif op < 0.75:
            assert j.seen(key, rank) == t.seen(key, rank)
        elif op < 0.85:
            j.expire_old()
            t.expire_old()
        else:
            clock.now += rng.choice([0.1, 1.0, 3.0, 6.0])
        assert len(j) == len(t)
        assert j._entries == t._entries


# ---------------------------------------------------------------------------
# Membership and leader election
# ---------------------------------------------------------------------------


def view(m):
    return (m.alive_peers(), m.suspect_peers(), m.dead_peers())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_test_gossip_membership_cases(pkg):
    mod = jmem if pkg == "jax" else tmem
    m = mod.Membership("p0", alive_expiration_ticks=3)
    m.handle_alive({"id": "p1", "endpoint": "h1:7051", "seq": 1})
    assert m.alive_peers() == ["p1"]
    for _ in range(5):
        m.tick()
    assert m.alive_peers() == [] and m.dead_peers() == ["p1"]
    assert not m.handle_alive({"id": "p1", "seq": 1})
    assert m.handle_alive({"id": "p1", "seq": 2})
    m = mod.Membership("p0")
    assert m.handle_alive({"id": "p1", "seq": 5}) and not m.handle_alive({"id": "p1", "seq": 4})
    assert not m.handle_alive({"id": "p0", "seq": 9})
    m = mod.Membership("p1", alive_expiration_ticks=2)
    el = mod.LeaderElection(m)
    changes = []
    el.on_leadership_change = changes.append
    assert el.evaluate()
    m.handle_alive({"id": "p0", "seq": 1})
    assert not el.evaluate()
    for _ in range(4):
        m.tick()
    assert el.evaluate()
    assert changes == [True, False, True]


def test_suspicion_on_stepped_ticks():
    """TestSuspicion's transitions, the port and the JAX view equal at every
    step (a tick is the membership's clock)."""
    ms = [mod.Membership("me", alive_expiration_ticks=10, suspect_ticks=4) for mod in (jmem, tmem)]

    def both(fn):
        out = [fn(m) for m in ms]
        assert out[0] == out[1]
        assert view(ms[0]) == view(ms[1])
        return out[0]

    both(lambda m: m.handle_alive({"id": "p1", "endpoint": "e1", "seq": 1}))
    for _ in range(5):
        both(lambda m: m.tick())
    assert both(view) == (["p1"], ["p1"], [])
    assert both(lambda m: m.newly_suspect()) == ["p1"]
    assert both(lambda m: m.newly_suspect()) == []
    both(lambda m: m.handle_alive({"id": "p1", "endpoint": "e1", "seq": 2}))
    assert both(lambda m: m.suspect_peers()) == []
    for _ in range(5):
        both(lambda m: m.tick())
    assert both(lambda m: m.newly_suspect()) == ["p1"]
    for _ in range(7):
        both(lambda m: m.tick())
    assert both(view) == ([], [], ["p1"])
    # a stale alive does not refute
    ms = [mod.Membership("me", alive_expiration_ticks=10, suspect_ticks=2) for mod in (jmem, tmem)]
    both(lambda m: m.handle_alive({"id": "p1", "endpoint": "e1", "seq": 5}))
    for _ in range(3):
        both(lambda m: m.tick())
    assert not both(lambda m: m.handle_alive({"id": "p1", "endpoint": "e1", "seq": 5}))
    assert both(lambda m: m.suspect_peers()) == ["p1"]


def test_incarnation_orders_before_sequence():
    """The port's departure from the JAX membership: an alive's freshness is
    (incarnation, sequence), so a restarted peer (a new incarnation, its
    sequence from 1) advances the view at once, alive or expired, and an
    alive of an older incarnation never does. The JAX membership, by the
    sequence alone, drops the restarted peer's alives; so does the port's
    for alives that carry no incarnation."""
    m, j = tmem.Membership("me", alive_expiration_ticks=3), jmem.Membership("me")
    assert m.handle_alive({"id": "p1", "endpoint": "old", "seq": 50, "inc": 7})
    assert j.handle_alive({"id": "p1", "endpoint": "old", "seq": 50})
    assert not m.is_fresh("p1", 50, 7) and not m.handle_alive({"id": "p1", "seq": 3, "inc": 7})
    assert m.is_fresh("p1", 1, 8)
    assert m.handle_alive({"id": "p1", "endpoint": "new", "seq": 1, "inc": 8})
    assert not j.handle_alive({"id": "p1", "endpoint": "new", "seq": 1})
    assert m.endpoint_of("p1") == "new" and j.endpoint_of("p1") == "old"
    assert not m.is_fresh("p1", 99, 7) and not m.handle_alive({"id": "p1", "seq": 99, "inc": 7})
    assert m.endpoint_of("p1") == "new"
    for _ in range(5):
        m.tick()
    assert m.dead_peers() == ["p1"]
    assert m.handle_alive({"id": "p1", "endpoint": "again", "seq": 1, "inc": 9})
    assert m.alive_peers() == ["p1"] and m.endpoint_of("p1") == "again"
    bare = tmem.Membership("me")
    assert bare.handle_alive({"id": "p1", "seq": 50})
    assert not bare.handle_alive({"id": "p1", "seq": 1})
    assert tmem.Membership("me", incarnation=5).incarnation == 5


@pytest.mark.parametrize("seed", range(6))
def test_membership_and_election_lockstep(seed):
    rng = random.Random(seed)
    ms = [mod.Membership("p3", endpoint="e3", alive_expiration_ticks=rng.randrange(2, 12),
                         metadata=b"m", suspect_ticks=rng.choice([None, 1, 3]))
          for mod in (jmem, tmem)]
    ms[1].expiration, ms[1].suspect_ticks = ms[0].expiration, ms[0].suspect_ticks
    els = [mod.LeaderElection(m) for mod, m in zip((jmem, tmem), ms)]
    changes = [[], []]
    for el, ch in zip(els, changes):
        el.on_leadership_change = ch.append
    for _ in range(400):
        op = rng.random()
        if op < 0.45:
            msg = {"id": f"p{rng.randrange(6)}", "endpoint": f"e{rng.randrange(3)}",
                   "seq": rng.randrange(30), "metadata": bytes([rng.randrange(4)])}
            # the port's is_fresh foretells whether the alive advances the view
            fresh = ms[1].is_fresh(msg["id"], msg["seq"])
            got = [m.handle_alive(dict(msg)) for m in ms]
            assert fresh == got[0]
        elif op < 0.7:
            got = [m.tick() for m in ms]
        elif op < 0.8:
            got = [m.bump_seq() for m in ms]
        elif op < 0.9:
            got = [m.newly_suspect() for m in ms]
        else:
            got = [(el.evaluate(), el.leader, el.is_leader) for el in els]
        assert got[0] == got[1]
        assert view(ms[0]) == view(ms[1])
        pid = f"p{rng.randrange(6)}"
        assert ms[0].endpoint_of(pid) == ms[1].endpoint_of(pid)
        assert ms[0].metadata_of(pid) == ms[1].metadata_of(pid)
    assert changes[0] == changes[1]


# ---------------------------------------------------------------------------
# State transfer
# ---------------------------------------------------------------------------


def providers(commits, height, fail_at=None, **kw):
    """A JAX and a port StateProvider over one height; each appends its
    commits' numbers to commits[pkg] (raising at block `fail_at`)."""
    out = []
    for pkg, mod in (("jax", jstate), ("port", tstate)):
        def commit(block, pkg=pkg):
            if fail_at is not None and number(block) == fail_at:
                raise RuntimeError("vscc failure")
            commits[pkg].append(raw_of(block))

        out.append(mod.StateProvider("ch", commit, height, **kw))
    return out


def test_test_gossip_state_cases():
    commits = {"jax": [], "port": []}
    h = {"v": 0}
    sps = providers(commits, lambda: h["v"])
    for sp, conv in zip(sps, (jblock, tblock)):
        sp.add_payload(conv(block_raw(2)))
        sp.add_payload(conv(block_raw(0)))
        assert sp.deliver_payloads() == 1
        sp.add_payload(conv(block_raw(1)))
        assert sp.deliver_payloads() == 2
    assert commits["jax"] == commits["port"] == [block_raw(n) for n in (0, 1, 2)]
    for mod, conv in ((jstate, jblock), (tstate, tblock)):
        sp = mod.StateProvider("ch", lambda b: None, lambda: 5)
        assert not sp.add_payload(conv(block_raw(3)))
        assert sp.add_payload(conv(block_raw(7)))
        assert not sp.add_payload(conv(block_raw(7)))
        assert sp.buffer.dropped == 2
        sp = mod.StateProvider("ch", lambda b: None, lambda: 0, max_block_dist=10)
        assert not sp.add_payload(conv(block_raw(50)))
        assert sp.add_payload(conv(block_raw(50)), from_gossip=False)

        def boom(block):
            raise RuntimeError("vscc failure")

        sp = mod.StateProvider("ch", boom, lambda: 0)
        sp.add_payload(conv(block_raw(0)))
        for _ in range(2):
            with pytest.raises(mod.CommitFailure):
                sp.deliver_payloads()
        assert sp.failed
        # anti-entropy
        got = []
        sp = mod.StateProvider("ch", got.append, lambda: 0)
        rng = sp.missing_range([4, 2])
        assert rng == range(0, 4)
        tall = mod.StateProvider("ch", lambda b: None, lambda: 4)
        served = tall.handle_state_request(0, 4, lambda n: conv(block_raw(n)))
        assert [number(b) for b in served] == [0, 1, 2, 3]
        assert sp.handle_state_response(served) == 4
        assert sp.missing_range([4]) is None
        assert len(sp.handle_state_request(0, 1000, lambda n: conv(block_raw(n)),
                                           max_blocks=10)) == 10


@pytest.mark.parametrize("seed", range(6))
def test_state_provider_lockstep(seed):
    """Seeded ingest from gossip and from state responses, drains, ledger
    height moving under the buffer (a deliver client committing directly),
    missing ranges, a commit failure: results, drops and commits equal."""
    rng = random.Random(seed)
    commits = {"jax": [], "port": []}
    h = {"v": 0}
    fail_at = rng.choice([None, 25, 40])
    sps = providers(commits, lambda: h["v"] + len(commits["jax"]), fail_at=fail_at,
                    max_block_dist=rng.randrange(3, 12))
    # the two providers share the height of the JAX commits: keep both
    # committed lists in step by driving the port one with its own height
    sps[1]._height = lambda: h["v"] + len(commits["port"])
    for _ in range(300):
        op = rng.random()
        n = rng.randrange(0, 50)
        if op < 0.45:
            fg = rng.random() < 0.8
            got = [sp.add_payload(conv(block_raw(n)), from_gossip=fg)
                   for sp, conv in zip(sps, (jblock, tblock))]
        elif op < 0.7:
            got = []
            for sp, mod in zip(sps, (jstate, tstate)):
                try:
                    got.append(("ok", sp.deliver_payloads()))
                except mod.CommitFailure as e:
                    got.append(("fail", str(e)))
        elif op < 0.8:
            heights = [rng.randrange(0, 60) for _ in range(rng.randrange(0, 3))]
            got = [sp.missing_range(heights) for sp in sps]
        elif op < 0.9:
            end, cap = n + rng.randrange(0, 8), rng.randrange(1, 5)
            got = [[raw_of(b) for b in sp.handle_state_request(
                n, end, lambda k, conv=conv: conv(block_raw(k)) if k < 30 else None,
                max_blocks=cap)] for sp, conv in zip(sps, (jblock, tblock))]
        else:
            h["v"] += rng.randrange(0, 3)
            got = [None, None]
        assert got[0] == got[1]
        assert (sps[0].buffer.next_seq, len(sps[0].buffer), sps[0].buffer.dropped,
                sps[0].failed) == (sps[1].buffer.next_seq, len(sps[1].buffer),
                                   sps[1].buffer.dropped, sps[1].failed)
        assert commits["jax"] == commits["port"]


# ---------------------------------------------------------------------------
# Pull rounds
# ---------------------------------------------------------------------------


class Side:
    """One node's pull state in both packages: certstores and mediators
    over a ledger of `height` blocks, the JAX mediator's generator seeded
    as the port's."""

    def __init__(self, name, height, seed, verify=None):
        self.ledger = [block_raw(n) for n in range(height)]
        self.added = {"jax": [], "port": []}
        self.stores = [mod.CertStore(name, f"id-{name}".encode(), verify)
                       for mod in (jpull, tpull)]
        self.jm = jpull.PullMediator("ch", self.stores[0], get_block=self.get(jblock),
                                     height=lambda: len(self.ledger),
                                     add_block=lambda b: self.added["jax"].append(raw_of(b)))
        self.jm._rng = random.Random(seed)
        self.tm = tpull.PullMediator("ch", self.stores[1], get_block=self.get(tblock),
                                     height=lambda: len(self.ledger),
                                     add_block=lambda b: self.added["port"].append(raw_of(b)),
                                     rng=random.Random(seed))

    def get(self, conv):
        return lambda n: conv(self.ledger[n]) if n < len(self.ledger) else None

    def handle(self, raw):
        """The same message to both mediators: the replies' bytes, equal."""
        jr = pb_bytes(self.jm.handle(as_jax(raw)))
        tr = pb_bytes(self.tm.handle(as_port(raw)))
        assert jr == tr
        return jr


@pytest.mark.parametrize("seed", range(4))
def test_pull_rounds_lockstep(seed):
    """Block and identity rounds between a requester and a responder, each
    message passed to both packages' mediators: every hello, digest,
    request and update equal byte for byte, the same blocks added and the
    same identities stored."""
    rng = random.Random(seed)
    req = Side("req", rng.randrange(0, 4), seed)
    resp = Side("resp", rng.randrange(4, 25), seed + 100)
    for i in range(rng.randrange(0, 4)):
        for s in resp.stores:
            s.put(f"p{i}".encode(), f"id-p{i}".encode())
    for r in range(6):
        msg_type = (tpull.PULL_BLOCK, tpull.PULL_IDENTITY)[r % 2]
        hello = pb_bytes(req.jm.hello(msg_type))
        assert pb_bytes(req.tm.hello(msg_type)) == hello
        msg, at = hello, resp
        for _ in range(4):
            if msg is None:
                break
            msg = at.handle(msg)
            at = req if at is resp else resp
    assert req.added["jax"] == req.added["port"]
    assert req.stores[0].digests() == req.stores[1].digests()
    assert req.stores[0]._store == req.stores[1]._store
    if len(resp.ledger) > len(req.ledger):
        assert req.added["port"], "no block moved"


def test_pull_handles_every_kind_alike():
    """Seeded messages of every kind and type, garbage digests included,
    handled by both mediators: replies equal."""
    rng = random.Random(5)
    side = Side("x", 12, 1)
    for s in side.stores:
        s.put(b"q", b"id-q")
    items = [wire.encode(gossip.GOSSIP_MESSAGE, {"channel": "ch", "peer_identity": {
        "pki_id": b"z", "cert": b"id-z"}}),
        wire.encode(gossip.GOSSIP_MESSAGE, {"channel": "ch", "data_msg": {
            "seq_num": 3, "block": block_raw(3)}}),
        wire.encode(gossip.GOSSIP_MESSAGE, {"channel": "ch", "hello": {}})]
    for _ in range(300):
        kind = rng.choice(["hello", "data_dig", "data_req", "data_update", "peer_identity"])
        body = {"nonce": rng.randrange(2 ** 63), "msg_type": rng.choice([0, 1, 2, 3])}
        if kind == "hello":
            body.pop("msg_type") if rng.random() < 0.1 else None
        elif kind in ("data_dig", "data_req"):
            body["digests"] = [rng.choice([b"3", b"11", b"40", b"x1", b"q", b"z", b"", b"-1"])
                               for _ in range(rng.randrange(0, 5))]
        elif kind == "data_update":
            body["data"] = rng.sample(items, rng.randrange(0, 3))
        else:
            body = {"pki_id": rng.choice([b"q", b"w"]), "cert": rng.choice([b"id-q", b"c"])}
        side.handle(wire.encode(gossip.GOSSIP_MESSAGE, {"channel": "ch", kind: body}))
    assert side.stores[0]._store == side.stores[1]._store
    assert side.added["jax"] == side.added["port"]


def test_certstore_first_bind_and_verify_alike():
    for mod in (jpull, tpull):
        s = mod.CertStore("me", b"id-me", verify=lambda pki, ident: ident.startswith(b"id-"))
        assert s.put(b"a", b"id-a") and s.put(b"a", b"id-a")
        assert not s.put(b"a", b"id-b")  # first bind wins
        assert not s.put(b"c", b"bad")  # the verify hook refuses
        assert s.get(b"a") == b"id-a" and s.get(b"c") is None
        assert s.digests() == [b"a", b"me"]
        assert s.missing([b"a", b"c", b"me"]) == [b"c"]


# ---------------------------------------------------------------------------
# Private data
# ---------------------------------------------------------------------------


def _signing_bytes_pair(req_dict, channel):
    """Both packages' signing bytes of one RemotePvtDataRequest."""
    raw = wire.encode(gossip.REMOTE_PVT_DATA_REQUEST, req_dict)
    pb = gossip_pb2.RemotePvtDataRequest.FromString(raw)
    return (jpvt._request_signing_bytes(pb, channel),
            tpvt._request_signing_bytes(wire.decode(gossip.REMOTE_PVT_DATA_REQUEST, raw,
                                                    keep_unknown=True), channel))


@pytest.mark.parametrize("seed", range(3))
def test_request_signing_bytes_equal(seed):
    rng = random.Random(seed)
    for _ in range(50):
        req = _rand_message(gossip.REMOTE_PVT_DATA_REQUEST, rng)
        j, t = _signing_bytes_pair(req, rng.choice(["ch", "", "é"]))
        assert j == t
    # a digest with an unknown field signs as protobuf carries it
    digest = bytes.fromhex("12026363") + bytes.fromhex("f00105")
    raw = b"\x0a" + bytes([len(digest)]) + digest + b"\x12\x01p"
    pb = gossip_pb2.RemotePvtDataRequest.FromString(raw)
    assert jpvt._request_signing_bytes(pb, "ch") == tpvt._request_signing_bytes(
        wire.decode(gossip.REMOTE_PVT_DATA_REQUEST, raw, keep_unknown=True), "ch")


class PvtWorld:
    """A serving PvtDataHandler of each package over one data set: requester
    identities by pki_id, the stand-in signature (sha256(identity || data)),
    eligibility by (collection, identity)."""

    IDS = {b"r1": b"id-r1", b"r2": b"id-r2"}
    DATA = {(3, 0, "cc", "a"): b"pvt-a", (3, 1, "cc", "b"): b"pvt-b", (4, 0, "cc", "a"): b"pvt-a4"}

    def __init__(self, eligible=True):
        import hashlib

        self.calls = {"jax": [], "port": []}
        self.handlers = []
        for pkg, mod, cm in (("jax", jpvt, jcoord), ("port", tpvt, tcoord)):
            def elig(ns, coll, ident, pkg=pkg):
                self.calls[pkg].append((ns, coll, ident))
                return (coll, ident) in {("a", b"id-r1"), ("a", b"id-r2"), ("b", b"id-r2")}

            self.handlers.append(mod.PvtDataHandler(
                "ch", cm.TransientStore(),
                lambda b, t, ns, coll: self.DATA.get((b, t, ns, coll)),
                serve_policy=lambda ns, coll: coll != "z",
                resolve_identity=self.IDS.get,
                verify_member_sig=lambda ident, data, sig: hashlib.sha256(
                    ident + data).digest() == sig,
                requester_eligible=elig if eligible else None))

    @staticmethod
    def sign(pki, data):
        import hashlib

        return hashlib.sha256(PvtWorld.IDS.get(pki, b"?") + data).digest()

    def handle(self, raw):
        jr = pb_bytes(self.handlers[0].handle(as_jax(raw)))
        tr = pb_bytes(self.handlers[1].handle(as_port(raw)))
        assert jr == tr
        return jr


@pytest.mark.parametrize("seed", range(3))
def test_pvt_requests_replay_and_eligibility_alike(seed):
    """Seeded RemotePvtDataRequests, rightly or wrongly signed, replayed,
    unsigned, from unknown pki_ids, for served, refused and unknown
    collections: both handlers answer the same bytes, ask the same
    eligibility questions, and fill the same transient stores."""
    rng = random.Random(seed)
    world = PvtWorld(eligible=seed != 2)
    sent = []
    for i in range(120):
        op = rng.random()
        if op < 0.15 and sent:
            raw = rng.choice(sent)  # a replay
        elif op < 0.25:
            raw = wire.encode(gossip.GOSSIP_MESSAGE, {"channel": rng.choice(["ch", "other"]),
                                                     "private_data": {"payload": {
                                                         "tx_id": f"t{i % 4}", "namespace": "cc",
                                                         "collection_name": "a",
                                                         "private_rwset": bytes([i])}}})
        else:
            digests = [{"namespace": "cc", "collection": rng.choice(["a", "b", "z"]),
                        "block_seq": rng.choice([3, 4, 5]), "seq_in_block": rng.choice([0, 1])}
                       for _ in range(rng.randrange(0, 4))]
            pki = rng.choice([b"r1", b"r2", b"r9", b""])
            req = {"digests": digests, "pki_id": pki,
                   "nonce": rng.choice([b"", bytes([rng.randrange(256)]) * 24])}
            sig = PvtWorld.sign(pki, tpvt._request_signing_bytes(req, "ch"))
            if rng.random() < 0.2:
                sig = sig[:-1] + bytes([sig[-1] ^ 1])
            if rng.random() > 0.1:
                req["signature"] = sig
            raw = wire.encode(gossip.GOSSIP_MESSAGE, {"channel": "ch", "private_req": req})
            sent.append(raw)
        world.handle(raw)
    assert world.calls["jax"] == world.calls["port"]
    assert world.handlers[0].transient._by_txid == world.handlers[1].transient._by_txid
    assert list(world.handlers[0]._seen_nonces) == list(world.handlers[1]._seen_nonces)


def test_dissemination_and_reconcile_messages_equal(monkeypatch):
    """dissemination_messages, reconcile_request (one nonce for both: the
    JAX module's `secrets.token_bytes` and the port's new_nonce) and
    reconcile_response_entries, byte for byte."""
    import secrets

    nonce = bytes(range(24))
    monkeypatch.setattr(secrets, "token_bytes", lambda n: nonce[:n])
    sign = lambda data: b"sig:" + data[:8]  # noqa: E731
    j = jpvt.PvtDataHandler("ch", jcoord.TransientStore(), lambda *a: None,
                            self_pki_id=b"me", sign_request=sign)
    t = tpvt.PvtDataHandler("ch", tcoord.TransientStore(), lambda *a: None,
                            self_pki_id=b"me", sign_request=sign, new_nonce=lambda: nonce)
    writes = [("cc", "a", b"w1"), ("cc", "b", b""), ("", "", b"\x00")]
    assert [pb_bytes(m) for m in j.dissemination_messages("tx", writes)] == [
        pb_bytes(m) for m in t.dissemination_messages("tx", writes)]
    missing_j = {4: [JMissing(1, "cc", "a"), JMissing(0, "cc", "b", eligible=False)],
                 2: [JMissing(7, "cc", "c")]}
    missing_t = {4: [TMissing(1, "cc", "a"), TMissing(0, "cc", "b", eligible=False)],
                 2: [TMissing(7, "cc", "c")]}
    jr, tr = j.reconcile_request(missing_j), t.reconcile_request(missing_t)
    assert pb_bytes(jr) == pb_bytes(tr)
    assert j.reconcile_request({1: [JMissing(0, "c", "d", False)]}) is None
    assert t.reconcile_request({1: [TMissing(0, "c", "d", False)]}) is None
    # an unsigned handler's request carries no pki_id, nonce or signature
    ju = jpvt.PvtDataHandler("ch", None, lambda *a: None)
    tu = tpvt.PvtDataHandler("ch", None, lambda *a: None)
    assert pb_bytes(ju.reconcile_request(missing_j)) == pb_bytes(tu.reconcile_request(missing_t))
    resp = wire.encode(gossip.GOSSIP_MESSAGE, {"channel": "ch", "private_res": {"elements": [
        {"digest": {"namespace": "cc", "collection": "a", "block_seq": 4, "seq_in_block": 1},
         "payload": b"p"}, {"digest": {}}, {}]}})
    assert jpvt.reconcile_response_entries(as_jax(resp)) == tpvt.reconcile_response_entries(
        as_port(resp))


# ---------------------------------------------------------------------------
# The coordinator and the transient store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_test_gossip_coordinator_cases(pkg):
    mod, conv = (jcoord, jblock) if pkg == "jax" else (tcoord, tblock)
    store = mod.TransientStore()
    store.persist("tx0", "cc", "collA", b"pvt-A")
    key_a, key_b = mod.PvtKey(0, "cc", "collA"), mod.PvtKey(0, "cc", "collB")
    fetched = {key_b: b"pvt-B"}
    commits = []
    coord = mod.Coordinator(
        "ch", validate=lambda b: "FLAGS", commit=lambda b, pvt: commits.append(pvt) or "OK",
        transient=store, fetch_from_peers=lambda keys: {k: fetched[k] for k in keys if k in fetched},
        pvt_requirements=lambda b, f: [mod.PvtDataRequirement("tx0", [key_a, key_b])])
    assert coord.store_block(conv(block_raw(0))) == "OK"
    assert commits[0] == {key_a: b"pvt-A", key_b: b"pvt-B"}
    assert not coord.missing and store.get("tx0", "cc", "collA") is None
    key = mod.PvtKey(0, "cc", "collX")
    coord = mod.Coordinator("ch", validate=lambda b: "FLAGS", commit=lambda b, pvt: None,
                            fetch_from_peers=lambda keys: {},
                            pvt_requirements=lambda b, f: [mod.PvtDataRequirement("t", [key])],
                            pull_retries=2)
    assert coord.store_block(conv(block_raw(0))) == "FLAGS"
    assert key in coord.missing
    coord._fetch = lambda keys: {key: b"late"}
    recovered = []
    assert coord.reconcile(lambda k, d: recovered.append((k, d))) == 1
    assert recovered == [(key, b"late")] and not coord.missing


@pytest.mark.parametrize("seed", range(3))
def test_coordinator_and_transient_lockstep(seed):
    """Seeded blocks with private-data requirements, transient writes and
    purges, peer fetches that succeed on some retries, reconciliation: the
    assembled data, the missing keys, fetch calls and stores equal."""
    rng = random.Random(seed)
    worlds = []
    for mod in (jcoord, tcoord):
        w = {"mod": mod, "commits": [], "fetches": [], "store": mod.TransientStore()}
        frng = random.Random(seed + 1000)

        def fetch(keys, w=w, frng=frng):
            w["fetches"].append([(k.tx_index, k.namespace, k.collection) for k in keys])
            return {k: b"peer-" + k.collection.encode() for k in keys if frng.random() < 0.4}

        reqs = {}

        def requirements(block, flags, reqs=reqs, mod=mod):
            return [mod.PvtDataRequirement(txid, [mod.PvtKey(*k) for k in keys])
                    for txid, keys in reqs[number(block)]]

        w["reqs"] = reqs
        w["coord"] = mod.Coordinator("ch", validate=lambda b: "F",
                                     commit=lambda b, pvt, w=w: w["commits"].append(
                                         sorted((k.tx_index, k.namespace, k.collection, v)
                                                for k, v in pvt.items())),
                                     transient=w["store"], fetch_from_peers=fetch,
                                     pvt_requirements=requirements,
                                     pull_retries=rng.randrange(0, 3))
        worlds.append(w)
    worlds[1]["coord"].pull_retries = worlds[0]["coord"].pull_retries
    for n in range(12):
        reqs = [(f"tx{n}-{i}", [(i, "cc", rng.choice(["a", "b", "c"]))
                                for _ in range(rng.randrange(1, 3))])
                for i in range(rng.randrange(0, 3))]
        writes = [(f"tx{n}-{rng.randrange(3)}", "cc", rng.choice(["a", "b"]), bytes([n]))
                  for _ in range(rng.randrange(0, 4))]
        for w in worlds:
            w["reqs"][n] = reqs
            for wr in writes:
                w["store"].persist(*wr)
            if rng.random() < 0.1:
                w["store"].purge_below_height(n)
            assert w["coord"].store_block(
                (jblock if w["mod"] is jcoord else tblock)(block_raw(n))) == "F"
        if n % 4 == 3:
            got = []
            for w in worlds:
                out = []
                got.append((w["coord"].reconcile(lambda k, d, out=out: out.append(
                    (k.tx_index, k.namespace, k.collection, d))), out))
            assert got[0] == got[1]
        keyset = [sorted((k.tx_index, k.namespace, k.collection) for k in w["coord"].missing)
                  for w in worlds]
        assert keyset[0] == keyset[1]
    assert worlds[0]["commits"] == worlds[1]["commits"]
    assert worlds[0]["fetches"] == worlds[1]["fetches"]
    assert worlds[0]["store"]._by_txid == worlds[1]["store"]._by_txid
