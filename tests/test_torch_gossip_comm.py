"""Mixed gossip networks over loopback gRPC: nodes of the JAX package
(`fabric_tpu.gossip.comm.GossipNode`) and of the port
(`fabric_tpu_torch.gossip.comm.GossipNode`) on one channel, each case run
both ways (`pair` is the (first, second) package of the case's roles).

The ledgers are tests/test_gossip_comm.py's FakeLedger, storing the raw
block bytes: every block a node commits is compared byte for byte with the
chain it came from. The signatures are the JAX tests' stand-in
(sha256(identity || data)), which both packages' nodes call as their
signer and verifier hooks, so the signed bytes of the two packages must be
equal for anything to verify. TLS material is made with the cryptography
package, here in the test only."""

import hashlib
import random
import threading
import time

import pytest
from conftest import requires_crypto
from torch_untraced import untraced  # noqa: F401

from fabric_tpu.common import faults as jfaults
from fabric_tpu.gossip import comm as jcomm
from fabric_tpu.gossip import coordinator as jcoord
from fabric_tpu.gossip import state as jstate
from fabric_tpu.ledger.pvtdatastore import MissingEntry as JMissing
from fabric_tpu.protos import common_pb2, gossip_pb2, protoutil
from fabric_tpu_torch.common import faults as tfaults
from fabric_tpu_torch.gossip import comm as tcomm
from fabric_tpu_torch.gossip import coordinator as tcoord
from fabric_tpu_torch.gossip import state as tstate
from fabric_tpu_torch.ledger.pvtdatastore import MissingEntry as TMissing
from fabric_tpu_torch.protos import fabric, gossip, wire

CHANNEL = "gchannel"
TICK = 0.03
WAIT_S = 20.0
PAIRS = [("jax", "port"), ("port", "jax")]
MOD = {"jax": (jcomm, jstate, jcoord), "port": (tcomm, tstate, tcoord)}


def chain_raws(n):
    """n sealed blocks chained by previous_hash, as raw bytes."""
    raws, prev = [], b""
    for i in range(n):
        b = protoutil.new_block(i, prev)
        b.data.data.append(f"tx{i}".encode())
        protoutil.seal_block(b)
        prev = protoutil.block_header_hash(b.header)
        raws.append(b.SerializeToString())
    return raws


def to_pkg(pkg, raw):
    return common_pb2.Block.FromString(raw) if pkg == "jax" else wire.decode(fabric.BLOCK, raw)


def raw_of(block):
    if isinstance(block, dict):
        return wire.encode(fabric.BLOCK, block)
    return block.SerializeToString()


class FakeLedger:
    """tests/test_gossip_comm.py's FakeLedger in either package's blocks,
    keeping each committed block's bytes."""

    def __init__(self, pkg, raws=()):
        self.pkg = pkg
        self.raws = list(raws)

    def commit(self, block):
        raw = raw_of(block)
        assert to_pkg("port", raw)["header"].get("number", 0) == len(self.raws)
        self.raws.append(raw)

    def get_block(self, n):
        return to_pkg(self.pkg, self.raws[n]) if n < len(self.raws) else None

    @property
    def height(self):
        return len(self.raws)


def as_pkg(pkg, msg):
    """A GossipMessage in `pkg`'s form, through its bytes."""
    raw = msg.SerializeToString() if not isinstance(msg, dict) else wire.encode(
        gossip.GOSSIP_MESSAGE, msg)
    return gossip_pb2.GossipMessage.FromString(raw) if pkg == "jax" else wire.decode(
        gossip.GOSSIP_MESSAGE, raw)


def sig_hooks(identity):
    """The JAX tests' stand-in signer: sha256(identity || data)."""

    def sign(data):
        return hashlib.sha256(identity + data).digest()

    def verify(ident, data, sig):
        return hashlib.sha256(ident + data).digest() == sig

    return sign, verify


def make_node(pkg, name, ledger, seed=0, **kw):
    comm, state, _ = MOD[pkg]
    sp = state.StateProvider(CHANNEL, ledger.commit, lambda: ledger.height)
    if pkg == "port":
        kw.setdefault("rng", random.Random(seed))
    return comm.GossipNode(name, CHANNEL, sp, ledger.get_block, lambda: ledger.height,
                           tick_interval=TICK, **kw)


def wait_until(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


class Net:
    """The nodes of one case, stopped (each port node checked) at the end."""

    def __init__(self):
        self.nodes = []

    def add(self, node, start=True):
        self.nodes.append(node)
        if start:
            node.start()
        return node

    def stop(self):
        for n in self.nodes:
            n.stop()
        for n in self.nodes:
            if isinstance(n, tcomm.GossipNode):
                n.check()


@pytest.fixture
def net():
    n = Net()
    yield n
    n.stop()


def converged(nodes):
    return all(len(n.membership.alive_peers()) == len(nodes) - 1 for n in nodes)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_push_and_forwarding(net, pair):
    """A pushes to every member; one block sent to B alone reaches C only
    through B's forward (C's anti-entropy and pull rounds are off)."""
    a_pkg, b_pkg = pair
    raws = chain_raws(4)
    la, lb, lc = FakeLedger(a_pkg), FakeLedger(b_pkg), FakeLedger(a_pkg)
    a = net.add(make_node(a_pkg, "peerA", la, 1))
    b = net.add(make_node(b_pkg, "peerB", lb, 2))
    c = net.add(make_node(a_pkg, "peerC", lc, 3))
    c.state.missing_range = lambda heights: None
    c.PULL_EVERY = 10 ** 6
    b.connect(a.addr)
    c.connect(b.addr)
    assert wait_until(lambda: converged([a, b, c])), [n.membership.alive_peers() for n in (a, b, c)]
    for raw in raws[:3]:
        la.commit(to_pkg(a_pkg, raw))
        a.broadcast_block(to_pkg(a_pkg, raw))
    assert wait_until(lambda: lb.height == 3 and lc.height == 3), (lb.height, lc.height)
    # block 3 goes to B alone, as A's DataMessage; C gets it forwarded
    la.commit(to_pkg(a_pkg, raws[3]))
    a._send(b.addr, [as_pkg(a_pkg, {"channel": CHANNEL,
                                    "data_msg": {"seq_num": 3, "block": raws[3]}})])
    assert wait_until(lambda: lc.height == 4), lc.height
    assert lb.raws == raws and lc.raws == raws
    if isinstance(b, tcomm.GossipNode):
        assert b.arrivals["push"] >= 4


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("route", ["anti_entropy", "pull"])
def test_late_joiner(net, pair, route):
    """A joiner of the other package catches up from a tall node by state
    transfer alone (its pull rounds off), or by the block pull alone (its
    anti-entropy off, as tests/test_gossip_pull.py turns it off)."""
    tall_pkg, join_pkg = pair
    raws = chain_raws(5)
    tall_l, join_l = FakeLedger(tall_pkg, raws), FakeLedger(join_pkg)
    tall = net.add(make_node(tall_pkg, "tall", tall_l, 1))
    joiner = make_node(join_pkg, "join", join_l, 2)
    if route == "anti_entropy":
        joiner.PULL_EVERY = 10 ** 6
    else:
        joiner._taller_peer_endpoints = lambda needed: []
        joiner.state.missing_range = lambda heights: None
    net.add(joiner)
    joiner.connect(tall.addr)
    assert wait_until(lambda: join_l.height == 5), join_l.height
    assert join_l.raws == raws
    if join_pkg == "port":
        want = {"push": 0, "pull": 0, "state": 5}
        if route == "pull":
            want = {"push": 0, "pull": 5, "state": 0}
        assert joiner.arrivals == want


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_leader_election_converges(net, pair):
    first, second = pair
    nodes = [net.add(make_node(pkg, name, FakeLedger(pkg), i))
             for i, (pkg, name) in enumerate([(second, "peerA"), (first, "peerB"),
                                              (second, "peerC")])]
    for n in nodes[1:]:
        n.connect(nodes[0].addr)
    assert wait_until(lambda: converged(nodes)), [n.membership.alive_peers() for n in nodes]
    assert wait_until(lambda: [n.is_leader for n in nodes] == [True, False, False])


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_certstore_identity_pull(net, pair):
    """Every node ends up holding every identity, also those of nodes it
    never connected to, through the Hello/Digest/Request/Update rounds."""
    first, second = pair
    pkgs = [first, second, first]
    nodes = [net.add(make_node(pkg, f"p{i}", FakeLedger(pkg), i,
                               identity_bytes=f"identity-of-p{i}".encode()))
             for i, pkg in enumerate(pkgs)]
    nodes[1].connect(nodes[0].addr)
    nodes[2].connect(nodes[0].addr)
    assert wait_until(lambda: all(n.certstore.get(f"p{i}".encode()) == f"identity-of-p{i}".encode()
                                  for n in nodes for i in range(3))), [
        (n.self_id, n.certstore.digests()) for n in nodes]


def _alive(pkg, pki, endpoint, seq, sign=None, flip=False):
    """An alive message in `pkg`'s form, signed with `sign` over the
    package's own signing bytes (a flipped last byte with `flip`)."""
    comm = MOD[pkg][0]
    if pkg == "jax":
        msg = gossip_pb2.GossipMessage(channel=CHANNEL)
        msg.alive_msg.membership.pki_id = pki
        msg.alive_msg.membership.endpoint = endpoint
        msg.alive_msg.membership.ledger_height = 5
        msg.alive_msg.seq_num = seq
        if sign is not None:
            sig = sign(comm._alive_signing_bytes(msg.alive_msg, CHANNEL))
            msg.alive_msg.signature = sig[:-1] + bytes([sig[-1] ^ flip])
        return msg
    alive = {"membership": {"endpoint": endpoint, "pki_id": pki, "ledger_height": 5},
             "seq_num": seq}
    if sign is not None:
        sig = sign(comm._alive_signing_bytes(alive, CHANNEL))
        alive["signature"] = sig[:-1] + bytes([sig[-1] ^ flip])
    return {"channel": CHANNEL, "alive_msg": alive}


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_signed_alives(net, pair):
    """Strict nodes of both packages adopt each other's signed alives; an
    alive sent over the wire with a flipped signature, one signed by
    another identity, and an unsigned one are refused."""
    a_pkg, b_pkg = pair
    hooks = {n: sig_hooks(f"identity-{n}".encode()) for n in ("A", "B", "R")}
    a = net.add(make_node(a_pkg, "A", FakeLedger(a_pkg), 1, identity_bytes=b"identity-A",
                          sign_message=hooks["A"][0], pvt_verify_member_sig=hooks["A"][1],
                          require_signed_alive=True))
    b = net.add(make_node(b_pkg, "B", FakeLedger(b_pkg), 2, identity_bytes=b"identity-B",
                          sign_message=hooks["B"][0], pvt_verify_member_sig=hooks["B"][1],
                          require_signed_alive=True))
    b.connect(a.addr)
    assert wait_until(lambda: converged([a, b]))
    assert b.certstore.get(b"A") == b"identity-A" and a.certstore.get(b"B") == b"identity-B"
    b.certstore.put(b"R", b"identity-R")
    forged = [_alive(a_pkg, b"A", "evil:1", 10 ** 6, hooks["A"][0], flip=1),
              _alive(a_pkg, b"A", "evil:2", 10 ** 6 + 1, hooks["R"][0]),
              _alive(a_pkg, b"R", "evil:3", 1),
              _alive(a_pkg, b"R", "evil:4", 2, hooks["R"][0], flip=1),
              _alive(a_pkg, b"ghost", "evil:5", 1, hooks["R"][0])]
    a._send(b.addr, forged)
    time.sleep(5 * TICK)
    assert "R" not in b.membership.alive_peers() and "ghost" not in b.membership.alive_peers()
    assert b._endpoints["A"] == a.addr
    # the same alive, rightly signed by R, is adopted
    a._send(b.addr, [_alive(a_pkg, b"R", "r:1", 3, hooks["R"][0])])
    assert wait_until(lambda: "R" in b.membership.alive_peers())


def _org_tls():
    from fabric_tpu.msp.cryptogen import OrgCA

    ca = OrgCA("org1.tls.test", "Org1MSP")
    return ca.enroll_tls("peer0.org1.tls.test"), ca.enroll_tls("peer1.org1.tls.test")


def _tls_pair(net, tall_pkg, join_pkg, pair_a, pair_b, claim_der=None):
    """tests/test_gossip_pull.py's _tls_nodes over either package: a strict
    mTLS node `tall` with two blocks and a joiner presenting pair_b whose
    handshake claims `claim_der` (its own certificate by default)."""
    sign_a, verify = sig_hooks(b"identity-tall")
    tall_comm = MOD[tall_pkg][0]
    creds = __import__(f"{tall_comm.__name__.rsplit('.', 2)[0]}.comm.server",
                       fromlist=["tls_server_credentials"]).tls_server_credentials(
        pair_a.cert_pem, pair_a.key_pem, client_ca_pem=pair_a.ca_pem)
    tall = make_node(tall_pkg, "tall", FakeLedger(tall_pkg, chain_raws(2)), 1,
                     identity_bytes=b"identity-tall", sign_message=sign_a,
                     pvt_verify_member_sig=verify, tls_server_creds=creds,
                     tls_client=(pair_a.ca_pem, (pair_a.key_pem, pair_a.cert_pem)),
                     self_tls_cert_der=pair_a.cert_der, require_handshake=True)
    sign_b, _ = sig_hooks(b"identity-join")
    jl = FakeLedger(join_pkg)
    joiner = make_node(join_pkg, "join", jl, 2, identity_bytes=b"identity-join",
                       sign_message=sign_b, pvt_verify_member_sig=verify,
                       tls_client=(pair_a.ca_pem, (pair_b.key_pem, pair_b.cert_pem)),
                       self_tls_cert_der=claim_der or pair_b.cert_der, require_handshake=True)
    net.add(tall)
    net.add(joiner)
    return tall, joiner, jl


@pytest.fixture(scope="module")
def tls_pairs():
    return _org_tls()


@requires_crypto
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("case", ["right_cert", "wrong_cert", "spoofed_pki_id", "no_handshake"])
def test_mtls_handshake(net, pair, case, tls_pairs):
    """The right certificate is served; a handshake binding another
    certificate's hash, one under another peer's pki_id, and a stream with
    no handshake are refused, whichever package serves."""
    pair_a, pair_b = tls_pairs
    tall_pkg, join_pkg = pair
    tall, joiner, jl = _tls_pair(net, tall_pkg, join_pkg, pair_a, pair_b,
                                 claim_der=pair_a.cert_der if case == "wrong_cert" else None)
    if case == "spoofed_pki_id":
        # the binding authority: a pki_id must match its identity
        tall.certstore._verify = lambda pki, ident: ident == b"identity-" + pki
        joiner.self_id = "victim"
        joiner.certstore._store[b"victim"] = b"identity-join"
        joiner._conn_msg_cache = None
    if case == "no_handshake":
        joiner._require_handshake = False
        joiner._self_tls_cert_der = b""
    joiner._send(tall.addr, [joiner.pull.hello_blocks()])
    if case == "right_cert":
        assert wait_until(lambda: jl.height == 2), jl.height
        assert jl.raws == chain_raws(2)
    else:
        time.sleep(0.5)
        assert jl.height == 0
        if case == "spoofed_pki_id":
            assert tall.certstore.get(b"victim") is None


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_dropped_bootstrap_hello_recovers(net, pair):
    """The joiner's first stream open is dropped by its package's fault
    plan; the tick loop's anchor redial heals the pair."""
    anchor_pkg, join_pkg = pair
    a = net.add(make_node(anchor_pkg, "a1", FakeLedger(anchor_pkg), 1))
    b = net.add(make_node(join_pkg, "a2", FakeLedger(join_pkg), 2))
    faults = jfaults if join_pkg == "jax" else tfaults
    plan = faults.FaultPlan.parse("gossip.comm.send=drop:1.0:max=1", seed=7)
    with faults.plan_installed(plan):
        b.connect(a.addr)
        assert plan.fired().get("gossip.comm.send", 0) == 1
        assert wait_until(lambda: converged([a, b]))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_pvt_dissemination_and_reconciliation(net, pair, monkeypatch):
    """Endorsement-time private data lands in the other package's transient
    store; the reconciler's signed request is served only the collections
    its requester is eligible for, and a replayed request nothing."""
    serve_pkg, req_pkg = pair
    ts, tr = MOD[serve_pkg][2].TransientStore(), MOD[req_pkg][2].TransientStore()
    served = {("secret", 3): b"pvt-secret", ("other", 3): b"pvt-other"}
    sign_r, verify = sig_hooks(b"id-req")
    eligibility = []

    def eligible(ns, coll, identity):
        eligibility.append((ns, coll, identity))
        return coll == "secret" and identity == b"id-req"

    server = net.add(make_node(serve_pkg, "srv", FakeLedger(serve_pkg), 1, identity_bytes=b"id-srv",
                               transient_store=ts,
                               pvt_reader=lambda b, t, ns, coll: served.get((coll, b)),
                               pvt_verify_member_sig=verify, pvt_requester_eligible=eligible))
    requester = make_node(req_pkg, "req", FakeLedger(req_pkg), 2, identity_bytes=b"id-req",
                          transient_store=tr, pvt_sign_request=sign_r)
    missing_cls = JMissing if req_pkg == "jax" else TMissing
    missing = {3: [missing_cls(0, "mycc", "secret"), missing_cls(0, "mycc", "other")]}
    reconciled, requests = [], []

    def reconcile_commit(items):
        reconciled.extend(items)
        missing[3] = [m for m in missing[3] if m.collection != "secret"]

    requester.enable_reconciliation(lambda: {k: list(v) for k, v in missing.items() if v},
                                    reconcile_commit)
    pvt_handle = requester.pvt.reconcile_request

    def keep_request(m):
        req = pvt_handle(m)
        if req is not None:
            requests.append(req)
        return req

    requester.pvt.reconcile_request = keep_request
    net.add(requester)
    requester.connect(server.addr)
    assert wait_until(lambda: converged([server, requester]))
    server.disseminate_pvt("tx42", [("mycc", "secret", b"cleartext-writes")])
    assert wait_until(lambda: tr.get("tx42", "mycc", "secret") == b"cleartext-writes")
    assert wait_until(lambda: reconciled != [])
    assert reconciled == [(3, 0, "mycc", "secret", b"pvt-secret")]
    assert ("mycc", "other", b"id-req") in eligibility
    # a replay of the first request is served nothing
    assert server._handle(as_pkg(serve_pkg, requests[0])) is None

RESTART_SEQ = 60  # the restarted node's sequence before it stops


@pytest.mark.parametrize("observer,restarted", [("port", "port"), ("jax", "port"),
                                                ("port", "jax")])
def test_restarted_node(net, observer, restarted):
    """A node that stops and starts again under its id, at a new endpoint,
    its sequence from 1. A port node's alives carry a new incarnation, and a
    port observer takes them at once, while the new sequence is far below
    the old one. A JAX observer judges by the sequence alone and takes the
    restarted node only once its sequence passes the old one; so does a
    port observer for a restarted JAX node, whose alives carry no
    incarnation."""
    o = net.add(make_node(observer, "O", FakeLedger(observer), 1))
    r = net.add(make_node(restarted, "R", FakeLedger(restarted), 2))
    r.connect(o.addr)
    assert wait_until(lambda: o.membership.endpoint_of("R") == r.addr
                      and o.membership._alive["R"].seq >= RESTART_SEQ)
    r.stop()
    old_seq = o.membership._alive["R"].seq
    r2 = net.add(make_node(restarted, "R", FakeLedger(restarted), 3))
    r2.connect(o.addr)
    assert wait_until(lambda: o.membership.endpoint_of("R") == r2.addr)
    with o.membership._lock:
        taken = o.membership._alive["R"].seq
    if (observer, restarted) == ("port", "port"):
        assert taken < old_seq // 2
        assert o.membership._alive["R"].inc == r2.membership.incarnation > r.membership.incarnation
    else:
        assert taken > old_seq


@pytest.mark.parametrize("peer_pkg", ["jax", "port"])
def test_stop_reaps_every_thread(peer_pkg):
    """After stop() no thread the port node started is alive: the tick
    loop, its send threads and its server's workers, whether it gossiped
    with a JAX node or a port node (both stopped; the peer's server pool,
    which a JAX node leaves running, is not the port node's)."""
    lb = FakeLedger(peer_pkg, chain_raws(3))
    b = make_node(peer_pkg, "reapB", lb, 2)
    b.start()
    before = set(threading.enumerate())
    la = FakeLedger("port")
    a = make_node("port", "reapA", la, 1)
    a.start()
    try:
        a.connect(b.addr)
        assert wait_until(lambda: la.height == 3 and converged([a, b]))
        for raw in chain_raws(4)[3:]:
            lb.commit(to_pkg(peer_pkg, raw))
            b.broadcast_block(to_pkg(peer_pkg, raw))
        assert wait_until(lambda: la.height == 4)
    finally:
        a.stop()
        b.stop()
    peer_threads = set(b.server._server._state.thread_pool._threads)
    if peer_pkg == "jax":  # the JAX server's stop returns before its grace ends
        peer_threads |= {t for t in threading.enumerate()
                         if t.name.endswith("(cancel_all_calls_after_grace)")}
    leaked = [t for t in set(threading.enumerate()) - before - peer_threads if t.is_alive()]
    assert leaked == [], leaked
    assert la.raws == chain_raws(4)
    a.check()
