"""The port's gRPC layer (fabric_tpu_torch.comm.{server,services}) against
the JAX package's (fabric_tpu.comm), over loopback gRPC: every client of
each package against every server of each package, for Broadcast, Deliver,
DeliverFiltered, DeliverWithPrivateData, ProcessProposal and the Snapshot
service, each response the same bytes in all four pairings (the servers
wrap each package's own handlers over the same inputs: the real
DeliverHandler over the same blocks, stand-in broadcast handlers, endorsers
and snapshot managers that answer alike). Then the ConcurrencyLimiter's
RESOURCE_EXHAUSTED, and TLS and mutual TLS with certificates made here with
the cryptography package (test code only), the file-backed CertReloader and
tls_credentials_from_config's outcomes."""

import hashlib
import threading

import grpc
import pytest
from conftest import requires_crypto
from torch_untraced import untraced  # noqa: F401

import torch_orderer_world as W
from fabric_tpu.comm import server as jserver
from fabric_tpu.comm import services as jservices
from fabric_tpu.deliver import server as jdeliver
from fabric_tpu.ledger.pvtdatastore import PvtEntry as JPvtEntry
from fabric_tpu.protos import ab_pb2, common_pb2, peer_pb2
from fabric_tpu_torch.comm import server as tserver
from fabric_tpu_torch.comm import services as tservices
from fabric_tpu_torch.deliver import server as tdeliver
from fabric_tpu_torch.ledger.pvtdatastore import PvtEntry
from fabric_tpu_torch.protos import ab, fabric, protoutil, wire

CHANNEL = "ch"
PKGS = ["jax", "port"]
PAIRS = [(c, s) for c in PKGS for s in PKGS]
ids = [f"{c}-client-{s}-server" for c, s in PAIRS]


def chain_raws(n=4, txs=3):
    out, prev = [], b""
    for k in range(n):
        block = protoutil.new_block(k, prev)
        block["data"]["data"] = [W.envelope(None, CHANNEL, b"tx-%d-%d" % (k, j))
                                 for j in range(txs)]
        if k % 2:
            block["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER] = bytes(
                (k + j) % 3 for j in range(txs))
        protoutil.seal_block(block)
        prev = protoutil.block_header_hash(block["header"])
        out.append(wire.encode(fabric.BLOCK, block))
    return out


RAWS = chain_raws()
PVT = {1: [(0, "cc", "a", b"\x0a\x02"), (2, "cc", "b", b"")], 3: [(1, "cc", "a", b"x")]}


def seek_raw(start, stop, channel=CHANNEL, behavior=ab.FAIL_IF_NOT_READY):
    seek = {"start": {"specified": {"number": start}}, "stop": {"specified": {"number": stop}},
            "behavior": behavior}
    chdr = wire.encode(fabric.CHANNEL_HEADER, protoutil.make_channel_header(
        fabric.DELIVER_SEEK_INFO, channel))
    payload = wire.encode(fabric.PAYLOAD, {"header": {"channel_header": chdr},
                                            "data": wire.encode(ab.SEEK_INFO, seek)})
    return wire.encode(fabric.ENVELOPE, {"payload": payload})


class Broadcaster:
    """A stand-in BroadcastHandler: FORBIDDEN for an envelope signed
    b"bad", else SUCCESS; the same answers in both packages."""

    def __init__(self, pkg):
        self.pkg = pkg

    def process_message(self, env):
        sig = env.get("signature", b"") if self.pkg == "port" else env.signature
        if sig == b"bad":
            return fabric.FORBIDDEN, "signature is bad"
        return fabric.SUCCESS, ""


class Endorser:
    """A stand-in Endorser: status 200 and a payload of sha256(proposal)."""

    def __init__(self, pkg, gate=None, entered=None):
        self.pkg = pkg
        self.gate = gate
        self.entered = entered

    def process_proposal(self, signed):
        if self.gate is not None:
            self.entered.set()
            self.gate.wait(20)
        prop = signed["proposal_bytes"] if self.pkg == "port" else signed.proposal_bytes
        sig = signed.get("signature", b"") if self.pkg == "port" else signed.signature
        resp = {"version": 1, "response": {"status": 200, "message": "ok",
                                           "payload": hashlib.sha256(prop).digest()},
                "payload": prop[::-1], "endorsement": {"endorser": b"e", "signature": sig}}
        raw = wire.encode(fabric.PROPOSAL_RESPONSE, resp)
        return resp if self.pkg == "port" else peer_pb2.ProposalResponse.FromString(raw)


class Manager:
    """A stand-in SnapshotRequestManager."""

    def __init__(self):
        self.heights = [7, 3]

    def submit(self, h):
        self.heights.append(h)
        return h

    def cancel(self, h):
        if h not in self.heights:
            raise ValueError(f"no pending snapshot at {h}")
        self.heights.remove(h)

    def pending(self):
        return sorted(self.heights)


def make_server(pkg, limiter=None, gate=None, entered=None, creds=None):
    srv_mod, svc_mod, dl = ((jserver, jservices, jdeliver) if pkg == "jax"
                            else (tserver, tservices, tdeliver))
    blocks = [W.jax_block(r) if pkg == "jax" else W.port_block(r) for r in RAWS]
    source = dl.BlockSource(lambda n: blocks[n] if n < len(blocks) else None,
                            lambda: len(blocks), lambda n, t: n < len(blocks))
    handler = dl.DeliverHandler(lambda cid: source if cid == CHANNEL else None,
                                wait_timeout=0.01)
    entry = JPvtEntry if pkg == "jax" else PvtEntry
    kw = {"interceptors": [limiter]} if limiter is not None else {}
    server = srv_mod.GRPCServer("127.0.0.1:0", credentials=creds, **kw)
    svc_mod.register_atomic_broadcast(server, Broadcaster(pkg), handler)
    svc_mod.register_peer_deliver(server, handler, pvt_entries=lambda ch, n: [
        entry(*e) for e in PVT.get(n, [])])
    svc_mod.register_endorser(server, Endorser(pkg, gate, entered))
    manager = Manager()

    def checker(channel_id, sd):
        if sd.identity == b"stranger":
            raise PermissionError("not an admin")

    svc_mod.register_snapshot_service(server, lambda cid: manager if cid == CHANNEL else None,
                                      policy_checker=checker)
    server.start()
    return server


@pytest.fixture(scope="module")
def servers():
    out = {pkg: make_server(pkg) for pkg in PKGS}
    yield out
    for s in out.values():
        s.stop()


def client_env(pkg, raw):
    return W.jax_env(raw) if pkg == "jax" else W.port_env(raw)


def as_bytes(msg, schema):
    return wire.encode(schema, msg) if isinstance(msg, dict) else msg.SerializeToString(
        deterministic=True)


def answers(client, servers, fn):
    """fn(client module, channel) against the server of each package."""
    mod = jservices if client == "jax" else tservices
    srv_mod = jserver if client == "jax" else tserver
    out = {}
    for pkg, server in servers.items():
        conn = srv_mod.channel_to(server.addr)
        try:
            out[pkg] = fn(mod, conn)
        finally:
            conn.close()
    return out


@pytest.mark.parametrize("client", PKGS)
def test_broadcast_across_packages(client, servers):
    envs = [W.envelope(None, CHANNEL, b"a"),
            wire.encode(fabric.ENVELOPE, {"payload": b"p", "signature": b"bad"})]

    def run(mod, conn):
        return [as_bytes(mod.broadcast_envelope(conn, client_env(client, e)),
                         ab.BROADCAST_RESPONSE) for e in envs]

    got = answers(client, servers, run)
    assert got["jax"] == got["port"]
    assert [wire.decode(ab.BROADCAST_RESPONSE, r) for r in got["port"]] == [
        {"status": 200}, {"status": 403, "info": "signature is bad"}]


DELIVERS = [("orderer.AtomicBroadcast", "Deliver"), ("protos.Deliver", "Deliver"),
            ("protos.Deliver", "DeliverFiltered"), ("protos.Deliver", "DeliverWithPrivateData")]


@pytest.mark.parametrize("client", PKGS)
@pytest.mark.parametrize("service,method", DELIVERS)
def test_deliver_streams_across_packages(client, service, method, servers):
    seeks = [seek_raw(0, 3), seek_raw(2, 9), seek_raw(1, 1, channel="nope"),
             wire.encode(fabric.ENVELOPE, {"payload": b"\xff"})]

    def run(mod, conn):
        out = []
        for s in seeks:
            try:
                out.append([as_bytes(r, ab.DELIVER_RESPONSE) for r in mod.deliver_stream(
                    conn, client_env(client, s), service=service, method=method)])
            except grpc.RpcError as exc:  # a payload that is no Payload: the stream fails
                out.append(exc.code().name)
        return out

    got = answers(client, servers, run)
    assert got["jax"] == got["port"]
    first = [wire.decode(ab.DELIVER_RESPONSE, r) for r in got["port"][0]]
    assert len(first) == 5 and first[-1] == {"status": fabric.SUCCESS}


def test_deliver_endpoint_feeds_a_deliverer(servers):
    """DeliverEndpoint over the JAX orderer's stream: a BlockDeliverer takes
    the chain; close() ends a session that waits for more, as a
    ConnectionError."""
    from fabric_tpu_torch.deliver.client import BlockDeliverer

    conn = tserver.channel_to(servers["jax"].addr)
    ep = tservices.DeliverEndpoint(conn)
    got = []
    d = BlockDeliverer(CHANNEL, [ep], on_block=lambda b: got.append(wire.encode(fabric.BLOCK, b)),
                       next_block=lambda: len(got))
    assert d.run(max_blocks=len(RAWS)) == len(RAWS)
    assert got == RAWS
    ep.close()
    with pytest.raises(ConnectionError):
        next(iter(ep(wire.decode(fabric.ENVELOPE, seek_raw(0, 1)))))
    conn.close()


@pytest.mark.parametrize("client", PKGS)
def test_process_proposal_across_packages(client, servers):
    signed = [{"proposal_bytes": b"prop-%d" % i, "signature": b"sig-%d" % i} for i in range(3)]

    def run(mod, conn):
        out = []
        for s in signed:
            raw = wire.encode(fabric.SIGNED_PROPOSAL, s)
            msg = peer_pb2.SignedProposal.FromString(raw) if client == "jax" else s
            out.append(as_bytes(mod.process_proposal(conn, msg), fabric.PROPOSAL_RESPONSE))
        return out

    got = answers(client, servers, run)
    assert got["jax"] == got["port"]


def _snapshot_request(kind, channel=CHANNEL, creator=b"admin", number=9):
    shdr = wire.encode(fabric.SIGNATURE_HEADER, {"creator": creator, "nonce": b"n"})
    if kind == "query":
        req = wire.encode(fabric.SNAPSHOT_QUERY, {"signature_header": shdr, "channel_id": channel})
    else:
        req = wire.encode(fabric.SNAPSHOT_REQUEST, {"signature_header": shdr,
                                                    "channel_id": channel,
                                                    "block_number": number})
    return wire.encode(fabric.SIGNED_SNAPSHOT_REQUEST, {"request": req, "signature": b"s"})


def test_snapshot_service_across_packages(servers):
    """Generate, Cancel and QueryPendings through raw stubs: each server's
    answer bytes, or its failed call's status, equal; a refused creator, an
    unknown channel and a failing cancel fail alike."""
    calls = [("QueryPendings", _snapshot_request("query")),
             ("Generate", _snapshot_request("generate", number=9)),
             ("QueryPendings", _snapshot_request("query")),
             ("Cancel", _snapshot_request("cancel", number=3)),
             ("Cancel", _snapshot_request("cancel", number=42)),
             ("Generate", _snapshot_request("generate", creator=b"stranger")),
             ("QueryPendings", _snapshot_request("query", channel="nope"))]
    got = {}
    for pkg, server in servers.items():
        conn = grpc.insecure_channel(server.addr)
        out = []
        for method, raw in calls:
            stub = conn.unary_unary(f"/protos.Snapshot/{method}")
            try:
                out.append(("ok", stub(raw)))
            except grpc.RpcError as exc:
                out.append((exc.code().name, exc.details()))
        conn.close()
        got[pkg] = out
    assert got["jax"] == got["port"]
    assert got["port"][2] == ("ok", wire.encode(fabric.QUERY_PENDING_SNAPSHOTS_RESPONSE,
                                                {"block_numbers": [3, 7, 9]}))
    assert [g[0] for g in got["port"][4:]] == ["UNKNOWN"] * 3


def test_concurrency_limiter_refuses_alike():
    """A limit of one ProcessProposal at a time: while one call waits in the
    endorser, the next is refused with RESOURCE_EXHAUSTED and the same
    details by both packages' limiters."""
    got = {}
    for pkg, srv_mod, svc_mod in (("jax", jserver, jservices), ("port", tserver, tservices)):
        gate, entered = threading.Event(), threading.Event()
        limiter = srv_mod.ConcurrencyLimiter({"protos.Endorser": 1})
        server = make_server(pkg, limiter=limiter, gate=gate, entered=entered)
        conn = grpc.insecure_channel(server.addr)
        stub = conn.unary_unary("/protos.Endorser/ProcessProposal")
        raw = wire.encode(fabric.SIGNED_PROPOSAL, {"proposal_bytes": b"p"})
        first = stub.future(raw)
        assert entered.wait(20)  # the first call holds the only slot
        outcome = None
        try:
            stub(raw, timeout=20)
        except grpc.RpcError as exc:
            outcome = (exc.code().name, exc.details())
        gate.set()
        got[pkg] = (outcome, first.result(timeout=20))
        conn.close()
        server.stop()
    assert got["jax"] == got["port"]
    assert got["port"][0] == ("RESOURCE_EXHAUSTED", "concurrency limit reached for protos.Endorser")


@pytest.fixture(scope="module")
def tls_material():
    from fabric_tpu.msp.cryptogen import OrgCA

    ca = OrgCA("org1.comm.test", "Org1MSP")
    other = OrgCA("org9.comm.test", "Org9MSP")
    return ca.enroll_tls("server.org1.comm.test"), ca.enroll_tls("client.org1.comm.test"), \
        other.enroll_tls("rogue.org9.comm.test")


def _call(server_pkg, client_pkg, creds, root=None, pair=None):
    server = make_server(server_pkg, creds=creds)
    srv_mod = jserver if client_pkg == "jax" else tserver
    conn = srv_mod.channel_to(server.addr, root_ca_pem=root, client_cert=pair)
    try:
        stub = conn.unary_unary("/protos.Endorser/ProcessProposal")
        return ("ok", stub(wire.encode(fabric.SIGNED_PROPOSAL, {"proposal_bytes": b"p"}),
                           timeout=5))
    except grpc.RpcError as exc:
        return (exc.code().name,)
    finally:
        conn.close()
        server.stop()


@requires_crypto
@pytest.mark.parametrize("client,server", PAIRS, ids=ids)
def test_tls_and_mtls_across_packages(client, server, tls_material):
    srv, cli, rogue = tls_material
    srv_mod = jserver if server == "jax" else tserver
    tls = srv_mod.tls_server_credentials(srv.cert_pem, srv.key_pem)
    ok = _call(server, client, tls, root=srv.ca_pem)
    assert ok[0] == "ok"
    mtls = srv_mod.tls_server_credentials(srv.cert_pem, srv.key_pem, client_ca_pem=srv.ca_pem)
    assert _call(server, client, mtls, root=srv.ca_pem, pair=(cli.key_pem, cli.cert_pem)) == ok
    assert _call(server, client, mtls, root=srv.ca_pem)[0] == "UNAVAILABLE"
    assert _call(server, client, mtls, root=srv.ca_pem,
                 pair=(rogue.key_pem, rogue.cert_pem))[0] == "UNAVAILABLE"


@requires_crypto
def test_cert_reloader_and_config_outcomes(tmp_path, tls_material):
    srv, cli, _ = tls_material
    files = {}
    for name, data in (("cert", srv.cert_pem), ("key", srv.key_pem), ("ca", srv.ca_pem)):
        files[name] = tmp_path / f"{name}.pem"
        files[name].write_bytes(data)
    outcomes = {}
    for pkg, srv_mod in (("jax", jserver), ("port", tserver)):
        reloader = srv_mod.CertReloader(str(files["cert"]), str(files["key"]), [str(files["ca"])])
        assert reloader.requires_client_auth and reloader.reloads == 1
        cfgs = [None, {}, {"enabled": False, "cert": "x"}, {"Enabled": True, "Certificate": "c"},
                {"cert": str(files["cert"])}, {"enabled": True, "cert": str(files["cert"]),
                                               "key": str(files["key"]),
                                               "clientRootCAs": [str(files["ca"])]}]
        out = []
        for cfg in cfgs:
            try:
                creds = srv_mod.tls_credentials_from_config(cfg)
                out.append(type(creds).__name__)
            except ValueError as exc:
                out.append(str(exc))
        with pytest.raises(OSError):
            srv_mod.CertReloader(str(tmp_path / "absent.pem"), str(files["key"]))
        outcomes[pkg] = out
        assert _call(pkg, pkg, reloader.credentials(), root=srv.ca_pem,
                     pair=(cli.key_pem, cli.cert_pem))[0] == "ok"
    assert outcomes["jax"] == outcomes["port"]
    assert tserver.MAX_MSG_SIZE == jserver.MAX_MSG_SIZE == 100 * 1024 * 1024
    assert tserver._options() == jserver._options()


def test_unknown_fields_survive_the_codec():
    """A request with a field the schema lacks reaches the handler and is
    written on as protobuf writes it."""
    dec, enc = tserver.wire_codec(fabric.ENVELOPE)
    raw = wire.encode(fabric.ENVELOPE, {"payload": b"p", "signature": b"s"}) + b"\xf0\x01\x07"
    assert enc(dec(raw)) == common_pb2.Envelope.FromString(raw).SerializeToString()
    assert ab_pb2.DeliverResponse.FromString(wire.encode(ab.DELIVER_RESPONSE, {"status": 0}))


def test_stop_leaves_no_server_thread():
    """GRPCServer.stop returns once grpc's thread that cancels the calls
    left after the grace has ended too (grpc sets the stop event from that
    thread, which then still takes the server's lock and cancels). CPU
    load on other threads widens the window in which it was still alive."""
    halt = threading.Event()

    def spin():
        while not halt.is_set():
            sum(range(1000))

    load = [threading.Thread(target=spin) for _ in range(4)]
    for t in load:
        t.start()
    try:
        alive = 0
        for _ in range(15):
            server = tserver.GRPCServer("127.0.0.1:0")
            server.start()
            server.stop()
            alive += any(t.is_alive() and t.name.endswith("(cancel_all_calls_after_grace)")
                         for t in threading.enumerate())
    finally:
        halt.set()
        for t in load:
            t.join()
    assert alive == 0
