"""orderer/cluster and discovery/server against the JAX package: the cluster
and discovery schemas byte for byte against `cluster_pb2` and
`discovery_pb2` (built in each package, read by the other, unknown fields
kept); a port ClusterClient streaming raft messages and forwarding
envelopes to a JAX ClusterService, and a JAX ClusterClient to a port
ClusterService, over loopback gRPC, each side's messages equal; the port's
fail-closed departures (a payload that is no raft message dropped and
counted, a chain's step error kept and ending the stream, a stopped client
starting no sender); and discovery queries from each package's client to
each package's server, the answers byte for byte."""

import random
import threading
import time

import pytest

from fabric_tpu.comm import server as jserver
from fabric_tpu.discovery import server as jdserver
from fabric_tpu.discovery import service as jdservice
from fabric_tpu.orderer import cluster as jcluster
from fabric_tpu.orderer import raft as jraft
from fabric_tpu.protos import cluster_pb2, common_pb2, discovery_pb2
from fabric_tpu_torch.comm import server as tserver
from fabric_tpu_torch.discovery import server as tdserver
from fabric_tpu_torch.discovery import service as tdservice
from fabric_tpu_torch.orderer import cluster as tcluster
from fabric_tpu_torch.orderer import raft as traft
from fabric_tpu_torch.protos import cluster as tproto
from fabric_tpu_torch.protos import discovery as tdproto
from fabric_tpu_torch.protos import fabric, wire

PKGS = {"jax": (jcluster, jraft, jserver), "port": (tcluster, traft, tserver)}
PAIRS = [(c, s) for c in PKGS for s in PKGS]


def messages(raft, seed=5):
    rng = random.Random(seed)
    out = []
    for kind in ("vote_req", "vote_resp", "append", "append_resp", "snap"):
        entries = tuple(raft.Entry(rng.randrange(1, 99), rng.randrange(9), rng.randrange(2),
                                   rng.randbytes(rng.randrange(0, 40))) for _ in range(3))
        out.append(raft.Message(kind=kind, term=rng.randrange(1, 9), frm=rng.randrange(1, 4),
                                to=rng.randrange(1, 4), prev_index=rng.randrange(50),
                                prev_term=rng.randrange(9),
                                entries=entries if kind == "append" else (),
                                commit=rng.randrange(50), last_index=rng.randrange(50),
                                last_term=rng.randrange(9), granted=rng.random() < 0.5,
                                success=rng.random() < 0.5, match_index=rng.randrange(50),
                                snap_index=rng.randrange(50) if kind == "snap" else 0,
                                snap_term=rng.randrange(9) if kind == "snap" else 0,
                                snap_data=rng.randbytes(30) if kind == "snap" else b""))
    return out


ENV = {"payload": b"\x0a\x02hi", "signature": b"sig"}


def jax_env():
    return common_pb2.Envelope(payload=ENV["payload"], signature=ENV["signature"])


def test_raft_frames_equal_jax():
    for tm, jmsg in zip(messages(traft), messages(jraft)):
        raw = traft.message_to_bytes(tm)
        assert raw == jraft.message_to_bytes(jmsg)
        assert traft.message_from_bytes(raw) == tm


def cases():
    """(schema, port dict, protobuf message) of every cluster message kind."""
    frame = traft.message_to_bytes(messages(traft)[2])
    consensus = {"channel": "ch", "payload": frame, "from_node": 3}
    submit = {"channel": "ch", "payload": ENV}
    res = {"channel": "ch", "status": fabric.FORBIDDEN, "info": "no"}
    jcons = cluster_pb2.ClusterConsensusRequest(channel="ch", payload=frame, from_node=3)
    jsub = cluster_pb2.ClusterSubmitRequest(channel="ch", payload=jax_env())
    jres = cluster_pb2.ClusterSubmitResponse(channel="ch", status=403, info="no")
    return [
        (tproto.CLUSTER_STEP_REQUEST, {"consensus_request": consensus},
         cluster_pb2.ClusterStepRequest(consensus_request=jcons)),
        (tproto.CLUSTER_STEP_REQUEST, {"submit_request": submit},
         cluster_pb2.ClusterStepRequest(submit_request=jsub)),
        (tproto.CLUSTER_STEP_REQUEST, {"submit_request": {}},
         cluster_pb2.ClusterStepRequest(submit_request=cluster_pb2.ClusterSubmitRequest())),
        (tproto.CLUSTER_STEP_RESPONSE, {"submit_res": res},
         cluster_pb2.ClusterStepResponse(submit_res=jres)),
        (tproto.CLUSTER_SUBMIT_REQUEST, submit, jsub),
        (tproto.CLUSTER_SUBMIT_RESPONSE, res, jres),
        (tproto.CLUSTER_SUBMIT_RESPONSE, {"status": 0}, cluster_pb2.ClusterSubmitResponse()),
        (tproto.CLUSTER_CONSENSUS_REQUEST, consensus, jcons),
        (tdproto.SIGNED_REQUEST, {"payload": b'{"q": 1}', "signature": b"s"},
         discovery_pb2.SignedRequest(payload=b'{"q": 1}', signature=b"s")),
        (tdproto.QUERY_RESPONSE, {"status": 500, "result": b"{}"},
         discovery_pb2.QueryResponse(status=500, result=b"{}")),
    ]


@pytest.mark.parametrize("i", range(10))
def test_schemas_byte_for_byte(i):
    schema, msg, jmsg = cases()[i]
    raw = jmsg.SerializeToString()
    assert wire.encode(schema, msg) == raw
    assert wire.encode(schema, wire.decode(schema, raw)) == raw
    # unknown fields survive a pass through the port, as through protobuf
    extra = raw + b"\xf8\x3f\x07"
    assert wire.encode(schema, wire.decode(schema, extra, keep_unknown=True)) == \
        type(jmsg).FromString(extra).SerializeToString()


class Chain:
    def __init__(self, fail=False):
        self.stepped = []
        self.fail = fail

    def step(self, msg):
        if self.fail:
            raise RuntimeError("chain broke")
        self.stepped.append(msg)


class Registrar:
    def __init__(self, chain):
        self.support = type("Support", (), {"chain": chain})()

    def get_chain(self, channel_id):
        return self.support if channel_id == "ch" else None


class Broadcast:
    def __init__(self):
        self.seen = []

    def process_message(self, env, forwarded=False):
        self.seen.append((env, forwarded))
        return 200, "ordered"


def serve(pkg, chain):
    cluster, _, server_mod = PKGS[pkg]
    server = server_mod.GRPCServer("127.0.0.1:0")
    bcast = Broadcast()
    service = cluster.ClusterService(Registrar(chain), bcast)
    service.register(server)
    server.start()
    return server, service, bcast


def wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.01)


@pytest.mark.parametrize("client,srv", PAIRS)
def test_step_and_submit_across_packages(client, srv):
    cluster, raft, _ = PKGS[client]
    chain = Chain()
    server, service, bcast = serve(srv, chain)
    cli = cluster.ClusterClient(1, {2: server.addr, 3: "127.0.0.1:1"})
    try:
        send = cli.transport_factory("ch", 1)
        sent = messages(raft)
        for m in sent:
            send(2, m)
        send(1, sent[0])  # to itself: dropped
        wait_for(lambda: len(chain.stepped) == len(sent))
        want = [traft.message_to_bytes(m) if srv == "port" else jraft.message_to_bytes(m)
                for m in messages(traft if srv == "port" else jraft)]
        stepped = [(traft if srv == "port" else jraft).message_to_bytes(m)
                   for m in chain.stepped]
        assert stepped == want
        env = ENV if client == "port" else jax_env()
        assert cli.forward_submit("ch", env, 2) == (200, "ordered")
        got, forwarded = bcast.seen[0]
        assert forwarded and (got == ENV if srv == "port" else got.SerializeToString() ==
                              jax_env().SerializeToString())
        assert cli.forward_submit("ch", env, 9) == (503, "no endpoint for leader 9")
        status, info = cli.forward_submit("ch", env, 3)
        assert status == 503 and info.startswith("leader unreachable: StatusCode.UNAVAILABLE")
    finally:
        cli.stop()
        server.stop()


def test_port_service_drops_malformed_payloads_and_keeps_a_step_error():
    chain = Chain()
    server, service, _ = serve("port", chain)
    cli = tcluster.ClusterClient(1, {2: server.addr})
    try:
        remote = cli._remote_for(server.addr)
        remote.q.put({"consensus_request": {"channel": "ch", "payload": b"\x01\x02"}})
        remote.q.put({"consensus_request": {"channel": "other", "payload": b"x"}})
        cli.transport_factory("ch", 1)(2, messages(traft)[0])
        wait_for(lambda: len(chain.stepped) == 1)
        assert service.dropped == 1 and service.step_error is None
        chain.fail = True
        cli.transport_factory("ch", 1)(2, messages(traft)[1])
        wait_for(lambda: service.step_error is not None)
        assert str(service.step_error) == "chain broke"
        # the sender reconnects: a later message goes through (one sent
        # while the broken stream is torn down may be lost, as raft allows)
        chain.fail = False
        deadline = time.monotonic() + 20
        while len(chain.stepped) < 2:
            assert time.monotonic() < deadline
            cli.transport_factory("ch", 1)(2, messages(traft)[3])
            time.sleep(0.2)
        assert chain.stepped[1] == messages(traft)[3]
    finally:
        cli.stop()
        server.stop()


def test_stopped_client_starts_no_sender():
    before = set(threading.enumerate())
    cli = tcluster.ClusterClient(1, {2: "127.0.0.1:1"})
    send = cli.transport_factory("ch", 1)
    send(2, messages(traft)[0])
    cli.stop()
    send(2, messages(traft)[1])
    assert cli.forward_submit("ch", ENV, 2) == (503, "cluster client stopped")
    # only the client's own sender threads: another module's test on the
    # same worker may still be starting threads of its own
    assert [t for t in threading.enumerate()
            if t not in before and t.name.startswith("cluster-send-")] == []
    assert cli._remotes == {}


class FakeDiscovery:
    """A discovery service with fixed answers, in either package's types."""

    def __init__(self, svc):
        self.svc = svc
        self.peer_list = [svc.PeerInfo("Org1MSP", "p0:7051", 3, ("cc",)),
                          svc.PeerInfo("Org2MSP", "p1:7051", 2, ("cc", "dd"), False)]

    def _check(self, client):
        if client.identity != b"member" or client.signature != b"sig:" + client.data:
            raise self.svc.DiscoveryError("access denied")

    def peers(self, channel, client):
        self._check(client)
        return self.peer_list

    def config(self, channel, client):
        self._check(client)
        return {"msps": ["Org1MSP", "Org2MSP"], "orderers": {"O": ["o:7050"]}}

    def endorsers(self, channel, cc, client):
        self._check(client)
        if cc != "cc":
            raise self.svc.DiscoveryError(f"failed constructing descriptor for chaincode {cc}")
        return self.svc.EndorsementDescriptor(cc, {"G0": self.peer_list[:1]}, [{"G0": 1}])


class Signer:
    def __init__(self, identity):
        self.identity = identity

    def serialize(self):
        return self.identity

    def sign(self, data):
        return b"sig:" + data


DSERVERS = {"jax": (jdserver, jdservice, jserver), "port": (tdserver, tdservice, tserver)}


@pytest.mark.parametrize("client,srv", PAIRS)
def test_discovery_queries_across_packages(client, srv):
    dserver, dservice, server_mod = DSERVERS[srv]
    server = server_mod.GRPCServer("127.0.0.1:0")
    dserver.DiscoveryServer(FakeDiscovery(dservice)).register(server)
    addr = server.start()
    query, error = DSERVERS[client][0].query, DSERVERS[client][1].DiscoveryError
    try:
        member = Signer(b"member")
        out = {what: query(addr, member, "ch", what, "cc")
               for what in ("peers", "config", "endorsers")}
        assert out["peers"] == [
            {"msp_id": "Org1MSP", "endpoint": "p0:7051", "ledger_height": 3,
             "chaincodes": ["cc"], "is_peer_role": True},
            {"msp_id": "Org2MSP", "endpoint": "p1:7051", "ledger_height": 2,
             "chaincodes": ["cc", "dd"], "is_peer_role": False}]
        assert out["endorsers"]["layouts"] == [{"G0": 1}]
        for args, message in (((member, "ch", "endorsers", "zz"),
                               "failed constructing descriptor for chaincode zz"),
                              ((Signer(b"stranger"), "ch", "peers"), "access denied"),
                              ((member, "ch", "bogus"), "unknown query 'bogus'")):
            with pytest.raises(error, match=message):
                query(addr, *args)
    finally:
        server.stop()


def test_discovery_answers_byte_for_byte():
    """The same SignedRequest bytes answered by both servers: the same
    QueryResponse bytes."""
    import json

    answers = {}
    for pkg, (dserver, dservice, _) in DSERVERS.items():
        srv = dserver.DiscoveryServer(FakeDiscovery(dservice))
        out = []
        for what in ("peers", "config", "endorsers", "bogus"):
            payload = json.dumps({"channel": "ch", "query": what, "chaincode": "cc",
                                  "identity": "bWVtYmVy"}, sort_keys=True).encode()
            req = {"payload": payload, "signature": b"sig:" + payload}
            if pkg == "jax":
                resp = srv.process(discovery_pb2.SignedRequest(**req), None).SerializeToString()
            else:
                resp = wire.encode(tdproto.QUERY_RESPONSE, srv.process(req, None))
            out.append(resp)
        answers[pkg] = out
    assert answers["port"] == answers["jax"]
