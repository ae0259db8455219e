"""The chaincode shim stream (chaincode/{extserver,extshim,launcher})
against the JAX package: the stream's messages byte for byte against
`peer_pb2.ChaincodeMessage` and its payloads; a chaincode served by each
package's CcaasServer and dialed by each package's ChaincodeListener (the
ccaas direction), and a chaincode of each package's shim dialing each
package's listener (the Register direction), each running the same state
operations over the same seeded state: responses, events and the
simulators' read-write sets and private write-sets equal byte for byte;
and the port's built-in python builder, which runs a package as a
`python -m fabric_tpu_torch.chaincode.launcher` child that registers with
the peer's listener. Every stream is torn down by stop() with no thread of
it left."""

import threading
import time

import pytest

from fabric_tpu.chaincode import extserver as jext
from fabric_tpu.chaincode import extshim as jshimx
from fabric_tpu.chaincode import shim as jshim
from fabric_tpu.chaincode import support as jsup
from fabric_tpu.comm import server as jserver
from fabric_tpu.ledger import simulator as jsim
from fabric_tpu.protos import peer_pb2
from fabric_tpu_torch.chaincode import extbuilder as text
from fabric_tpu_torch.chaincode import extserver as tex
from fabric_tpu_torch.chaincode import extshim as tshimx
from fabric_tpu_torch.chaincode import package as tpkg
from fabric_tpu_torch.chaincode import shim as tshim
from fabric_tpu_torch.chaincode import support as tsup
from fabric_tpu_torch.comm import server as tserver
from fabric_tpu_torch.ledger import simulator as tsim
from fabric_tpu_torch.protos import chaincode as ccm
from fabric_tpu_torch.protos import wire
from test_torch_simulator import seeded_dbs

PKGS = {"jax": (jext, jshimx, jshim, jsup, jserver, jsim),
        "port": (tex, tshimx, tshim, tsup, tserver, tsim)}
PAIRS = [(cc, peer) for cc in PKGS for peer in PKGS]


def message_cases():
    """(port dict, protobuf) of the shim stream's messages and payloads."""
    ev = {"chaincode_id": "", "tx_id": "", "event_name": "ev", "payload": b"p"}
    out = [({"type": t, "payload": b"\x01\x02", "txid": "tx9", "channel_id": "ch"},
            peer_pb2.ChaincodeMessage(type=t, payload=b"\x01\x02", txid="tx9", channel_id="ch"))
           for t in (ccm.REGISTER, ccm.REGISTERED, ccm.READY, ccm.INIT, ccm.TRANSACTION,
                     ccm.COMPLETED, ccm.ERROR, ccm.GET_STATE, ccm.PUT_STATE, ccm.DEL_STATE,
                     ccm.RESPONSE, ccm.GET_STATE_BY_RANGE, ccm.GET_QUERY_RESULT,
                     ccm.KEEPALIVE, ccm.GET_STATE_METADATA, ccm.PUT_STATE_METADATA,
                     ccm.GET_PRIVATE_DATA_HASH)]
    j = peer_pb2.ChaincodeMessage(type=ccm.COMPLETED, txid="t")
    j.chaincode_event.event_name, j.chaincode_event.payload = "ev", b"p"
    j.timestamp.seconds, j.timestamp.nanos = 5, 7
    j.proposal.proposal_bytes, j.proposal.signature = b"pb", b"sg"
    out.append(({"type": ccm.COMPLETED, "txid": "t", "chaincode_event": {
        k: v for k, v in ev.items() if v}, "timestamp": {"seconds": 5, "nanos": 7},
        "proposal": {"proposal_bytes": b"pb", "signature": b"sg"}}, j))
    return [(ccm.CHAINCODE_MESSAGE, d, p) for d, p in out] + [
        (ccm.GET_STATE_MSG, {"key": "k", "collection": "c"},
         peer_pb2.GetState(key="k", collection="c")),
        (ccm.PUT_STATE_MSG, {"key": "k", "value": b"v", "collection": "c"},
         peer_pb2.PutState(key="k", value=b"v", collection="c")),
        (ccm.DEL_STATE_MSG, {"key": "k"}, peer_pb2.DelState(key="k")),
        (ccm.GET_STATE_BY_RANGE_MSG, {"startKey": "a", "endKey": "z", "metadata": b"m"},
         peer_pb2.GetStateByRange(startKey="a", endKey="z", metadata=b"m")),
        (ccm.GET_QUERY_RESULT_MSG, {"query": "{}", "metadata": b"m"},
         peer_pb2.GetQueryResult(query="{}", metadata=b"m")),
        (ccm.QUERY_RESPONSE, {"results": [{"resultBytes": b"r1"}, {}], "has_more": True,
                              "id": "i", "metadata": b"m"},
         peer_pb2.QueryResponse(results=[peer_pb2.QueryResultBytes(resultBytes=b"r1"),
                                         peer_pb2.QueryResultBytes()],
                                has_more=True, id="i", metadata=b"m")),
        (ccm.STATE_METADATA_RESULT, {"entries": [{"metakey": "VALIDATION_PARAMETER",
                                                  "value": b"vp"}]},
         peer_pb2.StateMetadataResult(entries=[peer_pb2.StateMetadata(
             metakey="VALIDATION_PARAMETER", value=b"vp")])),
        (ccm.PUT_STATE_METADATA_MSG, {"key": "k", "metadata": {"metakey": "m", "value": b"v"}},
         peer_pb2.PutStateMetadata(key="k", metadata=peer_pb2.StateMetadata(
             metakey="m", value=b"v"))),
        (ccm.QUERY_METADATA, {"pageSize": 3, "bookmark": "b"},
         peer_pb2.QueryMetadata(pageSize=3, bookmark="b")),
        (ccm.QUERY_RESPONSE_METADATA, {"fetched_records_count": 3, "bookmark": "b"},
         peer_pb2.QueryResponseMetadata(fetched_records_count=3, bookmark="b")),
    ]


@pytest.mark.parametrize("i", range(len(message_cases())))
def test_shim_messages_byte_for_byte(i):
    schema, msg, pmsg = message_cases()[i]
    raw = pmsg.SerializeToString()
    assert wire.encode(schema, msg) == raw
    assert wire.encode(schema, wire.decode(schema, raw)) == raw


class Ops:
    """A chaincode over `shim` doing each kind of state access the stream
    carries: `mix` reads, writes, deletes, scans a range, reads and writes
    private data and sets an event; `page` runs paginated scans (read-only);
    `fail` answers an error."""

    def __init__(self, shim):
        self.shim = shim

    def init(self, stub):
        return self.shim.success(b"init")

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        if fn == "mix":
            a = stub.get_state("k000") or b"-"
            stub.put_state("k001", a + b"!")
            stub.put_state("new", b"n")
            stub.del_state("k002")
            rows = list(stub.get_state_by_range("k010", "k020"))
            secret = stub.get_private_data("secret", "p00") or b"-"
            stub.put_private_data("shared", "p99", b"pv")
            stub.set_event("mixed", secret)
            return self.shim.success(b"%d:%s" % (len(rows), a[:4]))
        if fn == "page":
            rows, mark = stub.get_state_by_range_with_pagination("k000", "k090", 5)
            rows2, mark2 = stub.get_state_by_range_with_pagination("k000", "k090", 5, mark)
            return self.shim.success(("|".join(k for k, _ in rows + rows2) + "#" + mark2)
                                     .encode())
        if fn == "fail":
            return self.shim.error_response("nope")
        raise RuntimeError("unknown function")


CALLS = [[b"mix"], [b"page"], [b"fail"], [b"boom"]]


def run_calls(peer, support, db):
    """Each call in a fresh simulator: (status, message, payload, event,
    public rwset bytes, pvt rwset bytes)."""
    _, _, _, sup, _, sim = PKGS[peer]
    out = []
    for n, args in enumerate(CALLS):
        s = sim.TxSimulator(db, f"tx{n}")
        resp, event = support.execute(sup.TxParams(channel_id="ch", tx_id=f"tx{n}",
                                                   simulator=s), "mycc", args)
        if event is not None and not isinstance(event, dict):
            event = {"event_name": event.event_name, "payload": event.payload}
        res = s.get_tx_simulation_results()
        out.append((resp.status, resp.message, resp.payload,
                    None if event is None else (event.get("event_name"), event.get("payload")),
                    res.public_bytes, res.pvt_rwset_bytes()))
    return out


@pytest.fixture(scope="module")
def dbs():
    jdb, tdb = seeded_dbs(41, n_keys=60)
    return {"jax": jdb, "port": tdb}


def _peer_side(peer):
    ext, _, _, sup, server_mod, _ = PKGS[peer]
    listener = ext.ChaincodeListener()
    server = server_mod.GRPCServer("127.0.0.1:0")
    listener.register(server)
    server.start()
    return listener, sup.ChaincodeSupport(listener=listener), server


@pytest.fixture(scope="module")
def ccaas_outcomes(dbs):
    out = {}
    for cc, peer in PAIRS:
        _, shimx, shim, _, _, _ = PKGS[cc]
        before = set(threading.enumerate())
        ccserver = shimx.CcaasServer(Ops(shim), "ops")
        listener, support, server = _peer_side(peer)
        try:
            name = listener.connect_ccaas(ccserver.start(), timeout=10, expected_name="mycc")
            assert name == "mycc" and listener.connected("mycc")
            out[(cc, peer)] = run_calls(peer, support, dbs[peer])
        finally:
            if peer == "port":
                listener.stop()
            ccserver.stop()
            server.stop()
        if cc == peer == "port":
            deadline = time.monotonic() + 10
            while [t for t in threading.enumerate() if t not in before and t.is_alive()]:
                assert time.monotonic() < deadline, [t.name for t in threading.enumerate()
                                                     if t not in before]
                time.sleep(0.05)
    return out


@pytest.mark.parametrize("cc,peer", PAIRS)
def test_ccaas_across_packages(ccaas_outcomes, cc, peer):
    got, want = ccaas_outcomes[(cc, peer)], ccaas_outcomes[("jax", "jax")]
    assert got == want
    statuses = [r[0] for r in got]
    assert statuses == [200, 200, 500, 500] and got[0][3] == ("mixed", b"-")
    assert got[2][1] == "nope" and got[0][4]


@pytest.mark.parametrize("cc,peer", PAIRS)
def test_register_stream_across_packages(dbs, cc, peer):
    """The chaincode dials the peer (shim.Start): the same answers."""
    _, shimx, shim, _, _, _ = PKGS[cc]
    listener, support, server = _peer_side(peer)
    session = shimx.start(Ops(shim), server.addr, "mycc", block=False)
    try:
        assert listener.wait_for("mycc", timeout=10)
        assert run_calls(peer, support, dbs[peer])[:3] == [
            r for r in run_calls_reference(dbs)][:3]
    finally:
        session.stop()
        if peer == "port":
            listener.stop()
        server.stop()


_REFERENCE = {}


def run_calls_reference(dbs):
    """The JAX in-process answers to CALLS through a JAX ccaas pair."""
    if "ref" not in _REFERENCE:
        ccserver = jshimx.CcaasServer(Ops(jshim), "ops")
        listener, support, server = _peer_side("jax")
        try:
            listener.connect_ccaas(ccserver.start(), timeout=10, expected_name="mycc")
            _REFERENCE["ref"] = run_calls("jax", support, dbs["jax"])
        finally:
            ccserver.stop()
            server.stop()
    return _REFERENCE["ref"]


CHAINCODE_PY = b'''
from fabric_tpu_torch.chaincode import shim


class Chaincode:
    def init(self, stub):
        return shim.success(b"")

    def invoke(self, stub):
        fn, params = stub.get_function_and_parameters()
        stub.put_state(params[0], b"from-launcher")
        return shim.success(b"launched:" + params[0].encode())
'''


def test_launcher_runs_a_python_package_as_a_child(tmp_path):
    """The built-in python builder: install, launch a child process that
    registers as the package id, execute through it, stop."""
    listener, support, server = _peer_side("port")
    store = tpkg.PackageStore(str(tmp_path / "store"))
    installed = store.install(tpkg.package("pycc", {"chaincode.py": CHAINCODE_PY}))
    launcher = text.Launcher(str(tmp_path / "build"))
    sup = tsup.ChaincodeSupport(listener=listener, launcher=launcher, package_store=store,
                                source_resolver=lambda cid, name: installed.package_id,
                                chaincode_address=lambda: server.addr)
    db = seeded_dbs(3, n_keys=4)[1]
    try:
        s = tsim.TxSimulator(db, "txl")
        resp, _ = sup.execute(tsup.TxParams(channel_id="ch", tx_id="txl", simulator=s),
                              "pycc", [b"put", b"kl"])
        assert (resp.status, resp.payload) == (200, b"launched:kl")
        writes = s.get_tx_simulation_results().rwset.ns_rw_sets[0].writes
        assert [(w.key, w.value) for w in writes] == [("kl", b"from-launcher")]
        proc = launcher._procs[installed.package_id]
        assert proc.args[1:3] == ["-m", "fabric_tpu_torch.chaincode.launcher"]
    finally:
        launcher.stop()
        listener.stop()
        server.stop()
    assert proc.poll() is not None
