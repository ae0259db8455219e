"""nodes/{orderer,peer} against the JAX package, over loopback gRPC.

- A port network beside a JAX network as tests/test_grpc_network.py builds
  it: one orderer node (solo) and two peer nodes of each package,
  SoftwareProvider on both sides, on endorse_config2's network (Org1-3,
  config #2's policy) at a few transactions a block. Org1's client sends
  each round's proposals over gRPC ProcessProposal to the port's peers,
  assembles the envelopes and broadcasts the same envelopes to both
  orderers over gRPC; every peer pulls through its deliver loop into its
  commit pipeline. The port's and the JAX package's block data, filters,
  commit hashes and state rows are equal. The port's first peer runs its
  operations server: /healthz answers 200 and /metrics counts the
  ProcessProposal calls it took; discovery answers over gRPC.
- A three-node port raft cluster of OrdererNodes over orderer/cluster's
  Step streams, as tests/test_cluster.py:142 drives the JAX one: a leader
  is elected, a broadcast to a follower is forwarded with cluster Submit,
  the leader is stopped, the survivors elect and order, and the stopped
  node restarts on its directory and port and catches up.
- chip_smoke.py's nodes_config2 phase at 10 transactions a block with the
  card's kernels stood in for (as tests/test_torch_raft_flow.py does).
- After every node's stop() no thread of the nodes is left.
- A PeerNode over a serve client latched `degraded`: /healthz answers 503
  and names the lost sidecar.
"""

import json
import sqlite3
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_untraced import untraced  # noqa: F401

import chip_smoke
from fabric_tpu.channelconfig import bundle as jbundle
from fabric_tpu.chaincode import shim as jshim
from fabric_tpu.comm import server as jserver
from fabric_tpu.comm import services as jservices
from fabric_tpu.crypto.bccsp import SoftwareProvider as JSoftwareProvider
from fabric_tpu.nodes.orderer import OrdererNode as JOrdererNode
from fabric_tpu.nodes.orderer import parse_duration as jparse_duration
from fabric_tpu.nodes.peer import PeerNode as JPeerNode
from fabric_tpu.policy import from_dsl as jdsl
from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch.chaincode import shim as tshim
from fabric_tpu_torch.channelconfig.bundle import bundle_from_genesis_block
from fabric_tpu_torch.comm.server import channel_to
from fabric_tpu_torch.comm.services import broadcast_envelope, process_proposal
from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.crypto.bccsp import SoftwareProvider
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.discovery.server import query as discover
from fabric_tpu_torch.ledger import mvcc_device as md
from fabric_tpu_torch.nodes.orderer import OrdererNode, parse_duration
from fabric_tpu_torch.nodes.peer import PeerNode
from fabric_tpu_torch.ops import p256_kernel as p256k
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.serve.client import SidecarProvider
from fabric_tpu_torch.validation.validator import ChaincodeDefinition, ChaincodeRegistry
from test_torch_endorse_flow import jax_signer
from torch_orderer_world import envelope

TXS = 4
CHANNEL = chip_smoke.CONFIG2_CHANNEL
SW, JSW = SoftwareProvider(), JSoftwareProvider()


def test_parse_duration_equals_jax():
    for text in ("", "2s", "500ms", "1m", "0.25", " 3S ", "bogus", "10m", "ms"):
        assert parse_duration(text, 0.5) == jparse_duration(text, 0.5)


def wait_for(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def rows(path, table):
    db = sqlite3.connect(str(path))
    try:
        return sorted(db.execute(f"SELECT * FROM {table}").fetchall())
    finally:
        db.close()


@pytest.fixture(scope="module")
def networks(tmp_path_factory):
    """Both packages' networks driven with the same envelopes; yields what
    the tests compare, then stops every node and checks no thread is left."""
    tmp = tmp_path_factory.mktemp("nodes")
    threads_before = set(threading.enumerate())
    obs_before = fabobs.active()
    en = chip_smoke.EndorseNet(seed=3191, n_txs=TXS)
    en.genesis = en.cn.genesis(CHANNEL, orderer_type="solo", max_message_count=TXS,
                               batch_timeout="10m")
    genesis_raw = wire.encode(fabric.BLOCK, en.genesis)
    tmgr = bundle_from_genesis_block(wire.decode(fabric.BLOCK, genesis_raw), SW).msp_manager
    jmgr = jbundle.bundle_from_genesis_block(common_pb2.Block.FromString(genesis_raw),
                                             JSW).msp_manager
    policy = chip_smoke.CONFIG2_POLICY
    nodes, conns = [], []
    out = {"en": en, "tmp": tmp, "calls": 0, "tmgr": tmgr}
    try:
        torderer = OrdererNode(str(tmp / "t-orderer"), signer=en.cn.orderer, provider=SW)
        jorderer = JOrdererNode(str(tmp / "j-orderer"), signer=jax_signer(en.cn.orderer.node),
                                provider=JSW)
        for node, block in ((torderer, wire.decode(fabric.BLOCK, genesis_raw)),
                            (jorderer, common_pb2.Block.FromString(genesis_raw))):
            nodes.append(node)
            node.join_channel(block)
            node.start()
        tpeers, jpeers = [], []
        for k in range(2):
            peer = PeerNode(str(tmp / f"t-peer{k}"), tmgr, en.net.endorsers[k],
                            lambda cid: ChaincodeRegistry([ChaincodeDefinition(
                                "benchcc", en.net.policy)]),
                            ops_address="127.0.0.1:0" if k == 0 else None,
                            provider=SW, device="cpu")
            nodes.append(peer)
            peer.support.register("benchcc", chip_smoke.BenchCC(tshim))
            peer.join_channel(wire.decode(fabric.BLOCK, genesis_raw))
            peer.start()
            peer.start_deliver_for_channel(CHANNEL, [torderer.addr])
            tpeers.append(peer)
            jpeer = JPeerNode(str(tmp / f"j-peer{k}"), jmgr,
                              jax_signer(en.net.endorsers[k].node),
                              lambda cid: jval.ChaincodeRegistry([jval.ChaincodeDefinition(
                                  "benchcc", jdsl(policy))]), provider=JSW)
            nodes.append(jpeer)
            jpeer.support.register("benchcc", chip_smoke.BenchCC(jshim))
            jpeer.join_channel(common_pb2.Block.FromString(genesis_raw))
            jpeer.start()
            jpeer.start_deliver_for_channel(CHANNEL, jorderer.addr)
            jpeers.append(jpeer)
        peer_conns = [channel_to(p.addr) for p in tpeers]
        tconn, jconn = channel_to(torderer.addr), jserver.channel_to(jorderer.addr)
        conns += peer_conns + [tconn, jconn]
        statuses = []
        for rnd in range(2):
            endorsed = []
            for bundle, signed, _ in en.proposals(rnd, TXS):
                responses = [process_proposal(c, signed) for c in peer_conns]
                out["calls"] += 1
                assert [r["response"].get("status") for r in responses] == [200, 200]
                endorsed.append((bundle, responses))
            for env in en.envelopes(rnd, endorsed, TXS):
                raw = wire.encode(fabric.ENVELOPE, env)
                statuses.append((broadcast_envelope(tconn, env)["status"],
                                 jservices.broadcast_envelope(
                                     jconn, common_pb2.Envelope.FromString(raw)).status))
            wait_for(lambda: all(p.channels[CHANNEL].ledger.height == rnd + 2 for p in tpeers)
                     and all(p.channels[CHANNEL].ledger.height == rnd + 2 for p in jpeers),
                     f"block {rnd + 1} on every peer")
        assert statuses == [(200, 200)] * (2 * TXS)
        for p in tpeers:
            assert p.commit_pipeline(CHANNEL).drain(timeout=60)
        for p in jpeers:
            assert p.commit_pipeline(CHANNEL).drain(timeout=60)
        out["tblocks"] = [[p.channels[CHANNEL].ledger.block_store.get_block_by_number(n)
                           for n in range(3)] for p in tpeers]
        out["jblocks"] = [[wire.decode(fabric.BLOCK, p.channels[CHANNEL].ledger.block_store
                                       .get_block_by_number(n).SerializeToString())
                           for n in range(3)] for p in jpeers]
        ops = tpeers[0].ops.addr
        with urllib.request.urlopen(f"http://{ops}/healthz", timeout=10) as resp:
            out["healthz"] = (resp.status, resp.read())
        with urllib.request.urlopen(f"http://{ops}/metrics", timeout=10) as resp:
            out["metrics"] = resp.read().decode()
        out["discovery"] = {what: discover(tpeers[0].addr, en.net.client, CHANNEL, what)
                            for what in ("peers", "config")}
        out["deliver_errors"] = [dict(p.deliver_errors) for p in tpeers]
    finally:
        for conn in conns:
            conn.close()
        # the JAX nodes first: what they leave running (their deliver loops
        # and commit pipelines) is not the port's
        for node in nodes:
            if type(node).__module__.startswith("fabric_tpu."):
                node.stop()
        time.sleep(0.5)
        jax_left = set(threading.enumerate()) - threads_before
        for node in nodes:
            if type(node).__module__.startswith("fabric_tpu_torch."):
                node.stop()
        if obs_before is None:
            fabobs.disable()
    deadline = time.monotonic() + 10
    port_left = []
    while time.monotonic() < deadline:
        port_left = [t.name for t in threading.enumerate()
                     if t not in threads_before and t not in jax_left and t.is_alive()]
        if not port_left:
            break
        time.sleep(0.05)
    out["threads_left"] = port_left
    return out


def test_blocks_filters_and_hashes_equal_jax(networks):
    t, j = networks["tblocks"], networks["jblocks"]
    for n in range(1, 3):
        want = j[0][n]
        for blocks in (t[0], t[1], j[1]):
            b = blocks[n]
            assert (b["header"], b["data"]) == (want["header"], want["data"])
            for slot in (fabric.TRANSACTIONS_FILTER, fabric.COMMIT_HASH):
                assert b["metadata"]["metadata"][slot] == want["metadata"]["metadata"][slot]
    en = networks["en"]
    assert [t[0][n]["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER]
            for n in (1, 2)] == [en.codes(0, TXS), en.codes(1, TXS)]


def test_state_rows_equal_jax(networks):
    tmp = networks["tmp"]
    for table in ("state", "history"):
        want = rows(tmp / "j-peer0" / CHANNEL / f"{CHANNEL}.state.db", table)
        assert want
        for peer in ("j-peer1", "t-peer0", "t-peer1"):
            assert rows(tmp / peer / CHANNEL / f"{CHANNEL}.state.db", table) == want


def test_operations_and_discovery(networks):
    assert networks["healthz"] == (200, b'{"status":"OK"}')
    line = ('grpc_server_unary_requests_completed{service="protos.Endorser",'
            f'method="ProcessProposal",code="OK"}} {networks["calls"]}')
    assert line in networks["metrics"].splitlines()
    assert "ledger_block_processing_time_count" in networks["metrics"]
    disc = networks["discovery"]
    assert [p["msp_id"] for p in disc["peers"]] == ["Org1MSP"]
    assert disc["config"]["msps"] == ["OrdererMSP", "Org1MSP", "Org2MSP", "Org3MSP"]
    assert not any(networks["deliver_errors"])


def test_no_thread_left_after_stop(networks):
    assert networks["threads_left"] == []


def test_healthz_names_a_rescuing_serve_client(networks, tmp_path):
    """A serve client that rescued a batch in process latches `degraded`;
    through the node's BatchingProvider /healthz answers 503 naming it."""
    obs_before = fabobs.active()
    client = SidecarProvider("127.0.0.1:1", fallback=SW)
    client.degraded = True
    peer = PeerNode(str(tmp_path / "peer"), networks["tmgr"], networks["en"].net.endorsers[0],
                    lambda cid: ChaincodeRegistry([]), ops_address="127.0.0.1:0",
                    provider=client, device="cpu")
    try:
        peer.start()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://{peer.ops.addr}/healthz", timeout=10)
        assert err.value.code == 503
        assert json.loads(err.value.read())["failed_checks"] == [{
            "component": "bccsp-device",
            "reason": "verify sidecar unavailable: batches rescued in process"}]
    finally:
        peer.stop()
        if obs_before is None:
            fabobs.disable()


def test_raft_cluster_elects_forwards_and_fails_over(tmp_path):
    en = chip_smoke.EndorseNet(seed=3192, n_txs=1)
    ports = chip_smoke.free_ports(3)
    genesis = en.cn.genesis("raftchan", orderer_type="etcdraft", max_message_count=1,
                            batch_timeout="100ms",
                            raft_consenters=[("127.0.0.1", p, b"", b"") for p in ports])
    signers = en.consenter_signers()
    before = set(threading.enumerate())
    nodes = {}

    def start(i):
        node = OrdererNode(str(tmp_path / f"o{i}"), signer=signers[i - 1],
                           listen_address=f"127.0.0.1:{ports[i - 1]}", provider=SW,
                           raft_node_id=i, raft_tick_seconds=0.05)
        node.join_channel(genesis)
        node.start()
        nodes[i] = node

    def chain(i):
        return nodes[i].registrar.get_chain("raftchan").chain

    def leaders(ids):
        return [i for i in ids if chain(i).node.role == "leader"]

    try:
        for i in (1, 2, 3):
            start(i)
        wait_for(lambda: len(leaders([1, 2, 3])) == 1, "a leader")
        leader = leaders([1, 2, 3])[0]
        follower = next(i for i in (1, 2, 3) if i != leader)
        conn = channel_to(nodes[follower].addr)
        env = wire.decode(fabric.ENVELOPE, envelope(en.net.client, "raftchan", b"tx-1"))
        assert broadcast_envelope(conn, env) == {"status": 200}
        conn.close()
        wait_for(lambda: all(chain(i).height >= 2 for i in (1, 2, 3)), "block 1")
        # the leader stops: the survivors re-elect and keep ordering
        nodes[leader].stop()
        live = [i for i in (1, 2, 3) if i != leader]
        wait_for(lambda: len(leaders(live)) == 1, "a new leader")
        target = next(i for i in live if i not in leaders(live))
        conn = channel_to(nodes[target].addr)
        env = wire.decode(fabric.ENVELOPE, envelope(en.net.client, "raftchan", b"tx-2"))
        assert broadcast_envelope(conn, env) == {"status": 200}
        conn.close()
        wait_for(lambda: all(chain(i).height >= 3 for i in live), "block 2")
        # the stopped node restarts on its directory and port and catches up
        start(leader)
        # a block is readable once stored, a moment after the height moves
        wait_for(lambda: all(chain(i).get_block(2) is not None for i in (1, 2, 3)),
                 "the restarted node's catch-up")
        blocks = [[chain(i).get_block(n) for n in range(3)] for i in (1, 2, 3)]
        assert all((b[n]["header"], b[n]["data"]) == (blocks[0][n]["header"],
                                                      blocks[0][n]["data"])
                   for b in blocks for n in range(3))
        assert all(n.loop_error is None for n in nodes.values())
    finally:
        for node in nodes.values():
            node.stop()
    deadline = time.monotonic() + 10
    while [t for t in threading.enumerate() if t not in before and t.is_alive()]:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in before)
        time.sleep(0.05)


@pytest.fixture
def stand_ins(monkeypatch):
    """The card's kernels stood in for: K2 by the P-256 oracle (one count a
    call, the key combs on a provider's first sight of a key), K5 by its
    plain version counted once a call."""
    oracle = chip_smoke.oracle_provider({})

    def batch_verify_async(self, keys, signatures, digests):
        if not signatures:
            return lambda: []
        seen = self.__dict__.setdefault("_stand_in_keys", set())
        if any(k.point not in seen for k in keys):
            p256k.LAUNCHES["p256_key_tables"] += 1
            seen.update(k.point for k in keys)
        p256k.LAUNCHES["p256_verify_bytes"] += 1
        self._inputs = (True, (np.zeros(4096),))
        verdicts = oracle.batch_verify(keys, signatures, digests)
        return lambda: verdicts

    def verify(self, key, signature, digest):
        return batch_verify_async(self, [key], [signature], [digest])()[0]

    real_resolve = md.resolve

    def resolve(*args, **kw):
        md.LAUNCHES["mvcc_resolve"] += 1
        return real_resolve(*args, **kw)

    monkeypatch.setattr(CUDAProvider, "batch_verify_async", batch_verify_async)
    monkeypatch.setattr(CUDAProvider, "verify", verify)
    monkeypatch.setattr(md, "resolve", resolve)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_nodes_config2_small(stand_ins, capsys):
    launches = chip_smoke.nodes_phase(torch, np, torch.device("cpu"), n_txs=10, ccaas_txs=2)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    phase = next(ln for ln in lines if ln.get("phase") == "nodes_config2")
    assert launches["mvcc_resolve"] == 4 and launches["p256_key_tables"] >= 1
    assert phase["broadcast"]["success"] == 20 and phase["broadcast"]["forbidden"] == 12
    assert phase["leaders"][0] != phase["leaders"][1]
    assert phase["process_proposal_calls"] == 44
    by_role = phase["launches_by_role"]
    assert by_role["peer0"]["mvcc_resolve"] == by_role["peer1"]["mvcc_resolve"] == 2
    assert by_role["orderers"]["p256_verify_bytes"] >= 48
    assert [b["block"] for b in phase["ms_per_block_cut_to_commit"]] == [1, 2]
    assert all(phase["equal"].values())
