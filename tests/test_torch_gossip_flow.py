"""chip_smoke.py's gossip_config2 phase at a small size on the CPU, against
the JAX package: the endorse_config2 phase (`chip_smoke.endorse_phase`, 10
transactions a block) endorses, orders and commits three rounds, keeping
its blocks; then `chip_smoke.gossip_phase` spreads them over loopback gRPC
to four port peers (P1 pulls block 1 and pushes it, P1 stops, P2 is elected
and pulls the rest, P3 gets them by push, P4 catches up by state transfer
alone), refuses forged alives, commits a block of 10 transactions writing
coll0 whose private write-sets the endorsers P2 and P3 push to each other,
and has P4 reconcile that block's private data, with every check of the
phase (endorse_config2's filters, commit hashes, stored blocks and rows,
the peers equal to each other, every K2 lane against hostec_np). Then the
JAX package's Channel commits the same blocks one at a time, the private
write-sets in its transient store: its filters and commit hashes, .chain
bytes, SQLite rows and private data equal the port peers'. The card's
kernels are stood in for as in tests/test_torch_raft_flow.py: K2 by the
P-256 oracle (K2's plain version takes about 5 s a call here), K5 by its
plain version, each counted once a call."""

import json
import sqlite3

import numpy as np
import pytest
import torch
from torch_untraced import untraced  # noqa: F401

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import chip_smoke  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.crypto.bccsp import SoftwareProvider  # noqa: E402
from fabric_tpu.gossip.coordinator import TransientStore as JTransient  # noqa: E402
from fabric_tpu.orderer import blockwriter as jbw  # noqa: E402
from fabric_tpu.peer.channel import Channel as JChannel  # noqa: E402
from fabric_tpu.policy import from_dsl as jdsl  # noqa: E402
from fabric_tpu.protos import common_pb2  # noqa: E402
from fabric_tpu.validation import validator as jval  # noqa: E402
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider  # noqa: E402
from fabric_tpu_torch.ledger import mvcc_device as md  # noqa: E402
from fabric_tpu_torch.ops import p256_kernel as p256k  # noqa: E402
from fabric_tpu_torch.protos import fabric, wire  # noqa: E402

SW = SoftwareProvider()
TXS = 10


@pytest.fixture
def stand_ins(monkeypatch):
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
        p256k.LAUNCHES["p256_verify_bytes"] += 1
        return oracle.verify(key, signature, digest)

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


def jax_channel(en, path, pvt_writes):
    """The JAX package's Channel on the genesis (its orderer signatures
    checked), the private write-sets in its transient store."""
    genesis_raw = wire.encode(fabric.BLOCK, en.genesis)
    bundle = jbundle.bundle_from_genesis_block(common_pb2.Block.FromString(genesis_raw), SW)
    registry = jval.ChaincodeRegistry([jval.ChaincodeDefinition(
        "benchcc", jdsl(chip_smoke.CONFIG2_POLICY))])
    transient = JTransient()
    for tx_id, writes in pvt_writes.items():
        for ns, coll, raw in writes:
            transient.persist(tx_id, ns, coll, raw)
    ch = JChannel(en.channel, path, bundle.msp_manager, registry, SW,
                  verify_orderer_sig=jbw.block_signature_verifier(lambda: bundle),
                  transient_store=transient)
    ch.ledger.commit(common_pb2.Block.FromString(genesis_raw))
    return ch


def rows(path):
    db = sqlite3.connect(str(path))
    try:
        return {t: sorted(db.execute(f"SELECT * FROM {t}").fetchall())
                for t in ("state", "hashed", "pvt", "history")}
    finally:
        db.close()


def test_gossip_config2_small_equals_jax(stand_ins, capsys, tmp_path):
    dev = torch.device("cpu")
    kept = {}
    # its own ledger directory: another worker may rehearse raft_config2's
    # endorse_config2 at the same time
    chip_smoke.endorse_phase(torch, np, dev, n_txs=TXS, keep=kept, root=tmp_path / "endorse")
    launches = chip_smoke.gossip_phase(torch, np, dev, kept["endorse_config2"], n_pvt_txs=TXS,
                                       wait_s=20.0, keep=kept)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    phase = next(ln for ln in lines if ln.get("phase") == "gossip_config2")
    assert launches["mvcc_resolve"] >= 10 and launches["p256_key_tables"] >= 1
    assert phase["leaders"] == ["peer0.org1.bench", "peer0.org2.bench"]
    assert phase["p4_catch_up"]["blocks"] == 3 and phase["pvt"]["reconciled"] == TXS
    assert phase["pvt"]["pushed_to_p3"] == TXS and phase["pvt"]["request_checks"] >= 1
    assert phase["alive_checks"]["count"] > 0 and phase["alive_checks"]["refused_forged"] == 1
    roles = phase["k2_launches_by_role"]
    assert roles["alive"] == phase["alive_checks"]["count"]
    assert roles["pvt"] == phase["pvt"]["request_checks"]
    assert roles["creator"] == 2 * TXS and roles["blocks"] >= 1
    assert all(phase["equal"].values())

    # the JAX Channel commits the same blocks one at a time
    got = kept["gossip_config2"]
    en = kept["endorse_config2"]["en"]
    ch = jax_channel(en, str(tmp_path / "jax"), got["pvt_writes"])
    jcommitted = []
    try:
        for raw in got["blocks"][1:]:
            b = common_pb2.Block.FromString(raw)
            jcommitted.append((ch.store_block(b).tobytes(),
                               b.metadata.metadata[fabric.COMMIT_HASH]))
        n = len(got["blocks"]) - 1
        jpvt = [(e.tx_num, e.namespace, e.collection, e.rwset)
                for t in range(TXS) for e in ch.ledger.pvt_store.get_pvt_data(n, t)]
    finally:
        ch.ledger.close()
    names = got["names"]
    assert got["committed"][names[0]] == jcommitted[:1]
    for name in names[1:]:
        assert got["committed"][name] == jcommitted
        assert got["chains"][name] == (tmp_path / "jax" / f"{en.channel}.chain").read_bytes()
        assert {t: got["rows"][name][t] for t in ("state", "hashed", "pvt", "history")} == rows(
            tmp_path / "jax" / f"{en.channel}.state.db")
        if name != names[0]:
            assert got["pvt"][name] == jpvt
    assert jpvt and all(coll == chip_smoke.GOSSIP_COLLECTION for _, _, coll, _ in jpvt)
