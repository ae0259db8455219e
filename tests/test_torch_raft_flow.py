"""chip_smoke.py's raft_config2 phase at a small size on the CPU: the
endorse_config2 phase (`chip_smoke.endorse_phase`, 10 transactions a block)
endorses, orders on its SoloChain and commits three rounds, keeping the
envelopes; then `chip_smoke.raft_phase` broadcasts the same envelopes to a
three-node raft cluster of the port through a non-leader, refuses the
flipped and outsider envelopes, partitions the leader after block 1,
restarts it from its WAL, delivers every block to two fresh peers whose
first endpoint is the partitioned leader, replicates them to a follower
orderer and asks discovery, with every check of the phase (the solo
chain's headers and data, the consenters' and the follower's blocks, each
signature, both peers' filters, commit hashes, stored blocks and rows
against endorse_config2's, every K2 lane against hostec_np). The card's
kernels are stood in for as the verify skill describes: K2 by the P-256
oracle over a memo (one count a call, the key combs on a provider's first
sight of a key), K5 by its plain version counted once a call."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.ledger import mvcc_device as md
from fabric_tpu_torch.ops import p256_kernel as p256k
from torch_untraced import untraced  # noqa: F401


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


def test_raft_config2_small(stand_ins, capsys):
    dev = torch.device("cpu")
    kept = {}
    chip_smoke.endorse_phase(torch, np, dev, n_txs=10, keep=kept)
    launches = chip_smoke.raft_phase(torch, np, dev, kept["endorse_config2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    phase = next(ln for ln in lines if ln.get("phase") == "raft_config2")
    assert launches["mvcc_resolve"] == 6 and launches["p256_key_tables"] >= 1
    assert phase["broadcast"]["success"] == 30 and phase["broadcast"]["forbidden"] == 12
    assert phase["broadcast"]["forwarded"] >= 30
    assert phase["leaders"][0] != phase["leaders"][1]
    assert phase["k2_launches_by_role"]["sigfilter"] >= 68
    assert phase["deliver_sessions"] >= 3
    split = phase["ms_per_envelope"]
    assert set(split) == {"unpack", "sigfilter", "propose", "classify_filters_forward"}
    assert all(v > 0 for v in split.values())
    assert sum(split.values()) == pytest.approx(phase["ms_per_envelope_broadcast"])
    assert [b["block"] for b in phase["ms_per_block_cut_to_commit"]] == [1, 2, 3]
    assert all(phase["equal"].values())
