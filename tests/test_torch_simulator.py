"""The port's TxSimulator (fabric_tpu_torch.ledger.simulator) against the
JAX package's, with no tolerance: the same seeded state in both packages'
VersionedDB, the same seeded sequence of reads, writes, deletes, range scans
(raw reads and Merkle summaries), rich and paginated queries, metadata
writes and private data, and the TxReadWriteSet and TxPvtReadWriteSet
bytes equal byte for byte; the read-only rule after a paginated query, the
closed simulator, composite keys. tests/test_endorser.py's simulator cases
run against the port here too."""

import hashlib
import json

import numpy as np
import pytest

from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.ledger import simulator as jsim
from fabric_tpu.ledger import statedb as jdb
from fabric_tpu.protos import rwset_pb2
from fabric_tpu_torch.ledger import rwset as trw
from fabric_tpu_torch.ledger import simulator as tsim
from fabric_tpu_torch.ledger import statedb as tdb
from fabric_tpu_torch.ledger.mvcc import serialize_metadata_entries
from fabric_tpu_torch.protos import wire

NAMESPACES = ("mycc", "othercc")
COLLECTIONS = ("secret", "shared")


def _value(rng, key):
    if rng.rand() < 0.4:
        return json.dumps({"owner": f"o{rng.randint(4)}", "size": int(rng.randint(100)),
                           "key": key}, sort_keys=True).encode()
    return bytes(rng.randint(0, 256, size=int(rng.randint(1, 12))).astype(np.uint8))


def seeded_dbs(seed, n_keys=140):
    """Both packages' VersionedDB over the same seeded public, hashed and
    private state (some keys with metadata)."""
    dbs = [(db_mod.VersionedDB(), db_mod, rw_mod) for db_mod, rw_mod in ((jdb, jrw), (tdb, trw))]
    for db, db_mod, rw_mod in dbs:
        r = np.random.RandomState(seed)
        batch, hashed, pvt = db_mod.UpdateBatch(), db_mod.HashedUpdateBatch(), db_mod.PvtUpdateBatch()
        for i in range(n_keys):
            ns = NAMESPACES[i % 2]
            key = f"k{i:03d}"
            meta = (serialize_metadata_entries([("VALIDATION_PARAMETER", b"vp%d" % i)])
                    if i % 7 == 0 else None)
            batch.put(ns, key, _value(r, key), rw_mod.Version(1 + i // 50, i % 50), meta)
        for i in range(20):
            coll = COLLECTIONS[i % 2]
            key = f"p{i:02d}"
            value = b"secret-%d" % i
            hashed.put("mycc", coll, hashlib.sha256(key.encode()).digest(),
                       hashlib.sha256(value).digest(), rw_mod.Version(3, i))
            pvt.put("mycc", coll, key, value, rw_mod.Version(3, i))
        db.apply_updates(batch, hashed, pvt)
    return dbs[0][0], dbs[1][0]


def ops_for(seed, n_ops=60):
    """A seeded list of simulator calls: (method, args)."""
    rng = np.random.RandomState(seed + 1000)
    ops = []
    for _ in range(n_ops):
        ns = NAMESPACES[int(rng.randint(2))]
        key = f"k{int(rng.randint(160)):03d}"
        kind = rng.randint(9)
        if kind == 0:
            ops.append(("get_state", (ns, key)))
        elif kind == 1:
            ops.append(("set_state", (ns, key, _value(rng, key))))
        elif kind == 2:
            ops.append(("delete_state", (ns, key)))
        elif kind == 3:
            lo, hi = sorted(int(x) for x in rng.randint(160, size=2))
            ops.append(("get_state_range_scan_iterator", (ns, f"k{lo:03d}",
                                                           f"k{hi:03d}" if rng.rand() < 0.8 else "")))
        elif kind == 4:
            entries = None if rng.rand() < 0.3 else {"VALIDATION_PARAMETER": b"x%d" % rng.randint(9),
                                                     "other": b"y"}
            ops.append(("set_state_metadata", (ns, key, entries)))
        elif kind == 5:
            ops.append(("get_state_metadata", (ns, key)))
        elif kind == 6:
            coll = COLLECTIONS[int(rng.randint(2))]
            ops.append(("get_private_data", ("mycc", coll, f"p{int(rng.randint(25)):02d}")))
        elif kind == 7:
            coll = COLLECTIONS[int(rng.randint(2))]
            if rng.rand() < 0.7:
                ops.append(("set_private_data", ("mycc", coll, f"p{int(rng.randint(25)):02d}",
                                                 b"new-%d" % rng.randint(99))))
            else:
                ops.append(("delete_private_data", ("mycc", coll, f"p{int(rng.randint(25)):02d}")))
        else:
            coll = COLLECTIONS[int(rng.randint(2))]
            ops.append(("get_private_data_hash", ("mycc", coll, f"p{int(rng.randint(25)):02d}")))
    return ops


def run(sim, ops):
    out = []
    for name, args in ops:
        got = getattr(sim, name)(*args)
        out.append(list(got) if name == "get_state_range_scan_iterator" else got)
    return out


def pvt_reader(db):
    return lambda ns, coll, key: (lambda vv: vv.value if vv else None)(
        db.get_private_data(ns, coll, key))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_degree", [50, 3, 0])
def test_rwset_bytes_equal_jax(seed, max_degree):
    """Public and private rwset bytes for the same state and calls (range
    scans past the Merkle degree summarize; 0 keeps raw reads)."""
    jd, td = seeded_dbs(seed)
    ops = ops_for(seed)
    js = jsim.TxSimulator(jd, tx_id="tx", pvt_reader=pvt_reader(jd),
                          range_query_hashing_max_degree=max_degree)
    ts = tsim.TxSimulator(td, tx_id="tx", pvt_reader=pvt_reader(td),
                          range_query_hashing_max_degree=max_degree)
    assert run(ts, ops) == run(js, ops)
    jr, tr = js.get_tx_simulation_results(), ts.get_tx_simulation_results()
    assert tr.public_bytes == jr.public_bytes
    assert tr.pvt_rwset_bytes() == jr.pvt_rwset_bytes()
    assert sorted(tr.pvt_writes) == sorted(jr.pvt_writes)
    for k in jr.pvt_writes:
        assert (tsim.collection_kvrwset_bytes(tr.pvt_writes[k])
                == jsim.collection_kvrwset_bytes(jr.pvt_writes[k]))
    assert tr.public_bytes
    # the port's TxPvtReadWriteSet schema reads protobuf's bytes as protobuf does
    pb = rwset_pb2.TxPvtReadWriteSet()
    pb.ParseFromString(jr.pvt_rwset_bytes())
    decoded = wire.decode(wire.TX_PVT_RWSET, jr.pvt_rwset_bytes())
    assert [n["namespace"] for n in decoded.get("ns_pvt_rwset", [])] == [
        n.namespace for n in pb.ns_pvt_rwset]
    assert wire.encode(wire.TX_PVT_RWSET, decoded) == pb.SerializeToString()


def test_range_scan_summary_past_the_degree():
    """A scan of more keys than the Merkle degree records the summary, in
    both packages, with the same bytes."""
    jd, td = seeded_dbs(7)
    out = []
    for mod, db in ((jsim, jd), (tsim, td)):
        sim = mod.TxSimulator(db, range_query_hashing_max_degree=4)
        rows = list(sim.get_state_range_scan_iterator("mycc", "", ""))
        res = sim.get_tx_simulation_results()
        rq = res.rwset.ns_rw_sets[0].range_queries[0]
        out.append((rows, rq.raw_reads, rq.reads_merkle_hashes is not None, res.public_bytes))
    assert len(out[1][0]) == 70 and out[1][2] and out[1][1] == ()
    assert out[1][0] == out[0][0] and out[1][3] == out[0][3]


@pytest.mark.parametrize("seed", range(3))
def test_queries_and_pagination_equal_jax(seed):
    """Rich queries add no reads; a paginated range records plain reads and
    its bookmark; a paginated query makes the transaction read-only."""
    jd, td = seeded_dbs(seed)
    query = {"selector": {"owner": "o1"}}
    results = []
    for mod, db in ((jsim, jd), (tsim, td)):
        sim = mod.TxSimulator(db)
        rich = sim.execute_query("mycc", json.dumps(query))
        page, mark = sim.get_state_range_with_pagination("othercc", "k010", "k090", 7)
        page2, mark2 = sim.get_state_range_with_pagination("othercc", "k010", "k090", 7, mark)
        qpage, qmark = sim.execute_query_with_pagination("mycc", json.dumps(query), 3)
        with pytest.raises(mod.SimulationError, match="paginated queries"):
            sim.set_state("mycc", "k001", b"x")
        with pytest.raises(mod.SimulationError, match="paginated queries"):
            sim.delete_state("mycc", "k001")
        with pytest.raises(ValueError, match="pageSize"):
            sim.get_state_range_with_pagination("mycc", "", "", 0)
        res = sim.get_tx_simulation_results()
        with pytest.raises(mod.SimulationError, match="closed"):
            sim.get_state("mycc", "k001")
        results.append((rich, page, mark, page2, mark2, qpage, qmark, res.public_bytes))
    assert results[1] == results[0]
    assert results[1][0] and results[1][2] == "k025"  # othercc holds the odd keys


def test_empty_key_refused_alike():
    for mod, db_mod in ((jsim, jdb), (tsim, tdb)):
        sim = mod.TxSimulator(db_mod.VersionedDB())
        with pytest.raises(mod.SimulationError, match="empty key"):
            sim.set_state("mycc", "", b"v")
        with pytest.raises(mod.SimulationError, match="empty key"):
            sim.set_private_data("mycc", "c", "", b"v")


@pytest.mark.parametrize("attrs", [[], ["red"], ["red", "car1"], ["a~b", "", "z"]])
def test_composite_keys_equal_jax(attrs):
    key = tsim.create_composite_key("Color~Name", attrs)
    assert key == jsim.create_composite_key("Color~Name", attrs)
    assert tsim.split_composite_key(key) == jsim.split_composite_key(key)


def test_endorser_suite_simulator_cases():
    """tests/test_endorser.py's simulator cases against the port."""
    db = tdb.VersionedDB()
    batch = tdb.UpdateBatch()
    batch.put("mycc", "a", b"100", trw.Version(1, 0))
    batch.put("mycc", "b", b"200", trw.Version(1, 1))
    batch.put("mycc", "c", b"300", trw.Version(2, 0))
    db.apply_updates(batch)
    sim = tsim.TxSimulator(db)
    assert sim.get_state("mycc", "a") == b"100"
    assert sim.get_state("mycc", "missing") is None
    sim.set_state("mycc", "a", b"1")
    sim.set_state("mycc", "a", b"2")
    assert sim.get_state("mycc", "a") == b"100"  # no read-your-writes
    sim.delete_state("mycc", "b")
    assert list(sim.get_state_range_scan_iterator("mycc", "a", "c")) == [
        ("a", b"100"), ("b", b"200")]
    sim.set_private_data("mycc", "secret", "k1", b"top")
    res = sim.get_tx_simulation_results()
    ns = res.rwset.ns_rw_sets[0]
    assert ns.reads == (trw.KVRead("a", trw.Version(1, 0)), trw.KVRead("missing", None))
    assert ns.writes == (trw.KVWrite("a", False, b"2"), trw.KVWrite("b", True, b""))
    rq = ns.range_queries[0]
    assert (rq.start_key, rq.end_key, rq.itr_exhausted) == ("a", "c", True)
    assert [r.key for r in rq.raw_reads] == ["a", "b"]
    w = ns.coll_hashed[0].hashed_writes[0]
    assert w.key_hash == hashlib.sha256(b"k1").digest()
    assert w.value_hash == hashlib.sha256(b"top").digest()
    assert res.pvt_writes[("mycc", "secret")][0].value == b"top"
