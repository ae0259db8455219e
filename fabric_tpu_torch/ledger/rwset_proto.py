"""TxRwSet -> TxReadWriteSet proto bytes (reference rwsetutil/rwset_proto_util.go).

The port's counterpart of the JAX package's `ledger/rwset_proto.serialize_tx_rwset`,
written over the hand-written wire codec; the bytes are protobuf's, byte for byte.
"""

from __future__ import annotations

from typing import Optional

from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.protos import wire


def _version(version: Optional[rw.Version]) -> Optional[dict]:
    if version is None:
        return None
    return {"block_num": version.block_num, "tx_num": version.tx_num}


def _entries(entries) -> list:
    return [{"name": name, "value": value} for name, value in entries or ()]


def _range_query(q: rw.RangeQueryInfo) -> dict:
    out = {"start_key": q.start_key, "end_key": q.end_key, "itr_exhausted": q.itr_exhausted}
    if q.reads_merkle_hashes is not None:
        degree, level, hashes = q.reads_merkle_hashes
        out["reads_merkle_hashes"] = {
            "max_degree": degree, "max_level": level, "max_level_hashes": list(hashes),
        }
    else:
        # present even when empty, as rq.raw_reads.SetInParent() makes it
        out["raw_reads"] = {
            "kv_reads": [{"key": r.key, "version": _version(r.version)} for r in q.raw_reads]
        }
    return out


def serialize_tx_rwset(txrw: rw.TxRwSet) -> bytes:
    ns_out = []
    for ns in txrw.ns_rw_sets:
        kv = {
            "reads": [{"key": r.key, "version": _version(r.version)} for r in ns.reads],
            "range_queries_info": [_range_query(q) for q in ns.range_queries],
            "writes": [
                {"key": w.key, "is_delete": w.is_delete, "value": w.value} for w in ns.writes
            ],
            "metadata_writes": [
                {"key": mw.key, "entries": _entries(mw.entries)} for mw in ns.metadata_writes
            ],
        }
        colls = []
        for coll in ns.coll_hashed:
            h = {
                "hashed_reads": [
                    {"key_hash": hr.key_hash, "version": _version(hr.version)}
                    for hr in coll.hashed_reads
                ],
                "hashed_writes": [
                    {"key_hash": hw.key_hash, "is_delete": hw.is_delete, "value_hash": hw.value_hash}
                    for hw in coll.hashed_writes
                ],
                "metadata_writes": [
                    {"key_hash": mw.key_hash, "entries": _entries(mw.entries)}
                    for mw in coll.metadata_writes
                ],
            }
            colls.append({
                "collection_name": coll.collection_name,
                "hashed_rwset": wire.encode(wire.HASHED_RWSET, h),
            })
        ns_out.append({
            "namespace": ns.namespace,
            "rwset": wire.encode(wire.KV_RWSET, kv),
            "collection_hashed_rwset": colls,
        })
    return wire.encode(wire.TX_RWSET, {"ns_rwset": ns_out})
