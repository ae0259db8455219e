"""TxReadWriteSet proto bytes -> TxRwSet (reference rwsetutil.TxRwSetFromProtoMsg).

The port's counterpart of `_parse_version` and `parse_tx_rwset` in the JAX
package's `ledger/txparse`, over the hand-written wire codec. Malformed bytes
raise `ValueError` (`wire.WireError`) wherever `protoutil.unmarshal` raises.
The envelope parse comes with the block-validator path.
"""

from __future__ import annotations

from typing import Optional, Tuple

from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.protos import wire


def _parse_version(v: Optional[dict]) -> Optional[rw.Version]:
    """A present but empty Version message is Version(0, 0); an absent one is None."""
    if v is None:
        return None
    return rw.Version(v.get("block_num", 0), v.get("tx_num", 0))


def _read(r: dict) -> rw.KVRead:
    return rw.KVRead(r.get("key", ""), _parse_version(r.get("version")))


def _entries(m: dict):
    # proto3 cannot tell nil from empty entries; like the reference, empty
    # means metadata delete (None here)
    return tuple((e.get("name", ""), e.get("value", b"")) for e in m.get("entries", ())) or None


def parse_tx_rwset(results: bytes) -> rw.TxRwSet:
    txrw = wire.decode(wire.TX_RWSET, results)
    ns_sets = []
    for ns in txrw.get("ns_rwset", ()):
        kv = wire.decode(wire.KV_RWSET, ns.get("rwset", b""))
        reads = tuple(_read(r) for r in kv.get("reads", ()))
        writes = tuple(
            rw.KVWrite(w.get("key", ""), w.get("is_delete", False), w.get("value", b""))
            for w in kv.get("writes", ())
        )
        md_writes = tuple(
            rw.KVMetadataWrite(m.get("key", ""), _entries(m)) for m in kv.get("metadata_writes", ())
        )
        rqs = []
        for q in kv.get("range_queries_info", ()):
            raw_reads: Tuple[rw.KVRead, ...] = ()
            merkle = None
            if "raw_reads" in q:
                raw_reads = tuple(_read(r) for r in q["raw_reads"].get("kv_reads", ()))
            if "reads_merkle_hashes" in q:
                m = q["reads_merkle_hashes"]
                merkle = (
                    m.get("max_degree", 0),
                    m.get("max_level", 0),
                    tuple(m.get("max_level_hashes", ())),
                )
            rqs.append(
                rw.RangeQueryInfo(
                    q.get("start_key", ""), q.get("end_key", ""), q.get("itr_exhausted", False),
                    raw_reads, merkle,
                )
            )
        colls = []
        for coll in ns.get("collection_hashed_rwset", ()):
            h = wire.decode(wire.HASHED_RWSET, coll.get("hashed_rwset", b""))
            colls.append(
                rw.CollHashedRwSet(
                    coll.get("collection_name", ""),
                    tuple(
                        rw.KVReadHash(r.get("key_hash", b""), _parse_version(r.get("version")))
                        for r in h.get("hashed_reads", ())
                    ),
                    tuple(
                        rw.KVWriteHash(
                            w.get("key_hash", b""), w.get("is_delete", False), w.get("value_hash", b"")
                        )
                        for w in h.get("hashed_writes", ())
                    ),
                    tuple(
                        rw.KVMetadataWriteHash(m.get("key_hash", b""), _entries(m))
                        for m in h.get("metadata_writes", ())
                    ),
                )
            )
        ns_sets.append(
            rw.NsRwSet(
                ns.get("namespace", ""), reads, writes, tuple(rqs), tuple(colls), md_writes
            )
        )
    return rw.TxRwSet(tuple(ns_sets))
