"""MVCC validation and update-batch preparation.

Host-sequential reference semantics, mirroring
core/ledger/kvledger/txmgmt/validation/validator.go:82-281 exactly:

- transactions scan in block order; each VALID tx's writes apply to the
  running update batch before the next tx validates (apply-as-you-go);
- a public read conflicts if (a) the key was written by a preceding valid
  tx in this block (updates.Exists) or (b) the committed version differs
  from the read version (version.AreSame) -> MVCC_READ_CONFLICT;
- range queries re-execute against committed-state + in-block updates
  (updates shadow, deletes hide) and compare results ->
  PHANTOM_READ_CONFLICT;
- hashed (private-collection) reads check like public reads ->
  MVCC_READ_CONFLICT.

A copy of the JAX package's `ledger/mvcc`, with the metadata codec over
the port's wire codec. This module is the oracle and the host route; the
device fixpoint path for the no-range-query common case lives in
mvcc_device.py (K5/K6, csrc/mvcc_resolve.cu).
Merkle-summarized range queries (rangequery_validator.go hash variant)
re-execute through the same results helper as simulation and compare
summaries incrementally (_validate_merkle_range_query below).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common.txflags import TxValidationCode
from fabric_tpu_torch.ledger.merkle import RangeQueryResultsHelper
from fabric_tpu_torch.ledger.rwset import (
    KVRead,
    RangeQueryInfo,
    TxRwSet,
    Version,
    versions_same,
)
from fabric_tpu_torch.ledger.statedb import (
    HashedUpdateBatch,
    UpdateBatch,
    VersionedDB,
)
from fabric_tpu_torch.protos import wire


def serialize_metadata_entries(entries) -> bytes:
    """statemetadata.Serialize: KVMetadataWrite{entries} proto bytes (the
    statedb storage form of key metadata)."""
    return wire.encode(
        wire.KV_METADATA_WRITE,
        {"entries": [{"name": name, "value": value} for name, value in entries]},
    )


def deserialize_metadata(metadata_bytes: Optional[bytes]) -> Optional[dict]:
    """statemetadata.Deserialize: storage bytes -> {name: value}."""
    if metadata_bytes is None:
        return None
    msg = wire.decode(wire.KV_METADATA_WRITE, metadata_bytes)
    return {e.get("name", ""): e.get("value", b"") for e in msg.get("entries", ())}


def _combined_range_iter(
    db: VersionedDB,
    updates: UpdateBatch,
    ns: str,
    start_key: str,
    end_key: str,
    include_end: bool,
) -> Iterator[Tuple[str, Version]]:
    """Merge committed state with pending in-block updates for a range scan
    (reference combined_iterator.go): updates take precedence; deletes in
    updates hide committed keys."""
    upd_in_range = sorted(
        (key, val)
        for (uns, key), val in updates.items()
        if uns == ns
        and key >= start_key
        and (not end_key or (key <= end_key if include_end else key < end_key))
    )
    upd_idx = 0
    committed = db.get_state_range(ns, start_key, end_key, include_end)

    def next_committed():
        return next(committed, None)

    cur = next_committed()
    while cur is not None or upd_idx < len(upd_in_range):
        if upd_idx < len(upd_in_range) and (cur is None or upd_in_range[upd_idx][0] <= cur[0]):
            key, entry = upd_in_range[upd_idx]
            if cur is not None and cur[0] == key:
                cur = next_committed()  # shadowed
            upd_idx += 1
            if entry.value is not None:  # deletes yield nothing
                yield key, entry.version
        else:
            assert cur is not None
            yield cur[0], cur[1].version
            cur = next_committed()


class Validator:
    """Block-level MVCC validator over a VersionedDB."""

    def __init__(self, db: VersionedDB):
        self.db = db

    def validate_and_prepare_batch(
        self,
        block_num: int,
        tx_rwsets: Sequence[Optional[TxRwSet]],
        incoming_codes: Sequence[TxValidationCode],
        do_mvcc: bool = True,
    ) -> Tuple[List[TxValidationCode], UpdateBatch, HashedUpdateBatch]:
        """Returns final per-tx codes plus the prepared update batches.

        incoming_codes carry the upstream (signature/policy) verdicts:
        only txs arriving VALID are MVCC-checked and applied
        (reference kvledger commit path: txvalidator flags first, then
        validateAndPrepareBatch skips already-invalid txs).
        """
        updates = UpdateBatch()
        hashed_updates = HashedUpdateBatch()
        out: List[TxValidationCode] = []
        for tx_num, (rwset, code) in enumerate(zip(tx_rwsets, incoming_codes, strict=True)):
            if code != TxValidationCode.VALID or rwset is None:
                out.append(code)
                continue
            vcode = self._validate_tx(rwset, updates, hashed_updates) if do_mvcc else TxValidationCode.VALID
            out.append(vcode)
            if vcode == TxValidationCode.VALID:
                self._apply_write_set(
                    rwset, Version(block_num, tx_num), updates, hashed_updates
                )
        return out, updates, hashed_updates

    # -- per-tx validation (validator.go validateTx) ----------------------
    def _validate_tx(
        self, rwset: TxRwSet, updates: UpdateBatch, hashed_updates: HashedUpdateBatch
    ) -> TxValidationCode:
        for ns_rw in rwset.ns_rw_sets:
            ns = ns_rw.namespace
            for read in ns_rw.reads:
                if not self._validate_kv_read(ns, read, updates):
                    return TxValidationCode.MVCC_READ_CONFLICT
            for rqi in ns_rw.range_queries:
                if not self._validate_range_query(ns, rqi, updates):
                    return TxValidationCode.PHANTOM_READ_CONFLICT
            for coll in ns_rw.coll_hashed:
                for hread in coll.hashed_reads:
                    if hashed_updates.contains(ns, coll.collection_name, hread.key_hash):
                        return TxValidationCode.MVCC_READ_CONFLICT
                    committed = self.db.get_key_hash_version(
                        ns, coll.collection_name, hread.key_hash
                    )
                    if not versions_same(committed, hread.version):
                        return TxValidationCode.MVCC_READ_CONFLICT
        return TxValidationCode.VALID

    def _validate_kv_read(self, ns: str, read: KVRead, updates: UpdateBatch) -> bool:
        if updates.exists(ns, read.key):
            return False
        return versions_same(self.db.get_version(ns, read.key), read.version)

    def _validate_range_query(
        self, ns: str, rqi: RangeQueryInfo, updates: UpdateBatch
    ) -> bool:
        # ItrExhausted=false: EndKey is the last key actually seen, so the
        # re-execution must include it (validator.go validateRangeQuery).
        include_end = not rqi.itr_exhausted
        actual = _combined_range_iter(
            self.db, updates, ns, rqi.start_key, rqi.end_key, include_end
        )
        if rqi.reads_merkle_hashes is not None:
            return self._validate_merkle_range_query(rqi, actual)
        for expected in rqi.raw_reads:
            got = next(actual, None)
            if got is None or got[0] != expected.key or not versions_same(got[1], expected.version):
                return False
        return next(actual, None) is None

    @staticmethod
    def _validate_merkle_range_query(rqi: RangeQueryInfo, actual) -> bool:
        """Re-execute the range and rebuild the Merkle summary with the
        recorded max_degree, comparing max-level hashes as they finalize
        so a mismatch in the early results exits before hashing the rest
        (rangequery_validator.go rangeQueryHashValidator.validate)."""
        in_degree, in_level, in_hashes = rqi.reads_merkle_hashes
        if in_degree < 2:
            # a crafted/zero-default summary must invalidate THIS tx as a
            # phantom read, not raise out of the whole block commit (the
            # _MerkleTree constructor rejects max_degree < 2)
            return False
        helper = RangeQueryResultsHelper(True, in_degree)
        last_matched = -1
        for key, version in actual:
            helper.add_result(KVRead(key, version))
            _deg, level, hashes = helper.merkle_summary()
            if level < in_level:
                continue  # still under construction, nothing to compare
            # >= (not ==): a level spill can shrink the in-construction
            # list below entries we already matched; defer to the final
            # post-done() comparison instead of indexing past it
            if last_matched >= len(hashes) - 1:
                continue
            if len(hashes) > len(in_hashes):
                return False  # more entries than simulation recorded
            last_matched += 1
            if hashes[last_matched] != in_hashes[last_matched]:
                return False
        _raw, summary = helper.done()
        return summary == rqi.reads_merkle_hashes

    # -- write application (tx_ops.go prepareTxOps + applyWriteSet) -------
    # keyOps flags mirroring tx_ops.go:160-167
    _UPSERT = 1
    _MD_UPDATE = 2
    _MD_DELETE = 4
    _KEY_DELETE = 8

    def _apply_write_set(
        self,
        rwset: TxRwSet,
        height: Version,
        updates: UpdateBatch,
        hashed_updates: HashedUpdateBatch,
    ) -> None:
        """Apply one VALID tx's writes to the running batch, merging value
        and metadata updates like the reference's prepareTxOps: a
        value-only write carries forward the latest metadata, a
        metadata-only write carries forward the latest value (and is a
        no-op if the key does not exist)."""
        txops: dict = {}  # (ns, coll, key) -> [flags, value, metadata]

        def op(ck):
            return txops.setdefault(ck, [0, None, None])

        for ns_rw in rwset.ns_rw_sets:
            ns = ns_rw.namespace
            for w in ns_rw.writes:
                o = op((ns, "", w.key))
                if w.is_delete:
                    o[0] |= self._KEY_DELETE
                else:
                    o[0] |= self._UPSERT
                    o[1] = w.value
            for mw in ns_rw.metadata_writes:
                o = op((ns, "", mw.key))
                if mw.entries is None:
                    o[0] |= self._MD_DELETE
                else:
                    o[0] |= self._MD_UPDATE
                    o[2] = serialize_metadata_entries(mw.entries)
            for coll in ns_rw.coll_hashed:
                cname = coll.collection_name
                for hw in coll.hashed_writes:
                    o = op((ns, cname, hw.key_hash))
                    if hw.is_delete:
                        o[0] |= self._KEY_DELETE
                    else:
                        o[0] |= self._UPSERT
                        o[1] = hw.value_hash
                for mw in coll.metadata_writes:
                    o = op((ns, cname, mw.key_hash))
                    if mw.entries is None:
                        o[0] |= self._MD_DELETE
                    else:
                        o[0] |= self._MD_UPDATE
                        o[2] = serialize_metadata_entries(mw.entries)

        for (ns, coll, key), (flags, value, metadata) in txops.items():
            if flags & self._KEY_DELETE:
                if coll == "":
                    updates.delete(ns, key, height)
                else:
                    hashed_updates.put(ns, coll, key, None, height)
                continue
            upsert = bool(flags & self._UPSERT)
            md_touched = bool(flags & (self._MD_UPDATE | self._MD_DELETE))
            if upsert and not md_touched:
                # merge the latest committed / in-block metadata
                metadata = self._latest_metadata(
                    ns, coll, key, updates, hashed_updates
                )
            elif md_touched and not upsert:
                value = self._latest_value(
                    ns, coll, key, updates, hashed_updates
                )
                if value is None:
                    continue  # metadata on a non-existent key: no-op
            if coll == "":
                updates.put(ns, key, value, height, metadata)
            else:
                hashed_updates.put(ns, coll, key, value, height, metadata)

    def _latest_value(self, ns, coll, key, updates, hashed_updates):
        if coll == "":
            entry = updates.get(ns, key)
            if entry is not None:
                return entry.value
            vv = self.db.get_state(ns, key)
            return vv.value if vv else None
        entry = hashed_updates.get(ns, coll, key)
        if entry is not None:
            return entry.value
        vv = self.db.get_hashed_state(ns, coll, key)
        return vv.value if vv else None

    def _latest_metadata(self, ns, coll, key, updates, hashed_updates):
        if coll == "":
            entry = updates.get(ns, key)
            if entry is not None:
                return entry.metadata
            return self.db.get_state_metadata(ns, key)
        entry = hashed_updates.get(ns, coll, key)
        if entry is not None:
            return entry.metadata
        return self.db.get_hashed_metadata(ns, coll, key)
