"""Private-data store (reference core/ledger/pvtdatastorage/store.go).

The port's counterpart of the JAX package's `ledger/pvtdatastore`, with its
file format unchanged: the same records give the same `.pvtdata` bytes.

Persists per-block private write-sets (cleartext TxPvtReadWriteSet
payloads) next to the block store, with:

* BTL (block-to-live) expiry per (namespace, collection) — expired
  entries are purged at commit time (pvtstatepurgemgmt analog);
* missing-data bookkeeping for collections the peer is entitled to but
  did not have at commit (feeds the reconciler, reconcile_missing_
  pvtdata.go);
* commit protocol: prepare(block_num, data) then committed marker, so a
  crash between pvtdata and block commit is detectable on recovery
  (store.go Commit + pendingCommit semantics).

File format: one append-only file of doubly-checksummed records
(``u32 len || u32 crc32(len) || body || u32 crc32(body)`` — the block
store's frame discipline):
  record = {block_num, [(tx_num, ns, coll, rwset_bytes)], [missing keys]}
serialized as a PvtBlockRecord proto-free binary layout (length-prefixed
fields) — simple, deterministic, rebuildable by scan like the block store,
and carrying the same crash-consistency contract: a torn
tail record is truncated on recovery (loud log +
``fabric_ledger_torn_tail_total``); damage one interrupted append cannot
explain (including a corrupted length prefix, caught by the header
checksum) fails closed via :class:`~fabric_tpu_torch.ledger.blockstore.
LedgerCorruptionError` (salvageable with FABRIC_TPU_RECOVERY_STRICT=0).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.ledger.blockstore import (
    frame_header,
    fsync_dir,
    read_frame_header,
    refuse_corrupt,
)

logger = must_get_logger("pvtdatastore")


@dataclass(frozen=True)
class PvtEntry:
    tx_num: int
    namespace: str
    collection: str
    rwset: bytes  # serialized KVRWSet (cleartext writes)


@dataclass(frozen=True)
class MissingEntry:
    tx_num: int
    namespace: str
    collection: str
    eligible: bool = True  # peer is entitled but lacked the data


def _w_bytes(out: bytearray, b: bytes) -> None:
    out += struct.pack("<I", len(b))
    out += b


def _r_bytes(buf: memoryview, off: int) -> Tuple[bytes, int]:
    (ln,) = struct.unpack_from("<I", buf, off)
    off += 4
    if off + ln > len(buf):
        raise ValueError("truncated record")
    return bytes(buf[off : off + ln]), off + ln


class PvtDataStore:
    def __init__(self, path: str, btl_policy=None):
        """btl_policy: callable (ns, coll) -> int blocks-to-live (0 = keep
        forever), matching the reference's BTLPolicy from collection
        configs."""
        self.path = path
        self.btl = btl_policy or (lambda ns, coll: 0)
        # block_num -> entries (committed, unexpired)
        self._by_block: Dict[int, List[PvtEntry]] = {}
        self._missing: Dict[int, List[MissingEntry]] = {}
        self._last_committed = -1
        self._closed = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._recover()
        self._f = open(self.path, "ab")

    # -- persistence ------------------------------------------------------
    def _refuse(self, why: str) -> None:
        """Same fail-closed discipline as BlockStore._refuse: strict
        (default) raises; FABRIC_TPU_RECOVERY_STRICT=0 salvages."""
        refuse_corrupt(
            logger, f"pvtdata store {self.path}", why, "corrupt-pvtdata",
            "truncate to the last whole record",
        )

    def _recover(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        buf = memoryview(data)
        off = 0
        valid_end = 0
        refused = False  # salvage truncation, NOT a benign torn tail
        while off < len(data):
            if off + 8 > len(buf):
                break  # torn header at the tail
            ln = read_frame_header(bytes(buf[off : off + 8]))
            if ln is None:
                # a full header failing its own checksum is corruption
                # (a torn append leaves a PREFIX of a valid record)
                self._refuse(f"record header checksum failed at offset {off}")
                refused = True
                break
            end = off + 8 + ln + 4
            if end > len(buf):
                break  # header-validated length overshoots EOF: torn tail
            body = bytes(buf[off + 8 : off + 8 + ln])
            (crc,) = struct.unpack_from("<I", buf, off + 8 + ln)
            if zlib.crc32(body) != crc:
                # one interrupted append can only damage the LAST record
                if end < len(data):
                    self._refuse(f"checksum mismatch at offset {off}")
                    refused = True
                break
            try:
                self._load_record(body)
            except (struct.error, ValueError, IndexError):
                # checksum-valid but undecodable: fully written garbage,
                # never a torn append
                self._refuse(f"checksummed record at offset {off} does not parse")
                refused = True
                break
            off = end
            valid_end = off
        if valid_end != len(data):
            if refused:
                logger.critical(
                    "pvtdata store %s: salvage dropped %d bytes "
                    "(FABRIC_TPU_RECOVERY_STRICT=0)",
                    self.path, len(data) - valid_end,
                )
            else:
                logger.warning(
                    "pvtdata store %s: truncating %d-byte torn tail "
                    "(crash recovery)", self.path, len(data) - valid_end,
                )
                fabobs.obs_count(
                    "fabric_ledger_torn_tail_total", store="pvtdata"
                )
            with open(self.path, "ab") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
            fsync_dir(self.path)

    def _load_record(self, rec: bytes) -> None:
        """Replay one record. Multiple records for the same block are the
        backfill case (commit_pvt_data_of_old_blocks appends): entries
        accumulate and clear any matching missing markers, reproducing
        the in-memory state at the time of the crash."""
        buf = memoryview(rec)
        (block_num, n_entries, n_missing) = struct.unpack_from("<QII", buf, 0)
        # Each entry consumes >= 4 bytes, so a count larger than the crc'd
        # body is a corrupt or hostile record: refuse it before the loops
        # allocate per-count (the decode_verify_request discipline).
        if n_entries > len(rec) or n_missing > len(rec):
            raise ValueError(
                f"pvt record counts exceed body size (entries={n_entries} "
                f"missing={n_missing} len={len(rec)})"
            )
        off = 16
        entries = []
        for _ in range(n_entries):
            (tx_num,) = struct.unpack_from("<I", buf, off)
            off += 4
            ns, off = _r_bytes(buf, off)
            coll, off = _r_bytes(buf, off)
            rwset, off = _r_bytes(buf, off)
            entries.append(PvtEntry(tx_num, ns.decode(), coll.decode(), rwset))
        missing = []
        for _ in range(n_missing):
            (tx_num, eligible) = struct.unpack_from("<IB", buf, off)
            off += 5
            ns, off = _r_bytes(buf, off)
            coll, off = _r_bytes(buf, off)
            missing.append(
                MissingEntry(tx_num, ns.decode(), coll.decode(), bool(eligible))
            )
        self._by_block.setdefault(block_num, []).extend(entries)
        still = [
            m
            for m in self._missing.get(block_num, [])
            if not any(
                e.tx_num == m.tx_num
                and e.namespace == m.namespace
                and e.collection == m.collection
                for e in entries
            )
        ] + missing
        if still:
            self._missing[block_num] = still
        else:
            self._missing.pop(block_num, None)
        self._last_committed = max(self._last_committed, block_num)

    def _append_record(
        self,
        block_num: int,
        entries: Sequence[PvtEntry],
        missing: Sequence[MissingEntry],
    ) -> None:
        body = bytearray(struct.pack("<QII", block_num, len(entries), len(missing)))
        for e in entries:
            body += struct.pack("<I", e.tx_num)
            _w_bytes(body, e.namespace.encode())
            _w_bytes(body, e.collection.encode())
            _w_bytes(body, e.rwset)
        for m in missing:
            body += struct.pack("<IB", m.tx_num, int(m.eligible))
            _w_bytes(body, m.namespace.encode())
            _w_bytes(body, m.collection.encode())
        body_bytes = bytes(body)
        out = bytearray(frame_header(len(body_bytes)))
        out += body_bytes
        out += struct.pack("<I", zlib.crc32(body_bytes))
        self._f.write(out)
        self._f.flush()
        os.fsync(self._f.fileno())
        fsync_dir(self.path)

    # -- commit path (store.go Commit) ------------------------------------
    def commit(
        self,
        block_num: int,
        entries: Sequence[PvtEntry],
        missing: Sequence[MissingEntry] = (),
    ) -> None:
        if block_num <= self._last_committed:
            raise ValueError(
                f"pvtdata for block {block_num} already committed "
                f"(last committed {self._last_committed})"
            )
        self._append_record(block_num, entries, missing)
        self._by_block[block_num] = list(entries)
        if missing:
            self._missing[block_num] = list(missing)
        self._last_committed = block_num
        self._purge_expired(block_num)

    def _purge_expired(self, current_block: int) -> None:
        """BTL purge (pvtstatepurgemgmt): entries whose
        birth + btl < current are dropped from the in-memory view; the
        file keeps history (compaction is a rewrite, as in the reference's
        leveldb purge batches)."""
        for bnum in list(self._by_block):
            kept = []
            for e in self._by_block[bnum]:
                btl = self.btl(e.namespace, e.collection)
                if btl and bnum + btl < current_block:
                    continue
                kept.append(e)
            if kept:
                self._by_block[bnum] = kept
            elif self._by_block[bnum]:
                self._by_block[bnum] = []

    # -- queries ----------------------------------------------------------
    def get_pvt_data_by_block(self, block_num: int) -> List[PvtEntry]:
        return list(self._by_block.get(block_num, []))

    def get_pvt_data(
        self, block_num: int, tx_num: int
    ) -> List[PvtEntry]:
        return [
            e for e in self._by_block.get(block_num, []) if e.tx_num == tx_num
        ]

    @property
    def last_committed_block(self) -> int:
        return self._last_committed

    # -- missing data / reconciliation ------------------------------------
    def get_missing_pvt_data(
        self, max_blocks: int = 0
    ) -> Dict[int, List[MissingEntry]]:
        """Oldest-first missing-data view (GetMissingPvtDataInfoForMostRecentBlocks
        inverted to oldest-first for deterministic reconciliation)."""
        out: Dict[int, List[MissingEntry]] = {}
        for bnum in sorted(self._missing):
            out[bnum] = list(self._missing[bnum])
            if max_blocks and len(out) >= max_blocks:
                break
        return out

    def commit_pvt_data_of_old_blocks(
        self, block_num: int, entries: Sequence[PvtEntry]
    ) -> None:
        """Reconciler write-back (CommitPvtDataOfOldBlocks): store
        late-arriving pvtdata and clear the matching missing markers."""
        if block_num > self._last_committed:
            raise ValueError("cannot backfill a block that is not committed")
        self._append_record(block_num, entries, ())
        self._by_block.setdefault(block_num, []).extend(entries)
        still = [
            m
            for m in self._missing.get(block_num, [])
            if not any(
                e.tx_num == m.tx_num
                and e.namespace == m.namespace
                and e.collection == m.collection
                for e in entries
            )
        ]
        if still:
            self._missing[block_num] = still
        else:
            self._missing.pop(block_num, None)

    def rollback_to(self, height: int) -> None:
        """Drop every record for block >= height and compact the file
        (KVLedger.rollback counterpart; the reference's pvtdata store
        rollback in kvledger rollback.go)."""
        self._f.close()
        self._by_block = {b: e for b, e in self._by_block.items() if b < height}
        self._missing = {b: m for b, m in self._missing.items() if b < height}
        self._last_committed = max(self._by_block, default=-1)
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            self._f = f
            for bnum in sorted(self._by_block):
                self._append_record(
                    bnum, self._by_block[bnum], self._missing.get(bnum, [])
                )
        os.replace(tmp, self.path)
        fsync_dir(self.path)
        self._f = open(self.path, "ab")
        self._closed = False

    def close(self) -> None:
        """Idempotent; tolerates a partially-constructed store."""
        if self._closed:
            return
        self._closed = True
        f = getattr(self, "_f", None)
        if f is not None:
            f.close()
