"""Range-query results Merkle summarization.

A copy of the JAX package's `ledger/merkle`; the leaf pre-image goes
through the port's wire codec and is protobuf's, byte for byte.

Mirrors reference rwsetutil/query_results_helper.go: results stream in
one at a time; once more than `max_degree` accumulate, the batch is
proto-serialized (kvrwset.QueryReads), hashed, and becomes a leaf-level
node in a degree-bounded Merkle tree.  If the total result count never
exceeds `max_degree`, no hashing happens and the raw reads are kept —
exactly the reference's space/size trade.

The summary triple (max_degree, max_level, max_level_hashes) is what
lands in RangeQueryInfo.reads_merkle_hashes and what the validator's
re-execution must reproduce (rangequery_validator.go
rangeQueryHashValidator).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.protos import wire

LEAF_LEVEL = 1


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def serialize_kv_reads(reads: List[rw.KVRead]) -> bytes:
    """proto.Marshal(QueryReads{kv_reads}) — the leaf pre-image
    (query_results_helper.go serializeKVReads)."""
    kv_reads = []
    for r in reads:
        kr = {"key": r.key}
        if r.version is not None:
            kr["version"] = {"block_num": r.version.block_num, "tx_num": r.version.tx_num}
        kv_reads.append(kr)
    return wire.encode(wire.QUERY_READS, {"kv_reads": kv_reads})


class _MerkleTree:
    """Degree-bounded incremental tree (query_results_helper.go
    merkleTree): a level spills into its parent as soon as it exceeds
    max_degree nodes; done() folds leftovers upward."""

    def __init__(self, max_degree: int):
        if max_degree < 2:
            raise ValueError("max_degree must be >= 2")
        self.tree: Dict[int, List[bytes]] = {}
        self.max_level = LEAF_LEVEL
        self.max_degree = max_degree

    def update(self, leaf_hash: bytes) -> None:
        self.tree.setdefault(LEAF_LEVEL, []).append(leaf_hash)
        level = LEAF_LEVEL
        while len(self.tree.get(level, ())) > self.max_degree:
            combined = _hash(b"".join(self.tree[level]))
            del self.tree[level]
            level += 1
            self.tree.setdefault(level, []).append(combined)
            self.max_level = max(self.max_level, level)

    def done(self) -> None:
        level = LEAF_LEVEL
        while level < self.max_level:
            hashes = self.tree.get(level, ())
            if not hashes:
                level += 1
                continue
            h = hashes[0] if len(hashes) == 1 else _hash(b"".join(hashes))
            self.tree.pop(level, None)
            level += 1
            self.tree.setdefault(level, []).append(h)
        final = self.tree.get(self.max_level, ())
        if len(final) > self.max_degree:
            combined = _hash(b"".join(final))
            del self.tree[self.max_level]
            self.max_level += 1
            self.tree[self.max_level] = [combined]

    def is_empty(self) -> bool:
        return self.max_level == LEAF_LEVEL and not self.tree.get(LEAF_LEVEL)

    def summary(self) -> Tuple[int, int, Tuple[bytes, ...]]:
        return (
            self.max_degree,
            self.max_level,
            tuple(self.tree.get(self.max_level, ())),
        )


class RangeQueryResultsHelper:
    """Feed results with add_result(); done() returns
    (raw_reads | None, summary | None) — exactly one non-None unless no
    results were ever added (then raw_reads is an empty tuple)."""

    def __init__(self, enable_hashing: bool, max_degree: int = 50):
        self.pending: List[rw.KVRead] = []
        self.hashing = enable_hashing
        self.max_degree = max_degree
        self.mt = _MerkleTree(max_degree) if enable_hashing else None

    def add_result(self, read: rw.KVRead) -> None:
        self.pending.append(read)
        if self.hashing and len(self.pending) > self.max_degree:
            self._process_pending()

    def _process_pending(self) -> None:
        assert self.mt is not None
        data = serialize_kv_reads(self.pending)
        self.pending = []
        self.mt.update(_hash(data))

    def merkle_summary(self) -> Optional[Tuple[int, int, Tuple[bytes, ...]]]:
        """Intermediate summary for the validator's early-mismatch exit
        (GetMerkleSummary)."""
        if not self.hashing:
            return None
        return self.mt.summary()

    def done(self):
        if not self.hashing or self.mt.is_empty():
            return tuple(self.pending), None
        if self.pending:
            self._process_pending()
        self.mt.done()
        return (), self.mt.summary()
