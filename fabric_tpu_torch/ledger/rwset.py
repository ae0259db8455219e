"""Read/write-set datamodel (reference rwsetutil + kvrwset protos).

A copy of the JAX package's `ledger/rwset`.

Shapes mirror fabric-protos ledger/rwset/kvrwset (KVRead/KVWrite/
RangeQueryInfo/KVReadHash/KVWriteHash) and rwsetutil's internal TxRwSet /
NsRwSet / CollHashedRwSet (core/ledger/kvledger/txmgmt/rwsetutil/
rwset_proto_util.go:32-48).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True, order=True)
class Version:
    """Logical version = (block height, tx index) —
    reference core/ledger/internal/version.Height."""

    block_num: int
    tx_num: int


def versions_same(a: Optional[Version], b: Optional[Version]) -> bool:
    """reference version.AreSame: nil == nil, nil != non-nil."""
    return a == b


@dataclass(frozen=True)
class KVRead:
    key: str
    version: Optional[Version]  # None: key did not exist at simulation time


@dataclass(frozen=True)
class KVWrite:
    key: str
    is_delete: bool = False
    value: bytes = b""


@dataclass(frozen=True)
class RangeQueryInfo:
    """Phantom-read check payload. raw_reads is the observed result list;
    reads_merkle_hashes (max_degree, max_level, max_level_hashes) is the
    space-saving Merkle summary the reference uses for big result sets
    (kvrwset.QueryReadsMerkleSummary, built by
    rwsetutil/query_results_helper.go)."""

    start_key: str
    end_key: str
    itr_exhausted: bool
    raw_reads: Tuple[KVRead, ...] = ()
    reads_merkle_hashes: Optional[Tuple[int, int, Tuple[bytes, ...]]] = None


@dataclass(frozen=True)
class KVMetadataWrite:
    """Key-level metadata update (kvrwset.KVMetadataWrite). `entries` is
    a name->value tuple list; None entries means metadata delete
    (reference tx_ops.go applyMetadata: nil Entries -> metadataDelete)."""

    key: str
    entries: Optional[Tuple[Tuple[str, bytes], ...]] = None


@dataclass(frozen=True)
class KVMetadataWriteHash:
    key_hash: bytes
    entries: Optional[Tuple[Tuple[str, bytes], ...]] = None


@dataclass(frozen=True)
class KVReadHash:
    key_hash: bytes
    version: Optional[Version]


@dataclass(frozen=True)
class KVWriteHash:
    key_hash: bytes
    is_delete: bool = False
    value_hash: bytes = b""


@dataclass(frozen=True)
class CollHashedRwSet:
    collection_name: str
    hashed_reads: Tuple[KVReadHash, ...] = ()
    hashed_writes: Tuple[KVWriteHash, ...] = ()
    metadata_writes: Tuple[KVMetadataWriteHash, ...] = ()


@dataclass(frozen=True)
class NsRwSet:
    namespace: str
    reads: Tuple[KVRead, ...] = ()
    writes: Tuple[KVWrite, ...] = ()
    range_queries: Tuple[RangeQueryInfo, ...] = ()
    coll_hashed: Tuple[CollHashedRwSet, ...] = ()
    metadata_writes: Tuple[KVMetadataWrite, ...] = ()


@dataclass(frozen=True)
class TxRwSet:
    ns_rw_sets: Tuple[NsRwSet, ...] = ()
