"""Transaction simulator + rwset builder (reference
core/ledger/kvledger/txmgmt/txmgr lockbased_txmgr.go NewTxSimulator and
rwsetutil/rwset_builder.go).

The port's counterpart of the JAX package's `ledger/simulator.py`, over the
port's state DBs (`ledger/statedb.VersionedDB`, `ledger/persistent.
SqliteVersionedDB`) and the wire codec: the same public and private rwset
bytes for the same state and the same calls.

Simulation runs against the committed state snapshot: reads record the
observed version (KVRead), writes are buffered (KVWrite, last-write-wins),
range scans record RangeQueryInfo for phantom-read revalidation, and
private-data writes produce both the cleartext TxPvtReadWriteSet (stored
off-block) and the on-block hashed rwset (CollHashedRwSet). Matching the
reference's lockbased simulator: reads do NOT observe the tx's own
buffered writes, and paginated/range queries after writes to the same
namespace are the caller's concern.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.ledger.merkle import RangeQueryResultsHelper
from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
from fabric_tpu_torch.ledger.statedb import VersionedDB
from fabric_tpu_torch.protos import wire

# TxReadWriteSet.DataModel
KV = 0

# Composite-key sentinel (reference shim uses U+0000 as min unicode rune).
COMPOSITE_KEY_NS = "\x00"
MAX_UNICODE_RUNE = "\U0010ffff"


@dataclass
class PvtKVWrite:
    key: str
    is_delete: bool
    value: bytes


@dataclass
class TxSimulationResults:
    """Public rwset (goes into the ChaincodeAction `results` field) plus
    the private cleartext write-sets keyed (namespace, collection)."""

    rwset: rw.TxRwSet
    pvt_writes: Dict[Tuple[str, str], List[PvtKVWrite]]

    @property
    def public_bytes(self) -> bytes:
        return serialize_tx_rwset(self.rwset)

    def pvt_rwset_bytes(self) -> bytes:
        """Serialized TxPvtReadWriteSet (rwset.proto:24) for the transient
        store / pvtdata store."""
        by_ns: Dict[str, Dict[str, List[PvtKVWrite]]] = {}
        for (ns, coll), writes in self.pvt_writes.items():
            by_ns.setdefault(ns, {})[coll] = writes
        return wire.encode(wire.TX_PVT_RWSET, {
            "data_model": KV,
            "ns_pvt_rwset": [
                {"namespace": ns, "collection_pvt_rwset": [
                    {"collection_name": coll, "rwset": collection_kvrwset_bytes(by_ns[ns][coll])}
                    for coll in sorted(by_ns[ns])]}
                for ns in sorted(by_ns)],
        })


def collection_kvrwset_bytes(writes: List[PvtKVWrite]) -> bytes:
    """One collection's cleartext writes -> serialized KVRWSet — the ONE
    encoding shared by the transient store, the pvt store and the gossip
    dissemination path (divergent copies would make pushed and stored
    payloads differ byte-for-byte)."""
    return wire.encode(wire.KV_RWSET, {"writes": [
        {"key": w.key, "is_delete": w.is_delete, "value": w.value} for w in writes]})


class SimulationError(Exception):
    pass


class TxSimulator:
    """rwset_builder.go semantics with deterministic output ordering
    (reads/writes sorted by key at GetTxSimulationResults time)."""

    def __init__(
        self,
        state_db: VersionedDB,
        tx_id: str = "",
        pvt_reader=None,  # callable (ns, coll, key) -> Optional[bytes]
        range_query_hashing_max_degree: int = 50,  # ledger config
        # MaxDegreeQueryReadsHashing default; 0 disables summarization
    ):
        self._db = state_db
        self.tx_id = tx_id
        self._pvt_reader = pvt_reader
        self._rq_max_degree = range_query_hashing_max_degree
        self._done = False
        # ns -> key -> KVRead (first read wins, like the reference builder)
        self._reads: Dict[str, Dict[str, rw.KVRead]] = {}
        self._writes: Dict[str, Dict[str, rw.KVWrite]] = {}
        self._metadata_writes: Dict[str, Dict[str, rw.KVMetadataWrite]] = {}
        self._range_queries: Dict[str, List[rw.RangeQueryInfo]] = {}
        self._hashed_reads: Dict[Tuple[str, str], Dict[bytes, rw.KVReadHash]] = {}
        self._hashed_writes: Dict[Tuple[str, str], Dict[bytes, rw.KVWriteHash]] = {}
        self._pvt_writes: Dict[Tuple[str, str], Dict[str, PvtKVWrite]] = {}
        # paginated queries restrict the tx to read-only (reference
        # lockbased_tx_simulator.go: checkBeforePaginatedQueries /
        # checkPaginatedQueryPerformed reject the mixed case)
        self._paginated_queries_performed = False

    def _check_open(self) -> None:
        if self._done:
            raise SimulationError("simulator already closed")

    # -- public state -----------------------------------------------------
    def get_state(self, ns: str, key: str) -> Optional[bytes]:
        self._check_open()
        vv = self._db.get_state(ns, key)
        self._reads.setdefault(ns, {}).setdefault(
            key, rw.KVRead(key, vv.version if vv else None)
        )
        return vv.value if vv else None

    def set_state(self, ns: str, key: str, value: bytes) -> None:
        self._check_open()
        self._check_no_paginated_queries()
        if not key:
            raise SimulationError("empty key is not supported")
        self._writes.setdefault(ns, {})[key] = rw.KVWrite(key, False, value)

    def delete_state(self, ns: str, key: str) -> None:
        self._check_open()
        self._check_no_paginated_queries()
        self._writes.setdefault(ns, {})[key] = rw.KVWrite(key, True, b"")

    def _check_no_paginated_queries(self) -> None:
        if self._paginated_queries_performed:
            raise SimulationError(
                "writes are not allowed in a transaction that has "
                "performed paginated queries (read-only contract)"
            )

    def get_state_metadata(self, ns: str, key: str) -> Optional[bytes]:
        self._check_open()
        return self._db.get_state_metadata(ns, key)

    def set_state_metadata(
        self, ns: str, key: str, entries: Optional[Dict[str, bytes]]
    ) -> None:
        """entries None = delete metadata (tx_ops.go metadataDelete)."""
        self._check_open()
        tup = (
            tuple(sorted(entries.items())) if entries is not None else None
        )
        self._metadata_writes.setdefault(ns, {})[key] = rw.KVMetadataWrite(key, tup)

    def get_state_range_scan_iterator(
        self, ns: str, start_key: str, end_key: str
    ) -> Iterator[Tuple[str, bytes]]:
        """Fully-consumed range scan recording RangeQueryInfo raw reads
        (validator.go:211-237 phantom-read input). The iterator is eager:
        itr_exhausted=True, matching a chaincode that drains the iterator;
        partial consumption would need the lazy form."""
        self._check_open()
        helper = RangeQueryResultsHelper(
            self._rq_max_degree > 0, max(self._rq_max_degree, 2)
        )
        results: List[Tuple[str, bytes]] = []
        for key, vv in self._db.get_state_range(ns, start_key, end_key, False):
            helper.add_result(rw.KVRead(key, vv.version))
            results.append((key, vv.value))
        raw_reads, summary = helper.done()
        self._range_queries.setdefault(ns, []).append(
            rw.RangeQueryInfo(
                start_key=start_key,
                end_key=end_key,
                itr_exhausted=True,
                raw_reads=raw_reads,
                reads_merkle_hashes=summary,
            )
        )
        return iter(results)

    def execute_query(self, ns: str, query) -> List[Tuple[str, bytes]]:
        """Rich selector query (chaincode GetQueryResult; reference
        statecouchdb.go:695). Like the reference's CouchDB path, results
        add NO reads to the rwset — rich queries are not phantom-protected
        (documented Fabric behavior)."""
        self._check_open()
        return self._db.execute_query(ns, query)

    # -- pagination (bookmark contract) -----------------------------------
    def execute_query_with_pagination(
        self, ns: str, query, page_size: int, bookmark: str = ""
    ) -> Tuple[List[Tuple[str, bytes]], str]:
        """GetQueryResultWithPagination (statecouchdb.go:653): one page +
        the resumption bookmark.  Like the reference
        (lockbased_tx_simulator.go checkBeforePaginatedQueries), paginated
        queries are for read-only transactions: performing one marks the
        simulation and later writes are rejected."""
        self._check_open()
        self._paginated_queries_performed = True
        return self._db.execute_query_paginated(ns, query, page_size, bookmark)

    def get_state_range_with_pagination(
        self, ns: str, start_key: str, end_key: str, page_size: int,
        bookmark: str = "",
    ) -> Tuple[List[Tuple[str, bytes]], str]:
        """GetStateByRangeWithPagination (statecouchdb.go:567): the
        bookmark is the next key to resume from; returned keys record
        plain reads (MVCC-protected) but no phantom-protecting range
        record, matching the reference's paginated range contract."""
        self._check_open()
        if page_size <= 0:
            raise ValueError("pageSize must be a positive integer")
        self._paginated_queries_performed = True
        start = bookmark or start_key
        results: List[Tuple[str, bytes]] = []
        next_bookmark = ""
        for key, vv in self._db.get_state_range(ns, start, end_key, False):
            if len(results) == page_size:
                next_bookmark = key
                break
            self._reads.setdefault(ns, {}).setdefault(
                key, rw.KVRead(key, vv.version)
            )
            results.append((key, vv.value))
        return results, next_bookmark

    # -- private data -----------------------------------------------------
    def get_private_data(self, ns: str, coll: str, key: str) -> Optional[bytes]:
        self._check_open()
        key_hash = hashlib.sha256(key.encode()).digest()
        version = self._db.get_key_hash_version(ns, coll, key_hash)
        self._hashed_reads.setdefault((ns, coll), {}).setdefault(
            key_hash, rw.KVReadHash(key_hash, version)
        )
        if self._pvt_reader is None:
            return None
        return self._pvt_reader(ns, coll, key)

    def get_private_data_hash(self, ns: str, coll: str, key: str) -> Optional[bytes]:
        """GetPrivateDataHash: readable by non-members; does NOT add to the
        read-set (reference simulator semantics)."""
        self._check_open()
        key_hash = hashlib.sha256(key.encode()).digest()
        vv = self._db.get_hashed_state(ns, coll, key_hash)
        return vv.value if vv else None

    def set_private_data(self, ns: str, coll: str, key: str, value: bytes) -> None:
        self._check_open()
        if not key:
            raise SimulationError("empty key is not supported")
        key_hash = hashlib.sha256(key.encode()).digest()
        self._hashed_writes.setdefault((ns, coll), {})[key_hash] = rw.KVWriteHash(
            key_hash, False, hashlib.sha256(value).digest()
        )
        self._pvt_writes.setdefault((ns, coll), {})[key] = PvtKVWrite(key, False, value)

    def delete_private_data(self, ns: str, coll: str, key: str) -> None:
        self._check_open()
        key_hash = hashlib.sha256(key.encode()).digest()
        self._hashed_writes.setdefault((ns, coll), {})[key_hash] = rw.KVWriteHash(
            key_hash, True, b""
        )
        self._pvt_writes.setdefault((ns, coll), {})[key] = PvtKVWrite(key, True, b"")

    # -- results ----------------------------------------------------------
    def get_tx_simulation_results(self) -> TxSimulationResults:
        self._check_open()
        self._done = True
        ns_names = sorted(
            set(self._reads)
            | set(self._writes)
            | set(self._metadata_writes)
            | set(self._range_queries)
            | {ns for ns, _ in self._hashed_reads}
            | {ns for ns, _ in self._hashed_writes}
        )
        ns_sets: List[rw.NsRwSet] = []
        for ns in ns_names:
            colls = sorted(
                {c for n, c in self._hashed_reads if n == ns}
                | {c for n, c in self._hashed_writes if n == ns}
            )
            coll_hashed = tuple(
                rw.CollHashedRwSet(
                    collection_name=coll,
                    hashed_reads=tuple(
                        self._hashed_reads.get((ns, coll), {})[kh]
                        for kh in sorted(self._hashed_reads.get((ns, coll), {}))
                    ),
                    hashed_writes=tuple(
                        self._hashed_writes.get((ns, coll), {})[kh]
                        for kh in sorted(self._hashed_writes.get((ns, coll), {}))
                    ),
                )
                for coll in colls
            )
            ns_sets.append(
                rw.NsRwSet(
                    namespace=ns,
                    reads=tuple(
                        self._reads.get(ns, {})[k]
                        for k in sorted(self._reads.get(ns, {}))
                    ),
                    writes=tuple(
                        self._writes.get(ns, {})[k]
                        for k in sorted(self._writes.get(ns, {}))
                    ),
                    range_queries=tuple(self._range_queries.get(ns, [])),
                    coll_hashed=coll_hashed,
                    metadata_writes=tuple(
                        self._metadata_writes.get(ns, {})[k]
                        for k in sorted(self._metadata_writes.get(ns, {}))
                    ),
                )
            )
        pvt = {
            (ns, coll): [w for _, w in sorted(writes.items())]
            for (ns, coll), writes in self._pvt_writes.items()
        }
        return TxSimulationResults(rwset=rw.TxRwSet(tuple(ns_sets)), pvt_writes=pvt)


def create_composite_key(object_type: str, attributes: List[str]) -> str:
    """shim.CreateCompositeKey: \\x00-delimited, validated UTF-8."""
    key = COMPOSITE_KEY_NS + object_type + COMPOSITE_KEY_NS
    for attr in attributes:
        key += attr + COMPOSITE_KEY_NS
    return key


def split_composite_key(key: str) -> Tuple[str, List[str]]:
    parts = key.split(COMPOSITE_KEY_NS)
    # parts[0] is empty (leading sentinel); last is empty (trailing)
    components = [p for p in parts[1:] if p != ""]
    return components[0], components[1:]
