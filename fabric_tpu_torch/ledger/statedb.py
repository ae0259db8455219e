"""Versioned state database (reference statedb SPI + stateleveldb).

A copy of the JAX package's in-memory `ledger/statedb`: (value, version)
per (namespace, key) plus the hashed private-data namespaces
(privacyenabledstate analog), a dict per namespace beside a sorted key
list for range scans, and the rich queries of `ledger/queries` over a
namespace's values. The persistent store is `ledger/persistent`.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

from fabric_tpu_torch.ledger.rwset import Version


@dataclass(frozen=True)
class VersionedValue:
    value: bytes
    version: Version
    metadata: Optional[bytes] = None  # serialized KVMetadataWrite entries


class BatchEntry(NamedTuple):
    """One pending update: value None = key delete; metadata is the
    serialized state metadata carried with the write (None = no
    metadata / metadata deleted)."""

    value: Optional[bytes]
    version: Version
    metadata: Optional[bytes] = None


class UpdateBatch:
    """Pending writes of a block (reference statedb.UpdateBatch): puts AND
    deletes both carry the committing version; deletes shadow reads."""

    def __init__(self):
        self._updates: Dict[Tuple[str, str], BatchEntry] = {}

    def put(
        self,
        ns: str,
        key: str,
        value: bytes,
        version: Version,
        metadata: Optional[bytes] = None,
    ) -> None:
        self._updates[(ns, key)] = BatchEntry(value, version, metadata)

    def delete(self, ns: str, key: str, version: Version) -> None:
        self._updates[(ns, key)] = BatchEntry(None, version)

    def exists(self, ns: str, key: str) -> bool:
        return (ns, key) in self._updates

    def get(self, ns: str, key: str) -> Optional[BatchEntry]:
        return self._updates.get((ns, key))

    def items(self):
        return self._updates.items()

    def __len__(self):
        return len(self._updates)


class HashedUpdateBatch:
    """Private-data hashed writes: keyed (ns, collection, key_hash)."""

    def __init__(self):
        self._updates: Dict[Tuple[str, str, bytes], BatchEntry] = {}

    def put(
        self,
        ns: str,
        coll: str,
        key_hash: bytes,
        value_hash: Optional[bytes],
        version: Version,
        metadata: Optional[bytes] = None,
    ) -> None:
        self._updates[(ns, coll, key_hash)] = BatchEntry(
            value_hash, version, metadata
        )

    def contains(self, ns: str, coll: str, key_hash: bytes) -> bool:
        return (ns, coll, key_hash) in self._updates

    def get(self, ns: str, coll: str, key_hash: bytes) -> Optional[BatchEntry]:
        return self._updates.get((ns, coll, key_hash))

    def items(self):
        return self._updates.items()

    def __len__(self):
        return len(self._updates)


class PvtUpdateBatch:
    """Cleartext private-data writes keyed (ns, collection, key)
    (reference privacyenabledstate UpdateBatch.PvtUpdates)."""

    def __init__(self):
        self._updates: Dict[Tuple[str, str, str], BatchEntry] = {}

    def put(
        self,
        ns: str,
        coll: str,
        key: str,
        value: Optional[bytes],
        version: Version,
    ) -> None:
        self._updates[(ns, coll, key)] = BatchEntry(value, version)

    def get(self, ns: str, coll: str, key: str) -> Optional[BatchEntry]:
        return self._updates.get((ns, coll, key))

    def items(self):
        return self._updates.items()

    def __len__(self):
        return len(self._updates)


class VersionedDB:
    """Committed state: (ns, key) -> VersionedValue, ordered per namespace."""

    def __init__(self):
        self._data: Dict[str, Dict[str, VersionedValue]] = {}
        self._sorted_keys: Dict[str, List[str]] = {}
        self._hashed: Dict[Tuple[str, str, bytes], VersionedValue] = {}
        self._pvt: Dict[Tuple[str, str, str], VersionedValue] = {}
        # coherence stamp for device-resident derived caches (see
        # SqliteVersionedDB.state_generation): out-of-band mutators
        # (rollback / rebuild / anything bypassing the validator flow)
        # must bump_generation() so resident version tables fail closed
        self.state_generation = 0

    def bump_generation(self) -> None:
        self.state_generation += 1

    # -- reads ------------------------------------------------------------
    def get_state(self, ns: str, key: str) -> Optional[VersionedValue]:
        return self._data.get(ns, {}).get(key)

    def get_state_metadata(self, ns: str, key: str) -> Optional[bytes]:
        """Serialized VALIDATION_PARAMETER et al. for a key (reference
        statedb GetStateMetadata)."""
        vv = self.get_state(ns, key)
        return vv.metadata if vv else None

    def get_version(self, ns: str, key: str) -> Optional[Version]:
        vv = self.get_state(ns, key)
        return vv.version if vv else None

    def get_hashed_state(
        self, ns: str, coll: str, key_hash: bytes
    ) -> Optional[VersionedValue]:
        return self._hashed.get((ns, coll, key_hash))

    def get_hashed_metadata(
        self, ns: str, coll: str, key_hash: bytes
    ) -> Optional[bytes]:
        vv = self._hashed.get((ns, coll, key_hash))
        return vv.metadata if vv else None

    def get_key_hash_version(self, ns: str, coll: str, key_hash: bytes) -> Optional[Version]:
        entry = self._hashed.get((ns, coll, key_hash))
        return entry.version if entry else None

    def get_private_data(
        self, ns: str, coll: str, key: str
    ) -> Optional[VersionedValue]:
        """Cleartext private read (privacyenabledstate GetPrivateData);
        returns None when this peer never received the collection data."""
        return self._pvt.get((ns, coll, key))

    def get_state_range(
        self, ns: str, start_key: str, end_key: str, include_end: bool
    ) -> Iterator[Tuple[str, VersionedValue]]:
        """Sorted iteration over [start_key, end_key) or [..., end_key].
        Empty end_key means an open-ended scan (reference semantics)."""
        keys = self._sorted_keys.get(ns, [])
        i = bisect.bisect_left(keys, start_key)
        table = self._data.get(ns, {})
        while i < len(keys):
            k = keys[i]
            if end_key:
                if include_end:
                    if k > end_key:
                        break
                elif k >= end_key:
                    break
            yield k, table[k]
            i += 1

    # -- writes -----------------------------------------------------------
    def apply_updates(
        self,
        batch: UpdateBatch,
        hashed: Optional[HashedUpdateBatch] = None,
        pvt: Optional[PvtUpdateBatch] = None,
    ) -> None:
        for (ns, key), entry in batch.items():
            table = self._data.setdefault(ns, {})
            keys = self._sorted_keys.setdefault(ns, [])
            if entry.value is None:
                if key in table:
                    del table[key]
                    idx = bisect.bisect_left(keys, key)
                    if idx < len(keys) and keys[idx] == key:
                        keys.pop(idx)
            else:
                if key not in table:
                    bisect.insort(keys, key)
                table[key] = VersionedValue(
                    entry.value, entry.version, entry.metadata
                )
        if hashed is not None:
            for (ns, coll, key_hash), entry in hashed.items():
                if entry.value is None:
                    self._hashed.pop((ns, coll, key_hash), None)
                else:
                    self._hashed[(ns, coll, key_hash)] = VersionedValue(
                        entry.value, entry.version, entry.metadata
                    )
        if pvt is not None:
            for (ns, coll, key), entry in pvt.items():
                if entry.value is None:
                    self._pvt.pop((ns, coll, key), None)
                else:
                    self._pvt[(ns, coll, key)] = VersionedValue(
                        entry.value, entry.version
                    )

    def num_keys(self) -> int:
        return sum(len(t) for t in self._data.values())

    # -- full iteration (snapshot export) ----------------------------------
    def iter_all_state(self) -> Iterator[Tuple[str, str, VersionedValue]]:
        """Deterministic (ns, key, value) iteration over all public state."""
        for ns in sorted(self._data):
            table = self._data[ns]
            for key in self._sorted_keys[ns]:
                yield ns, key, table[key]

    def iter_all_hashed(
        self,
    ) -> Iterator[Tuple[str, str, bytes, VersionedValue]]:
        for ns, coll, kh in sorted(self._hashed):
            yield ns, coll, kh, self._hashed[(ns, coll, kh)]

    # -- rich queries (statecouchdb.go:695 analog) -------------------------
    def execute_query(self, ns: str, query):
        """Selector query over a namespace's JSON values (see
        ledger/queries). Not phantom-protected, like the reference's
        CouchDB queries."""
        from fabric_tpu_torch.ledger import queries as rich_queries

        table = self._data.get(ns, {})
        rows = (
            (key, table[key].value) for key in self._sorted_keys.get(ns, [])
        )
        return rich_queries.execute(rows, query)

    def execute_query_paginated(
        self, ns: str, query, page_size: int, bookmark: str = ""
    ):
        """One page + next bookmark (statecouchdb.go:653
        ExecuteQueryWithPagination)."""
        from fabric_tpu_torch.ledger import queries as rich_queries

        table = self._data.get(ns, {})
        rows = (
            (key, table[key].value) for key in self._sorted_keys.get(ns, [])
        )
        return rich_queries.execute_paginated(rows, query, page_size, bookmark)
