"""Persistent versioned state + history on an embedded B-tree (sqlite3).

The stateleveldb analog (reference core/ledger/kvledger/txmgmt/statedb/
stateleveldb/stateleveldb.go:185 ApplyUpdates; history db.go:79): state and
the history index live in ONE sqlite file per channel, written atomically
per block together with a savepoint. Restart recovery replays only the
blocks above the savepoint instead of the whole chain (the reference's
recoverDBs contract — state is a derived cache but recovery cost must not
grow with chain length).

sqlite is the idiomatic embedded choice here: it is in the Python stdlib
(no external service, matching the "pure-embedded equivalents" rule of
SURVEY.md §2.12 item 3), its B-tree gives ordered range scans like
LevelDB, and WAL-mode commits are atomic. Rich selector queries
(statecouchdb.go:695) run over the same rows via ledger/queries.

The port's counterpart of the JAX package's `ledger/persistent`, with the
same schema and writes: the same blocks give the same rows in every table.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterator, List, Optional, Tuple

from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.ledger import queries as rich_queries
from fabric_tpu_torch.ledger.rwset import Version
from fabric_tpu_torch.ledger.statedb import (
    BatchEntry,
    HashedUpdateBatch,
    PvtUpdateBatch,
    UpdateBatch,
    VersionedValue,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS state (
  ns TEXT NOT NULL, key TEXT NOT NULL,
  value BLOB NOT NULL, block INTEGER NOT NULL, txn INTEGER NOT NULL,
  metadata BLOB,
  PRIMARY KEY (ns, key)
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS hashed (
  ns TEXT NOT NULL, coll TEXT NOT NULL, keyhash BLOB NOT NULL,
  value BLOB NOT NULL, block INTEGER NOT NULL, txn INTEGER NOT NULL,
  metadata BLOB,
  PRIMARY KEY (ns, coll, keyhash)
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS pvt (
  ns TEXT NOT NULL, coll TEXT NOT NULL, key TEXT NOT NULL,
  value BLOB NOT NULL, block INTEGER NOT NULL, txn INTEGER NOT NULL,
  PRIMARY KEY (ns, coll, key)
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS history (
  ns TEXT NOT NULL, key TEXT NOT NULL,
  block INTEGER NOT NULL, txn INTEGER NOT NULL,
  PRIMARY KEY (ns, key, block, txn)
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS meta (
  k TEXT PRIMARY KEY, v BLOB NOT NULL
) WITHOUT ROWID;
"""


class SqliteVersionedDB:
    """Same read/write surface as statedb.VersionedDB, durably on disk."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        # one connection shared across the peer's threads (endorser gRPC
        # workers read while the commit pipeline writes); sqlite3 objects
        # are not thread-safe, so every access serializes on this lock
        self._lock = threading.RLock()
        self._closed = False
        # coherence stamp for device-resident derived caches
        # (mvcc_device.ResidentDeviceValidator): bumped whenever state is
        # mutated OUT OF BAND of the validator flow (clear / rebuild /
        # rollback), so a resident version table can detect it went stale
        # and must never emit a mask from a dead generation
        self.state_generation = 0
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.executescript(_SCHEMA)
        self._db.commit()

    def bump_generation(self) -> None:
        self.state_generation += 1

    def close(self) -> None:
        """Idempotent (recovery error paths may close twice)."""
        if self._closed:
            return
        self._closed = True
        self._db.close()

    def _one(self, sql, params=()):
        with self._lock:
            return self._db.execute(sql, params).fetchone()

    def _all(self, sql, params=()):
        with self._lock:
            return self._db.execute(sql, params).fetchall()

    # -- savepoint ---------------------------------------------------------
    def savepoint(self) -> Optional[int]:
        """Height of the last block whose writes are durably applied, or
        None for a fresh database (stateleveldb GetLatestSavePoint)."""
        row = self._one("SELECT v FROM meta WHERE k='savepoint'")
        return int(row[0]) if row else None

    def commit_hash(self) -> bytes:
        row = self._one("SELECT v FROM meta WHERE k='commit_hash'")
        return bytes(row[0]) if row else b""

    # -- reads -------------------------------------------------------------
    def get_state(self, ns: str, key: str) -> Optional[VersionedValue]:
        row = self._one(
            "SELECT value, block, txn, metadata FROM state WHERE ns=? AND key=?",
            (ns, key),
        )
        if row is None:
            return None
        return VersionedValue(
            bytes(row[0]),
            Version(row[1], row[2]),
            bytes(row[3]) if row[3] is not None else None,
        )

    def get_state_metadata(self, ns: str, key: str) -> Optional[bytes]:
        vv = self.get_state(ns, key)
        return vv.metadata if vv else None

    def get_version(self, ns: str, key: str) -> Optional[Version]:
        vv = self.get_state(ns, key)
        return vv.version if vv else None

    def get_hashed_state(
        self, ns: str, coll: str, key_hash: bytes
    ) -> Optional[VersionedValue]:
        row = self._one(
            "SELECT value, block, txn, metadata FROM hashed "
            "WHERE ns=? AND coll=? AND keyhash=?",
            (ns, coll, key_hash),
        )
        if row is None:
            return None
        return VersionedValue(
            bytes(row[0]),
            Version(row[1], row[2]),
            bytes(row[3]) if row[3] is not None else None,
        )

    def get_hashed_metadata(
        self, ns: str, coll: str, key_hash: bytes
    ) -> Optional[bytes]:
        vv = self.get_hashed_state(ns, coll, key_hash)
        return vv.metadata if vv else None

    def get_key_hash_version(
        self, ns: str, coll: str, key_hash: bytes
    ) -> Optional[Version]:
        vv = self.get_hashed_state(ns, coll, key_hash)
        return vv.version if vv else None

    def get_private_data(
        self, ns: str, coll: str, key: str
    ) -> Optional[VersionedValue]:
        row = self._one(
            "SELECT value, block, txn FROM pvt WHERE ns=? AND coll=? AND key=?",
            (ns, coll, key),
        )
        if row is None:
            return None
        return VersionedValue(bytes(row[0]), Version(row[1], row[2]))

    def get_state_range(
        self, ns: str, start_key: str, end_key: str, include_end: bool
    ) -> Iterator[Tuple[str, VersionedValue]]:
        """Ordered scan (sqlite BINARY collation == UTF-8 byte order ==
        Python str code-point order, so bounds agree with the in-memory
        VersionedDB and the reference's LevelDB)."""
        if end_key:
            op = "<=" if include_end else "<"
            rows = self._all(
                f"SELECT key, value, block, txn, metadata FROM state "
                f"WHERE ns=? AND key>=? AND key{op}? ORDER BY key",
                (ns, start_key, end_key),
            )
        else:
            rows = self._all(
                "SELECT key, value, block, txn, metadata FROM state "
                "WHERE ns=? AND key>=? ORDER BY key",
                (ns, start_key),
            )
        for key, value, blk, txn, md in rows:
            yield key, VersionedValue(
                bytes(value),
                Version(blk, txn),
                bytes(md) if md is not None else None,
            )

    def num_keys(self) -> int:
        return self._one("SELECT COUNT(*) FROM state")[0]

    def iter_all_state(self) -> Iterator[Tuple[str, str, VersionedValue]]:
        for ns, key, value, blk, txn, md in self._all(
            "SELECT ns, key, value, block, txn, metadata FROM state "
            "ORDER BY ns, key"
        ):
            yield ns, key, VersionedValue(
                bytes(value),
                Version(blk, txn),
                bytes(md) if md is not None else None,
            )

    def iter_all_hashed(
        self,
    ) -> Iterator[Tuple[str, str, bytes, VersionedValue]]:
        for ns, coll, kh, value, blk, txn, md in self._all(
            "SELECT ns, coll, keyhash, value, block, txn, metadata "
            "FROM hashed ORDER BY ns, coll, keyhash"
        ):
            yield ns, coll, bytes(kh), VersionedValue(
                bytes(value),
                Version(blk, txn),
                bytes(md) if md is not None else None,
            )

    # -- rich queries (statecouchdb ExecuteQuery analog) --------------------
    def execute_query(self, ns: str, query) -> List[Tuple[str, bytes]]:
        return rich_queries.execute(self._query_rows(ns), query)

    def execute_query_paginated(
        self, ns: str, query, page_size: int, bookmark: str = ""
    ):
        """One page + next bookmark (statecouchdb.go:653)."""
        return rich_queries.execute_paginated(
            self._query_rows(ns), query, page_size, bookmark
        )

    def _query_rows(self, ns: str):
        return (
            (key, bytes(value))
            for key, value in self._all(
                "SELECT key, value FROM state WHERE ns=? ORDER BY key", (ns,)
            )
        )

    # -- history ------------------------------------------------------------
    def get_history(self, ns: str, key: str) -> List[Version]:
        return [
            Version(b, t)
            for b, t in self._all(
                "SELECT block, txn FROM history WHERE ns=? AND key=? "
                "ORDER BY block, txn",
                (ns, key),
            )
        ]

    # -- writes -------------------------------------------------------------
    def apply_updates(
        self,
        batch: UpdateBatch,
        hashed: Optional[HashedUpdateBatch] = None,
        pvt: Optional[PvtUpdateBatch] = None,
    ) -> None:
        self.commit_block(batch, hashed, pvt, savepoint=None)

    def commit_block(
        self,
        batch: UpdateBatch,
        hashed: Optional[HashedUpdateBatch] = None,
        pvt: Optional[PvtUpdateBatch] = None,
        savepoint: Optional[int] = None,
        commit_hash: Optional[bytes] = None,
        history: bool = True,
    ) -> None:
        """One block's state + history + savepoint, atomically."""
        db = self._db
        with self._lock, db:  # one transaction
            for (ns, key), entry in batch.items():
                if entry.value is None:
                    db.execute(
                        "DELETE FROM state WHERE ns=? AND key=?", (ns, key)
                    )
                else:
                    db.execute(
                        "INSERT OR REPLACE INTO state VALUES (?,?,?,?,?,?)",
                        (
                            ns,
                            key,
                            entry.value,
                            entry.version.block_num,
                            entry.version.tx_num,
                            entry.metadata,
                        ),
                    )
                if history:
                    db.execute(
                        "INSERT OR REPLACE INTO history VALUES (?,?,?,?)",
                        (ns, key, entry.version.block_num, entry.version.tx_num),
                    )
            for (ns, coll, key_hash), entry in (hashed.items() if hashed else ()):
                if entry.value is None:
                    db.execute(
                        "DELETE FROM hashed WHERE ns=? AND coll=? AND keyhash=?",
                        (ns, coll, key_hash),
                    )
                else:
                    db.execute(
                        "INSERT OR REPLACE INTO hashed VALUES (?,?,?,?,?,?,?)",
                        (
                            ns,
                            coll,
                            key_hash,
                            entry.value,
                            entry.version.block_num,
                            entry.version.tx_num,
                            entry.metadata,
                        ),
                    )
            for (ns, coll, key), entry in (pvt.items() if pvt else ()):
                if entry.value is None:
                    db.execute(
                        "DELETE FROM pvt WHERE ns=? AND coll=? AND key=?",
                        (ns, coll, key),
                    )
                else:
                    db.execute(
                        "INSERT OR REPLACE INTO pvt VALUES (?,?,?,?,?,?)",
                        (
                            ns,
                            coll,
                            key,
                            entry.value,
                            entry.version.block_num,
                            entry.version.tx_num,
                        ),
                    )
            if savepoint is not None:
                # kill window: every row above is written but
                # the transaction is uncommitted — a kill here rolls the
                # whole block back on reopen (WAL discards), leaving the
                # state db exactly one block behind the block store
                fault_point("persistent.commit.mid", key=int(savepoint))
                db.execute(
                    "INSERT OR REPLACE INTO meta VALUES ('savepoint', ?)",
                    (str(savepoint).encode(),),
                )
            if commit_hash is not None:
                db.execute(
                    "INSERT OR REPLACE INTO meta VALUES ('commit_hash', ?)",
                    (commit_hash,),
                )

    def iter_all_pvt(
        self,
    ) -> Iterator[Tuple[str, str, str, VersionedValue]]:
        """Deterministic walk of the cleartext private state (crash-
        harness digests; the pvt sibling of iter_all_state)."""
        for ns, coll, key, value, blk, txn in self._all(
            "SELECT ns, coll, key, value, block, txn FROM pvt "
            "ORDER BY ns, coll, key"
        ):
            yield ns, coll, key, VersionedValue(bytes(value), Version(blk, txn))

    def clear(self) -> None:
        """Drop all derived data (peer node rebuild-dbs).  Out-of-band
        state mutation: bumps the generation stamp so resident version
        tables built over this db fail closed instead of serving stale
        versions."""
        self.bump_generation()
        with self._lock, self._db as db:
            for table in ("state", "hashed", "pvt", "history", "meta", "confighistory"):
                try:
                    db.execute(f"DELETE FROM {table}")
                except sqlite3.OperationalError:
                    pass  # optional table (confighistory) not created yet
