"""Collection-config history (reference core/ledger/confighistory/mgr.go:
record every committed change to a chaincode's collection config, keyed
by committing block, and answer "most recent config at or below block N"
— what pvt-data reconciliation and expiry need to interpret OLD blocks
under the config that was in force when they committed).

The manager watches committed update batches for writes to the
`_lifecycle` namespace's `.../Collections` field (the reference hooks
the same seam via its ledger commit listener / DeployedChaincodeInfoProvider)
and appends (namespace, block, config bytes) rows. Persistent ledgers
store rows in the state sqlite file; in-memory ledgers keep a dict.

The port's counterpart of the JAX package's `ledger/confighistory`. It keeps
its own copy of the lifecycle namespace's name and imports no lifecycle
package.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

#: the _lifecycle system chaincode's namespace (JAX package:
#: lifecycle/lifecycle.py NAMESPACE)
LIFECYCLE_NS = "_lifecycle"

_COLLECTIONS_KEY = re.compile(r"^namespaces/fields/([^/]+)/Collections$")


class ConfigHistoryMgr:
    def __init__(self, db=None):
        """db: SqliteVersionedDB to persist into (shares the channel's
        state file), or None for the in-memory form."""
        self._db = db
        if db is not None:
            with db._lock:
                db._db.execute(
                    "CREATE TABLE IF NOT EXISTS confighistory ("
                    "ns TEXT NOT NULL, block INTEGER NOT NULL, "
                    "config BLOB NOT NULL, PRIMARY KEY (ns, block)"
                    ") WITHOUT ROWID"
                )
                db._db.commit()
        self._mem: Dict[str, List[Tuple[int, bytes]]] = {}

    # -- commit-time hook --------------------------------------------------
    def record_from_updates(self, block_num: int, updates) -> None:
        """Scan one block's public update batch for collection-config
        writes (confighistory mgr.go HandleStateUpdates)."""
        for (ns, key), entry in updates.items():
            if ns != LIFECYCLE_NS or entry.value is None:
                continue
            m = _COLLECTIONS_KEY.match(key)
            if not m:
                continue
            self.record(m.group(1), block_num, entry.value)

    def record(self, chaincode: str, block_num: int, config: bytes) -> None:
        if self._db is not None:
            with self._db._lock, self._db._db as conn:
                conn.execute(
                    "INSERT OR REPLACE INTO confighistory VALUES (?,?,?)",
                    (chaincode, block_num, config),
                )
        else:
            rows = self._mem.setdefault(chaincode, [])
            rows[:] = [r for r in rows if r[0] != block_num]
            rows.append((block_num, config))
            rows.sort()

    # -- queries (mgr.go MostRecentCollectionConfigBelow) ------------------
    def most_recent_below(
        self, chaincode: str, block_num: int
    ) -> Optional[Tuple[int, bytes]]:
        """(committing block, config bytes) of the newest config recorded
        at a block STRICTLY below block_num, or None."""
        if self._db is not None:
            row = self._db._one(
                "SELECT block, config FROM confighistory "
                "WHERE ns=? AND block<? ORDER BY block DESC LIMIT 1",
                (chaincode, block_num),
            )
            return (row[0], bytes(row[1])) if row else None
        best = None
        for blk, cfg in self._mem.get(chaincode, []):
            if blk < block_num:
                best = (blk, cfg)
        return best
