"""History index + GetHistoryForKey (reference core/ledger/kvledger/
history/db.go + kv_scanner in query_executer.go).

The port's counterpart of the JAX package's `ledger/history`. The reference
keeps a LevelDB index of (ns, key) -> [(blockNum, txNum)] written at commit
and resolves values by re-reading the block from the block store at query
time (history/query_executer.go:71-112). Here the index lives on the
KVLedger (the `history` table of its SQLite state) and this module resolves
each version to the committed write, through the port's `txparse` over the
port's dict blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from fabric_tpu_torch.ledger.rwset import Version
from fabric_tpu_torch.ledger.txparse import parse_transaction


@dataclass(frozen=True)
class KeyModification:
    """One historical write (peer.KeyModification analog)."""

    tx_id: str
    version: Version
    value: bytes
    is_delete: bool


def get_history_for_key(ledger, ns: str, key: str) -> List[KeyModification]:
    """Newest-first history of committed writes to (ns, key), resolved
    from the block store (history/query_executer.go getKeyModification)."""
    out: List[KeyModification] = []
    for version in reversed(ledger.get_history_for_key(ns, key)):
        block = ledger.block_store.get_block_by_number(version.block_num)
        if block is None:
            continue
        parsed = parse_transaction(version.tx_num, block["data"]["data"][version.tx_num])
        if parsed.rwset is None:
            continue
        for ns_rw in parsed.rwset.ns_rw_sets:
            if ns_rw.namespace != ns:
                continue
            for w in ns_rw.writes:
                if w.key == key:
                    out.append(KeyModification(
                        tx_id=parsed.tx_id, version=version, value=w.value,
                        is_delete=w.is_delete,
                    ))
    return out
