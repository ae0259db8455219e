"""Commit entry point (reference gossip/privdata/coordinator.go
StoreBlock): Validate(block) -> assemble private data -> commit, with
transient-store lookups, peer pulls with a retry budget, and a
reconciler for private data that arrived after commit.

Validate() here is the batched device validator (the port's
`validation/validator`, K2 on the card), so StoreBlock is exactly the
reference's coordinator boundary with the goroutine fan-out replaced by one
device batch per block.

The port's counterpart of the JAX package's `gossip/coordinator.py`, over the
port's dict blocks. `TransientStore` is the store `peer/channel.Channel`
takes as its `transient_store` (`get`, `purge_by_txids`) and
`gossip/pvtdata.PvtDataHandler` fills (`persist`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class PvtKey:
    tx_index: int
    namespace: str
    collection: str


class TransientStore:
    """Pre-commit private-data staging, keyed by txid (reference
    core/transientstore): endorsement-time writesets wait here until the
    block arrives."""

    def __init__(self):
        self._by_txid: Dict[str, Dict[Tuple[str, str], bytes]] = {}
        # persist() runs on endorsement (gRPC handler) threads while the
        # commit thread purges and the pvt-assembly path reads: the nested
        # per-txid dict makes the setdefault-then-setitem sequence
        # non-atomic even under the GIL
        self._lock = threading.Lock()

    def persist(
        self, txid: str, namespace: str, collection: str, pvt_writeset: bytes
    ) -> None:
        with self._lock:
            self._by_txid.setdefault(txid, {})[
                (namespace, collection)
            ] = pvt_writeset

    def get(
        self, txid: str, namespace: str, collection: str
    ) -> Optional[bytes]:
        with self._lock:
            return self._by_txid.get(txid, {}).get((namespace, collection))

    def purge_by_txids(self, txids: Sequence[str]) -> None:
        with self._lock:
            for t in txids:
                self._by_txid.pop(t, None)

    def purge_below_height(self, height: int) -> None:
        # height-based purge hook (reference PurgeBelowHeight); txid map
        # keeps no heights, so this is driven by the caller's bookkeeping
        pass


@dataclass
class PvtDataRequirement:
    """Private collections a valid tx's rwset hashes reference."""

    txid: str
    keys: List[PvtKey]


class Coordinator:
    """Per-channel commit coordinator."""

    def __init__(
        self,
        channel_id: str,
        validate: Callable[[dict], object],
        commit: Callable[[dict, Dict[PvtKey, bytes]], object],
        transient: Optional[TransientStore] = None,
        fetch_from_peers: Optional[
            Callable[[List[PvtKey]], Dict[PvtKey, bytes]]
        ] = None,
        pvt_requirements: Optional[
            Callable[[dict, object], List[PvtDataRequirement]]
        ] = None,
        pull_retries: int = 3,
    ):
        self.channel_id = channel_id
        self._validate = validate
        self._commit = commit
        self.transient = transient or TransientStore()
        self._fetch = fetch_from_peers or (lambda keys: {})
        self._requirements = pvt_requirements or (lambda block, flags: [])
        self.pull_retries = pull_retries
        # pvt data we could not assemble at commit time -> reconciler
        self.missing: Set[PvtKey] = set()

    def store_block(self, block: dict):
        """Validate -> fetch pvtdata (transient store, then peers with a
        retry budget) -> commit (coordinator.go:149-209). Returns the
        commit result (validation flags)."""
        flags = self._validate(block)

        needed = self._requirements(block, flags)
        assembled: Dict[PvtKey, bytes] = {}
        outstanding: List[Tuple[str, PvtKey]] = []
        for req in needed:
            for key in req.keys:
                data = self.transient.get(
                    req.txid, key.namespace, key.collection
                )
                if data is not None:
                    assembled[key] = data
                else:
                    outstanding.append((req.txid, key))

        retries = self.pull_retries
        while outstanding and retries > 0:
            fetched = self._fetch([k for _, k in outstanding])
            still = []
            for txid, key in outstanding:
                if key in fetched:
                    assembled[key] = fetched[key]
                else:
                    still.append((txid, key))
            outstanding = still
            retries -= 1

        # commit proceeds with what we have; missing keys go to the
        # reconciler (coordinator commits with missing-data tracking)
        for _txid, key in outstanding:
            self.missing.add(key)

        result = self._commit(block, assembled)
        self.transient.purge_by_txids([req.txid for req in needed])
        return result if result is not None else flags

    # -- reconciliation (gossip/privdata/reconcile.go) ---------------------
    def reconcile(
        self,
        store_pvt: Callable[[PvtKey, bytes], None],
    ) -> int:
        """Try to fetch previously-missing private data; returns how many
        keys were recovered."""
        if not self.missing:
            return 0
        fetched = self._fetch(sorted(self.missing, key=lambda k: (k.tx_index, k.namespace, k.collection)))
        recovered = 0
        for key, data in fetched.items():
            if key in self.missing:
                store_pvt(key, data)
                self.missing.discard(key)
                recovered += 1
        return recovered
