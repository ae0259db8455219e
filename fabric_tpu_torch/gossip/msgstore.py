"""Dedup-expiry message store (reference gossip/msgstore/msgs.go).

The reference keeps every gossiped message in a store whose `Add`
returns false for duplicates and for messages an already-stored one
invalidates (e.g. a newer alive from the same peer invalidates older
ones), and expires entries after a TTL so the memory stays bounded and
a long-dead message can circulate again without being mistaken for a
duplicate. Without it, a push mesh re-forwards every message endlessly.

Messages are identified by an explicit (key, rank) pair chosen by the
caller — (pki_id, seq) for alives, (seq, 0) for data messages — instead
of a generic invalidation predicate over opaque messages; the semantics
(newer rank invalidates older, equal rank is a duplicate) match the
reference's NewGossipMessageComparator ordering for these types.

The port's counterpart of the JAX package's `gossip/msgstore.py`. The
clock is the caller's (`clock`, `time.monotonic` by default), so a test
can step it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Hashable, Tuple


class MessageStore:
    def __init__(self, ttl_s: float = 30.0, max_entries: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self._ttl = ttl_s
        self._max = max_entries
        self._clock = clock
        self._lock = threading.Lock()
        # key -> (rank, stored_at)
        self._entries: Dict[Hashable, Tuple[int, float]] = {}

    def add(self, key: Hashable, rank: int = 0) -> bool:
        """True if the message is FRESH (process + forward it); False if
        a stored entry with the same key has an equal or newer rank."""
        now = self._clock()
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                stored_rank, stored_at = hit
                if now - stored_at < self._ttl and stored_rank >= rank:
                    return False
            if len(self._entries) >= self._max:
                self._expire_locked(now)
                if len(self._entries) >= self._max:
                    # still full: drop the oldest quarter (bounded memory
                    # beats perfect dedup)
                    for k, _ in sorted(
                        self._entries.items(), key=lambda kv: kv[1][1]
                    )[: self._max // 4]:
                        del self._entries[k]
            self._entries[key] = (rank, now)
            return True

    def seen(self, key: Hashable, rank: int = 0) -> bool:
        now = self._clock()
        with self._lock:
            hit = self._entries.get(key)
            return hit is not None and now - hit[1] < self._ttl and hit[0] >= rank

    def _expire_locked(self, now: float) -> None:
        dead = [k for k, (_r, at) in self._entries.items() if now - at >= self._ttl]
        for k in dead:
            del self._entries[k]

    def expire_old(self) -> None:
        with self._lock:
            self._expire_locked(self._clock())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
