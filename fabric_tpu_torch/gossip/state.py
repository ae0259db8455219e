"""Gossip state transfer (reference gossip/state/state.go): the ordered
payload buffer between block dissemination and the commit pipeline, plus
anti-entropy catch-up.

deliverPayloads semantics reproduced (state.go:542-585): blocks commit
strictly in sequence from a buffer keyed by block number; duplicates and
stale blocks are dropped; a commit failure aborts the channel (the
reference panics on VSCCExecutionFailure). Anti-entropy (state.go:586-612)
asks taller peers for [height, max) ranges and feeds responses back into
the same buffer.

The port's counterpart of the JAX package's `gossip/state.py`, over the
port's dict blocks (`protos/fabric.BLOCK`).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence


def block_number(block: dict) -> int:
    return block.get("header", {}).get("number", 0)


class PayloadBuffer:
    """Ordered block buffer (reference gossip/state/payloads_buffer.go)."""

    def __init__(self, next_seq: int):
        self._items: Dict[int, dict] = {}
        self._next = next_seq
        self.dropped = 0

    @property
    def next_seq(self) -> int:
        return self._next

    def push(self, block: dict) -> bool:
        """Accept a block unless stale/duplicate. Returns True if stored."""
        seq = block_number(block)
        if seq < self._next or seq in self._items:
            self.dropped += 1
            return False
        self._items[seq] = block
        return True

    def advance_to(self, seq: int) -> None:
        """Sync with commits that bypassed the buffer (the deliver client
        commits directly on the gossip leader): drop buffered blocks below
        seq and move the cursor forward."""
        if seq <= self._next:
            return
        for n in list(self._items):
            if n < seq:
                del self._items[n]
        self._next = seq

    def pop(self) -> Optional[dict]:
        blk = self._items.pop(self._next, None)
        if blk is not None:
            self._next += 1
        return blk

    def ready(self) -> bool:
        return self._next in self._items

    def __len__(self) -> int:
        return len(self._items)


class CommitFailure(Exception):
    """Commit errors abort the channel's processing (the reference panics
    on StoreBlock failure, state.go:570-577)."""


class StateProvider:
    """Per-channel state sync: buffer -> commit loop + anti-entropy."""

    def __init__(
        self,
        channel_id: str,
        commit_block: Callable[[dict], None],
        height: Callable[[], int],
        max_block_dist: int = 100,
    ):
        self.channel_id = channel_id
        self._commit = commit_block
        self._height = height
        self.buffer = PayloadBuffer(height())
        self.max_block_dist = max_block_dist
        self.failed = False
        # The gossip node drives this from the tick thread, gRPC stream
        # handlers and forward threads concurrently; an unguarded pop
        # race would double-commit (and poison the channel via `failed`).
        self._lock = threading.RLock()

    # -- ingest (gossip DataMsg / deliver client / state response) ---------
    def add_payload(self, block: dict, from_gossip: bool = True) -> bool:
        """Reference addPayload: gossiped blocks too far ahead of the
        ledger height are dropped (non-blocking ingest); direct/deliver
        payloads are always buffered."""
        with self._lock:
            self.buffer.advance_to(self._height())
            if from_gossip and block_number(block) >= self._height() + self.max_block_dist:
                self.buffer.dropped += 1
                return False
            return self.buffer.push(block)

    # -- commit loop --------------------------------------------------------
    def deliver_payloads(self) -> int:
        """Drain in-order payloads into the committer. Returns number
        committed. Raises CommitFailure on commit error."""
        with self._lock:
            if self.failed:
                raise CommitFailure(f"channel {self.channel_id} previously failed")
            self.buffer.advance_to(self._height())
            committed = 0
            while self.buffer.ready():
                block = self.buffer.pop()
                try:
                    self._commit(block)
                except Exception as e:
                    self.failed = True
                    raise CommitFailure(
                        f"block {block_number(block)} commit failed: {e}"
                    ) from e
                committed += 1
            return committed

    # -- anti-entropy -------------------------------------------------------
    def missing_range(self, peer_heights: Sequence[int]) -> Optional[range]:
        """antiEntropy: if some peer is taller, the [our_height, max)
        range to request (state.go:586-616)."""
        if not peer_heights:
            return None
        with self._lock:
            self.buffer.advance_to(self._height())
            max_h = max(peer_heights)
            ours = self.buffer.next_seq
        if max_h <= ours:
            return None
        return range(ours, max_h)

    def handle_state_request(
        self,
        start: int,
        end: int,
        get_block: Callable[[int], Optional[dict]],
        max_blocks: int = 100,
    ) -> List[dict]:
        """Serve a peer's StateRequest [start, end) from our ledger
        (state.go handleStateRequest, range capped)."""
        out = []
        for n in range(start, min(end, start + max_blocks)):
            blk = get_block(n)
            if blk is None:
                break
            out.append(blk)
        return out

    def handle_state_response(self, blocks: Sequence[dict]) -> int:
        """Buffer anti-entropy blocks and drain."""
        for b in blocks:
            self.add_payload(b, from_gossip=False)
        return self.deliver_payloads()
