"""Envelope batching (reference orderer/common/blockcutter/blockcutter.go).

Ordered() semantics replicated:
- a message larger than preferred_max_bytes is cut into its own batch
  (after first cutting any pending batch);
- appending a message that would overflow preferred_max_bytes cuts the
  pending batch first;
- reaching max_message_count cuts immediately;
- `pending` tells the caller whether a timer should be armed.

The port's counterpart of the JAX package's `orderer/blockcutter.py`. An
envelope is an Envelope message dict; its size is that of its wire bytes.
The clock of `pending_age` is the caller's (`clock`, `time.monotonic` by
default).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from fabric_tpu_torch.protos import fabric, wire


@dataclass
class BatchConfig:
    max_message_count: int = 10
    absolute_max_bytes: int = 10 * 1024 * 1024
    preferred_max_bytes: int = 2 * 1024 * 1024


class BlockCutter:
    def __init__(self, config: Optional[BatchConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config if config is not None else BatchConfig()
        self._clock = clock
        self._pending: List[dict] = []
        self._pending_bytes = 0
        self._pending_since: Optional[float] = None

    def pending_age(self) -> Optional[float]:
        """Seconds since the oldest pending message arrived, or None for
        an empty batch — the reference's batch timer starts at the FIRST
        message of a batch (chain run loops: timer = time.After(...) when
        pending becomes non-empty), so BatchTimeout means 'oldest message
        waits at most this long', not a global flush cadence."""
        if not self._pending or self._pending_since is None:
            return None
        return self._clock() - self._pending_since

    @staticmethod
    def _size(env: dict) -> int:
        return len(wire.encode(fabric.ENVELOPE, env))

    def ordered(self, env: dict) -> Tuple[List[List[dict]], bool]:
        """Returns (batches_to_cut, pending_remaining)."""
        batches: List[List[dict]] = []
        size = self._size(env)

        if size > self.config.preferred_max_bytes:
            # oversized message: flush pending, isolate this one
            if self._pending:
                batches.append(self._cut())
            batches.append([env])
            return batches, False

        if self._pending_bytes + size > self.config.preferred_max_bytes and self._pending:
            batches.append(self._cut())

        self._pending.append(env)
        self._pending_bytes += size
        if self._pending_since is None:
            # set AFTER the append: a concurrent timeout flush (solo
            # chains take no lock) may steal the batch between the two
            # statements, and a message must never sit with no timestamp
            # or the age-gated flush loop would skip it forever
            self._pending_since = self._clock()

        if len(self._pending) >= self.config.max_message_count:
            batches.append(self._cut())

        return batches, bool(self._pending)

    def cut(self) -> List[dict]:
        return self._cut() if self._pending else []

    def _cut(self) -> List[dict]:
        batch = self._pending
        self._pending = []
        self._pending_bytes = 0
        self._pending_since = None
        return batch
