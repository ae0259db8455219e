"""Two-stage commit pipeline (SURVEY.md §2.13 P4: deliver -> payload
buffer -> validate -> commit stages overlap across blocks; reference
gossip/state.go:542 + kv_ledger.go:596 run block N's delivery while
block N-1 commits).

Stage A (prepare): orderer-sig check + host parse + the DEVICE signature
batch for block N — runs while stage B finishes block N-1.
Stage B (commit): policy circuits, MVCC, stores — inherently sequential
per channel, one worker, in order.

The bounded queue between the stages is the backpressure discipline of
SURVEY §2.13 P7 (orderer WaitReady analog): a slow commit stage stalls
`submit`, which stalls the deliver client, which stops pulling.

The port's counterpart of the JAX package's `peer/pipeline`, over the port's
`peer/channel.Channel` and its dict blocks (`protos/fabric.BLOCK`). On the
card stage A dispatches the block's signatures (K2 through the provider or
the shared `parallel/batcher.VerifyBatcher`) and stage B runs MVCC (K5 with
`device_mvcc`) on the committer thread; `stage_stats()` gives both stages'
latency, from which a caller reads how far they overlap."""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.fabobs import STAGE_BUCKETS
from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.common.metrics import (
    new_histogram_state,
    observe_into,
    summary_from_histogram_state,
)


class PipelineError(Exception):
    pass


def _number(block: dict) -> int:
    return int(block.get("header", {}).get("number", 0))


class CommitPipeline:
    def __init__(
        self,
        channel,  # peer.channel.Channel
        on_commit: Optional[Callable[[dict, object], None]] = None,
        on_error: Optional[Callable[[dict, Exception], None]] = None,
        depth: int = 2,
    ):
        self.channel = channel
        self.on_commit = on_commit
        self.on_error = on_error
        self._prepared: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stopped = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._pending = 0
        self._pending_lock = threading.Lock()
        # terminal triage for soak runs: drain() returning False means
        # "not yet idle" — last_error (most recent commit exception,
        # guarded by _pending_lock) and dead (committer thread gone
        # without stop()) distinguish slow from dead
        self.last_error: Optional[BaseException] = None
        self._crashed = False
        # per-stage latency as metrics-SPI histogram state: bucket
        # accumulators, constant memory for the process lifetime,
        # summarized by summary_from_histogram_state
        self._stage_hist = {
            "prepare": new_histogram_state(STAGE_BUCKETS),
            "commit": new_histogram_state(STAGE_BUCKETS),
        }
        self._committer = threading.Thread(
            target=self._commit_loop,
            name=f"commit-{channel.channel_id}",
            daemon=True,
        )
        self._committer.start()

    # -- producer side (the deliver loop) ----------------------------------
    def submit(self, block: dict) -> None:
        """Prepare block and hand it to the committer. Runs stage A on
        the CALLING thread (the deliver loop), so while the committer
        drains block N-1 this thread already parses + device-verifies
        block N. Blocks when the queue is full (P7 backpressure)."""
        if self._stopped.is_set():
            raise PipelineError("pipeline stopped")
        with self._pending_lock:
            self._pending += 1
            self._idle.clear()
        try:
            t0 = time.perf_counter()
            with fabobs.span("pipeline.prepare", block=_number(block)):
                prepared = self.channel.prepare_block(block)
            self._observe_stage("prepare", time.perf_counter() - t0)
            # bounded put that watches _stopped: a plain blocking put on
            # a full queue after stop() would wait forever — the
            # committer has exited and will never drain it
            while True:
                if self._stopped.is_set():
                    raise PipelineError("pipeline stopped")
                try:
                    self._prepared.put((block, prepared), timeout=0.2)
                except queue.Full:
                    continue
                if self._stopped.is_set() and not self._committer.is_alive():
                    # stop() landed between our check and the put: the
                    # committer will never consume this item. Reclaim it
                    # (one submitter per pipeline, so the reclaimed item
                    # is ours) so _pending/_idle stay balanced.
                    try:
                        self._prepared.get_nowait()
                    except queue.Empty:
                        return  # consumed before the committer exited
                    raise PipelineError("pipeline stopped")
                return
        except Exception:
            with self._pending_lock:
                self._pending -= 1
                if self._pending == 0:
                    self._idle.set()
            raise

    # -- consumer side -----------------------------------------------------
    def _commit_loop(self) -> None:
        try:
            self._commit_loop_inner()
        except BaseException as exc:
            # the loop only exits this way on a non-Exception escape
            # (interpreter teardown, injected BaseException): latch the
            # crash so dead stays True even after a cleanup stop()
            with self._pending_lock:
                self.last_error = exc
            self._crashed = True
            raise

    def _commit_loop_inner(self) -> None:
        while not self._stopped.is_set():
            try:
                item = self._prepared.get(timeout=0.2)
            except queue.Empty:
                continue
            block, prepared = item
            try:
                # chaos seam: keyed by block number, so a seeded plan
                # fails a deterministic subset of commits
                fault_point("pipeline.commit", key=_number(block))
                t0 = time.perf_counter()
                with fabobs.span("pipeline.commit", block=_number(block)):
                    flags = self.channel.store_block(block, prepared=prepared)
                self._observe_stage("commit", time.perf_counter() - t0)
                if self.on_commit is not None:
                    self.on_commit(block, flags)
            except Exception as exc:  # noqa: BLE001 - surfaced to the owner
                fabobs.obs_count("fabric_pipeline_commit_failures_total")
                with self._pending_lock:
                    self.last_error = exc
                if self.on_error is not None:
                    self.on_error(block, exc)
                else:
                    # no owner callback installed: a silently dropped
                    # block would stall the channel with no trace — log
                    # loudly
                    must_get_logger("pipeline").error(
                        "commit of block %s failed with no on_error "
                        "handler installed: %s",
                        _number(block), exc,
                    )
            finally:
                with self._pending_lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    def _observe_stage(self, stage: str, seconds: float) -> None:
        with self._pending_lock:
            observe_into(self._stage_hist[stage], STAGE_BUCKETS, seconds)
        fabobs.obs_observe(
            "fabric_pipeline_stage_seconds", seconds, stage=stage
        )

    def stage_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-stage latency summary over the accumulated histogram
        state: {"prepare": {n, p50_ms, p99_ms, mean_ms}, "commit":
        {...}}, served from the live pipeline.  Quantiles are bucket upper
        bounds (STAGE_BUCKETS); mean_ms times n is a stage's total time."""
        with self._pending_lock:
            states = {
                k: summary_from_histogram_state(v, STAGE_BUCKETS)
                for k, v in self._stage_hist.items()
            }
        return states

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted block has committed.  Returns
        False on timeout — check ``last_error`` (the loop's most recent
        commit exception) and ``dead`` to tell a slow pipeline from a
        wedged or crashed one."""
        return self._idle.wait(timeout)

    @property
    def dead(self) -> bool:
        """True when the committer thread crashed or exited without
        stop() — the pipeline will never drain (vs. merely slow).  The
        crashed state is latched, so a cleanup stop() after the fact
        does not mask it."""
        return self._crashed or (
            not self._committer.is_alive() and not self._stopped.is_set()
        )

    def stop(self) -> None:
        self._stopped.set()
        self._committer.join(timeout=5)
        # release the pending counts of any items the committer never
        # consumed, so a post-stop drain() returns instead of hanging
        while True:
            try:
                self._prepared.get_nowait()
            except queue.Empty:
                break
            with self._pending_lock:
                self._pending -= 1
                if self._pending == 0:
                    self._idle.set()
