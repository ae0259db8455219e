#!/usr/bin/env python3
"""Probe of the peer's commit path on one card.

    python3 scripts/pipeline_probe.py [--runs N] [--switch-ms A,B] [--trace-host]

Builds csrc/p256_verify.cu and csrc/mvcc_resolve.cu (one nvcc each, started
together) and the native host runtime, then runs chip_smoke.py's commit-path
phases alone (`chip_smoke.pipeline_phases`) N times (default 1):
pipeline_config2 (10 linked config #2 blocks through CommitPipeline,
Channel, a BatchingProvider over CUDAProvider and the persistent KVLedger
with K5, against the same chain stored one block at a time and against the
host MVCC) and pipeline_config5 (four config #5 channels sharing one
BatchingProvider). With --switch-ms the runs take the interpreter's
thread switch interval (`sys.setswitchinterval`) from the list in turns
(A, B, B, A for two values): how much of the stages' contention is the
interpreter lock's hand-over. With --trace-host each run also reports,
by thread, the SQLite reads (`SqliteVersionedDB._one`: count and wall
time), the SQLite block commits, and each stage's wall time beside the
thread's CPU time (`time.thread_time`): whether a slow stage computes or
waits. Each result is a JSON line; the card's name and power limit come
last.
"""

import argparse
import collections
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


class HostTrace:
    """Wall and thread CPU time of chosen methods, summed by thread name."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals = collections.defaultdict(lambda: [0, 0.0, 0.0])

    def wrap(self, cls, name: str, label: str) -> None:
        fn = getattr(cls, name)

        def timed(*args, **kw):
            t, c = time.perf_counter(), time.thread_time()
            try:
                return fn(*args, **kw)
            finally:
                wall, cpu = time.perf_counter() - t, time.thread_time() - c
                with self.lock:
                    rec = self.totals[(threading.current_thread().name, label)]
                    rec[0] += 1
                    rec[1] += wall
                    rec[2] += cpu

        setattr(cls, name, timed)

    def take(self) -> dict:
        with self.lock:
            out = {f"{thread} {label}": {"calls": n, "wall_ms": w * 1e3, "cpu_ms": c * 1e3}
                   for (thread, label), (n, w, c) in sorted(self.totals.items())}
            self.totals.clear()
        return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--switch-ms", default="",
                        help="comma-separated switch intervals in ms, run in turns")
    parser.add_argument("--trace-host", action="store_true",
                        help="time SQLite calls and each stage's wall and CPU by thread")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pipeline_probe: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.utils import native

    sources = ("p256_verify", "mvcc_resolve")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        built = pool.submit(native.build)
        list(pool.map(cudalib.build, sources))
        built.result()
    dev = torch.device("cuda", 0)
    trace = None
    if args.trace_host:
        from fabric_tpu_torch.ledger.persistent import SqliteVersionedDB
        from fabric_tpu_torch.peer.channel import Channel

        trace = HostTrace()
        trace.wrap(SqliteVersionedDB, "_one", "sqlite_read")
        trace.wrap(SqliteVersionedDB, "commit_block", "sqlite_commit_block")
        trace.wrap(Channel, "prepare_block", "stage_a")
        trace.wrap(Channel, "store_block", "stage_b")
    default = sys.getswitchinterval()
    intervals = [float(ms) / 1e3 for ms in args.switch_ms.split(",") if ms] or [default]
    order = intervals + intervals[::-1] if len(intervals) > 1 else intervals
    try:
        for run in range(args.runs):
            for interval in order:
                sys.setswitchinterval(interval)
                launches = chip_smoke.pipeline_phases(torch, np, dev)
                print(json.dumps({"run": run, "switch_interval_ms": interval * 1e3,
                                  "launches": launches,
                                  "host_trace": trace.take() if trace else None}), flush=True)
    finally:
        sys.setswitchinterval(default)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
