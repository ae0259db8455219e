#!/usr/bin/env python3
"""Probe of join by snapshot on one card.

    python3 scripts/snapshot_probe.py [--keys N] [--trace-host]

Builds csrc/p256_verify.cu and csrc/mvcc_resolve.cu (one nvcc each, started
together) and the native host runtime, signs pipeline_config2's chain (10
linked config #2 blocks of 1,000 txs, in a pool of spawned processes, as
`chip_smoke.pipeline_phases` does) and runs chip_smoke.py's snapshot_config2
phase alone (`chip_smoke.snapshot_phase`) over a seed of N public keys
(default 1,000,000). With --trace-host the run also reports, by thread, the
seconds spent in the seed, the exports, the imports and the SQLite block
commits (wall and thread CPU time). The phase's JSON line comes first, then
the probe's, then the card's name and power limit.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from pipeline_probe import HostTrace  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--keys", type=int, default=chip_smoke.CHAIN_KEYS)
    parser.add_argument("--trace-host", action="store_true")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("snapshot_probe: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.utils import native

    t0 = time.perf_counter()
    sources = ("p256_verify", "mvcc_resolve")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        built = pool.submit(native.build)
        list(pool.map(cudalib.build, sources))
        built.result()
    build_s = time.perf_counter() - t0
    trace = None
    if args.trace_host:
        from fabric_tpu_torch.ledger import snapshot
        from fabric_tpu_torch.ledger.persistent import SqliteVersionedDB

        trace = HostTrace()
        trace.wrap(SqliteVersionedDB, "commit_block", "sqlite_commit_block")
        trace.wrap(snapshot, "generate_snapshot", "export")
        trace.wrap(snapshot, "create_from_snapshot", "import")
        trace.wrap(chip_smoke, "seed_snapshot_ledger", "seed")
    t0 = time.perf_counter()
    net = chip_smoke.Config2Net()
    chains = chip_smoke.build_chains(net, {chip_smoke.CONFIG2_CHANNEL: (
        chip_smoke.PIPELINE_BLOCKS, chip_smoke.CONFIG2_TXS, chip_smoke.PIPELINE_CONFLICT_BLOCK,
        chip_smoke.CONFIG2_CHANNEL, chip_smoke.PIPELINE_FLIPPED)})
    sign_s = time.perf_counter() - t0
    launches = chip_smoke.snapshot_phase(torch, np, torch.device("cuda", 0), net,
                                         chains[chip_smoke.CONFIG2_CHANNEL], n_keys=args.keys)
    print(json.dumps({"probe": "snapshot", "build_seconds": build_s, "sign_seconds": sign_s,
                      "launches": launches, "host_trace": trace.take() if trace else None}),
          flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
