#!/usr/bin/env python3
"""Probe of gossip and the gRPC transport, on one card.

    python3 scripts/gossip_probe.py

Builds csrc/p256_verify.cu and csrc/mvcc_resolve.cu (one nvcc each, started
together) and the native host runtime, runs chip_smoke.py's endorse_config2
phase (`chip_smoke.endorse_phase`), which endorses config #2's proposals and
keeps the blocks it ordered, then its gossip_config2 phase alone
(`chip_smoke.gossip_phase`): the blocks let out by an orderer over gRPC,
pulled by the elected leader of four peers and spread by gossip, a leader
failover, a late peer caught up by state transfer, forged alives refused, a
block of private data disseminated at endorsement and reconciled by the peer
that was down. The phases' JSON lines come first, then the probe's, then
the card's name and power limit.
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gossip_probe: no CUDA device", file=sys.stderr)
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
    dev = torch.device("cuda", 0)
    kept = {}
    endorse = chip_smoke.endorse_phase(torch, np, dev, keep=kept)
    launches = chip_smoke.gossip_phase(torch, np, dev, kept["endorse_config2"])
    print(json.dumps({"probe": "gossip", "build_seconds": build_s,
                      "endorse_launches": endorse, "launches": launches}), flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
