#!/usr/bin/env python3
"""Probe of channel configuration on the peer, on one card.

    python3 scripts/config_probe.py

Builds csrc/p256_verify.cu and csrc/mvcc_resolve.cu (one nvcc each, started
together) and the native host runtime, signs pipeline_config2's chain (10
linked config #2 blocks of 1,000 txs, in a pool of spawned processes, as
`chip_smoke.pipeline_phases` does) and runs chip_smoke.py's
config_update_config2 phase alone (`chip_smoke.config_phase`). The phase's
JSON line comes first, then the probe's, then the card's name and power
limit.
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
        print("config_probe: no CUDA device", file=sys.stderr)
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
    t0 = time.perf_counter()
    net = chip_smoke.Config2Net()
    chains = chip_smoke.build_chains(net, {chip_smoke.CONFIG2_CHANNEL: (
        chip_smoke.PIPELINE_BLOCKS, chip_smoke.CONFIG2_TXS, chip_smoke.PIPELINE_CONFLICT_BLOCK,
        chip_smoke.CONFIG2_CHANNEL, chip_smoke.PIPELINE_FLIPPED)})
    sign_s = time.perf_counter() - t0
    launches = chip_smoke.config_phase(torch, np, torch.device("cuda", 0), net,
                                       chains[chip_smoke.CONFIG2_CHANNEL])
    print(json.dumps({"probe": "config", "build_seconds": build_s, "sign_seconds": sign_s,
                      "launches": launches}), flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
