#!/usr/bin/env python3
"""Probe of the endorsement side and the solo orderer, on one card.

    python3 scripts/endorse_probe.py

Builds csrc/p256_verify.cu and csrc/mvcc_resolve.cu (one nvcc each, started
together) and the native host runtime, prints whether the grpc and yaml
modules import on this machine (`chip_smoke.module_probe`), then runs
chip_smoke.py's endorse_config2 phase alone (`chip_smoke.endorse_phase`):
config #2's proposals endorsed by two peers, ordered by a SoloChain and
committed through both peers' CommitPipelines. The phase's JSON line comes
first, then the probe's, then the card's name and power limit.
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
        print("endorse_probe: no CUDA device", file=sys.stderr)
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
    chip_smoke.emit({"phase": "modules", **chip_smoke.module_probe()})
    launches = chip_smoke.endorse_phase(torch, np, torch.device("cuda", 0))
    print(json.dumps({"probe": "endorse", "build_seconds": build_s, "launches": launches}),
          flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
