#!/usr/bin/env python3
"""Probe of the MVCC kernels (K5, and K6's two routes) on one card.

    python3 scripts/mvcc_probe.py

Builds csrc/mvcc_resolve.cu, prints ptxas's lines for each of its
kernels, then runs chip_smoke.py's MVCC phases alone
(`chip_smoke.mvcc_phases`): K5 and both K6 routes against their plain
versions on the edge cases and past the shared route's limit, config #4
through DeviceValidator and its resident blocks through
ResidentDeviceValidator, and the 1M-key resident chain, each held to the
host oracle, with each kernel's time at its shapes (the route the sizes
pick, and the global route beside it). Each result is a JSON line; the
card's name and power limit come last.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mvcc_probe: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.ops import cudalib

    cudalib.load("mvcc_resolve")
    print(json.dumps({"ptxas": chip_smoke.ptxas_by_function(
        cudalib.ptxas_report("mvcc_resolve"))}), flush=True)
    kernels = chip_smoke.mvcc_phases(torch, np, torch.device("cuda", 0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
