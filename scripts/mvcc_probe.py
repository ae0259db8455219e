#!/usr/bin/env python3
"""Probe of the MVCC kernels (K5's and K6's two routes each) on one card.

    python3 scripts/mvcc_probe.py

Builds csrc/mvcc_resolve.cu, prints ptxas's lines for each of its
kernels, then runs chip_smoke.py's MVCC phases alone
(`chip_smoke.mvcc_phases`): both routes of K5 and of K6 against their
plain versions on the edge cases and past each shared route's limit,
config #4 through DeviceValidator (and the same block shape at 13,000 txs,
past K5's shared route) and its resident blocks through
ResidentDeviceValidator, and the 1M-key resident chain, each held to the
host oracle, with each kernel's time at its shapes (the route the sizes
pick, and the global route beside it) and the shared routes' splits from
their clock stamps; then the launch floor (`chip_smoke.floor_ms`) and K5's
shared route on blocks of one read, one write and one transaction, with
one key and with 13,000 (its fixed cost, and that of 52 KB of shared
memory), with their clock stamps, beside the floor of a block of 1,024
threads with and without config #4's shared memory. Each result is a JSON line; the card's name and power limit come
last.
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
    dev = torch.device("cuda", 0)
    kernels = chip_smoke.mvcc_phases(torch, np, dev)
    floor = chip_smoke.floor_ms(torch, cudalib, dev)
    from fabric_tpu_torch.ledger import mvcc_device as md

    def one(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)

    fixed = {}
    for keys in (1, 13_000):
        args = (one([0]), one([0]), torch.zeros(1, dtype=torch.bool, device=dev), one([0]),
                one([0]))
        valid, status = md.resolve(*args, num_txs=1, num_keys=keys)
        if valid.tolist() != [True] or status.tolist() != [1]:
            raise AssertionError("K5 on a one-transaction block")
        fixed[f"keys_{keys}"] = {
            "shared_bytes": md.resolve_shared_bytes(1, keys, 1),
            "ms": chip_smoke.device_ms(torch, lambda: md.resolve(*args, num_txs=1,
                                                                 num_keys=keys), 20),
            "k5_split": chip_smoke.k5_probe(np, md, args, {"num_txs": 1, "num_keys": keys})}
    # the floor of a block shaped like K5's: 1,024 threads, with and without
    # config #4's 65,016 bytes of shared memory
    for shared in (0, md.resolve_shared_bytes(5000, 5000, 5000)):
        fixed[f"floor_1024_threads_{shared}_bytes"] = chip_smoke.floor_ms(
            torch, cudalib, dev, threads=1024, shared_bytes=shared)[20]
    print(json.dumps({"kernels": kernels, "k5_one_tx_block": fixed,
                      "floor_ms_by_reps": {str(r): floor[r] for r in chip_smoke.FLOOR_REPS}}),
          flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
