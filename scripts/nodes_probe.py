#!/usr/bin/env python3
"""Probe of the peer and orderer nodes over gRPC, on one card.

    python3 scripts/nodes_probe.py

Builds csrc/p256_verify.cu and csrc/mvcc_resolve.cu (one nvcc each, started
together) and the native host runtime, then runs chip_smoke.py's
nodes_config2 phase alone (`chip_smoke.nodes_phase`): three OrdererNode
consenters over orderer/cluster's Step streams and two PeerNodes on the
card, config #2's proposals over gRPC ProcessProposal, a chaincode-as-a-
service package installed through _lifecycle, envelopes broadcast to a
non-leader and forwarded by cluster Submit, the leader node stopped and
restarted, discovery over gRPC, the operations servers. The phase's JSON
line comes first, then the probe's, then the card's name and power limit.
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
        print("nodes_probe: no CUDA device", file=sys.stderr)
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
    launches = chip_smoke.nodes_phase(torch, np, dev)
    print(json.dumps({"probe": "nodes", "build_seconds": build_s, "launches": launches}),
          flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
