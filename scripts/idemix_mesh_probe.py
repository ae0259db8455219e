#!/usr/bin/env python3
"""Probe of the Idemix MSP and the multi-device wrappers, on one card.

    python3 scripts/idemix_mesh_probe.py [--phase idemix_msp|mesh_sharded|both]

Builds csrc/bn256.cu and csrc/p256_verify.cu (one nvcc each, started
together) and the native host runtime, then runs chip_smoke.py's
idemix_msp phase (`chip_smoke.idemix_msp_phase`) and its mesh_sharded phase
(`chip_smoke.mesh_sharded_phase`) on inputs made here as the smoke's
earlier phases make them: the headline's 32,768 lanes and the limb route's
4,096 (`chip_smoke.p256_pool`, masks from the P-256 oracle), config #2's
1,000-tx block, config #5's four 2,000-tx channels (each expected all
VALID, as multichannel_config5 holds them) and config #3's 256 signatures
(`chip_smoke.idemix_world`). Each phase's JSON line comes first, then the
probe's, then the card's name and power limit.
"""

import argparse
import json
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def mesh_inputs() -> dict:
    """mesh_sharded_phase's inputs, as p256_phases, validator_phases,
    multichannel_phase and idemix_phases leave them."""
    from fabric_tpu_torch.common import der, p256
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey, VerifyError, parse_and_precheck
    from fabric_tpu_torch.protos import fabric, wire

    privs = chip_smoke.p256_privs(p256)
    keys = [ECDSAPublicKey(*p256.scalar_mult(d, p256.GENERATOR)) for d in privs]

    def oracle(key, sig, digest) -> bool:
        try:
            r, s = parse_and_precheck(sig)
        except VerifyError:
            return False
        return p256.verify_digest(key.point, digest, r, s)

    def tiled(nkeys, nrows, tag, n):
        rows = chip_smoke.p256_pool(p256, der, ECDSAPublicKey, keys, privs, nkeys, nrows, tag)
        want = [oracle(*row) for row in rows]
        return [rows[i % nrows] for i in range(n)], [want[i % nrows] for i in range(n)]

    net = chip_smoke.Config2Net()
    channels = [f"bench{i}" for i in range(chip_smoke.CONFIG5_CHANNELS)]
    config5 = {ch: wire.encode(fabric.BLOCK, net.block(chip_smoke.CONFIG5_TXS, channel=ch))
               for ch in channels}
    ipk, uniq, _ = chip_smoke.idemix_world(random)
    size = chip_smoke.IDEMIX_SIZES[-1]
    return {"headline": tiled(8, 1024, "headline", 32768), "limb": tiled(64, 192, "limb", 4096),
            "net": net, "config2": net.block(chip_smoke.CONFIG2_TXS, number=1)["data"]["data"],
            "config5": {"raw": config5, "net": net,
                        "alone": {ch: bytes(chip_smoke.CONFIG5_TXS) for ch in channels}},
            "config3": ([uniq[i % len(uniq)] for i in range(size)], None, ipk)}


def main() -> int:
    parser = argparse.ArgumentParser(prog="idemix_mesh_probe")
    parser.add_argument("--phase", choices=("idemix_msp", "mesh_sharded", "both"), default="both")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("idemix_mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.utils import native

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    sources = ("bn256", "p256_verify")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        built = pool.submit(native.build)
        list(pool.map(cudalib.build, sources))
        built.result()
    build_s = time.perf_counter() - t0
    report = {"probe": "idemix_mesh", "build_seconds": build_s}
    if args.phase in ("idemix_msp", "both"):
        report["idemix_msp"] = chip_smoke.idemix_msp_phase(torch, np, dev)
    if args.phase in ("mesh_sharded", "both"):
        t0 = time.perf_counter()
        inputs = mesh_inputs()
        report["inputs_seconds"] = time.perf_counter() - t0
        report["mesh_sharded"] = chip_smoke.mesh_sharded_phase(torch, np, dev, inputs)
    print(json.dumps(report), flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
