#!/usr/bin/env python3
"""K1's and K2's times at chip_smoke.py's shapes, for one tree's kernels.

    python3 scripts/p256_probe.py [--root DIR]

Imports `fabric_tpu_torch` from DIR (a checkout of this repository; the
default is the one this script is in), which builds its own
csrc/p256_verify.cu, and times through that tree's CUDAProvider, on one
card: K2 at the headline's 32,768 lanes (8 keys and a key off the curve)
and at the block's 3,000 lanes (3 keys, the 4,096 bucket), and K1 at the
limb route's 4,096 lanes (64 keys); CUDA events around 20 launches each,
after a warm-up. The signed rows come from this repository's
chip_smoke.p256_pool, so two trees time the same inputs: run it for two
trees in turns in one call (A, B, B, A) to compare their kernels on one
card. Prints one JSON line, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    root = Path(ap.parse_args().root).resolve()
    spec = importlib.util.spec_from_file_location("smoke_inputs", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("p256_probe: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.common import der, p256
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider, _bucket as bucket

    privs = smoke.p256_privs(p256)
    keys = [ECDSAPublicKey(*p256.scalar_mult(d, p256.GENERATOR)) for d in privs]
    prov = CUDAProvider(device=torch.device("cuda", 0))
    out = {"root": str(root)}
    for label, nkeys, unique, lanes in (("headline", 8, 1024, 32768), ("block", 3, 300, 3000),
                                        ("limb", 64, 192, 4096)):
        rows = smoke.p256_pool(p256, der, ECDSAPublicKey, keys, privs, nkeys, unique, label)
        rows = [rows[i % len(rows)] for i in range(lanes)]
        prep, limbs = prov.prep_bytes([r[0] for r in rows], [r[1] for r in rows],
                                      [r[2] for r in rows])
        fn, args = prov.device_inputs(prep, limbs, bucket(lanes))
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        out[label] = {"lanes": lanes, "bucket": bucket(lanes), "route": "K2" if prep else "K1",
                      "ms": start.elapsed_time(stop) / 20}
    print(json.dumps(out), flush=True)
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
