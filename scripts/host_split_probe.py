#!/usr/bin/env python3
"""The host steps the port's card paths wait on, timed on this machine.

    python3 scripts/host_split_probe.py [--runs N]

Host code only, no card needed; run it on the card's machine to read that
host. Prints one JSON line, each step's min and max over N runs (5 by
default) on the host clock:

- config #2's 1,000-tx block (`chip_smoke.Config2Net`): the native C pass
  alone (`utils/native.block_parse`), the whole `parse_block` (the C pass
  and the ParsedTx objects built from its columns) and
  `parse_block_python`;
- the limb route's 4,096-lane batch (the smoke's limb pool: 64 keys and
  the off-curve one): the provider's shared prep (`CUDAProvider._parse`:
  the native DER parse, the digest rows, the key columns) and the
  byte-to-limb conversion (`_limbs`);
- the headline's 32,768-lane batch (8 keys): `prep_bytes` and the native
  DER parse alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def spread(fn, runs: int):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return [min(times), max(times)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    runs = ap.parse_args().runs

    from fabric_tpu_torch.common import der, p256
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
    from fabric_tpu_torch.utils import native
    from fabric_tpu_torch.validation.blockparse import parse_block, parse_block_python

    native.load()
    datas = chip_smoke.Config2Net().block(chip_smoke.CONFIG2_TXS)["data"]["data"]
    out = {"config2_block": {
        "txs": len(datas),
        "c_pass_ms": spread(lambda: native.block_parse(datas), runs),
        "parse_block_ms": spread(lambda: parse_block(datas), runs),
        "parse_block_python_ms": spread(lambda: parse_block_python(datas), runs)}}

    privs = chip_smoke.p256_privs(p256)
    keys = [ECDSAPublicKey(*p256.scalar_mult(d, p256.GENERATOR)) for d in privs]
    prov = CUDAProvider(device="cpu")
    for label, nkeys, nrows, lanes in (("limb_route", 64, 192, 4096),
                                       ("headline", 8, 1024, 32768)):
        rows = chip_smoke.p256_pool(p256, der, ECDSAPublicKey, keys, privs, nkeys, nrows, label)
        rows = [rows[i % len(rows)] for i in range(lanes)]
        batch = [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows]
        prov.prep_bytes(*batch)  # the key columns cached, as on the smoke's path
        entry = {"lanes": lanes,
                 "prep_bytes_ms": spread(lambda: prov.prep_bytes(*batch), runs),
                 "der_parse_ms": spread(lambda: native.batch_der_parse(batch[1]), runs)}
        if label == "limb_route":
            parsed = prov._parse(*batch)
            entry["parse_ms"] = spread(lambda: prov._parse(*batch), runs)
            entry["limbs_ms"] = spread(
                lambda: prov._limbs(*parsed[:5], parsed[5], parsed[7]), runs)
        out[label] = entry
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
