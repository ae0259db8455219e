#!/usr/bin/env python3
"""Probe of the key-comb kernel `p256_key_tables` on one card.

    python3 scripts/key_tables_probe.py

Builds csrc/p256_verify.cu, prints ptxas's line for the kernel, then for
the combs of 4 and of 32 keys (the keys of chip_smoke.py's P-256 phases)
the kernel's time (CUDA events) and its split from the SM clock stamps
each block writes (`chip_smoke.key_table_probe`): the doubling chain, a
doubling's cycles and the fill left after the chain. The words of both
are held to the plain version `key_tables_ref` on the card.
Each result is a JSON line; the card's name and power limit come last.
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
        print("key_tables_probe: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.common import p256
    from fabric_tpu_torch.crypto.cuda_provider import be_bytes_to_limbs
    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.ops import p256_kernel as pk

    cudalib.load("p256_verify")
    ptxas = chip_smoke.ptxas_by_function(cudalib.ptxas_report("p256_verify"))
    print(json.dumps({"ptxas": {"p256_key_tables": ptxas.get("p256_key_tables")}}), flush=True)
    dev = torch.device("cuda", 0)
    points = [p256.scalar_mult(d, p256.GENERATOR) for d in chip_smoke.p256_privs(p256)[:32]]

    def limbs(vals):
        raw = b"".join(v.to_bytes(32, "big") for v in vals)
        arr = np.frombuffer(raw, dtype=np.uint8).reshape(len(vals), 32)
        return torch.from_numpy(np.ascontiguousarray(be_bytes_to_limbs(arr))).to(dev)

    kx, ky = limbs([pt[0] for pt in points]), limbs([pt[1] for pt in points])
    for nkeys in (4, 32):
        x, y = kx[:, :nkeys].contiguous(), ky[:, :nkeys].contiguous()
        row = chip_smoke.key_table_probe(torch, np, pk, x, y)
        got = pk.key_tables(x, y)
        torch.cuda.synchronize()
        row["words_equal_plain"] = bool(torch.equal(got, pk.key_tables_ref(x, y)))
        if not row["words_equal_plain"]:
            raise AssertionError("p256_key_tables: words differ from key_tables_ref")
        print(json.dumps(row), flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
