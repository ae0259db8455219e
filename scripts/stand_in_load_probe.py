#!/usr/bin/env python3
"""Times the P-256 rehearsal binary of tests/test_torch_p256_emulated.py
alone and beside busy processes, on the CPU.

    python3 scripts/stand_in_load_probe.py [--stand-in DIR] [--busy N] [--limit S]

Builds fabric_tpu_torch/csrc/p256_verify.cu with g++ under DIR's
`stand_in.h` and `run_p256.cpp` (tests/cuda_emu by default) exactly as the
test's fixture does, writes the fixture's inputs, then runs the binary
once alone and once beside N processes that spin (the CPU count by
default), each run cut at S seconds (300, the fixture's limit). Prints one
JSON line: the build's seconds, each run's seconds (null when cut) and
whether its outputs equal the alone run's. Pointing DIR at an older
stand-in (a copy of `git show <commit>:tests/cuda_emu/stand_in.h` beside
run_p256.cpp) compares the two under the same load. It runs the JAX
package's oracle to build the inputs, so it runs where the tests run.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

OUTPUTS = ("out_bytes.bin", "out_limbs.bin", "tables.bin")


def spin(stop_at: float) -> None:
    while time.time() < stop_at:
        pass


def write_inputs(build: Path) -> tuple:
    """The fixture's inputs, as test_torch_p256_emulated's `emulated` packs them."""
    import numpy as np

    import test_torch_p256_emulated as t

    lanes = t._lanes()
    points = sorted({ln[1] for ln in lanes})
    col = {pt: i for i, pt in enumerate(points)}
    e_b = np.stack([np.frombuffer(ln[2], dtype=np.uint8) for ln in lanes])
    r_b, s_b = t._be([ln[3] for ln in lanes]), t._be([ln[4] for ln in lanes])
    kx = t.be_bytes_to_limbs(t._be([pt[0] for pt in points]))
    ky = t.be_bytes_to_limbs(t._be([pt[1] for pt in points]))
    idx = np.array([col[ln[1]] for ln in lanes], dtype=np.int32)
    valid = np.array([ln[5] for ln in lanes], dtype=np.uint8)
    limbs = [t.be_bytes_to_limbs(a) for a in (e_b, r_b, s_b)] + [kx[:, idx], ky[:, idx]]
    inputs = {"e_b": e_b, "r_b": r_b, "s_b": s_b, "kx": kx, "ky": ky, "idx": idx,
              "valid": valid, "gcomb": t.pk.g_comb_words(),
              **dict(zip(("e", "r", "s", "qx", "qy"), limbs))}
    for name, arr in inputs.items():
        (build / f"{name}.bin").write_bytes(np.ascontiguousarray(arr).tobytes())
    return str(len(lanes)), str(len(points))


def run(exe: Path, build: Path, args: tuple, limit: float):
    t0 = time.perf_counter()
    try:
        subprocess.run([str(exe), str(build), *args], check=True, capture_output=True,
                       timeout=limit)
    except subprocess.TimeoutExpired:
        return None, None
    seconds = time.perf_counter() - t0
    return seconds, {name: (build / name).read_bytes() for name in OUTPUTS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stand-in", default=str(REPO / "tests" / "cuda_emu"))
    ap.add_argument("--busy", type=int, default=os.cpu_count())
    ap.add_argument("--limit", type=float, default=300.0)
    opts = ap.parse_args()
    cu = REPO / "fabric_tpu_torch" / "csrc" / "p256_verify.cu"
    with tempfile.TemporaryDirectory() as tmp:
        build = Path(tmp)
        (build / "p.cpp").write_text(
            f'#include "stand_in.h"\n#include "{cu}"\n#include "run_p256.cpp"\n')
        exe = build / "p256_emulated"
        t0 = time.perf_counter()
        subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-DP256_KERNELS_ONLY", "-I",
                        opts.stand_in, "-o", str(exe), str(build / "p.cpp")], check=True)
        build_s = time.perf_counter() - t0
        args = write_inputs(build)
        alone_s, want = run(exe, build, args, opts.limit)
        ctx = multiprocessing.get_context("spawn")
        stop_at = time.time() + opts.limit + 30
        hogs = [ctx.Process(target=spin, args=(stop_at,)) for _ in range(opts.busy)]
        for h in hogs:
            h.start()
        try:
            time.sleep(1.0)
            loaded_s, got = run(exe, build, args, opts.limit)
        finally:
            for h in hogs:
                h.terminate()
            for h in hogs:
                h.join(timeout=10)
    print(json.dumps({"stand_in": opts.stand_in, "busy": opts.busy, "build_seconds": build_s,
                      "alone_seconds": alone_s, "loaded_seconds": loaded_s,
                      "loaded_outputs_equal": got == want if got is not None else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
