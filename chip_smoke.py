#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fabric_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the P-256 verify kernels from csrc/ with nvcc, holds each against its
plain PyTorch version on the card, then drives the port's main path, the
CUDAProvider behind the BCCSP SPI, at the sizes Fabric's block validator
feeds it:

  1. kernel vs plain version, K1 (limbs) and K2 (bytes), 64 lanes with the
     edge cases: masks bit-identical, and equal to the oracle's;
  2. headline: 32,768 lanes from 8 keys (bytes route), 3 timed passes of
     2 batches in flight;
  3. block batch: 3,000 lanes from 3 keys (the signature phase of a
     1,000-tx block under a 2-of-3 policy);
  4. limb route: 4,096 lanes from 64 keys (past the 32-column key bucket);
  5. launch counts of the main path (phases 2-4), then each kernel's own
     time (CUDA events), its plain version's time and its bound;
  6. the card's name and power limit.

Inputs are signed by the port's oracle with fixed keys and nonces, a known
subset corrupted (flipped digest, wrong key, s+1, high-S, bad DER, r = 0,
r = n, off-curve key); the expected masks come from the oracle. Any
mismatch or error exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

SEED_PRIV = 0xC2B2AE3D27D4EB4F
SEED_NONCE = 12345
# H100 memory rate for the byte bound (NVIDIA data sheet, SXM part)
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds per SM per clock on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
IMAD_PER_SM_PER_CLOCK = 64


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    import numpy as np

    from fabric_tpu_torch.common import der, p256
    from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey, VerifyError, parse_and_precheck
    from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider, be_bytes_to_limbs
    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.ops import p256_kernel as pk

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # --- build -----------------------------------------------------------
    t0 = time.perf_counter()
    cudalib.load("p256_verify")
    emit({
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "ptxas": [ln for ln in cudalib.ptxas_report("p256_verify").splitlines()
                  if "registers" in ln or "spill" in ln or "stack" in ln],
    })

    # --- inputs ----------------------------------------------------------
    t0 = time.perf_counter()
    privs = [(k * 0x9E3779B97F4A7C15 + SEED_PRIV) % (p256.N - 1) + 1 for k in range(64)]
    keys = [ECDSAPublicKey(*p256.scalar_mult(d, p256.GENERATOR)) for d in privs]

    def oracle(key, sig, digest) -> bool:
        try:
            r, s = parse_and_precheck(sig)
        except VerifyError:
            return False
        return p256.verify_digest(key.point, digest, r, s)

    def pool(nkeys: int, nrows: int, tag: str):
        """Rows signed with keys[0:nkeys]; rows with i % 16 >= 8 corrupted."""
        off_curve = ECDSAPublicKey(keys[0].x, (keys[0].y + 1) % p256.P)
        rows = []
        for i in range(nrows):
            kidx = i % nkeys
            key = keys[kidx]
            digest = hashlib.sha256(f"{tag} {i}".encode()).digest()
            nonce = (i * 0xD6E8FEB86659FD93 + SEED_NONCE) % (p256.N - 1) + 1
            r, s = p256.sign_digest(privs[kidx], digest, k=nonce)
            kind = i % 16
            sig = None
            if kind == 8:
                digest = bytes([digest[0] ^ 1]) + digest[1:]
            elif kind == 9:
                key = keys[(kidx + 1) % nkeys]
            elif kind == 10:
                s = s + 1
            elif kind == 11:
                s = p256.N - s
            elif kind == 12:
                sig = der.marshal_signature(r, s)[:-3]
            elif kind == 13:
                r = 0
            elif kind == 14:
                r = p256.N
            elif kind == 15:
                key = off_curve
            if sig is None:
                sig = der.marshal_signature(r, s)
            rows.append((key, sig, digest))
        return rows, [oracle(*row) for row in rows]

    pool8, want8 = pool(8, 1024, "headline")
    pool3, want3 = pool(3, 300, "block")
    pool64, want64 = pool(64, 192, "limb")
    emit({"phase": "inputs", "unique_rows": len(pool8) + len(pool3) + len(pool64),
          "seconds": time.perf_counter() - t0})

    def tile(rows, want, n):
        return [rows[i % len(rows)] for i in range(n)], [want[i % len(want)] for i in range(n)]

    # --- phase 1: kernel vs plain version, 64 lanes ------------------------
    lanes = []  # (point, digest, r, s, valid_in)
    for key, sig, digest in pool8[:40]:
        try:
            r, s = parse_and_precheck(sig)
            valid = 1 <= r < p256.N and 1 <= s < p256.N and p256.is_on_curve(key.point)
        except VerifyError:
            r, s, valid = 0, 0, False
        lanes.append((key.point, digest, r, s, valid))
    g = p256.GENERATOR
    d0 = hashlib.sha256(b"edge").digest()
    r1, s1 = p256.sign_digest(1, d0, k=7)  # Q = G
    k_eq = 0x1234567
    r_eq = p256.scalar_mult(k_eq, g)[0] % p256.N
    d_eq = r_eq.to_bytes(32, "big")  # e == r: u1 == u2
    r2, s2 = p256.sign_digest(privs[1], d_eq, k=k_eq)
    d_zero = bytes(32)
    r3, s3 = p256.sign_digest(privs[2], d_zero, k=99)
    d_big = b"\xff" * 32  # e >= n
    r4, s4 = p256.sign_digest(privs[3], d_big, k=101)
    r5, s5 = p256.sign_digest(1, d_eq, k=k_eq)  # Q = G and u1 == u2: doubling in the ladder
    pmn = p256.P - p256.N
    crafted = [
        (g, d0, r1, s1, True),
        (keys[1].point, d_eq, r2, s2, True),
        (keys[2].point, d_zero, r3, s3, True),
        (keys[3].point, d_big, r4, s4, True),
        (g, d_eq, r5, s5, True),
        # u1*G = -u2*Q with Q = G: e = n - r, any s; the sum is infinity
        (g, (p256.N - 12345).to_bytes(32, "big"), 12345, 777, True),
        (keys[4].point, d0, 5, 1234567, True),  # r < p - n: the r+n candidate
        (keys[4].point, d0, pmn - 1, 4321, True),
        (keys[4].point, d0, pmn, 4321, True),
        (keys[5].point, d0, r1, p256.N - s1, True),  # high-S reaching the kernel
        (keys[5].point, d0, r1, 0, True),  # s = 0
        (keys[5].point, d0, 0, s1, True),  # r = 0
        (keys[5].point, d0, p256.N, s1, True),  # r = n
        ((keys[6].x, (keys[6].y + 1) % p256.P), d0, r1, s1, True),  # off curve
        (keys[6].point, d0, r1, s1, False),  # valid_in false
    ]
    lanes += crafted
    while len(lanes) < 64:
        lanes.append(lanes[len(lanes) % 40])
    want1 = [bool(v) and p256.verify_digest(pt, d, r, s) for pt, d, r, s, v in lanes]
    points = sorted({ln[0] for ln in lanes})
    col = {pt: i for i, pt in enumerate(points)}

    def be(vals):
        return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                             dtype=np.uint8).reshape(len(vals), 32).copy()

    e_b = np.stack([np.frombuffer(ln[1], dtype=np.uint8) for ln in lanes])
    r_b = be([ln[2] for ln in lanes])
    s_b = be([ln[3] for ln in lanes])
    kx = be_bytes_to_limbs(be([pt[0] for pt in points]))
    ky = be_bytes_to_limbs(be([pt[1] for pt in points]))
    idx = np.array([col[ln[0]] for ln in lanes], dtype=np.int32)
    valid = np.array([ln[4] for ln in lanes], dtype=bool)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bytes_args = [cuda(a) for a in (e_b, r_b, s_b, kx, ky, idx, valid)]
    limb_args = [cuda(a) for a in (be_bytes_to_limbs(e_b), be_bytes_to_limbs(r_b),
                                   be_bytes_to_limbs(s_b), kx[:, idx], ky[:, idx], valid)]
    results = {}
    for name, kernel, ref, args in (
        ("p256_verify_bytes", pk.verify_batch_bytes, pk.verify_batch_bytes_ref, bytes_args),
        ("p256_verify_limbs", pk.verify_batch, pk.verify_batch_ref, limb_args),
    ):
        got = kernel(*args)
        torch.cuda.synchronize()
        plain = ref(*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - plain.to(torch.int32)).abs().max().item())
        if got.tolist() != plain.tolist():
            raise AssertionError(f"{name}: kernel and plain masks differ")
        if got.tolist() != want1:
            raise AssertionError(f"{name}: mask differs from the oracle's")
        results[name] = {"max_abs_err": err}
        emit({"phase": "kernel_vs_plain", "kernel": name, "lanes": len(lanes),
              "accepted": sum(want1), "max_abs_err": err, "identical": True})

    # --- phases 2-4: the main path through CUDAProvider -------------------
    prov = CUDAProvider(device=dev)
    if prov.describe_backend() != "cuda":
        raise AssertionError(f"provider runs on {prov.describe_backend()}")
    head_rows, head_want = tile(pool8, want8, 32768)
    block_rows, block_want = tile(pool3, want3, 3000)
    limb_rows, limb_want = tile(pool64, want64, 4096)

    def cols(rows):
        return [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows]

    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    # headline: 3 timed passes, each with 2 batches in flight
    head = cols(head_rows)
    pass_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        first = prov.batch_verify_async(*head)
        second = prov.batch_verify_async(*head)
        masks = (first(), second())
        pass_s.append(time.perf_counter() - t0)
        for m in masks:
            if m != head_want:
                raise AssertionError("headline mask differs from the oracle's")
    block = cols(block_rows)
    block_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = prov.batch_verify(*block)
        block_s.append(time.perf_counter() - t0)
        if m != block_want:
            raise AssertionError("block mask differs from the oracle's")
    limb = cols(limb_rows)
    limb_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = prov.batch_verify(*limb)
        limb_s.append(time.perf_counter() - t0)
        if m != limb_want:
            raise AssertionError("limb-route mask differs from the oracle's")
    launches = dict(pk.LAUNCHES)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")

    # --- kernel times at the main path's shapes ----------------------------
    head_prep_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        prov.prep_bytes(*head)
        head_prep_s.append(time.perf_counter() - t0)

    def time_launch(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    imad_rate = IMAD_PER_SM_PER_CLOCK * sms * clock_hz

    def bound_ms(live_lanes: int, nbytes: int):
        ops_s = live_lanes * pk.IMAD_PER_VERIFY / imad_rate
        bytes_s = nbytes / HBM_BYTES_PER_S
        return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"

    shapes = {}
    for label, batch, size in (("headline", head_rows, 32768),
                               ("block", block_rows, 4096),
                               ("limb", limb_rows, 4096)):
        prep, limbs = prov.prep_bytes(*cols(batch))
        fn, args = prov.device_inputs(prep, limbs, size)
        ms = time_launch(lambda: fn(*args))
        live = int(args[-1].sum().item())
        nbytes = sum(a.numel() * a.element_size() for a in args) + size
        nbytes += pk.g_table_words().nbytes
        b_ms, b_by = bound_ms(live, nbytes)
        shapes[label] = {"fn": fn, "args": args, "ms": ms, "live": live,
                         "bound_ms": b_ms, "bound_by": b_by, "lanes": size}

    # plain versions on the card, once each, at the main path's shapes
    for label, ref in (("headline", pk.verify_batch_bytes_ref), ("limb", pk.verify_batch_ref)):
        sh = shapes[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ref(*sh["args"])
        torch.cuda.synchronize()
        sh["plain_ms"] = (time.perf_counter() - t0) * 1e3
        got = sh["fn"](*sh["args"])
        if got.tolist() != plain.tolist():
            raise AssertionError(f"{label}: kernel and plain masks differ at full size")

    lanes_per_pass = 2 * 32768
    emit({"phase": "headline", "lanes": 32768, "keys": 8, "in_flight": 2,
          "pass_seconds": pass_s,
          "verifies_per_s": [lanes_per_pass / s for s in pass_s],
          "kernel_ms": shapes["headline"]["ms"], "host_prep_ms": [t * 1e3 for t in head_prep_s],
          "mask_equal_oracle": True})
    emit({"phase": "block", "lanes": 3000, "keys": 3, "padded_to": 4096,
          "ms_per_batch": [s * 1e3 for s in block_s], "kernel_ms": shapes["block"]["ms"],
          "mask_equal_oracle": True})
    emit({"phase": "limb_route", "lanes": 4096, "keys": 65,
          "ms_per_batch": [s * 1e3 for s in limb_s], "kernel_ms": shapes["limb"]["ms"],
          "mask_equal_oracle": True})

    kernels = []
    for name, label, replaces in (
        ("p256_verify_bytes", "headline", "fabric_tpu/ops/p256_kernel.py:499"),
        ("p256_verify_limbs", "limb", "fabric_tpu/ops/p256_kernel.py:386"),
    ):
        sh = shapes[label]
        kernels.append({
            "name": name, "route": "cuda", "source": "fabric_tpu_torch/csrc/p256_verify.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "lanes": sh["lanes"], "live_lanes": sh["live"],
            "ms": sh["ms"], "plain_ms": sh["plain_ms"],
            "bound_ms": sh["bound_ms"], "bound_by": sh["bound_by"], "library_ms": None,
        })
    emit({"phase": "block_kernel", "lanes": 4096, "live_lanes": shapes["block"]["live"],
          "ms": shapes["block"]["ms"], "bound_ms": shapes["block"]["bound_ms"]})
    emit({"phase": "totals", "seconds": time.perf_counter() - t_start,
          "sms": sms, "max_sm_clock_hz": clock_hz,
          "imad_per_verify": pk.IMAD_PER_VERIFY})
    emit({"kernels": kernels})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
