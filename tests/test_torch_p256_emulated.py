"""K1, K2 and K2's table kernel as the card runs them, compiled for the CPU,
against their plain versions and the oracle.

`fabric_tpu_torch/csrc/p256_verify.cu` is compiled with g++ under the
stand-ins of `tests/cuda_emu/stand_in.h` (a block as fibers taking turns,
`__syncwarp` a barrier over the caller's warp, `__syncthreads` one over the
block, `__shfl_down_sync` an exchange between warp barriers, FMUL and NMUL
counted Montgomery multiplies mod p and mod n), with P256_KERNELS_ONLY,
which leaves out its launchers, and run through `tests/cuda_emu/run_p256.cpp`
on inputs packed as the wrappers pack them. The card's inline-PTX carry
chains are not in this build (it takes the same functions' 64-bit C++
arithmetic); they, the registers and the timing show only on the card
(`chip_smoke.py`). The lanes are the smoke's crafted edge lanes
(`chip_smoke.p256_crafted_lanes`) and four valid signatures, built and
judged by the JAX package's oracle (`fabric_tpu.common.p256`): every
verdict of both kernels must equal the plain version's and the oracle's, the table
kernel's words must equal `key_tables_ref`'s, and the multiplies each
lane's (or key's) threads ran must equal the counts the kernels'
`bound_ms_kernel` is computed from (`p256_kernel.KERNEL_*`). All
comparisons are exact.
"""

import hashlib
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fabric_tpu.common import p256 as jp
from fabric_tpu_torch.crypto.cuda_provider import be_bytes_to_limbs
from fabric_tpu_torch.ops import p256_kernel as pk
from torch_untraced import untraced  # noqa: F401

HARNESS = Path(__file__).resolve().parent / "cuda_emu"
CU = Path(pk.__file__).resolve().parent.parent / "csrc" / "p256_verify.cu"
PRIVS = [(k * 0x9E3779B97F4A7C15 + chip_smoke.SEED_PRIV) % (jp.N - 1) + 1 for k in range(64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lanes():
    lanes = []
    for i in range(4):
        d = hashlib.sha256(f"emulated {i}".encode()).digest()
        r, s = jp.sign_digest(PRIVS[10 + i], d, k=555 + i)
        lanes.append((f"valid-{i}", jp.scalar_mult(PRIVS[10 + i], jp.GENERATOR), d, r, s, True))
    return lanes + chip_smoke.p256_crafted_lanes(jp, PRIVS)


def _be(vals):
    return np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                         dtype=np.uint8).reshape(len(vals), 32).copy()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    build = tmp_path_factory.mktemp("p256_emulated")
    cpp = build / "p256_emulated.cpp"
    cpp.write_text(f'#include "stand_in.h"\n#include "{CU}"\n#include "run_p256.cpp"\n')
    exe = build / "p256_emulated"
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-DP256_KERNELS_ONLY", "-I",
                    str(HARNESS), "-o", str(exe), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    lanes = _lanes()
    points = sorted({ln[1] for ln in lanes})
    col = {pt: i for i, pt in enumerate(points)}
    e_b = np.stack([np.frombuffer(ln[2], dtype=np.uint8) for ln in lanes])
    r_b, s_b = _be([ln[3] for ln in lanes]), _be([ln[4] for ln in lanes])
    kx, ky = be_bytes_to_limbs(_be([pt[0] for pt in points])), be_bytes_to_limbs(
        _be([pt[1] for pt in points]))
    idx = np.array([col[ln[1]] for ln in lanes], dtype=np.int32)
    valid = np.array([ln[5] for ln in lanes], dtype=bool)
    limbs = [be_bytes_to_limbs(a) for a in (e_b, r_b, s_b)] + [kx[:, idx], ky[:, idx]]
    inputs = {"e_b": e_b, "r_b": r_b, "s_b": s_b, "kx": kx, "ky": ky, "idx": idx,
              "valid": valid.astype(np.uint8), "gcomb": pk.g_comb_words(),
              **dict(zip(("e", "r", "s", "qx", "qy"), limbs))}
    for name, arr in inputs.items():
        (build / f"{name}.bin").write_bytes(np.ascontiguousarray(arr).tobytes())
    printed = subprocess.run([str(exe), str(build), str(len(lanes)), str(len(points))],
                             check=True, capture_output=True, text=True, timeout=300).stdout
    group, block, table_block = map(int, printed.split())

    def counts(what, per, items):
        out = {}
        for kind in ("fmuls", "nmuls"):
            c = np.fromfile(build / f"{kind}_{what}.bin", dtype=np.int64)
            out[kind] = [int(c[i * per:(i + 1) * per].sum()) for i in range(items)]
        return out

    lanes_a_block = block // group
    blocks = -(-len(lanes) // lanes_a_block)

    t = torch.from_numpy
    args_b = [t(a) for a in (e_b, r_b, s_b, kx, ky, idx, valid)]
    args_l = [t(np.ascontiguousarray(a)) for a in limbs] + [t(valid)]
    return {
        "names": [ln[0] for ln in lanes],
        "oracle": [bool(ln[5]) and jp.verify_digest(ln[1], ln[2], ln[3], ln[4])
                   for ln in lanes],
        "valid": valid.tolist(),
        "bytes": np.fromfile(build / "out_bytes.bin", dtype=np.uint8).tolist(),
        "limbs": np.fromfile(build / "out_limbs.bin", dtype=np.uint8).tolist(),
        "plain_bytes": pk.verify_batch_bytes(*args_b).tolist(),
        "plain_limbs": pk.verify_batch(*args_l).tolist(),
        "tables": np.fromfile(build / "tables.bin", dtype=np.uint32),
        "stamps": np.fromfile(build / "stamps.bin", dtype=np.int64).reshape(len(points), -1),
        "plain_tables": pk.key_tables(t(kx), t(ky)).numpy().view(np.uint32),
        "shape": (group, block, table_block),
        "counts": {"bytes": counts("bytes", group, len(lanes)),
                   "bytes_blocks": counts("bytes", block, blocks),
                   "limbs": counts("limbs", group, len(lanes)),
                   "tables": counts("tables", table_block, len(points))},
    }


@pytest.mark.parametrize("route", ["bytes", "limbs"])
def test_verdicts_match_plain_and_oracle(emulated, route):
    got = [bool(v) for v in emulated[route]]
    bad = [n for n, a, b, c in zip(emulated["names"], got, emulated[f"plain_{route}"],
                                   emulated["oracle"]) if not a == b == c]
    assert not bad, bad
    assert sum(emulated["oracle"]) >= 9  # the crafted true lanes verify


def test_key_tables_match_plain_words(emulated):
    assert np.array_equal(emulated["tables"], emulated["plain_tables"].reshape(-1))


def test_threads_and_multiplies_match_the_counts(emulated):
    """A live lane's threads run KERNEL_MOD_P_* multiplies mod p, a dead
    lane none; mod n a K1 lane KERNEL_MOD_N, a K2 block with a live lane
    KERNEL_MOD_N_BYTES_BLOCK (its batch inversion) and KERNEL_MOD_N_BYTES_LANE
    a live lane; a key's table block KERNEL_MOD_P_TABLE."""
    group, block, _ = emulated["shape"]
    assert group == pk.THREADS_PER_LANE and block == group * pk.LANES_PER_BLOCK
    live = emulated["valid"]
    for route, mod_p in (("bytes", pk.KERNEL_MOD_P_BYTES), ("limbs", pk.KERNEL_MOD_P_LIMBS)):
        assert emulated["counts"][route]["fmuls"] == [mod_p if v else 0 for v in live]
    assert emulated["counts"]["limbs"]["nmuls"] == [pk.KERNEL_MOD_N if v else 0 for v in live]
    per_block = [live[i:i + pk.LANES_PER_BLOCK] for i in range(0, len(live), pk.LANES_PER_BLOCK)]
    assert emulated["counts"]["bytes_blocks"]["nmuls"] == [
        sum(b) * pk.KERNEL_MOD_N_BYTES_LANE + (pk.KERNEL_MOD_N_BYTES_BLOCK if any(b) else 0)
        for b in per_block]
    tables = emulated["counts"]["tables"]
    assert set(tables["fmuls"]) == {pk.KERNEL_MOD_P_TABLE} and set(tables["nmuls"]) == {0}


def test_table_stamps_in_order(emulated):
    """Each table block's clock stamps (what key_tables_stamped returns on
    the card): the start, then doubling 128's start and the ends of its
    four steps, then the chain's end; the fill's end after the start."""
    st = emulated["stamps"]
    assert st.shape[1] == 8
    for row in st:
        assert all(np.diff(row[[0, 3, 4, 5, 6, 7, 1]]) >= 0)
        assert row[2] >= row[0] > 0
