"""K3 and K4 as the card runs them, compiled for the CPU, against their
plain versions.

`fabric_tpu_torch/csrc/bn256.cu` is compiled with g++ under the stand-ins
of `tests/cuda_emu/stand_in.h` (a block as 32 fibers taking turns, `__syncwarp`
a barrier, `__shfl_down_sync` an exchange between barriers, FMUL a
counted Montgomery multiply), with BN256_KERNELS_ONLY, which leaves out
its launchers, and run through `tests/cuda_emu/run_kernels.cpp` on inputs
packed by the wrappers' own code. That holds the kernels' algorithms, the
thread groups' division of the work and their synchronisation to the
plain versions here; the compiler, registers and timing of the card show
only on the card (`chip_smoke.py`). The checks are the smoke's: K3's
points lane by lane against the plain version and the host oracle of the
JAX package (the kernel adds in another order, so its projective words
differ), every word of K4's Miller values and final-exponentiated
values, and its verdicts. The Montgomery multiplies each lane's threads
ran are held to the counts the kernels' `bound_ms_kernel` is computed
from (`bn256_kernel.muls_per_lane`, `pairing_kernel.MULS_PER_LANE`), and
the threads a lane to `pairing_kernel.THREADS_PER_LANE`. All comparisons
are exact.
"""

import random
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fabric_tpu.common import fp256bn as jhost
from fabric_tpu_torch.common import fp256bn as host
from fabric_tpu_torch.ops import bn256_kernel as bk
from fabric_tpu_torch.ops import pairing_kernel as pk
from torch_untraced import untraced  # noqa: F401

HARNESS = Path(__file__).resolve().parent / "cuda_emu"
CU = Path(bk.__file__).resolve().parent.parent / "csrc" / "bn256.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    build = tmp_path_factory.mktemp("bn256_emulated")
    cpp = build / "bn256_emulated.cpp"
    cpp.write_text(f'#include "stand_in.h"\n#include "{CU}"\n#include "run_kernels.cpp"\n')
    exe = build / "bn256_emulated"
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-DBN256_KERNELS_ONLY", "-I",
                    str(HARNESS), "-o", str(exe), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    return exe


def _run(exe, mode, io_dir, n, lanes, inputs) -> str:
    for name, arr in inputs.items():
        (io_dir / f"{name}.bin").write_bytes(np.ascontiguousarray(arr).tobytes())
    return subprocess.run([str(exe), mode, str(io_dir), str(n), str(lanes)], check=True,
                          capture_output=True, text=True, timeout=300).stdout


def _lane_muls(path, lanes, threads_a_lane, lane_of):
    """Sum each lane's threads' Montgomery multiplies; `lane_of(i)` maps the
    launch's thread i to its lane (or past the last)."""
    per_thread = np.fromfile(path, dtype=np.int64)
    out = [0] * lanes
    for i, m in enumerate(per_thread.tolist()):
        if lane_of(i) < lanes:
            out[lane_of(i)] += m
    return out


@pytest.mark.parametrize("k_count", [8, 3, 1, 17, 33])
def test_msm_points_match_plain_and_oracle(emulator, tmp_path, k_count):
    """The smoke's edge lanes (identity bases, zero scalars, e = r - 1,
    r * G = O, equal bases, random) cut to K bases: K = 8 runs groups of
    8 threads, K = 3 groups of 4 with an idle thread, K = 1 no tree. Past
    16 bases (chip_smoke.msm_wide_lanes, the oracle alone: the plain version
    takes a second a base here) K = 17 runs a warp a lane and K = 33 a warp
    whose thread 0 takes a second base."""
    rng = random.Random(chip_smoke.IDEMIX_SEED + 1)
    if k_count <= 8:
        lanes = [(b[:k_count], e[:k_count]) for b, e in chip_smoke.msm_edge_lanes(host, rng)]
    else:
        lanes = chip_smoke.msm_wide_lanes(host, rng, k_count)
    bases, scalars = bk.pack_batch([b for b, _ in lanes], [e for _, e in lanes])
    _run(emulator, "msm", tmp_path, k_count, len(lanes), {"bases": bases, "scalars": scalars})
    out = np.fromfile(tmp_path / "out.bin", dtype=np.int64).reshape(3, 20, len(lanes))
    got = bk.unpack_points(out)
    want = []
    for bs, es in lanes:
        acc = None
        for b, e in zip(bs, es):
            acc = jhost.g1_add(acc, jhost.g1_mul(b, e % jhost.R))
        want.append(acc)
    assert got == want
    if k_count <= 8:
        plain = bk.msm_batch_ref(torch.from_numpy(bases), torch.from_numpy(scalars))
        assert bk.unpack_points(plain) == want
    g = bk.threads_per_lane(k_count)
    muls = _lane_muls(tmp_path / "muls.bin", len(lanes), g, lambda i: i // g)
    real = [sum(b is not None and e % host.R != 0 for b, e in zip(bs, es)) for bs, es in lanes]
    assert muls == [bk.muls_per_lane(k, k_count) for k in real]


PAIR_LANES = ["true", "false", "none", "identity-abar", "true-generator"]


@pytest.fixture(scope="module")
def pairing(emulator, tmp_path_factory):
    """Both entries of K4 on five lanes of one issuer, and the plain
    version's values and verdicts on the same columns."""
    rng = random.Random(chip_smoke.IDEMIX_SEED + 2)
    gamma = rng.randrange(1, host.R)
    tables = pk.Ate2Kernel(host.g2_mul(host.G2_GEN, gamma), device="cpu").tables
    a = [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R)) for _ in range(3)]
    pairs = [(a[0], host.g1_mul(a[0], gamma)), (a[1], host.g1_mul(a[1], (gamma + 1) % host.R)),
             None, (a[2], None), (host.G1_GEN, host.g1_mul(host.G1_GEN, gamma))]
    cols = pk.lane_columns(pairs, "cpu")
    g_tab = pk._g2_tables()
    io_dir = tmp_path_factory.mktemp("pairing_io")
    inputs = {"sw": tables.words("cpu").numpy(), "sg": g_tab.words("cpu").numpy(),
              "has_add": g_tab.has_add("cpu").numpy(), "ok": cols[4].numpy().astype(np.uint8)}
    inputs.update({n: c.numpy() for n, c in zip(("p1x", "p1y", "p2x", "p2y"), cols[:4])})
    group, lanes_a_block, block = map(int, _run(emulator, "ate", io_dir, pk.STEPS, len(pairs),
                                                  inputs).split())
    vals = np.fromfile(io_dir / "vals.bin", dtype=np.uint32).reshape(3, 12, 8, len(pairs))
    verdict = np.fromfile(io_dir / "verdict.bin", dtype=np.uint8)
    plain = pk.miller2_values_ref_words(tables, *cols[:4]).numpy().view(np.uint32)

    def lane_of(i):
        b, t = divmod(i, block)
        return b * lanes_a_block + t // group if t < lanes_a_block * group else len(pairs)

    muls = {e: _lane_muls(io_dir / f"muls_{e}.bin", len(pairs), group, lane_of)
            for e in ("debug", "unity")}
    return (vals, verdict, plain, pk.unity_check_ref(tables, *cols).tolist(), group, muls,
            cols[4].tolist())


@pytest.mark.parametrize("value", ["f1", "f2", "fexp"])
def test_ate2_debug_words_match_plain(pairing, value):
    vals, _, plain = pairing[:3]
    i = ("f1", "f2", "fexp").index(value)
    assert np.array_equal(vals[i], plain[i])


def test_ate2_unity_verdicts_match_plain(pairing):
    _, verdict, _, plain = pairing[:4]
    assert verdict.tolist() == [int(v) for v in plain]
    assert plain == [lane.startswith("true") for lane in PAIR_LANES]


def test_ate2_lanes_run_the_counted_multiplies(pairing):
    """ate2_debug computes every lane, ate2_unity only the lanes whose ok
    flag is set; a lane is THREADS_PER_LANE threads."""
    group, muls, ok = pairing[4:]
    assert group == pk.THREADS_PER_LANE
    assert muls["debug"] == [pk.MULS_PER_LANE] * len(PAIR_LANES)
    assert muls["unity"] == [pk.MULS_PER_LANE if o else 0 for o in ok]
