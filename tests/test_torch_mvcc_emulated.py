"""Both routes of K5 and of K6 as the card runs them, compiled for the CPU,
against their plain versions.

`fabric_tpu_torch/csrc/mvcc_resolve.cu` is compiled with g++ under the
stand-ins of `tests/cuda_emu/stand_in.h` (a block as 1,024 fibers taking turns,
`__syncthreads` and `__syncthreads_or` barriers over them, atomicMin and
atomicMax compare-and-swap loops, the shared route's extern `__shared__`
array one the harness defines), with MVCC_KERNELS_ONLY, which leaves out
its launchers, and run through `tests/cuda_emu/run_mvcc.cpp` on columns
laid out as the wrappers lay them out. K5's shared route (`mvcc_resolve`:
scratch in shared memory, columns in registers, stamped writer words) and
its global route (`mvcc_resolve_global`), K6's shared route
(`mvcc_resolve_resident`) and its global route
(`mvcc_resolve_resident_global`) each run on every case, and their masks,
status words and version tables must equal `resolve_ref` /
`resolve_resident_ref` exactly. The cases: the smoke's edge cases
(`chip_smoke.mvcc_kernel_cases`: a 64-tx invalidation chain, duplicate
writers, deletes, drop-sentinel slots), a config #4-shaped block of 400
transactions, a 5,000-transaction block shaped like the smoke's 1M-key
chain (Zipf keys, two reads and two writes a tx, about 10,000 of each),
a block past K6's shared limit (19,400 keys), which `resident_route` sends
to K6's global route and which K6's shared route refuses, and a block past
both shared limits (13,000 reads), which `resolve_route` sends to K5's
global route and which K5's shared route refuses, and one of 301
transactions. The limits themselves
are held to the .cu's `resolve_fits` / `resident_fits` at each edge. The
compiler, registers and timing show only on the card (`chip_smoke.py`).
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fabric_tpu_torch.ledger import mvcc_device as md

HARNESS = Path(__file__).resolve().parent / "cuda_emu"
CU = Path(md.__file__).resolve().parent.parent / "csrc" / "mvcc_resolve.cu"
SEED = 20261017


def _config4_case(rng):
    """bench.py bench_mvcc's block at 400 txs over a resident table: tx t
    reads key t at its committed version and writes it, every 10th reads
    its neighbour's key (which the neighbour writes), 2% claim a stale
    version; 40 keys are seeded by the launch."""
    T = K = 400
    cap = 512
    gid = rng.permutation(cap)[:K]
    table = np.full((cap, 2), -1, dtype=np.int64)
    table[gid] = np.stack([np.zeros(K, dtype=np.int64), np.arange(K)], axis=1)
    seeded = rng.choice(K, 40, replace=False)
    init_idx = gid[seeded]
    init_ver = np.stack([np.ones(40, dtype=np.int64), seeded], axis=1)
    truth = table.copy()
    truth[init_idx] = init_ver
    r_key = np.array([t - 1 if t % 10 == 5 else t for t in range(T)])
    r_tx = np.arange(T)
    r_ver = truth[gid[r_key]].copy()
    stale = rng.random(T) < 0.02
    r_ver[stale] = (7, 7)
    w_tx = w_key = np.arange(T)
    w_ver = np.stack([np.full(T, 2), w_tx], axis=1)
    return (table, init_idx, init_ver, gid[r_key], r_ver, r_tx, r_key, w_tx, w_key,
            gid[w_key], w_ver, T, K)


def _cases():
    rng = np.random.default_rng(SEED)
    _k5, edge = chip_smoke.mvcc_kernel_cases(np)
    return {
        "edge": edge,
        "config4": _config4_case(rng),
        "chain_like": chip_smoke.mvcc_random_case(np, rng, 5000, 100_000, 10_000, 10_000,
                                                  131_072, zipf=chip_smoke.ZIPF_S),
        "past_shared": chip_smoke.mvcc_random_case(np, rng, 300, 19_400, 3_000, 9_000, 20_000),
        "past_k5": chip_smoke.mvcc_random_case(np, rng, 5000, 6_000, 13_000, 5_000, 8_192),
        "odd_txs": chip_smoke.mvcc_random_case(np, rng, 301, 97, 700, 650, 256),
    }


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    build = tmp_path_factory.mktemp("mvcc_emulated")
    cpp = build / "mvcc_emulated.cpp"
    cpp.write_text(f'#include "stand_in.h"\n#include "{CU}"\n#include "run_mvcc.cpp"\n')
    exe = build / "mvcc_emulated"
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-DMVCC_KERNELS_ONLY", "-I",
                    str(HARNESS), "-o", str(exe), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    out = {}
    for name, case in _cases().items():
        (table, init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx, w_key, w_gid, w_ver,
         T, K) = case
        d = build / name
        d.mkdir()
        cap = len(table)
        r_bad = np.zeros(len(r_tx), dtype=np.uint8)  # K5 reads its own static flags
        r_bad[(np.asarray(r_ver) != table[np.clip(r_gid, 0, cap - 1)]).any(axis=1)] = 1
        cols = {"r_tx": r_tx, "r_key": r_key, "r_gid": r_gid, "r_ver": r_ver, "w_tx": w_tx,
                "w_key": w_key, "w_gid": w_gid, "w_ver": w_ver, "versions": table,
                "init_idx": init_idx, "init_ver": init_ver}
        for col, arr in cols.items():
            (d / f"{col}.bin").write_bytes(np.ascontiguousarray(arr, dtype=np.int32).tobytes())
        (d / "r_bad.bin").write_bytes(r_bad.tobytes())
        (d / "sizes.txt").write_text(f"{len(r_tx)} {len(w_tx)} {T} {K} {len(init_idx)} {cap}\n")
        printed = subprocess.run([str(exe), str(d)], check=True, capture_output=True,
                                 text=True, timeout=600).stdout
        threads, ncols = map(int, printed.split())
        out.setdefault("exe", exe)

        def t32(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

        res = {"T": T, "K": K, "R": len(r_tx), "W": len(w_tx), "threads": threads,
               "cols": ncols}
        for route in ("k5", "k5global", "shared", "global"):
            res[route] = {
                "valid": np.fromfile(d / f"valid_{route}.bin", dtype=np.uint8).tolist(),
                "status": int(np.fromfile(d / f"status_{route}.bin", dtype=np.int32)[0]),
            }
            if route in ("shared", "global"):
                res[route]["versions"] = np.fromfile(
                    d / f"versions_{route}.bin", dtype=np.int32).reshape(cap, 2)
        if (d / "stamps_shared.bin").exists():
            res["stamps"] = np.fromfile(d / "stamps_shared.bin", dtype=np.int64)
        if (d / "stamps_k5.bin").exists():
            res["stamps_k5"] = np.fromfile(d / "stamps_k5.bin", dtype=np.int64)
        valid, status = md.resolve_ref(t32(r_tx), t32(r_key), torch.from_numpy(r_bad.astype(bool)),
                                       t32(w_tx), t32(w_key), T, K)
        res["plain_k5"] = {"valid": valid.to(torch.uint8).tolist(), "status": int(status[0])}
        versions = t32(table).clone()
        valid, status = md.resolve_resident_ref(
            versions, *(t32(a) for a in (init_idx, init_ver, r_gid, r_ver, r_tx, r_key, w_tx,
                                         w_key, w_gid, w_ver)), T, K)
        res["plain_k6"] = {"valid": valid.to(torch.uint8).tolist(), "status": int(status[0]),
                           "versions": versions.numpy()}
        out[name] = res
    return out


CASES = ("edge", "config4", "chain_like", "past_shared")
K5_CASES = CASES + ("past_k5", "odd_txs")


@pytest.mark.parametrize("case", CASES)
def test_k5_matches_plain(emulated, case):
    """K5's shared route, which every one of these blocks fits."""
    got, want = emulated[case]["k5"], emulated[case]["plain_k5"]
    assert want["status"] >= 1
    assert got["status"] == want["status"]
    assert got["valid"] == want["valid"]


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_global_route_matches_plain(emulated, case):
    got, want = emulated[case]["k5global"], emulated[case]["plain_k5"]
    assert want["status"] >= 1
    assert got["status"] == want["status"]
    assert got["valid"] == want["valid"]


def test_k5_shared_route_odd_block(emulated):
    """301 transactions over 97 keys: a block whose sizes are multiples of
    neither four nor a thread block."""
    got, want = emulated["odd_txs"]["k5"], emulated["odd_txs"]["plain_k5"]
    assert emulated["odd_txs"]["T"] % 4 == 1
    assert want["status"] >= 1
    assert got["status"] == want["status"]
    assert got["valid"] == want["valid"]


def test_k5_shared_route_refuses_past_its_limit(emulated):
    """13,000 reads are past K5's shared route (and K6's): resolve_route
    sends the block to the global route, the shared launcher refuses it."""
    res = emulated["past_k5"]
    assert res["R"] > md.RESIDENT_THREADS * md.RESIDENT_COLS
    assert not md.resolve_fits(res["R"], res["W"], res["T"], res["K"])
    assert md.resolve_route(res["R"], res["W"], res["T"], res["K"]) == "mvcc_resolve_global"
    assert res["k5"]["status"] == 99 and res["shared"]["status"] == 99  # no launch
    assert res["global"]["valid"] == res["plain_k6"]["valid"]
    assert res["global"]["status"] == res["plain_k6"]["status"]


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("case", CASES)
def test_k6_route_matches_plain(emulated, case, route):
    """Masks, status and the version table (init scatter and commit) equal
    to the plain version's; the shared route refuses the block past its
    limit, which its sizes send to the global route."""
    res = emulated[case]
    fits = md.resident_fits(res["R"], res["W"], res["T"], res["K"])
    assert fits == (case != "past_shared")
    if route == "shared" and not fits:
        assert res["shared"]["status"] == 99  # no launch
        return
    got, want = res[route], res["plain_k6"]
    assert want["status"] >= 1
    assert got["status"] == want["status"]
    assert got["valid"] == want["valid"]
    assert np.array_equal(got["versions"], want["versions"])


def test_route_by_size_alone(emulated):
    """resident_route names the shared kernel for every case within the
    limits and the global one past them; the chain-like block fills more
    than eight of its threads' register columns, and the edge chain takes
    at least 64 sweeps."""
    routes = {c: md.resident_route(emulated[c]["R"], emulated[c]["W"], emulated[c]["T"],
                                   emulated[c]["K"]) for c in CASES}
    assert routes == {"edge": "mvcc_resolve_resident", "config4": "mvcc_resolve_resident",
                      "chain_like": "mvcc_resolve_resident",
                      "past_shared": "mvcc_resolve_resident_global"}
    first = emulated["edge"]
    assert (first["threads"], first["cols"]) == (md.RESIDENT_THREADS, md.RESIDENT_COLS)
    assert emulated["chain_like"]["R"] > 8 * md.RESIDENT_THREADS
    assert emulated["edge"]["plain_k6"]["status"] >= 64
    assert md.resident_shared_bytes(5000, 15_619, 5000) <= md.RESIDENT_SHARED_MAX
    assert md.resident_shared_bytes(5000, 15_620, 5000) > md.RESIDENT_SHARED_MAX


@pytest.mark.parametrize("case", CASES[:3])
def test_shared_route_stamps_in_order(emulated, case):
    """Thread 0's clock stamps (what resolve_resident_stamped returns on the
    card) are written at the start, its reads and writes loaded, the load's
    barrier, the check, each barrier of the sweeps run (up to five) and the
    commit, in that order."""
    st = emulated[case]["stamps"]
    sweeps = emulated[case]["plain_k6"]["status"]
    written = [i for i in range(len(st)) if st[i]]
    # sweeps 0 .. sweeps - 1 each pass both barriers (the first five stamped)
    barriers = [3 + j for j in range(2 * min(sweeps, 5))]
    assert written == [0, 1, 2] + barriers + [13, 14, 15, 16, 17]
    in_time = [0, 16, 17, 1, 2] + barriers + [13, 14, 15]
    assert all(np.diff(st[in_time]) >= 0)


@pytest.mark.parametrize("case", CASES[:3])
def test_k5_shared_route_stamps_in_order(emulated, case):
    """Thread 0's clock stamps on K5's shared route (what resolve_stamped
    returns on the card): the start, the scratch's barrier, each half of its
    columns in, the columns' barrier, each barrier of the sweeps run (up to
    five) and the end, in that order."""
    st = emulated[case]["stamps_k5"]
    sweeps = emulated[case]["plain_k5"]["status"]
    assert len(st) == md.RESOLVE_STAMPS
    barriers = [5 + j for j in range(2 * min(sweeps, 5))]
    written = [i for i in range(len(st)) if st[i]]
    assert written == [0, 1, 2, 3, 4] + barriers + [15]
    assert all(np.diff(st[written]) >= 0)


def _edges():
    """name -> (R, W, T, K) just inside a limit, the same just past it, and
    which shared routes the limit is theirs ("both", "k5" or "k6"). The
    16-bit limits on T and K bind no shape: the bytes bind first (5 T and
    4 K within 232,448)."""
    cols = md.RESIDENT_THREADS * md.RESIDENT_COLS
    # keys that fill the block's shared memory at W = T = 5,000
    room = md.RESIDENT_SHARED_MAX - 16 - 4 * 5000 - 5 * 5000
    k5_keys, k6_keys = room // 4, room // 12
    return {
        "reads": ((cols, 10, 10, 10), (cols + 1, 10, 10, 10), "both"),
        "writes": ((10, cols, 10, 10), (10, cols + 1, 10, 10), "both"),
        "k5_bytes": ((5000, 5000, 5000, k5_keys), (5000, 5000, 5000, k5_keys + 1), "k5"),
        "k5_bytes_txs": ((10, 0, 46_486, 0), (10, 0, 46_487, 0), "k5"),
        "k6_bytes": ((5000, 5000, 5000, k6_keys), (5000, 5000, 5000, k6_keys + 1), "k6"),
    }


@pytest.mark.parametrize("edge", sorted(_edges()))
def test_resolve_route_at_each_limit(emulated, edge):
    """resolve_route and resident_route at each limit's edge: the last shape
    inside takes the shared route and the first past it the global one,
    and the Python limits equal the .cu's resolve_fits / resident_fits."""
    inside, past, which = _edges()[edge]
    for shape in (inside, past):
        printed = subprocess.run([str(emulated["exe"]), "fits", *map(str, shape)], check=True,
                                 capture_output=True, text=True, timeout=60).stdout
        assert tuple(map(int, printed.split())) == (md.resolve_fits(*shape),
                                                    md.resident_fits(*shape))
    if which in ("both", "k5"):
        assert md.resolve_route(*inside) == "mvcc_resolve"
        assert md.resolve_route(*past) == "mvcc_resolve_global"
    if which in ("both", "k6"):
        assert md.resident_route(*inside) == "mvcc_resolve_resident"
        assert md.resident_route(*past) == "mvcc_resolve_resident_global"
