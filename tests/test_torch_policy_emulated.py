"""Both routes of K7 as the card runs them, compiled for the CPU, against
the plain version.

`fabric_tpu_torch/csrc/policy_eval.cu` is compiled with g++ under the
stand-ins of `tests/cuda_emu/stand_in.h` (a block as fibers taking turns, a
`__syncthreads` barrier over them, `int4` a quad of ints, the shared
route's extern `__shared__` array one the harness defines), with
POLICY_KERNELS_ONLY, which leaves out its launchers, and run through
`tests/cuda_emu/run_policy.cpp` on programs and sat laid out as the
wrapper lays them out, each sat starting 0-3 bytes past a 16-byte boundary
so that a block's tile starts unaligned. The shared route (`policy_eval`:
the program and the block's tile in shared memory, the walk node after
node) runs on every case within its limits and the global route
(`policy_eval_kernel`, local or scratch state as the wrapper picks) on
every case; every verdict must equal `policy_eval_ref`'s. The cases:
every case of `chip_smoke.policy_cases()` (tests/test_policy.py's
exhaustive and random policies; edge lanes at S in {31, 32, 33, 64, 65,
100}, n = 0, n above the child count, NOutOf with no children, depth 23)
and a config #2-shaped batch (1,000 lanes, S = 2, P = 3, OutOf(2, ...)).
The compiler, registers and timing show only on the card
(`chip_smoke.py`).
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fabric_tpu_torch.ops import policy_kernel as pk
from fabric_tpu_torch.policy.ast import NOutOf, SignedBy

HARNESS = Path(__file__).resolve().parent / "cuda_emu"
CU = Path(pk.__file__).resolve().parent.parent / "csrc" / "policy_eval.cu"
SEED = 20261017


def _cases():
    """(group, rule, P, sat): the smoke's cases, then config #2's shape."""
    cases = chip_smoke.policy_cases()
    groups = ["exhaustive"] * 5 + ["random"] * 25 + ["edges"] * (len(cases) - 30)
    out = [(g, rule, P, sat) for g, (rule, P, sat) in zip(groups, cases)]
    rng = np.random.default_rng(SEED)
    config2 = NOutOf(2, [SignedBy(0), SignedBy(1), SignedBy(2)])
    out.append(("config2", config2, 3, rng.random((1000, 2, 3)) < 0.4))
    return out


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    build = tmp_path_factory.mktemp("policy_emulated")
    cpp = build / "policy_emulated.cpp"
    cpp.write_text(f'#include "stand_in.h"\n#include "{CU}"\n#include "run_policy.cpp"\n')
    exe = build / "policy_emulated"
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-DPOLICY_KERNELS_ONLY", "-I",
                    str(HARNESS), "-o", str(exe), str(cpp)],
                   check=True, capture_output=True, text=True, timeout=300)
    cases = _cases()
    blob, programs = bytearray(), []
    for i, (_g, rule, P, sat) in enumerate(cases):
        program = pk.encode_program(rule, P, "cpu")
        programs.append(program)
        B, S, _ = sat.shape
        nodes = program.nodes.shape[0]
        blob += np.array([B, S, P, program.depth, nodes, i % 4], dtype=np.int32).tobytes()
        blob += program.nodes.numpy().astype(np.int32).tobytes()
        blob += np.ascontiguousarray(sat, dtype=np.uint8).tobytes()
    (build / "cases.bin").write_bytes(bytes(blob))
    printed = subprocess.run([str(exe), str(build)], check=True, capture_output=True, text=True,
                             timeout=600).stdout
    fits = [bool(int(x)) for x in printed.split()]
    got = {r: np.fromfile(build / f"verdicts_{r}.bin", dtype=np.uint8)
           for r in ("shared", "global")}
    out, at = [], 0
    for (group, _rule, P, sat), program, fit in zip(cases, programs, fits):
        B, S, _ = sat.shape
        want = pk.policy_eval_ref(torch.from_numpy(np.ascontiguousarray(sat)), program)
        out.append({"group": group, "S": S, "P": P, "depth": program.depth,
                     "nodes": program.nodes.shape[0], "fits": fit,
                     "want": want.to(torch.uint8).tolist(),
                     "shared": got["shared"][at:at + B].tolist(),
                     "global": got["global"][at:at + B].tolist()})
        at += B
    assert at == len(got["shared"]) == len(got["global"])
    return out


GROUPS = ("exhaustive", "random", "edges", "config2")


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("route", ["shared", "global"])
def test_route_matches_plain(emulated, route, group):
    """Every lane of every case of the group on the route: the shared route
    on the cases within its limits (it refuses the others), the global route on all."""
    ran = 0
    for case in emulated:
        if case["group"] != group:
            continue
        if route == "shared" and not case["fits"]:
            assert set(case["shared"]) <= {2}  # no launch
            continue
        assert case[route] == case["want"], (case["S"], case["P"], case["depth"])
        ran += len(case["want"])
    assert ran > 0


def test_route_by_shape_alone(emulated):
    """policy_route sends S <= 32 to the shared route and S > 32 to the global route,
    for every case here; the Python limits equal the .cu's shared_fits; both
    routes take cases, the depth-23 policy among the shared route's."""
    for case in emulated:
        shape = (case["S"], case["P"], case["depth"], case["nodes"])
        assert case["fits"] == pk.shared_fits(*shape)
        assert pk.policy_route(*shape) == ("policy_eval" if case["S"] <= 32
                                           else "policy_eval_global")
    routes = {pk.policy_route(c["S"], c["P"], c["depth"], c["nodes"]) for c in emulated}
    assert routes == {"policy_eval", "policy_eval_global"}
    assert any(c["fits"] and c["depth"] == 23 and c["S"] == 32 for c in emulated)
    config2 = [c for c in emulated if c["group"] == "config2"]
    assert len(config2) == 1 and config2[0]["fits"] and len(config2[0]["want"]) == 1000


def _limits():
    """name -> (S, P, depth, nodes) just inside a limit and just past it.
    Node indices in 16 bits bind no shape: 16 bytes a node bind first."""
    room = pk.SHARED_BYTES_MAX - 16 - 8  # one node, the tile's two spare words
    p_max = room // (pk.SHARED_LANES + 4 * pk.SHARED_LANES)  # S = 1, depth 0
    n_max = (pk.SHARED_BYTES_MAX - 8 - 4 * 32 - 4 * pk.SHARED_LANES) // 16  # S = P = 1
    d_max = (pk.SHARED_BYTES_MAX - 16 * 3 - 8 - 4 * 96 - 4 * pk.SHARED_LANES * 3) // (
        8 * pk.SHARED_LANES)  # S = 1, P = 3, 3 nodes
    return {
        "signers": ((32, 3, 1, 4), (33, 3, 1, 4)),
        "principals": ((1, p_max, 0, 1), (1, p_max + 1, 0, 1)),
        "nodes": ((1, 1, 0, n_max), (1, 1, 0, n_max + 1)),
        "depth": ((1, 3, d_max, 3), (1, 3, d_max + 1, 3)),
    }


@pytest.mark.parametrize("limit", sorted(_limits()))
def test_shared_fits_at_each_limit(limit):
    """The last shape inside each limit takes the shared route, the first
    past it the global route."""
    inside, past = _limits()[limit]
    assert pk.shared_bytes(*inside) <= pk.SHARED_BYTES_MAX
    assert pk.policy_route(*inside) == "policy_eval"
    assert pk.policy_route(*past) == "policy_eval_global"
    assert inside[3] <= pk.SHARED_MAX_NODES
