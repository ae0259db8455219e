#!/usr/bin/env python3
"""Probe of K7's two routes and of the launch floor on one card.

    python3 scripts/policy_probe.py

Builds csrc/policy_eval.cu and prints ptxas's lines for each of its
kernels, then runs chip_smoke.py's K7 check alone
(`chip_smoke.policy_kernel_vs_plain`: every case on the route its shape
picks and on each route that takes it, against the plain version and
evaluate_host), then times, at config #2's shape (1,000 lanes, S = 2,
P = 3, OutOf(2, ...) over seeded satisfaction rows), the shared route and
the global route in turns (global, shared, shared, global; `chip_smoke.device_ms`,
50 launches each), the global route at the same rows 33 signers wide, and the
launch floor (`chip_smoke.floor_ms`). Each result is a JSON line; the
card's name and power limit come last.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

SEED = 20261017


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("policy_probe: no CUDA device", file=sys.stderr)
        return 2
    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.ops import policy_kernel as pk
    from fabric_tpu_torch.policy.ast import NOutOf, SignedBy

    dev = torch.device("cuda", 0)
    cudalib.load("policy_eval")
    print(json.dumps({"ptxas": chip_smoke.ptxas_by_function(
        cudalib.ptxas_report("policy_eval"))}), flush=True)
    chip_smoke.policy_kernel_vs_plain(torch, np, dev)

    program = pk.encode_program(NOutOf(2, [SignedBy(0), SignedBy(1), SignedBy(2)]), 3, dev)
    sat_np = np.random.default_rng(SEED).random((1000, 2, 3)) < 0.4
    wide_np = np.zeros((1000, chip_smoke.WIDE_SIGNERS, 3), dtype=bool)
    wide_np[:, :2] = sat_np
    sat, wide = (torch.from_numpy(a).to(dev) for a in (sat_np, wide_np))
    want = pk.policy_eval_ref(sat, program).cpu()
    for got in (pk.launch_route("policy_eval", sat, program),
                pk.launch_route("policy_eval_global", sat, program), pk.policy_eval(wide, program)):
        if not torch.equal(got.cpu(), want):
            raise AssertionError("K7 differs from the plain version at config #2's shape")
    shared = lambda: pk.launch_route("policy_eval", sat, program)  # noqa: E731
    pr4 = lambda: pk.launch_route("policy_eval_global", sat, program)  # noqa: E731
    turns = [chip_smoke.device_ms(torch, fn, 50) for fn in (pr4, shared, shared, pr4)]
    wide_ms = chip_smoke.device_ms(torch, lambda: pk.policy_eval(wide, program), 50)
    floor = chip_smoke.floor_ms(torch, cudalib, dev)
    print(json.dumps({"k7": {"lanes": 1000, "signers": 2, "principals": 3,
                             "shared_ms": (turns[1] + turns[2]) / 2,
                             "global_route_ms": (turns[0] + turns[3]) / 2, "in_turns": turns,
                             "wide_global_ms": wide_ms,
                             "bound_ms": chip_smoke.policy_bound_ms(1000, 2, 3, 4)},
                      "floor_ms_by_reps": {str(r): floor[r] for r in chip_smoke.FLOOR_REPS}}),
          flush=True)
    print(chip_smoke.nvidia_smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
