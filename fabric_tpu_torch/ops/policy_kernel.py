"""K7, the greedy cauthdsl policy circuit (`csrc/policy_eval.cu`), its
program encoding, its plain version and its launch counters.

`encode_program` compiles a policy rule once into preorder nodes of four
int32 words: kind (SIGNED_BY or N_OUT_OF), argument (principal index, or n),
child count, and the index just past the node's subtree. `policy_eval`
walks the program over a (B, S, P) bool satisfaction tensor: on a CUDA
tensor it launches K7 on the current stream and does not synchronize; on a
CPU tensor it runs the plain version `policy_eval_ref`, which is the JAX
package's `compile_batched` walk (`policy/evaluator.py:72-95`) in torch ops,
reading the same program. Anything else raises; there is no fallback.

K7 has two routes, chosen by shape alone (`policy_route`): `policy_eval`,
the program and a block's tile of sat in shared memory, for at most 32
signers, 65,535 nodes and a block's shared memory within 232,448 bytes
(`shared_fits`), and the global route `policy_eval_global`, a thread a lane walking
the program from device memory, for any other shape.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict

import torch

from fabric_tpu_torch.ops import cudalib
from fabric_tpu_torch.policy.ast import SignedBy

SIGNED_BY, N_OUT_OF = 0, 1
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1

# Kernel launches by route, counted where a kernel launches (never for the
# plain version).
LAUNCHES: Dict[str, int] = {"policy_eval": 0, "policy_eval_global": 0}

# The shared route's limits (csrc/policy_eval.cu shared_fits): a block of
# SHARED_LANES threads, one signer word, node indices in 16 bits, and the
# program (16 bytes a node), the block's tile of sat, P masks and two words
# a frame a lane within the 232,448 bytes of shared memory a block may have.
SHARED_LANES = 128
SHARED_MAX_SIGNERS = 32
SHARED_MAX_NODES = 65535
SHARED_BYTES_MAX = 232448


@dataclass(frozen=True)
class Program:
    nodes: torch.Tensor  # (N, 4) int32
    depth: int  # NOutOf nodes on the longest root-to-leaf path
    num_principals: int


def encode_program(rule, num_principals: int, device) -> Program:
    """The rule's preorder program for `num_principals` principals. A
    principal index is taken as numpy and JAX take a static index: in
    [-P, P), a negative one counting from the end; any other raises."""
    nodes = []

    def visit(r, level: int) -> int:
        i = len(nodes)
        nodes.append(None)
        if isinstance(r, SignedBy):
            idx = r.index + num_principals if r.index < 0 else r.index
            if not 0 <= idx < num_principals:
                raise IndexError(
                    f"principal index {r.index} is out of bounds for {num_principals} principals")
            nodes[i] = [SIGNED_BY, idx, 0, i + 1]
            return level
        deepest = level + 1
        for child in r.rules:
            deepest = max(deepest, visit(child, level + 1))
        # successes lie in [0, len(rules)], so clamping n keeps every verdict
        n = min(max(r.n, _INT32_MIN), _INT32_MAX)
        nodes[i] = [N_OUT_OF, n, len(r.rules), len(nodes)]
        return deepest

    depth = visit(rule, 0)
    return Program(torch.tensor(nodes, dtype=torch.int32, device=device).reshape(-1, 4),
                   depth, num_principals)


def policy_eval_ref(sat: torch.Tensor, program: Program) -> torch.Tensor:
    """K7's plain version: the JAX walk, vectorized over lanes, on any device."""
    nodes = program.nodes.tolist()
    B, S, _ = sat.shape

    def walk(i: int, used: torch.Tensor):
        kind, arg, nchild, _end = nodes[i]
        if kind == SIGNED_BY:
            elig = sat[:, :, arg] & ~used
            ok = elig.any(dim=1)
            if S == 0:
                return ok, used
            first = elig.to(torch.int32).argmax(dim=1)  # the first eligible signer
            claim = torch.nn.functional.one_hot(first, S).bool() & ok[:, None]
            return ok, used | claim
        verified = torch.zeros(B, dtype=torch.int64, device=sat.device)
        c = i + 1
        for _ in range(nchild):
            ok, used_child = walk(c, used)
            verified += ok
            used = torch.where(ok[:, None], used_child, used)
            c = nodes[c][3]
        return verified >= arg, used

    ok, _ = walk(0, torch.zeros((B, S), dtype=torch.bool, device=sat.device))
    return ok


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cudalib.load("policy_eval")
    lib.policy_eval_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.policy_eval_launch.restype = _I
    lib.policy_eval_global_launch.argtypes = [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.policy_eval_global_launch.restype = _I
    lib.policy_eval_local_words.argtypes = []
    lib.policy_eval_local_words.restype = _I
    return lib


def state_words(S: int, P: int, depth: int) -> int:
    """int32 words of a lane's walk state: P signer masks and `depth` used
    rows of ceil(S / 32) words, and a 4-word frame a level."""
    return (P + depth) * ((S + 31) // 32) + 4 * depth


def shared_bytes(S: int, P: int, depth: int, nodes: int) -> int:
    """Shared memory of a block of the shared route: the program, the
    block's tile of sat as the 32-bit words that cover it from any byte
    offset, P masks and `depth` two-word frames a lane."""
    tile_words = SHARED_LANES * S * P // 4 + 2
    return 16 * nodes + 4 * tile_words + 4 * SHARED_LANES * (P + 2 * depth)


def shared_fits(S: int, P: int, depth: int, nodes: int) -> bool:
    return (S <= SHARED_MAX_SIGNERS and 1 <= nodes <= SHARED_MAX_NODES
            and shared_bytes(S, P, depth, nodes) <= SHARED_BYTES_MAX)


def policy_route(S: int, P: int, depth: int, nodes: int) -> str:
    """The K7 kernel a shape selects: "policy_eval" (shared memory) or
    "policy_eval_global" (the program read from device memory)."""
    return "policy_eval" if shared_fits(S, P, depth, nodes) else "policy_eval_global"


def _checks(sat: torch.Tensor, program: Program) -> int:
    device = sat.device
    if sat.dim() != 3:
        raise ValueError(f"sat must be (B, S, P), got shape {tuple(sat.shape)}")
    B, S, P = sat.shape
    cudalib.check_tensor("sat", sat, torch.bool, (B, S, P), device)
    cudalib.check_tensor("program", program.nodes, torch.int32,
                         (program.nodes.shape[0], 4), device)
    if P != program.num_principals:
        raise ValueError(f"sat has {P} principals, the program {program.num_principals}")
    words = state_words(S, P, program.depth)
    if max(B, S, P, words, B * S * P) > _INT32_MAX:
        raise ValueError("sat is too large for 32-bit sizes")
    return words


def policy_eval(sat: torch.Tensor, program: Program) -> torch.Tensor:
    """K7: (B, S, P) bool sat -> (B,) bool verdicts of `program`, on the
    route `policy_route` names for the shape."""
    words = _checks(sat, program)
    if not cudalib.kernel_device(sat.device, "policy"):
        return policy_eval_ref(sat, program)
    _B, S, P = sat.shape
    route = policy_route(S, P, program.depth, program.nodes.shape[0])
    return _launch(route, sat, program, words)


def launch_route(route: str, sat: torch.Tensor, program: Program) -> torch.Tensor:
    """K7's kernel `route` ("policy_eval" or "policy_eval_global") on CUDA
    tensors, whatever the shape would pick: the entry through which
    `chip_smoke.py` holds each route to the plain version at one shape. The
    shared route raises on a shape past `shared_fits`."""
    words = _checks(sat, program)
    if sat.device.type != "cuda":
        raise ValueError("launch_route runs a kernel: give it CUDA tensors")
    return _launch(route, sat, program, words)


def _launch(route: str, sat: torch.Tensor, program: Program, words: int) -> torch.Tensor:
    device = sat.device
    B, S, P = sat.shape
    out = torch.empty(B, dtype=torch.uint8, device=device)
    if B == 0:
        return out.view(torch.bool)  # a grid of zero blocks is a launch error
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if route == "policy_eval":
            rc = lib.policy_eval_launch(sat.data_ptr(), program.nodes.data_ptr(), B, S, P,
                                        program.depth, program.nodes.shape[0], out.data_ptr(),
                                        stream)
        elif route == "policy_eval_global":
            scratch = None
            if words > lib.policy_eval_local_words():
                scratch = torch.empty((B, words), dtype=torch.int32, device=device)
            rc = lib.policy_eval_global_launch(
                sat.data_ptr(), program.nodes.data_ptr(), B, S, P, program.depth, words,
                out.data_ptr(), None if scratch is None else scratch.data_ptr(), stream)
        else:
            raise ValueError(f"no K7 route {route!r}")
    if rc != 0:
        raise RuntimeError(f"{route} launch failed: cudaError {rc}")
    LAUNCHES[route] += 1
    return out.view(torch.bool)

