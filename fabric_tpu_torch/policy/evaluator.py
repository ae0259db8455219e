"""Signature-policy evaluation: the host oracle, the validator's NumPy
epilogue and K7, the batched circuit on the card.

The port's counterpart of the JAX package's `policy/evaluator.py`. The
reference compiles a SignaturePolicy into closures with greedy,
order-dependent semantics (common/cauthdsl/cauthdsl.go:24-92):

- SignedBy(i): the first not-yet-used signer that satisfies identities[i]
  is marked used and the leaf succeeds.
- NOutOf(n, rules): every child in order (no short-circuit), each against a
  scratch copy of `used`; a succeeding child commits its copy. Succeed iff
  >= n children succeeded.

`evaluate_host` is the oracle for one transaction; `compile_batched_numpy`
is the validator's default, as in the JAX package; `compile_batched` runs
K7 (`ops/policy_kernel.py`, `csrc/policy_eval.cu`) on the card, or its
plain version with `device="cpu"`, and `compile_batched_ref` is that plain
version on any device. torch and K7's wrapper are imported by the
functions that use them, so the policy manager and the channel
configuration above it (which need only `evaluate_host`) load no torch.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from fabric_tpu_torch.policy.ast import NOutOf, SignaturePolicyEnvelope, SignedBy


def evaluate_host(env: SignaturePolicyEnvelope, sat: np.ndarray) -> bool:
    """Oracle evaluation for ONE transaction.

    sat: (num_signers, num_principals) bool: sat[s, p] true iff signer s
    satisfies identities[p] (and its signature verified; the reference
    drops non-verifying signers before evaluation, policy.go:365-402).
    """
    num_signers = sat.shape[0]
    used = [False] * num_signers

    def walk(rule, used: List[bool]) -> bool:
        if isinstance(rule, SignedBy):
            for s in range(num_signers):
                if used[s]:
                    continue
                if sat[s, rule.index]:
                    used[s] = True
                    return True
            return False
        assert isinstance(rule, NOutOf)
        verified = 0
        for child in rule.rules:
            scratch = list(used)
            if walk(child, scratch):
                verified += 1
                used[:] = scratch
        return verified >= rule.n

    return walk(env.rule, used)


def _batched(env: SignaturePolicyEnvelope, num_signers: int, device, launch) -> Callable:
    import torch

    from fabric_tpu_torch.ops import policy_kernel as pk

    programs: Dict[int, pk.Program] = {}

    def run(sat) -> torch.Tensor:
        sat = torch.as_tensor(sat, dtype=torch.bool, device=device).contiguous()
        if sat.dim() != 3 or sat.shape[1] != num_signers:
            raise ValueError(f"sat must be (B, {num_signers}, P), got {tuple(sat.shape)}")
        P = sat.shape[2]
        program = programs.get(P)
        if program is None:
            program = programs[P] = pk.encode_program(env.rule, P, sat.device)
        return launch(sat, program)

    return run


def compile_batched(
    env: SignaturePolicyEnvelope, num_signers: int, device=None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The policy as a function over batched satisfaction tensors: sat
    (B, num_signers, P) bool -> (B,) bool. It launches K7 on the card, which
    it needs unless `device="cpu"`, where it runs K7's plain version. The
    program is encoded once per P and kept with the function."""
    from fabric_tpu_torch.ops import cudalib
    from fabric_tpu_torch.ops import policy_kernel as pk

    dev = cudalib.resolve_device(device, "policy")
    return _batched(env, num_signers, dev, pk.policy_eval)


def compile_batched_ref(
    env: SignaturePolicyEnvelope, num_signers: int, device="cpu"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """`compile_batched` through K7's plain version, on any device."""
    import torch

    from fabric_tpu_torch.ops import policy_kernel as pk

    return _batched(env, num_signers, torch.device(device), pk.policy_eval_ref)


def compile_batched_numpy(
    env: SignaturePolicyEnvelope,
) -> Callable[[np.ndarray], np.ndarray]:
    """The batched greedy walk in vectorized NumPy: sat (B, S, P) bool ->
    (B,) bool, bit-identical to `compile_batched` / `evaluate_host`. The
    validator's default epilogue, as in the JAX package: a few dozen mask
    updates over small bool tensors."""

    def walk(rule, sat, used):
        if isinstance(rule, SignedBy):
            elig = sat[:, :, rule.index] & ~used  # (B, S)
            ok = elig.any(axis=1)
            first = elig.argmax(axis=1)  # first True (argmax on bool)
            claim = np.zeros_like(used)
            claim[np.arange(used.shape[0]), first] = ok
            return ok, used | claim
        assert isinstance(rule, NOutOf)
        verified = np.zeros(used.shape[0], dtype=np.int32)
        for child in rule.rules:
            ok, used_child = walk(child, sat, used)
            verified = verified + ok.astype(np.int32)
            used = np.where(ok[:, None], used_child, used)
        return verified >= rule.n, used

    def run(sat: np.ndarray) -> np.ndarray:
        sat = np.asarray(sat, dtype=bool)
        used0 = np.zeros(sat.shape[:2], dtype=bool)
        ok, _ = walk(env.rule, sat, used0)
        return ok

    return run
