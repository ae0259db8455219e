"""Principal-set algebra over signature policies (reference
common/policies/inquire: SatisfiedBy/principalSets).

``satisfied_by(envelope)`` returns every minimal multiset of principals
that satisfies the policy — the input to endorsement-descriptor layout
computation (discovery/endorsement/endorsement.go:221-240). Combination
counts are capped like the reference's inquire (it bounds recursion via
combinationsUpperBound) so a pathological NOutOf cannot explode.

A copy of the JAX package's `discovery/inquire.py` over the port's policy
datamodel (`policy/ast.py`).
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Tuple

from fabric_tpu_torch.policy.ast import (
    MSPPrincipal,
    NOutOf,
    SignaturePolicyEnvelope,
    SignedBy,
)

COMBINATION_CAP = 10_000


class TooManyCombinationsError(Exception):
    pass


PrincipalSet = Tuple[MSPPrincipal, ...]  # a multiset, kept sorted


def _merge(a: PrincipalSet, b: PrincipalSet) -> PrincipalSet:
    return tuple(sorted(a + b, key=lambda p: (p.msp_id, p.role.value)))


def _sets_for(rule, identities) -> List[PrincipalSet]:
    if isinstance(rule, SignedBy):
        return [(identities[rule.index],)]
    assert isinstance(rule, NOutOf)
    child_sets = [_sets_for(r, identities) for r in rule.rules]
    out: List[PrincipalSet] = []
    for chosen in combinations(range(len(child_sets)), rule.n):
        partial: List[PrincipalSet] = [()]
        for idx in chosen:
            nxt = []
            for base in partial:
                for s in child_sets[idx]:
                    nxt.append(_merge(base, s))
                    if len(nxt) > COMBINATION_CAP:
                        raise TooManyCombinationsError(
                            "policy has too many satisfying combinations"
                        )
            partial = nxt
        out.extend(partial)
        if len(out) > COMBINATION_CAP:
            raise TooManyCombinationsError(
                "policy has too many satisfying combinations"
            )
    # dedupe while keeping deterministic order
    seen = set()
    uniq = []
    for s in out:
        if s not in seen:
            seen.add(s)
            uniq.append(s)
    return uniq


def satisfied_by(env: SignaturePolicyEnvelope) -> List[PrincipalSet]:
    return _sets_for(env.rule, env.identities)
