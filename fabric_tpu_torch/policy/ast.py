"""Signature-policy datamodel + the policy string DSL (a copy of the JAX
package's `policy/ast.py`).

Mirrors the proto shapes the reference evaluates (fabric-protos
common/policies.proto: SignaturePolicyEnvelope{version, rule, identities},
SignaturePolicy = SignedBy(int32) | NOutOf{n, rules}) and the human DSL of
common/policydsl ("AND('Org1.member','Org2.member')", "OutOf(2, ...)").
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from typing import List, Tuple, Union


class Role(enum.Enum):
    MEMBER = "member"
    ADMIN = "admin"
    CLIENT = "client"
    PEER = "peer"
    ORDERER = "orderer"


@dataclass(frozen=True)
class MSPRole:
    """PRINCIPAL_ROLE principal: (msp_id, role)."""

    msp_id: str
    role: Role


# Future classifications (OU, identity-equality) slot in here.
MSPPrincipal = MSPRole


@dataclass(frozen=True)
class SignedBy:
    """Leaf: satisfied by one not-yet-used signer matching identities[index]."""

    index: int


@dataclass(frozen=True)
class NOutOf:
    n: int
    rules: Tuple["SignaturePolicy", ...]

    def __init__(self, n: int, rules):
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "rules", tuple(rules))


SignaturePolicy = Union[SignedBy, NOutOf]


@dataclass(frozen=True)
class SignaturePolicyEnvelope:
    rule: SignaturePolicy
    identities: Tuple[MSPPrincipal, ...]
    version: int = 0

    def __init__(self, rule, identities, version=0):
        object.__setattr__(self, "rule", rule)
        object.__setattr__(self, "identities", tuple(identities))
        object.__setattr__(self, "version", version)

    def __hash__(self):
        # envelopes key every validator cache (policy fn, principals,
        # pattern memo, policy groups) and the recursive dataclass hash
        # walks the whole rule tree — at 1k-tx blocks that recomputation
        # showed up as ~10% of the host path. Frozen => cache it.
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.rule, self.identities, self.version))
            object.__setattr__(self, "_hash", h)
        return h


# ---------------------------------------------------------------------------
# DSL: AND / OR / OutOf over 'Msp.role' terms (reference common/policydsl)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"\s*(?:(?P<name>AND|OR|OutOf)|(?P<lparen>\()|(?P<rparen>\))|(?P<comma>,)"
    r"|(?P<num>\d+)|'(?P<term>[^']+)')"
)


class DslError(ValueError):
    pass


def _parse_term(term: str) -> MSPRole:
    if "." not in term:
        raise DslError(f"bad principal term {term!r}")
    msp_id, role_name = term.rsplit(".", 1)
    try:
        role = Role(role_name.lower())
    except ValueError as e:
        raise DslError(f"unknown role in {term!r}") from e
    return MSPRole(msp_id, role)


def from_dsl(text: str) -> SignaturePolicyEnvelope:
    """Parse e.g. "AND('Org1.member', OR('Org2.admin','Org3.member'))".

    Each distinct principal term gets one identities[] slot, deduplicated
    like the reference DSL compiler does.
    """
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise DslError(f"syntax error at {text[pos:pos + 20]!r}")
        pos = m.end()
        for kind in ("name", "lparen", "rparen", "comma", "num", "term"):
            if m.group(kind) is not None:
                tokens.append((kind, m.group(kind)))
                break

    identities: List[MSPRole] = []
    index_of = {}

    def principal_index(term: str) -> int:
        pr = _parse_term(term)
        if pr not in index_of:
            index_of[pr] = len(identities)
            identities.append(pr)
        return index_of[pr]

    def parse(i: int) -> Tuple[SignaturePolicy, int]:
        kind, val = tokens[i]
        if kind == "term":
            return SignedBy(principal_index(val)), i + 1
        if kind != "name":
            raise DslError(f"expected operator or term, got {val!r}")
        op = val
        i += 1
        if tokens[i][0] != "lparen":
            raise DslError(f"expected ( after {op}")
        i += 1
        n_required = None
        if op == "OutOf":
            if tokens[i][0] != "num":
                raise DslError("OutOf requires a leading count")
            n_required = int(tokens[i][1])
            i += 1
            if tokens[i][0] == "comma":
                i += 1
        rules = []
        while True:
            rule, i = parse(i)
            rules.append(rule)
            kind = tokens[i][0]
            i += 1
            if kind == "rparen":
                break
            if kind != "comma":
                raise DslError("expected , or )")
        if op == "AND":
            n_required = len(rules)
        elif op == "OR":
            n_required = 1
        assert n_required is not None
        return NOutOf(n_required, rules), i

    if not tokens:
        raise DslError("empty policy expression")
    try:
        rule, i = parse(0)
    except IndexError as e:
        raise DslError("truncated policy expression") from e
    if i != len(tokens):
        raise DslError("trailing tokens")
    return SignaturePolicyEnvelope(rule, identities)
