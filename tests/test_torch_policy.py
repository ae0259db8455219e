"""The port's policy modules and K7's plain version against the JAX package's
`fabric_tpu.policy`: the DSL, the envelope bytes, `evaluate_host`,
`compile_batched_numpy` and `compile_batched(device="cpu")` against JAX's
`compile_batched` and `evaluate_host`, on test_policy.py's exhaustive and
random sets and on K7's edge lanes; and the program K7 walks. Every
comparison is exact."""

import itertools
import random

import numpy as np
import pytest
import torch

from fabric_tpu.policy import ast as jast
from fabric_tpu.policy import evaluator as jev
from fabric_tpu.policy import proto_convert as jpc
from fabric_tpu_torch.ops import policy_kernel as pk
from fabric_tpu_torch.policy import ast as tast
from fabric_tpu_torch.policy import evaluator as tev
from fabric_tpu_torch.policy import proto_convert as tpc

EXHAUSTIVE = [
    "AND('A.member','B.member')",
    "OR('A.member','B.member')",
    "AND('A.member','A.member')",
    "OutOf(1, AND('A.member','B.member'), 'B.member')",
    "OutOf(2, 'A.member', 'B.member', 'A.member')",
]
DSL = EXHAUSTIVE + [
    "OutOf(2,'Org1MSP.member','Org2MSP.member','Org3MSP.member')",
    "AND('Org1MSP.admin', OR('Org2MSP.peer','Org3MSP.client'), 'Org1MSP.orderer')",
    "OutOf(0, 'A.member')",
    "OR(AND('A.member','B.member'), AND('B.member','C.member'), AND('A.member','C.member'))",
]


def convert(rule, mod):
    """The same rule in the other package's AST classes."""
    if isinstance(rule, (jast.SignedBy, tast.SignedBy)):
        return mod.SignedBy(rule.index)
    return mod.NOutOf(rule.n, [convert(r, mod) for r in rule.rules])


def both(rule, num_p):
    return (jast.SignaturePolicyEnvelope(convert(rule, jast), [object()] * num_p),
            tast.SignaturePolicyEnvelope(convert(rule, tast), [object()] * num_p))


def verdicts(jenv, tenv, sat: np.ndarray):
    """Every evaluator of both packages on one (B, S, P) batch."""
    S = sat.shape[1]
    want = np.asarray(jev.compile_batched(jenv, num_signers=S)(sat))
    got = {
        "jax evaluate_host": np.array([jev.evaluate_host(jenv, m) for m in sat], dtype=bool),
        "evaluate_host": np.array([tev.evaluate_host(tenv, m) for m in sat], dtype=bool),
        "compile_batched_numpy": tev.compile_batched_numpy(tenv)(sat),
        "compile_batched(cpu)": tev.compile_batched(tenv, S, device="cpu")(sat).numpy(),
        "compile_batched_ref": tev.compile_batched_ref(tenv, S)(torch.from_numpy(sat)).numpy(),
    }
    return want, got


def assert_all_equal(jenv, tenv, sat):
    want, got = verdicts(jenv, tenv, sat)
    for name, g in got.items():
        assert g.dtype == bool and g.shape == want.shape, name
        assert np.array_equal(g, want), name


@pytest.mark.parametrize("text", DSL)
def test_dsl_and_envelope_bytes_match(text):
    jenv, tenv = jast.from_dsl(text), tast.from_dsl(text)
    assert convert(jenv.rule, tast) == tenv.rule
    assert [(p.msp_id, p.role.value) for p in jenv.identities] == [
        (p.msp_id, p.role.value) for p in tenv.identities]
    raw = jpc.marshal_envelope(jenv)
    assert tpc.marshal_envelope(tenv) == raw
    assert tpc.marshal_application_policy(tenv) == jpc.marshal_application_policy(jenv)
    assert tpc.unmarshal_envelope(raw) == tenv
    assert tpc.unmarshal_application_policy(jpc.marshal_application_policy(jenv)) == tenv
    assert tpc.principal_for(tenv.identities[0])["principal"] == (
        jpc.principal_for(jenv.identities[0]).principal)


def test_unmarshal_refusals_match():
    with pytest.raises(tpc.PolicyConversionError):
        tpc.unmarshal_envelope(b"")  # no rule
    with pytest.raises(jpc.PolicyConversionError):
        jpc.unmarshal_envelope(b"")
    ref = b"\x12\x03abc"  # ApplicationPolicy{channel_config_policy_reference}
    with pytest.raises(tpc.PolicyConversionError):
        tpc.unmarshal_application_policy(ref)
    with pytest.raises(jpc.PolicyConversionError):
        jpc.unmarshal_application_policy(ref)


@pytest.mark.parametrize("text", EXHAUSTIVE)
def test_exhaustive_small(text):
    """Every sat matrix for 2 signers x P principals (test_policy.py:105-123)."""
    jenv, tenv = jast.from_dsl(text), tast.from_dsl(text)
    P = len(tenv.identities)
    sat = np.stack([np.array(bits, dtype=bool).reshape(2, P)
                    for bits in itertools.product([0, 1], repeat=2 * P)])
    assert_all_equal(jenv, tenv, sat)


def random_policy(rng, num_principals, depth=0):
    if depth >= 2 or rng.random() < 0.4:
        return tast.SignedBy(rng.randrange(num_principals))
    k = rng.randint(1, 3)
    rules = [random_policy(rng, num_principals, depth + 1) for _ in range(k)]
    return tast.NOutOf(rng.randint(1, k), rules)


def test_randomized():
    """test_policy.py:125-136's 25 random policies, same seeds."""
    rng = random.Random(1234)
    for trial in range(25):
        num_p = rng.randint(1, 4)
        num_s = rng.randint(1, 4)
        jenv, tenv = both(random_policy(rng, num_p), num_p)
        sat = np.random.default_rng(trial).random((16, num_s, num_p)) < 0.45
        assert_all_equal(jenv, tenv, sat)


def deep_chain(depth):
    """NOutOf nesting `depth` deep whose inner branches claim signers and
    fail: OutOf(1, AND(B, A, C), <deeper>)."""
    rule = tast.SignedBy(0)
    for _ in range(depth):
        rule = tast.NOutOf(1, [tast.NOutOf(3, [tast.SignedBy(1), tast.SignedBy(0),
                                                tast.SignedBy(2)]), rule])
    return rule


EDGE_RULES = {
    "n=0": tast.NOutOf(0, [tast.SignedBy(0), tast.SignedBy(1)]),
    "n>children": tast.NOutOf(3, [tast.SignedBy(0), tast.SignedBy(1)]),
    "no children": tast.NOutOf(0, []),
    "no children n=1": tast.NOutOf(1, []),
    "failing branch claims": tast.NOutOf(1, [
        tast.NOutOf(3, [tast.SignedBy(0), tast.SignedBy(1), tast.SignedBy(2)]),
        tast.NOutOf(2, [tast.SignedBy(0), tast.SignedBy(0)]),
    ]),
    "leaf root": tast.SignedBy(2),
    "negative index": tast.NOutOf(2, [tast.SignedBy(-1), tast.SignedBy(0)]),
    "depth 22": deep_chain(22),
}


@pytest.mark.parametrize("S", [31, 32, 33, 64, 65, 100])
@pytest.mark.parametrize("name", sorted(EDGE_RULES))
def test_edge_lanes(name, S):
    """K7's edge lanes: signer counts around the 32-bit words, n = 0, n
    above the child count, NOutOf with no children, a failing branch whose
    children claimed signers, depth >= 20; B = 1 and B = 9."""
    jenv, tenv = both(EDGE_RULES[name], 3)
    rng = np.random.default_rng(S)
    for B, density in ((1, 0.05), (9, 0.02), (9, 0.5)):
        assert_all_equal(jenv, tenv, rng.random((B, S, 3)) < density)


def test_program_encoding():
    """Preorder nodes (kind, argument, child count, subtree end) and the
    NOutOf depth."""
    prog = pk.encode_program(tast.from_dsl(
        "OutOf(1, AND('A.member','B.member'), 'B.member')").rule, 2, "cpu")
    assert prog.nodes.tolist() == [
        [pk.N_OUT_OF, 1, 2, 5], [pk.N_OUT_OF, 2, 2, 4],
        [pk.SIGNED_BY, 0, 0, 3], [pk.SIGNED_BY, 1, 0, 4], [pk.SIGNED_BY, 1, 0, 5],
    ]
    assert prog.depth == 2 and prog.num_principals == 2
    assert pk.encode_program(tast.SignedBy(-1), 3, "cpu").nodes.tolist() == [[0, 2, 0, 1]]
    assert pk.encode_program(tast.SignedBy(0), 3, "cpu").depth == 0
    assert pk.encode_program(deep_chain(22), 3, "cpu").depth == 23
    big = pk.encode_program(tast.NOutOf(2**40, []), 1, "cpu")
    assert big.nodes.tolist() == [[pk.N_OUT_OF, 2**31 - 1, 0, 1]]
    assert pk.state_words(33, 3, 2) == (3 + 2) * 2 + 4 * 2


def test_out_of_range_principal_raises_like_jax():
    sat = np.ones((2, 2, 2), dtype=bool)
    jenv, tenv = both(tast.NOutOf(1, [tast.SignedBy(2)]), 2)
    with pytest.raises(IndexError):
        jev.compile_batched(jenv, num_signers=2)(sat)
    with pytest.raises(IndexError):
        tev.compile_batched(tenv, 2, device="cpu")(sat)
    with pytest.raises(IndexError):
        pk.encode_program(tast.SignedBy(-3), 2, "cpu")


def test_wrapper_checks_and_empty_batch():
    tenv = tast.from_dsl("AND('A.member','B.member')")
    run = tev.compile_batched(tenv, 2, device="cpu")
    assert run(np.zeros((0, 2, 2), dtype=bool)).shape == (0,)
    with pytest.raises(ValueError):
        run(np.zeros((3, 4, 2), dtype=bool))  # num_signers differs
    prog = pk.encode_program(tenv.rule, 2, "cpu")
    with pytest.raises(ValueError):
        pk.policy_eval(torch.zeros((1, 2, 3), dtype=torch.bool), prog)  # P differs
    with pytest.raises(TypeError):
        pk.policy_eval(torch.zeros((1, 2, 2), dtype=torch.uint8), prog)
    assert pk.LAUNCHES["policy_eval"] == 0  # plain versions never count

