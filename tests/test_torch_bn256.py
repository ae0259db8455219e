"""The port's FP256BN host oracle and G1 MSM (K3's plain version) against the
JAX package.

(a) `fabric_tpu_torch.common.fp256bn`, the port's copy of the oracle,
against `fabric_tpu.common.fp256bn`: constants, G1/G2 arithmetic, the
Miller loop, the final exponentiation and the encodings on seeded values.
(b) `msm_batch` on CPU tensors (the plain version `msm_batch_ref`) against
the JAX package's `msm_host_batch` on the cases of
`tests/test_bn256_kernel.py::TestMSM`, seeded, at its one (K=4, B=4) shape:
the packed inputs, the projective Montgomery limbs the JAX program returns
and the affine points, all equal. The JAX program runs in a child process
(its XLA:CPU compile peaks near 7 GB, which the child hands back), through
`msm_host_batch` with the jitted program wrapped to keep its raw output.
(c) The plain a = 0 point formulas against the oracle. (d) The kernel's
schedule of a lane (a thread a base, a shuffle tree) and the least-work
schedule (one accumulator, shared doublings), run on host points: each
sum against the JAX package's host oracle, and the multiplies each runs,
at the plain formulas' counts, against `muls_per_lane` and `muls_least`,
from which `bound_ms_kernel` and `bound_ms` are computed. All comparisons
are exact.
"""

import json
import random

import numpy as np
import pytest
import torch

from fabric_tpu.common import fp256bn as jhost
from fabric_tpu_torch.common import fp256bn as host
from fabric_tpu_torch.ops import bn256_kernel as bk
from torch_jax_child import child_json, shared
from torch_untraced import untraced  # noqa: F401

K, B = 4, 4
MSM_CASES = ["single-base", "multi-base", "edge-scalars-and-identity"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand_scalar(rng):
    return rng.randrange(1, host.R)


def _rand_point(rng):
    return host.g1_mul(host.G1_GEN, _rand_scalar(rng))


def msm_cases():
    """TestMSM's three cases, seeded, each padded to (K, B) with identity
    bases and zero scalars as TestMSM pads them: {case: (bases, scalars)}."""
    rng = random.Random(20261017)
    cases = {
        "single-base": [([_rand_point(rng)], [_rand_scalar(rng)]) for _ in range(B)],
        "multi-base": [
            ([_rand_point(rng) for _ in range(K)], [_rand_scalar(rng) for _ in range(K)])
            for _ in range(B)
        ],
        "edge-scalars-and-identity": [
            ([host.G1_GEN, None], [0, 5]),
            ([host.G1_GEN, host.G1_GEN], [1, host.R - 1]),  # R·G = O
            ([None, None], [3, 7]),
            ([_rand_point(rng), host.G1_GEN], [host.R - 1, 2]),
        ],
    }
    out = {}
    for name, lanes in cases.items():
        bases = [list(bs) + [None] * (K - len(bs)) for bs, _ in lanes]
        scalars = [list(es) + [0] * (K - len(es)) for _, es in lanes]
        out[name] = (bases, scalars)
    return out


def _oracle(bases, scalars):
    want = []
    for bs, es in zip(bases, scalars):
        acc = None
        for b, e in zip(bs, es):
            acc = jhost.g1_add(acc, jhost.g1_mul(b, e % jhost.R))
        want.append(acc)
    return want


def _jax_child():
    """Run in a child process (see `jax_side`): print, as one JSON line, for
    each case the JAX program's packed inputs, raw output and affine
    points, all through `msm_host_batch`."""
    import jax

    from fabric_tpu.ops import bn256_kernel as jbk
    from fabric_tpu.utils.jaxcache import enable_compile_cache

    jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    calls = []
    program = jbk.msm_batch_jit

    def recorded(bases, scalars):
        out = program(bases, scalars)
        calls.append((np.asarray(bases), np.asarray(out)))
        return out

    jbk.msm_batch_jit = recorded
    result = {}
    for name, (bases, scalars) in msm_cases().items():
        affine = jbk.msm_host_batch(bases, scalars)
        packed, raw = calls[-1]
        result[name] = {
            "packed": packed.tolist(),
            "raw": raw.tolist(),
            "affine": [None if p is None else [str(p[0]), str(p[1])] for p in affine],
        }
    result["calls"] = len(calls)
    print(json.dumps(result))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX MSM program in a child process, once per test session
    (`torch_jax_child`)."""
    out = shared(tmp_path_factory, __file__, lambda: child_json(
        "test_torch_bn256", "_jax_child",
        {"JAX_PLATFORMS": "cpu", "FABRIC_TPU_CIOS_UNROLL": "0"}))
    assert out.pop("calls") == len(MSM_CASES)
    return out


@pytest.fixture(scope="module")
def cases():
    return msm_cases()


# ---------------------------------------------------------------------------
# (a) the oracle copy
# ---------------------------------------------------------------------------


def test_constants_match_jax():
    for name in ("P", "R", "U", "B_COEFF", "G1_X", "G1_Y", "G2_XA", "G2_XB", "G2_YA", "G2_YB",
                 "XI", "TWIST_B", "G1_GEN", "G2_GEN", "FP12_ONE", "_HARD_EXP", "_FROB_GAMMA"):
        assert getattr(host, name) == getattr(jhost, name), name
    assert host._HARD_EXP.bit_length() == 768 and bin(host._HARD_EXP).count("1") == 408


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_group_ops_match_jax(seed):
    rng = random.Random(seed)
    a, b = _rand_scalar(rng), _rand_scalar(rng)
    p = host.g1_mul(host.G1_GEN, a)
    assert p == jhost.g1_mul(jhost.G1_GEN, a)
    q = host.g1_mul(host.G1_GEN, b)
    assert host.g1_add(p, q) == jhost.g1_add(p, q)
    assert host.g1_add(p, p) == jhost.g1_add(p, p)
    assert host.g1_add(p, host.g1_neg(p)) is None
    assert host.g1_mul2(p, b, q, a) == jhost.g1_mul2(p, b, q, a)
    w = host.g2_mul(host.G2_GEN, a)
    assert w == jhost.g2_mul(jhost.G2_GEN, a)
    assert host.g2_add(w, host.G2_GEN) == jhost.g2_add(w, jhost.G2_GEN)
    assert host.g2_is_on_curve(w) and host.g1_is_on_curve(p)


@pytest.mark.parametrize("seed", [4, 5])
def test_miller_loop_and_final_exp_match_jax(seed):
    rng = random.Random(seed)
    q = host.g2_mul(host.G2_GEN, _rand_scalar(rng))
    p = host.g1_mul(host.G1_GEN, _rand_scalar(rng))
    f = host.miller_loop(q, p)
    assert f == jhost.miller_loop(q, p)
    fe = host.final_exp(f)
    assert fe == jhost.final_exp(f)
    assert host.fp12_inv(f) == jhost.fp12_inv(f)
    for n in (1, 2):
        assert host.fp12_frobenius(f, n) == jhost.fp12_frobenius(f, n)


def test_encodings_match_jax():
    rng = random.Random(6)
    p = _rand_point(rng)
    w = host.g2_mul(host.G2_GEN, _rand_scalar(rng))
    assert host.g1_to_bytes(p) == jhost.g1_to_bytes(p)
    assert host.g1_from_bytes(host.g1_to_bytes(p)) == p
    assert host.g1_to_bytes(None) == jhost.g1_to_bytes(None)
    assert host.g2_to_bytes(w) == jhost.g2_to_bytes(w)
    assert host.g2_from_bytes(host.g2_to_bytes(w)) == w
    data = bytes(range(77))
    assert host.hash_mod_order(data) == jhost.hash_mod_order(data)
    assert host.rand_mod_order(random.Random(7)) == jhost.rand_mod_order(random.Random(7))


# ---------------------------------------------------------------------------
# (b) K3's plain version against the JAX program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_msm(cases):
    """The port's wrapper on CPU tensors (the plain version, no launch),
    one call for the three cases side by side."""
    before = dict(bk.LAUNCHES)
    bases = [lane for name in MSM_CASES for lane in cases[name][0]]
    scalars = [lane for name in MSM_CASES for lane in cases[name][1]]
    packed, packed_scalars = bk.pack_batch(bases, scalars)
    raw = bk.msm_batch(torch.from_numpy(packed), torch.from_numpy(packed_scalars))
    assert bk.LAUNCHES == before
    out = {}
    for i, name in enumerate(MSM_CASES):
        lanes = slice(i * B, (i + 1) * B)
        out[name] = {"packed": packed[..., lanes], "raw": raw[..., lanes].numpy()}
    return out


@pytest.mark.parametrize("case", MSM_CASES)
def test_msm_inputs_pack_as_jax(cases, port_msm, jax_side, case):
    assert np.array_equal(port_msm[case]["packed"], np.array(jax_side[case]["packed"]))


@pytest.mark.parametrize("case", MSM_CASES)
def test_msm_projective_limbs_match_jax(port_msm, jax_side, case):
    assert np.array_equal(port_msm[case]["raw"], np.array(jax_side[case]["raw"]))


@pytest.mark.parametrize("case", MSM_CASES)
def test_msm_affine_matches_jax_and_oracle(cases, port_msm, jax_side, case):
    got = bk.unpack_points(port_msm[case]["raw"])
    jax_affine = [None if p is None else (int(p[0]), int(p[1])) for p in jax_side[case]["affine"]]
    assert got == jax_affine == _oracle(*cases[case])


def test_msm_host_batch_on_cpu():
    bases, scalars = [[host.G1_GEN], [None], [host.G1_GEN]], [[5], [7], [host.R + 3]]
    assert bk.msm_host_batch(bases, scalars, device="cpu") == _oracle(bases, scalars)


@pytest.mark.parametrize("k_count", [17, 20, 33])
def test_msm_host_batch_past_sixteen_bases(k_count):
    """A lane of more than 16 bases (an Idemix key of 13 or more
    attributes): one launch, a lane of 32 threads, each taking bases k,
    k + 32, ... past 32; the sum equals the JAX package's oracle."""
    rng = random.Random(k_count)
    bases = [[_rand_point(rng) for _ in range(k_count)] for _ in range(2)]
    scalars = [[_rand_scalar(rng) for _ in range(k_count)] for _ in range(2)]
    bases[1][3], scalars[1][k_count - 1] = None, 0
    assert bk.threads_per_lane(k_count) == bk.MAX_THREADS
    assert bk.msm_host_batch(bases, scalars, device="cpu") == _oracle(bases, scalars)


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda a: a.to(torch.int32), TypeError),
        (lambda a: a[..., :-1], ValueError),
        (lambda a: a.transpose(0, 1).contiguous().transpose(0, 1), ValueError),
        (lambda a: a.to("meta"), ValueError),
    ],
    ids=["dtype", "shape", "contiguity", "device"],
)
def test_msm_wrapper_rejects_bad_inputs(change, error):
    bases, scalars = bk.pack_batch([[host.G1_GEN, None]] * 2, [[1, 2]] * 2)
    with pytest.raises(error):
        bk.msm_batch(torch.from_numpy(bases), change(torch.from_numpy(scalars)))


@pytest.mark.parametrize("k_count", [0])
def test_msm_wrapper_rejects_base_counts_the_kernel_cannot_hold(k_count):
    bases = torch.zeros((k_count, 3, 20, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        bk.msm_batch(bases, torch.zeros((k_count, 20, 2), dtype=torch.int64))


# ---------------------------------------------------------------------------
# (c) the a = 0 point formulas against the oracle
# ---------------------------------------------------------------------------


def _packed(points):
    return bk._point(torch.from_numpy(bk.pack_points(points).astype(np.int64)))


def test_point_add_matches_oracle():
    rng = random.Random(8)
    r = _rand_point(rng)
    ps = [_rand_point(rng) for _ in range(3)] + [None, host.G1_GEN, None, r, r]
    qs = [_rand_point(rng) for _ in range(3)] + [host.G1_GEN, host.G1_GEN, None, r,
                                                   host.g1_neg(r)]
    got = bk.unpack_points(bk._stack(bk.point_add(_packed(ps), _packed(qs))))
    assert got == [host.g1_add(p, q) for p, q in zip(ps, qs)]


def test_point_double_matches_oracle():
    rng = random.Random(9)
    ps = [_rand_point(rng), host.G1_GEN, None]
    got = bk.unpack_points(bk._stack(bk.point_double(_packed(ps))))
    assert got == [host.g1_add(p, p) for p in ps]


# ---------------------------------------------------------------------------
# (d) the kernel's schedule and its count
# ---------------------------------------------------------------------------

def _formula_muls(formula, *points) -> int:
    """The Montgomery multiplies of a plain point formula (its stacked
    multiplies counted one by one)."""
    count = [0]
    real = bk._muls

    def counting(*pairs):
        count[0] += len(pairs)
        return real(*pairs)

    bk._muls = counting
    try:
        formula(*(_packed([pt]) for pt in points))
    finally:
        bk._muls = real
    return count[0]


def test_formula_counts():
    rng = random.Random(7)
    p, q = _rand_point(rng), _rand_point(rng)
    assert _formula_muls(bk.point_double, p) == bk.MULS_PER_DOUBLE
    assert _formula_muls(bk.point_add, p, q) == bk.MULS_PER_ADD


class _Tally:
    """Host-point arithmetic (the JAX package's oracle) that counts the
    Montgomery multiplies the kernel's formulas take for each operation."""

    def __init__(self):
        self.muls = 0

    def radix(self, n):
        self.muls += n

    def dbl(self, p):
        self.muls += bk.MULS_PER_DOUBLE
        return jhost.g1_add(p, p)

    def add(self, p, q):
        self.muls += bk.MULS_PER_ADD
        return jhost.g1_add(p, q)


def _digit(e, w):
    return (e >> (254 - 2 * w)) & 3


def _kernel_lane(bases, scalars):
    """bn256_msm's work for one lane: thread k takes bases k, k + G, ...;
    it skips an identity base or a zero scalar, else builds {O, B, 2B, 3B}
    and runs 128 windows of two doublings and an addition; a base after the
    thread's first is added to its sum; the G partial sums meet in a
    shuffle tree. Returns the sum and the multiplies run."""
    g = bk.threads_per_lane(len(bases))
    t = _Tally()
    partial = [None] * g
    for kb, (b, e) in enumerate(zip(bases, scalars)):
        e %= host.R
        acc = None
        if b is not None and e != 0:
            t.radix(3)
            table = [None, b, t.dbl(b)]
            table.append(t.add(table[2], b))
            for w in range(bk.NUM_WINDOWS):
                acc = t.add(t.dbl(t.dbl(acc)), table[_digit(e, w)])
        partial[kb % g] = acc if kb < g else t.add(partial[kb % g], acc)
    d = g // 2
    while d:
        for k in range(d):
            partial[k] = t.add(partial[k], partial[k + d])
        d //= 2
    t.radix(3)  # the result
    return partial[0], t.muls


def _least_lane(bases, scalars):
    """The least-work schedule at the real bases: their tables, then one
    accumulator, 128 windows of two doublings and an addition a base."""
    t = _Tally()
    real = [(b, e % host.R) for b, e in zip(bases, scalars) if b is not None and e % host.R]
    tables = []
    for b, _ in real:
        t.radix(3)
        table = [None, b, t.dbl(b)]
        table.append(t.add(table[2], b))
        tables.append(table)
    acc = None
    for w in range(bk.NUM_WINDOWS):
        acc = t.dbl(t.dbl(acc))
        for table, (_, e) in zip(tables, real):
            acc = t.add(acc, table[_digit(e, w)])
    t.radix(3)
    return acc, t.muls


LANE_CASES = [(8, 8), (3, 8), (0, 8), (3, 3), (5, 5), (1, 1), (17, 17), (30, 33)]


def _lane_case(k_real, k_count):
    rng = random.Random(100 * k_real + k_count)
    bases = [_rand_point(rng) for _ in range(k_real)] + [None] * (k_count - k_real)
    scalars = [_rand_scalar(rng) for _ in range(k_count)]
    if k_real > 1:
        bases[1], scalars[0] = bases[0], host.R  # an equal base and a zero scalar mod r
    live = sum(b is not None and e % host.R != 0 for b, e in zip(bases, scalars))
    return bases, scalars, live


@pytest.mark.parametrize("k_real,k_count", LANE_CASES)
def test_kernel_schedule_sums_right_and_counts_muls_per_lane(k_real, k_count):
    bases, scalars, live = _lane_case(k_real, k_count)
    got, muls = _kernel_lane(bases, scalars)
    assert got == _oracle([bases], [scalars])[0]
    assert muls == bk.muls_per_lane(live, k_count)


@pytest.mark.parametrize("k_real,k_count", LANE_CASES)
def test_least_schedule_sums_right_and_counts_muls_least(k_real, k_count):
    bases, scalars, live = _lane_case(k_real, k_count)
    got, muls = _least_lane(bases, scalars)
    assert got == _oracle([bases], [scalars])[0]
    assert muls == bk.muls_least(live)


def test_counts_at_the_idemix_shapes():
    """The numbers the kernel's header and PERF.md quote."""
    assert (bk.muls_per_lane(8, 8), bk.muls_per_lane(3, 8)) == (33_077, 12_467)
    assert (bk.muls_least(8), bk.muls_least(3)) == (16_851, 7_761)
    assert [bk.threads_per_lane(k) for k in (1, 2, 3, 8, 9, 16, 17, 33)] == [
        1, 2, 4, 8, 16, 16, 32, 32]
