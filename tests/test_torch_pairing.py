"""The port's plain Fp12 tower and Ate2 pairing check (K4's plain version)
against the JAX package and the host oracle.

(a) The plain tower (`ops/fp12`) against the JAX package's `ops/fp12` on two
seeded lanes, the JAX operations in one jit as `tests/test_pairing_kernel.py`
runs them: the Montgomery limbs are equal, row for row. Inverse and fixed
powers, which the JAX suite keeps out of tier-1, are held to the JAX
package's host oracle (`fabric_tpu.common.fp256bn`, pure Python). (b) The
port's `LineSchedule` arrays against the JAX package's (host numpy). (c)
The plain Miller values and final-exponentiated values against that
oracle's `miller_loop` / `fexp`, and (d) the unity verdicts of
`Ate2Kernel(w, device="cpu").check` against that oracle, on true, false,
None and identity lanes: the hold the JAX package's own tests put on its
K4 program (`test_pairing_kernel.py`), whose XLA:CPU run takes minutes and
is not repeated here. All comparisons are exact.
"""

import random

import jax
import numpy as np
import pytest
import torch

from fabric_tpu.common import fp256bn as jhost
from fabric_tpu.ops import bignum as jbn
from fabric_tpu.ops import fp12 as jf12
from fabric_tpu.ops import pairing_kernel as jpk
from fabric_tpu_torch.common import fp256bn as host
from fabric_tpu_torch.ops import convert
from fabric_tpu_torch.ops import fp12 as f12
from fabric_tpu_torch.ops import pairing_kernel as pk

RNG_SEED = 20260731


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand_fp12(rng):
    return tuple((rng.randrange(host.P), rng.randrange(host.P)) for _ in range(6))


# ---------------------------------------------------------------------------
# (a) the tower
# ---------------------------------------------------------------------------

TOWER_OPS = ["mul", "sqr", "frobenius-1", "frobenius-2", "conj"]


@pytest.fixture(scope="module")
def tower():
    rng = random.Random(RNG_SEED)
    xs = [_rand_fp12(rng) for _ in range(2)]
    ys = [_rand_fp12(rng) for _ in range(2)]
    x, y = f12.from_host(xs), f12.from_host(ys)
    port = {
        "mul": f12.mul(x, y), "sqr": f12.sqr(x), "frobenius-1": f12.frobenius(x, 1),
        "frobenius-2": f12.frobenius(x, 2), "conj": f12.conj(x),
    }
    with jbn.force_looped_cios():

        @jax.jit
        def fn(x_st, y_st):
            xx, yy = jf12.unpack(x_st), jf12.unpack(y_st)
            return (
                jf12.pack(jf12.fp12_mul(xx, yy)),
                jf12.pack(jf12.fp12_sqr(xx)),
                jf12.pack(jf12.fp12_frobenius(xx, 1)),
                jf12.pack(jf12.fp12_frobenius(xx, 2)),
                jf12.pack(jf12.fp12_conj(xx)),
            )

        outs = fn(x.numpy().astype(np.uint32), y.numpy().astype(np.uint32))
    jax_out = dict(zip(TOWER_OPS, (np.asarray(o) for o in outs)))
    want = {
        "mul": [jhost.fp12_mul(a, b) for a, b in zip(xs, ys)],
        "sqr": [jhost.fp12_sqr(a) for a in xs],
        "frobenius-1": [jhost.fp12_frobenius(a, 1) for a in xs],
        "frobenius-2": [jhost.fp12_frobenius(a, 2) for a in xs],
        "conj": [jhost.fp12_conj(a) for a in xs],
    }
    return xs, port, jax_out, want


@pytest.mark.parametrize("op", TOWER_OPS)
def test_tower_op_matches_jax(tower, op):
    _, port, jax_out, want = tower
    assert np.array_equal(port[op].numpy(), jax_out[op])
    assert f12.to_host(port[op]) == want[op]


def test_inverse_and_power_match_oracle(tower):
    xs = tower[0]
    x = f12.from_host(xs)
    assert f12.to_host(f12.inv(x)) == [jhost.fp12_inv(a) for a in xs]
    e = 0xDEADBEEF12345
    assert f12.to_host(f12.pow_const(x, e)) == [jhost.fp12_pow(a, e) for a in xs]
    one = f12.one(2, "cpu")
    assert f12.equal(f12.mul(x, f12.inv(x)), one).tolist() == [True, True]


# ---------------------------------------------------------------------------
# (b) the line schedules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def issuer():
    rng = random.Random(RNG_SEED + 1)
    gamma = rng.randrange(1, host.R)
    return gamma, host.g2_mul(host.G2_GEN, gamma), rng


@pytest.mark.parametrize("which", ["issuer", "generator"])
def test_line_schedule_matches_jax(issuer, which):
    q = issuer[1] if which == "issuer" else host.G2_GEN
    port, ref = pk.LineSchedule(q), jpk.LineSchedule(q)
    for name in ("dbl_a", "dbl_b", "add_a", "add_b", "has_add"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert len(port.corr) == len(ref.corr) == 2
    for (pa, pb), (ra, rb) in zip(port.corr, ref.corr):
        assert np.array_equal(pa, ra) and np.array_equal(pb, rb)
    assert len(port.has_add) == pk.STEPS == 65 and int(port.has_add.sum()) == pk.ADD_STEPS == 22


# ---------------------------------------------------------------------------
# (c) Miller values and (d) verdicts
# ---------------------------------------------------------------------------

LANES = ["true", "false", "none", "identity-abar", "identity-aprime", "true-generator"]


@pytest.fixture(scope="module")
def lanes(issuer):
    gamma, _, rng = issuer
    a = [host.g1_mul(host.G1_GEN, rng.randrange(1, host.R)) for _ in range(3)]
    return {
        "true": (a[0], host.g1_mul(a[0], gamma)),
        "false": (a[1], host.g1_mul(a[1], (gamma + 1) % host.R)),
        "none": None,
        "identity-abar": (a[2], None),
        "identity-aprime": (None, host.g1_mul(a[2], gamma)),
        "true-generator": (host.G1_GEN, host.g1_mul(host.G1_GEN, gamma)),
    }


def _lane_points(pair):
    """The G1 points a lane runs with: (G1, G1) for a None pair or point."""
    if pair is None or pair[0] is None or pair[1] is None:
        return host.G1_GEN, host.G1_GEN
    return pair


@pytest.fixture(scope="module")
def miller(issuer, lanes):
    """The plain version's values for every lane, in one call."""
    return dict(zip(LANES, pk.miller2_values(issuer[1], [lanes[n] for n in LANES], device="cpu")))


@pytest.mark.parametrize("lane", LANES)
def test_miller_values_match_oracle(issuer, lanes, miller, lane):
    w = issuer[1]
    p1, p2 = _lane_points(lanes[lane])
    f1, f2, fe = miller[lane]
    assert f1 == jhost.miller_loop(w, p1)
    assert f2 == jhost.miller_loop(jhost.G2_GEN, p2)
    assert fe == jhost.fexp(jhost.fp12_mul(f1, jhost.fp12_inv(f2)))


@pytest.fixture(scope="module")
def verdicts(issuer, lanes):
    before = dict(pk.LAUNCHES)
    kernel = pk.Ate2Kernel(issuer[1], device="cpu")
    got = kernel.check([lanes[n] for n in LANES])
    assert pk.LAUNCHES == before
    return dict(zip(LANES, got))


def _oracle(w, pair) -> bool:
    if pair is None or pair[0] is None or pair[1] is None:
        return False
    t = jhost.fp12_mul(jhost.ate(w, pair[0]), jhost.fp12_inv(jhost.ate(jhost.G2_GEN, pair[1])))
    return jhost.gt_is_unity(jhost.fexp(t))


@pytest.mark.parametrize("lane", LANES)
def test_unity_verdict_matches_oracle(issuer, lanes, verdicts, lane):
    want = _oracle(issuer[1], lanes[lane])
    assert verdicts[lane] == want
    assert want == (lane in ("true", "true-generator"))


def test_debug_words_decode_to_host_values(tower):
    """The layout of the kernel's debug entry, (3, 12, 8, B) words with
    R = 2^256, decodes to the values it carries."""
    xs = tower[0]
    limbs = np.stack([f12.from_host(xs).numpy()] * 3)  # (3, 20, 12, B)
    words = convert.limbs_to_words(limbs, axis=1, modulus=host.P)  # (3, 8, 12, B)
    words = torch.from_numpy(np.moveaxis(words, 1, 2).view(np.int32).copy())
    assert pk.words_to_host(words) == [(x, x, x) for x in xs]


def test_kernel_for_issuer_is_cached_per_key_and_device(issuer):
    w_bytes = host.g2_to_bytes(issuer[1])
    k = pk.kernel_for_issuer(w_bytes, "cpu")
    assert pk.kernel_for_issuer(w_bytes, "cpu") is k
    assert k.check([]) == []
    assert np.array_equal(k.sched_w.dbl_a, pk.LineSchedule(issuer[1]).dbl_a)
