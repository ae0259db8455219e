"""The port's limb arithmetic and layout conversions against the JAX package.

Same seeded numpy inputs through `fabric_tpu.ops.bignum` and
`fabric_tpu_torch.ops.bignum`: every output limb must be equal (the outputs
are integers, so the tolerance is exact).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.common import p256 as jp256
from fabric_tpu.crypto import tpu_provider as jprov
from fabric_tpu.ops import bignum as jbn
from fabric_tpu.ops import p256_kernel as jpk
from fabric_tpu_torch.crypto import cuda_provider as tprov
from fabric_tpu_torch.ops import bignum as bn
from fabric_tpu_torch.ops import convert
from fabric_tpu_torch.ops import p256_kernel as pk

LANES = 12
MODULI = {"p": jp256.P, "n": jp256.N}
JAX_CTX = {"p": jpk.CTX_P, "n": jpk.CTX_N}
PORT_CTX = {"p": pk.CTX_P, "n": pk.CTX_N}


def _ints(rng, bound, lanes=LANES):
    """Seeded ints in [0, bound), with the edges 0 and bound - 1 first."""
    vals = [0, bound - 1]
    while len(vals) < lanes:
        vals.append(int.from_bytes(rng.bytes(40), "big") % bound)
    return vals


def _limbs(vals):
    return jbn.ints_to_limbs(vals)  # (20, B) uint32


def _port(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(jax_out, port_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.int64), port_out.numpy()
    )


@pytest.mark.parametrize("mod", ["p", "n"])
@pytest.mark.parametrize("bounds", [(1, 1), (2, 4), (4, 4)])
def test_mont_mul(mod, bounds):
    rng = np.random.default_rng(11)
    m = MODULI[mod]
    a = _limbs(_ints(rng, bounds[0] * m))
    b = _limbs(_ints(rng, bounds[1] * m))
    _same(
        jbn.mont_mul(JAX_CTX[mod], jnp.asarray(a), jnp.asarray(b)),
        bn.mont_mul(PORT_CTX[mod], _port(a), _port(b)),
    )


@pytest.mark.parametrize("mod", ["p", "n"])
def test_to_and_from_mont(mod):
    rng = np.random.default_rng(12)
    # to_mont takes any value below 2^256: digests and keys arrive unreduced
    x = _limbs(_ints(rng, 1 << 256))
    jm = jbn.to_mont(JAX_CTX[mod], jnp.asarray(x))
    pm = bn.to_mont(PORT_CTX[mod], _port(x))
    _same(jm, pm)
    _same(jbn.from_mont(JAX_CTX[mod], jm), bn.from_mont(PORT_CTX[mod], pm))


@pytest.mark.parametrize("mod", ["p", "n"])
def test_mont_pow_fermat_inverse(mod):
    rng = np.random.default_rng(13)
    m = MODULI[mod]
    x = _limbs(_ints(rng, m, lanes=4))
    jx = jbn.to_mont(JAX_CTX[mod], jnp.asarray(x))
    _same(
        jbn.mont_pow(JAX_CTX[mod], jx, m - 2),
        bn.mont_pow(PORT_CTX[mod], bn.to_mont(PORT_CTX[mod], _port(x)), m - 2),
    )


@pytest.mark.parametrize("mod", ["p", "n"])
@pytest.mark.parametrize("a_bound,b_bound", [(1, 1), (1, 4), (4, 3), (2, 2)])
def test_sub_mod(mod, a_bound, b_bound):
    rng = np.random.default_rng(14)
    m = MODULI[mod]
    a = _limbs(_ints(rng, a_bound * m))
    b = _limbs(_ints(rng, b_bound * m))
    nreduce = a_bound + b_bound - 1
    _same(
        jbn.sub_mod(JAX_CTX[mod], jnp.asarray(a), jnp.asarray(b), b_bound, nreduce),
        bn.sub_mod(PORT_CTX[mod], _port(a), _port(b), b_bound, nreduce),
    )


@pytest.mark.parametrize("mod", ["p", "n"])
@pytest.mark.parametrize("times", [1, 3])
def test_cond_sub_and_reduce_canonical(mod, times):
    rng = np.random.default_rng(15)
    m = MODULI[mod]
    x = _limbs(_ints(rng, (times + 1) * m) + [m, 2 * m - 1])
    if times == 1:
        _same(jbn.cond_sub(jnp.asarray(x), JAX_CTX[mod]), bn.cond_sub(PORT_CTX[mod], _port(x)))
    _same(
        jbn.reduce_canonical(jnp.asarray(x), JAX_CTX[mod], times),
        bn.reduce_canonical(PORT_CTX[mod], _port(x), times),
    )


def test_add_raw():
    rng = np.random.default_rng(16)
    a = _limbs(_ints(rng, 4 * jp256.P))
    b = _limbs(_ints(rng, 4 * jp256.P))
    _same(jbn.add_raw(jnp.asarray(a), jnp.asarray(b)), bn.add_raw(_port(a), _port(b)))


def test_carry_matches_limb_chain_with_borrows():
    """The port's all-limbs-at-once carry against the JAX limb-by-limb chain,
    on signed limbs wide enough to ripple carries and borrows."""
    rng = np.random.default_rng(17)
    x = rng.integers(-(1 << 20), 1 << 20, size=(bn.NLIMBS, 64), dtype=np.int32)
    x[:, 0] = -1  # a borrow that ripples through every limb
    x[:, 1] = 0
    x[0, 1] = -1
    x[:, 2] = bn.LIMB_MASK  # a carry that ripples through every limb
    x[0, 2] = bn.LIMB_MASK + 1
    j_limbs, j_out = jbn.carry_i32(jnp.asarray(x))
    p_limbs, p_out = bn.carry(_port(x))
    _same(j_limbs, p_limbs)
    _same(j_out, p_out)


def test_int_limb_round_trip():
    rng = np.random.default_rng(18)
    vals = _ints(rng, 1 << 256)
    t = bn.ints_to_limbs(vals)
    np.testing.assert_array_equal(t.numpy(), _limbs(vals).astype(np.int64))
    assert bn.limbs_to_ints(t) == vals


def test_bytes_to_limbs_matches_both_jax_forms():
    rng = np.random.default_rng(19)
    rows = rng.integers(0, 256, size=(33, 32), dtype=np.uint8)
    rows[0] = 255
    rows[1] = 0
    want = jprov.be_bytes_to_limbs(rows).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(jpk.bytes_to_limbs_device(jnp.asarray(rows))), want)
    np.testing.assert_array_equal(pk.bytes_to_limbs(torch.from_numpy(rows)).numpy(), want)
    np.testing.assert_array_equal(tprov.be_bytes_to_limbs(rows), want)


def test_scalar_digits_msb():
    rng = np.random.default_rng(20)
    u = _limbs(_ints(rng, jp256.N))
    _same(jpk.scalar_digits_msb(jbn.split(jnp.asarray(u))), pk.scalar_digits_msb(_port(u)))


def test_limbs13_words_round_trip():
    rng = np.random.default_rng(21)
    vals = _ints(rng, 1 << 256)
    limbs = _limbs(vals)
    words = convert.limbs13_to_words(limbs)
    assert words.dtype == np.uint32 and words.shape == (8, LANES)
    for j, v in enumerate(vals):
        assert sum(int(words[i, j]) << (32 * i) for i in range(8)) == v
    np.testing.assert_array_equal(convert.words_to_limbs13(words), limbs)


def test_g_tables_match_reference():
    ref = jpk.g_small_table()
    np.testing.assert_array_equal(pk.g_small_table().numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(convert.g_table_from_reference(ref), pk.g_comb_words()[0])
