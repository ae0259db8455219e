"""The port's host EC tiers (`crypto/hostec`, `crypto/hostec_np`) and its
`SoftwareProvider` against the JAX package's, on the same numpy-seeded
lanes, with no tolerance: verdict masks are booleans, field values
integers.

The lanes are the vectors of tests/test_hostec.py and
tests/test_hostec_np.py: bit-flipped r and s, wrong digests, high-S,
r and s at 0, 1, n-1, n, n+1, off-curve, out-of-range and identity keys,
the sizes around the window seams, the exceptional lanes (P = Q in the
last G-add, results at infinity) and scalars dense in negative signed
windows. Both packages' tiers and the port's P-256 oracle give one mask.
The sharded pools (2 workers) keep lane order, their workers import no
torch, and each pool fault site recomputes the batch inline, the same
mask under the same plan in both packages. The `bccsp.verdict` plan
flips the same lanes in both packages, once a batch.
"""

import hashlib
import logging

import numpy as np
import pytest

from fabric_tpu.common import faults as jfaults
from fabric_tpu.crypto import bccsp as jbccsp
from fabric_tpu.crypto import hostec as jhostec
from fabric_tpu.crypto import hostec_np as jhn
from fabric_tpu_torch.common import der, fabobs, p256
from fabric_tpu_torch.common import faults as tfaults
from fabric_tpu_torch.crypto import bccsp, hostec
from fabric_tpu_torch.crypto import hostec_np as hn
from torch_untraced import untraced  # noqa: F401

N, P, G = p256.N, p256.P, p256.GENERATOR
SEED = 20261018


def _scalar(rng) -> int:
    return int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1


@pytest.fixture(scope="module")
def keys():
    rng = np.random.RandomState(SEED)
    privs = [_scalar(rng) for _ in range(4)]
    return [(d, hostec.scalar_base_mult(d)) for d in privs]


def _digest(tag: bytes, i: int) -> bytes:
    return hashlib.sha256(b"%s %d" % (tag, i)).digest()


def _signed(keys, tag: bytes, i: int):
    """(pub, digest, r, s), signed by the oracle with a seeded nonce."""
    priv, pub = keys[i % len(keys)]
    d = _digest(tag, i)
    nonce = _scalar(np.random.RandomState([SEED, i, len(tag)]))
    r, s = p256.sign_digest(priv, d, nonce)
    return pub, d, r, s


def _fuzz(keys):
    rng = np.random.RandomState(SEED + 1)
    lanes = []
    for i in range(24):
        pub, d, r, s = _signed(keys, b"fuzz", i)
        kind = i % 5
        if kind == 1:
            r ^= 1 << int(rng.randint(256))
        elif kind == 2:
            s ^= 1 << int(rng.randint(256))
        elif kind == 3:
            d = _digest(b"other", i)
        elif kind == 4:
            s = N - s  # high-S: no low-S rule at this layer
        lanes.append((pub, d, r, s))
    return lanes


def _boundaries(keys):
    pub, d, r, s = _signed(keys, b"edge", 0)
    edges = [0, 1, N - 1, N, N + 1]
    return [(pub, d, e, s) for e in edges] + [(pub, d, r, e) for e in edges] + [(pub, d, r, s)]


def _bad_keys(keys):
    pub, d, r, s = _signed(keys, b"badkey", 0)
    x, y = pub
    return [((x, (y + 1) % P), d, r, s), ((P, y), d, r, s), ((x, P + y), d, r, s),
            (None, d, r, s), (pub, d, r, s)]


def _exceptional(keys):
    """pub = G, s = 1, so u1 = e and u2 = r: u2 = 16 puts 16*Q in the last
    Q-add from infinity and u1 = 17 collides the last G-add with 17*Q
    (P = Q); u1 = n - u2 makes the sum the identity."""
    crafts = [(17, 16), (N - 5, 5), (N - 16, 16), (1, 1), (N - 1, 1), (2, N - 2)]
    return [(G, int(u1 % N).to_bytes(32, "big"), u2, 1) for u1, u2 in crafts]


def _negative_windows(keys):
    """Valid signatures whose u2 = r/s is a pattern dense in 0x1f windows
    (every digit recodes signed): with nonce k, r = x(kG) mod n,
    s = r/u2 and e = s*k - r*d; each beside a copy with s flipped."""
    priv, pub = keys[0]
    lanes = []
    for j, pat in enumerate((int("11111" * 51, 2), (1 << 256) % N, N - 1,
                             int("1" * 255, 2) % N)):
        k = _scalar(np.random.RandomState([SEED, 99, j]))
        r = p256.base_mult(k)[0] % N
        s = r * pow(pat, -1, N) % N
        d = ((s * k - r * priv) % N).to_bytes(32, "big")
        lanes += [(pub, d, r, s), (pub, d, r, s ^ 1)]
    return lanes


def _sizes(keys):
    lanes = []
    for size in (1, 2, 31, 32, 33):
        for i in range(size):
            pub, d, r, s = _signed(keys, b"size%d" % size, i)
            lanes.append((pub, d, r, s ^ 2 if i % 3 == 1 else s))
    return lanes


CASES = {"fuzz": _fuzz, "boundaries": _boundaries, "bad_keys": _bad_keys,
         "exceptional": _exceptional, "negative_windows": _negative_windows}


@pytest.mark.parametrize("case", list(CASES))
def test_tiers_match_jax_and_oracle(keys, case):
    lanes = CASES[case](keys)
    want = [p256.verify_digest(pub, d, r, s) if pub is not None else False
            for pub, d, r, s in lanes]
    assert any(want) or case == "exceptional"  # crafted scalars: no lane verifies
    assert hostec.verify_parsed_batch(lanes) == want
    assert hn.verify_parsed_batch(lanes) == want
    assert jhostec.verify_parsed_batch(lanes) == want
    assert jhn.verify_parsed_batch(lanes) == want


def test_sizes_around_the_window_seams(keys):
    lanes = _sizes(keys)
    got = hn.verify_parsed_batch(lanes)
    assert got == hostec.verify_parsed_batch(lanes) == jhn.verify_parsed_batch(lanes)
    assert got.count(False) == sum(i % 3 == 1 for size in (1, 2, 31, 32, 33) for i in range(size))


# -- the pair-limb field, value for value -----------------------------------


@pytest.mark.parametrize("modulus", [P, N], ids=["P", "N"])
def test_montgomery_kernels_equal_jax(modulus):
    rng = np.random.RandomState(SEED + 2)
    xs = [int.from_bytes(rng.bytes(32), "big") % modulus for _ in range(33)]
    ys = [int.from_bytes(rng.bytes(32), "big") % modulus for _ in range(33)]
    xs[0], ys[1] = modulus - 1, 0
    got, want, ints = [], [], []
    for mod, out in ((hn, got), (jhn, want)):
        field = mod._Field(mod._ctx(modulus))
        a = field.fe(mod.limbs13_to_pairs(mod.ints_to_limbs13(xs)), 1, mod.PAIR_MASK)
        b = field.fe(mod.limbs13_to_pairs(mod.ints_to_limbs13(ys)), 1, mod.PAIR_MASK)
        for v in (field.mul(a, b), field.sqr(a), mod._invert_lanes(field, a)):
            out.append(field.carried(v).limbs.copy())
            ints.append(field.to_ints(v, from_mont=False))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    rinv = pow(hn.R_MONT, -1, modulus)
    assert ints[:3] == ints[3:]
    assert ints[0] == [x * y * rinv % modulus for x, y in zip(xs, ys)]
    assert ints[1] == [x * x * rinv % modulus for x in xs]


def test_exceptional_madd_patch_equals_jax(keys):
    """_madd_vec on equal and negated operands takes the wholesale detect
    and the per-lane patch through hostec._madd1, limb for limb as the JAX
    engine does; P = -Q lands at infinity."""
    five = p256.scalar_mult(5, keys[0][1])
    results = []
    for mod in (hn, jhn):
        field = mod._Field(mod._ctx(P))

        def mk(v):
            arr = mod.limbs13_to_pairs(mod.ints_to_limbs13([(v * mod.R_MONT) % P] * 3))
            return field.fe(arr, 1, mod.PAIR_MASK)

        X, Y, Z = mk(five[0]), mk(five[1]), mk(1)
        out = []
        for ay in (mk(five[1]), mk(P - five[1])):
            ax = mk(five[0])
            inf = np.zeros(3, dtype=bool)
            X3, Y3, Z3, exc = mod._madd_vec(field, X, Y, Z, ax, ay)
            assert exc.all()
            X3, Y3, Z3 = mod._patch_exceptional(field, exc, (X, Y, Z), X3, Y3, Z3, ax, ay,
                                                inf_out=inf)
            out.append(([field.carried(v).limbs.copy() for v in (X3, Y3, Z3)], inf.copy()))
        results.append(out)
    for (port_limbs, port_inf), (jax_limbs, jax_inf) in zip(*results):
        assert all(np.array_equal(a, b) for a, b in zip(port_limbs, jax_limbs))
        assert np.array_equal(port_inf, jax_inf)
    assert not results[0][0][1].any() and results[0][1][1].all()
    want = hostec._dbl1(five[0], five[1], 1)
    rinv = pow(hn.R_MONT, -1, P)
    x, _, z = (hn._pairs_to_int(v[:, 0]) * rinv % P for v in results[0][0][0])
    assert x * pow(z, -2, P) % P == want[0] * pow(want[2], -2, P) % P


# -- the scalar API -----------------------------------------------------------


def test_sign_and_keys_cross_the_packages(keys):
    priv, pub = keys[1]
    d = _digest(b"cross", 0)
    r, s = hostec.sign_digest(priv, d)
    assert s <= p256.HALF_N
    assert jhostec.verify_digest(pub, d, r, s) and p256.verify_digest(pub, d, r, s)
    r2, s2 = jhostec.sign_digest(priv, d)
    assert hostec.verify_digest(pub, d, r2, s2) and hn.verify_digest(pub, d, r2, s2)
    kp = hn.generate_keypair()
    assert isinstance(kp, hostec.KeyPair) and kp.pub == p256.base_mult(kp.priv)
    for k in (1, 2, 15, 16, 0xDEADBEEF, N - 1, N, N + 7):
        assert hostec.scalar_base_mult(k) == jhostec.scalar_base_mult(k) == p256.scalar_mult(k, G)


# -- the pools -----------------------------------------------------------------


def _pool_lanes(keys, n):
    lanes = []
    for i in range(n):
        pub, d, r, s = _signed(keys, b"shard", i)
        lanes.append((pub, d, r ^ 4 if i % 7 == 3 else r, s))
    return lanes


@pytest.fixture
def small_pools(monkeypatch):
    """Both tiers' pools at 2 workers and a small batch size, torn down
    (cooldown closed) after. The port's thresholds are module constants;
    FABRIC_TPU_HOSTEC_NP_MIN_LANES sets the JAX package's."""
    monkeypatch.setenv("FABRIC_TPU_HOSTEC_PROCS", "2")
    monkeypatch.setenv("FABRIC_TPU_HOSTEC_NP_PROCS", "2")
    monkeypatch.setenv("FABRIC_TPU_HOSTEC_NP_MIN_LANES", "64")
    monkeypatch.setattr(hn, "NP_MIN_LANES", 64)
    monkeypatch.setattr(hostec, "MIN_POOL_LANES", 64)
    monkeypatch.setattr(hn, "MIN_POOL_LANES", 128)
    monkeypatch.setattr(hn, "MIN_SHARD_LANES", 64)
    for mod in (hostec, hn):
        mod.shutdown_pool()
        mod._POOL_GATE.record_success()
    yield
    for mod in (hostec, hn):
        mod.shutdown_pool()
        mod._POOL_GATE.record_success()


@pytest.mark.parametrize("tier", ["hostec", "hostec_np"])
def test_sharded_pool_keeps_order_and_imports_no_torch(keys, small_pools, tier):
    mod = hostec if tier == "hostec" else hn
    lanes = _pool_lanes(keys, 131)
    resolver = mod.verify_parsed_batch_sharded(lanes)
    got = resolver()
    assert resolver() == got  # a second resolve reads the memo, never the freed block
    assert mod._POOL, "the batch did not reach the pool"
    assert mod._POOL_PROCS == 2
    assert got == jhn.verify_parsed_batch(lanes) == mod.verify_parsed_batch(lanes)
    assert got.count(False) == len(range(3, 131, 7))
    assert hostec.start_method() in ("forkserver", "spawn")
    assert mod._POOL.submit(eval, "'torch' in __import__('sys').modules").result() is False


def test_fork_is_refused_while_cuda_is_initialised(monkeypatch):
    """The pools never fork, with or without a CUDA context in the parent."""
    import multiprocessing

    import torch

    want = "forkserver" if "forkserver" in multiprocessing.get_all_start_methods() else "spawn"
    for initialised in (False, True):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
        assert hostec.start_method() == want


@pytest.mark.parametrize("site", ["hostec.pool.submit", "hostec.pool.resolve",
                                  "hostec_np.pool.submit", "hostec_np.pool.resolve"])
def test_pool_fault_recomputes_inline_as_jax(keys, small_pools, site):
    """One plan, each package's pool: the fault fires, the pool is torn
    down and the batch recomputed inline, the same mask in both."""
    tier = site.split(".")[0]
    lanes = _pool_lanes(keys, 131)
    want = hostec.verify_parsed_batch(lanes)
    plan = f"{site}=raise:1.0"
    with fabobs.obs_installed() as reg, tfaults.plan_installed(
            tfaults.FaultPlan.parse(plan, seed=5)):
        got = (hostec if tier == "hostec" else hn).verify_parsed_batch_sharded(lanes)()
    assert got == want
    assert reg.value("fabric_fault_fired_total", site=site) == 1
    assert reg.value("fabric_degrade_total", seam=f"{tier}.pool") == 1
    assert reg.value("fabric_pool_cooldowns_total", pool=tier) == 1
    jmod = jhostec if tier == "hostec" else jhn
    try:
        with jfaults.plan_installed(jfaults.FaultPlan.parse(plan, seed=5)):
            assert jmod.verify_parsed_batch_sharded(lanes)() == want
    finally:
        jmod.shutdown_pool()
        jmod._POOL_GATE.record_success()


# -- SoftwareProvider and the ladder ------------------------------------------


def _provider_lanes(keys, n):
    """Provider triples: valid, a wrong digest, bad DER and high-S lanes."""
    out = []
    for i in range(n):
        pub, d, r, s = _signed(keys, b"prov", i)
        sig = der.marshal_signature(r, s)
        if i % 4 == 1:
            d = _digest(b"prov!", i)
        elif i % 4 == 2:
            sig = b"\x30\x03\x02\x01\x01"
        elif i % 8 == 3:
            sig = der.marshal_signature(r, N - s)
        out.append((pub, sig, d))
    return out


@pytest.fixture
def ladders():
    """Restore both packages' EC pins after a test."""
    before = bccsp.ec_backend_name(), jbccsp.ec_backend_name()
    yield
    bccsp.select_ec_backend(before[0])
    jbccsp.select_ec_backend(before[1])


@pytest.mark.parametrize("tier", ["hostec_np", "hostec", "p256"])
def test_software_provider_equals_jax(keys, ladders, tier):
    lanes = _provider_lanes(keys, 40)
    bccsp.select_ec_backend(tier)
    jbccsp.select_ec_backend(tier)
    port, jax = bccsp.SoftwareProvider(), jbccsp.SoftwareProvider()
    assert port.describe_backend() == jax.describe_backend() == f"sw:{tier}"
    pk = [bccsp.ECDSAPublicKey(*pub) for pub, _, _ in lanes]
    jk = [jbccsp.ECDSAPublicKey(*pub) for pub, _, _ in lanes]
    sigs, digests = [s for _, s, _ in lanes], [d for _, _, d in lanes]
    want = jax.batch_verify(jk, sigs, digests)
    assert any(want) and not all(want)
    assert port.batch_verify(pk, sigs, digests) == want
    assert port.batch_verify_async(pk, sigs, digests)() == want
    assert bccsp.PurePythonProvider().batch_verify(pk, sigs, digests) == want
    for i in (0, 2, 3):  # valid, bad DER, high-S
        try:
            ok = jax.verify(jk[i], sigs[i], digests[i])
        except jbccsp.VerifyError:
            with pytest.raises(bccsp.VerifyError):
                port.verify(pk[i], sigs[i], digests[i])
        else:
            assert port.verify(pk[i], sigs[i], digests[i]) == ok


def test_verify_batcher_routes_through_hostec_np(keys, ladders):
    from fabric_tpu_torch.parallel.batcher import VerifyBatcher

    bccsp.select_ec_backend("hostec_np")
    calls = []
    orig = hn.verify_parsed_batch_sharded
    b = VerifyBatcher(bccsp.SoftwareProvider(), linger_s=0.02)
    try:
        hn.verify_parsed_batch_sharded = lambda lanes: calls.append(len(lanes)) or orig(lanes)
        reqs = [_provider_lanes(keys, 3 + i) for i in range(4)]
        resolvers = [b.submit([bccsp.ECDSAPublicKey(*p) for p, _, _ in r],
                              [s for _, s, _ in r], [d for _, _, d in r]) for r in reqs]
        for resolver, r in zip(resolvers, reqs):
            assert resolver() == bccsp.PurePythonProvider().batch_verify(
                [bccsp.ECDSAPublicKey(*p) for p, _, _ in r], [s for _, s, _ in r],
                [d for _, _, d in r])
    finally:
        hn.verify_parsed_batch_sharded = orig
        b.stop()
    assert sum(calls) == sum(3 + i for i in range(4))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_ec_ladder(ladders, monkeypatch):
    """hostec_np on the auto walk; fastec is known and never available (a
    pin raises, the auto walk passes it by);
    without numpy the walk logs and lands on hostec; the oracle is only
    pinned; an unknown name is a ValueError."""
    assert bccsp.EC_TIERS == jbccsp.EC_TIERS
    assert bccsp.available_ec_backends() == {"fastec": False, "hostec_np": True,
                                             "hostec": True, "p256": True}
    assert bccsp.select_ec_backend("auto") is hn and bccsp.ec_pool_ready()
    with pytest.raises(ImportError, match="cryptography"):
        bccsp.select_ec_backend("fastec")
    with pytest.raises(ValueError):
        bccsp.select_ec_backend("openssl")
    monkeypatch.setattr(hn, "HAVE_NUMPY", False)
    records = _Records()
    bccsp.logger.addHandler(records)
    try:
        assert bccsp.select_ec_backend("auto") is hostec
    finally:
        bccsp.logger.removeHandler(records)
    assert any("hostec_np tier skipped" in line for line in records.lines)
    assert bccsp.ec_backend_name() == "hostec"
    assert bccsp.select_ec_backend("p256") is p256


@pytest.mark.parametrize("plan", ["bccsp.verdict=corrupt:1.0", "bccsp.verdict=corrupt:1.0:lanes=3",
                                  "bccsp.verdict=corrupt:1.0:lanes=0:max=1"])
@pytest.mark.parametrize("route", ["batch", "async", "pooled"])
def test_verdict_seam_flips_the_same_lanes(keys, ladders, small_pools, plan, route):
    """The same plan flips the same lanes in both packages, once a
    batch_verify or resolve in the calling process, pool or no pool."""
    n = 131 if route == "pooled" else 12
    lanes = [(pub, der.marshal_signature(r, s), d) for pub, d, r, s in _pool_lanes(keys, n)]
    pk = [bccsp.ECDSAPublicKey(*pub) for pub, _, _ in lanes]
    jk = [jbccsp.ECDSAPublicKey(*pub) for pub, _, _ in lanes]
    sigs, digests = [s for _, s, _ in lanes], [d for _, _, d in lanes]
    bccsp.select_ec_backend("hostec_np")
    jbccsp.select_ec_backend("hostec_np")
    clean = bccsp.SoftwareProvider().batch_verify(pk, sigs, digests)
    masks = []
    for faults, prov, k in ((tfaults, bccsp.SoftwareProvider(), pk),
                            (jfaults, jbccsp.SoftwareProvider(), jk)):
        with faults.plan_installed(faults.FaultPlan.parse(plan, seed=11)):
            if route == "async":
                masks.append(prov.batch_verify_async(k, sigs, digests)())
            else:
                masks.append(prov.batch_verify(k, sigs, digests))
    assert masks[0] == masks[1]
    flipped = [i for i, (a, b) in enumerate(zip(masks[0], clean)) if a != b]
    width = 3 if "lanes=3" in plan else (n if "lanes=0" in plan else 1)
    assert flipped == list(range(width))
    if route == "pooled":
        assert hn._POOL, "the batch did not reach the pool"
        jhn.shutdown_pool()


@pytest.mark.parametrize("tier", ["hostec_np", "p256"])
def test_key_gen_and_sign_verify_in_both_packages(ladders, tier):
    """Keys and signatures made by the port's providers (the active tier's
    signer, or the oracle's with its own nonce) verify through the JAX
    SoftwareProvider, low-S, and a changed digest does not."""
    bccsp.select_ec_backend("hostec_np")
    prov = bccsp.SoftwareProvider() if tier == "hostec_np" else bccsp.PurePythonProvider()
    key = prov.key_gen()
    digest = prov.hash(b"signed in the port")
    sig = prov.sign(key, digest)
    assert p256.is_low_s(der.unmarshal_signature(sig)[1])
    jkey = jbccsp.ECDSAPublicKey(key.public.x, key.public.y)
    assert jbccsp.SoftwareProvider().verify(jkey, sig, digest)
    assert not jbccsp.SoftwareProvider().verify(jkey, sig, prov.hash(b"other"))
