"""The port's hostbn rung (`crypto/hostbn`, `idemix/batch.py`'s "hostbn"
backend) against the JAX package's, with no tolerance: verdicts are
booleans and points integers.

`pairing_check_batch` and `msm_batch` take the inputs of
tests/test_hostbn.py (valid, mismatched, identity and unparsed pairing
lanes; mixed base counts, identity bases, zero and order-edge scalars,
P + (-P) and the duplicate base that reaches the P = Q patch) and give the
JAX engine's verdicts and points, and the oracle's. `verify_signatures_batch
(backend="hostbn")` gives the JAX hostbn and scheme masks on that file's
adversarial flavours and on bench.py's config #3 signatures (the smoke's
`idemix_world`), issued from one seed in both packages; the signature-chunk
pool (2 workers, whose workers import no torch) keeps lane order, and its
two fault sites fall back inline. The `idemix.verdict` plan flips the same
lanes in both packages, once a batch in the calling process and never in
a pool worker. The factory's IdemixBackend pin names the host rung.
"""

import copy
import random

import pytest

from fabric_tpu import idemix as jidemix
from fabric_tpu.common import faults as jfaults
from fabric_tpu.common import fp256bn as jbn
from fabric_tpu.crypto import bccsp as jbccsp
from fabric_tpu.crypto import hostbn as jhb
from fabric_tpu.idemix import batch as jib
from fabric_tpu.protos import idemix_pb2
from fabric_tpu_torch import idemix
from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common import faults as tfaults
from fabric_tpu_torch.common import fp256bn as bn
from fabric_tpu_torch.crypto import bccsp
from fabric_tpu_torch.crypto import hostbn as hb
from fabric_tpu_torch.idemix import batch as ib
from torch_untraced import untraced  # noqa: F401

R = bn.R
ATTRS = ["OU", "Role", "EnrollmentID", "RevocationHandle"]
RH_INDEX = 3


def _oracle_check(w, a_prime, a_bar):
    t = bn.fp12_mul(bn.ate(w, a_prime), bn.fp12_inv(bn.ate(bn.G2_GEN, a_bar)))
    return bn.gt_is_unity(bn.fexp(t))


def test_pairing_check_batch_equals_jax():
    rng = random.Random(99)
    sk = rng.randrange(R)
    w = bn.g2_mul(bn.G2_GEN, sk)
    a = bn.g1_mul(bn.G1_GEN, rng.randrange(1, R))
    other = bn.g1_mul(bn.G1_GEN, rng.randrange(1, R))
    b = rng.randrange(2, R)
    pairs = [(a, bn.g1_mul(a, sk)), (a, other), (other, bn.g1_mul(a, sk)), None,
             (a, None), (bn.g1_mul(bn.G1_GEN, b), bn.g1_mul(bn.G1_GEN, sk * b % R)),
             (bn.g1_mul(bn.G1_GEN, b), bn.g1_mul(bn.G1_GEN, (sk * b + 1) % R))]
    got = hb.pairing_check_batch(w, pairs)
    assert got == jhb.pairing_check_batch(w, pairs)
    assert got == [True, False, False, False, False, True, False]
    assert got[:3] == [_oracle_check(w, *p) for p in pairs[:3]]


def test_msm_batch_equals_jax():
    rng = random.Random(5)
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, R)) for _ in range(6)]
    pt = pts[0]
    jobs = [
        ([pts[1], pts[2], pts[3]], [rng.randrange(R) for _ in range(3)]),
        ([pts[i % 6] for i in range(8)], [rng.randrange(R) for _ in range(8)]),
        ([pts[4], None, pts[5]], [rng.randrange(R), 7, 0]),
        ([pts[1], pts[2]], [R - 1, 1]),
        ([pt, bn.g1_neg(pt)], [1, 1]),
        ([pt, pt], [9, 9]),  # duplicate base: the slot reduction adds P = Q
        ([pts[3]], [0]),
        ([pts[2], pts[2], pts[2]], [R - 1, 1, 5]),
    ]
    got = hb.msm_batch(jobs)
    assert got == jhb.msm_batch(jobs)
    want = []
    for bases, scalars in jobs:
        acc = None
        for base, s in zip(bases, scalars):
            acc = bn.g1_add(acc, bn.g1_mul(base, s))
        want.append(acc)
    assert got == want
    assert got[4] is None and got[6] is None


# -- Idemix batches, both packages issued from one seed ----------------------


def _world(pkg, curve, cri, seed):
    rng = random.Random(seed)
    ik = pkg.new_issuer_key(ATTRS, rng)
    ipk = ik["ipk"] if isinstance(ik, dict) else ik.ipk
    sk = curve.rand_mod_order(rng)
    nonce = curve.big_to_bytes(curve.rand_mod_order(rng))
    req = pkg.new_cred_request(sk, nonce, ipk, rng)
    cred = pkg.new_credential(ik, req, [11, 22, 33, 44], rng)

    def sign(disclosure, msg):
        nym, r_nym = pkg.make_nym(sk, ipk, rng)
        return pkg.new_signature(cred, sk, nym, r_nym, ipk, disclosure, msg, RH_INDEX, cri, rng)

    return ipk, sign


def _flavours(ipk, sign, is_pb):
    """tests/test_hostbn.py's lanes: two valid, a wrong message, bumped
    s_sk and c, a wrong disclosed value, an off-curve and an identity ABar."""
    hid, dis = [0, 0, 0, 0], [0, 1, 0, 0]
    s0, s1 = sign(hid, b"m0"), sign(dis, b"m1")

    def variant(base, field, value):
        if is_pb:
            sig = idemix_pb2.Signature()
            sig.CopyFrom(base)
            if field == "a_bar":
                sig.a_bar.x, sig.a_bar.y = value
            else:
                setattr(sig, field, value(getattr(sig, field)))
            return sig
        sig = copy.deepcopy(base)
        if field == "a_bar":
            sig["a_bar"] = {"x": value[0], "y": value[1]}
        else:
            sig[field] = value(sig[field])
        return sig

    def bump(v):
        return bn.big_to_bytes((bn.big_from_bytes(v) + 1) % R)

    lanes = [
        (s0, hid, b"m0", [None] * 4),
        (s1, dis, b"m1", [None, 22, None, None]),
        (s0, hid, b"WRONG", [None] * 4),
        (variant(s0, "proof_s_sk", bump), hid, b"m0", [None] * 4),
        (variant(s1, "proof_c", bump), dis, b"m1", [None, 22, None, None]),
        (s1, dis, b"m1", [None, 999, None, None]),
        (variant(s0, "a_bar", (bn.big_to_bytes(3), bn.big_to_bytes(4))), hid, b"m0", [None] * 4),
        (variant(s0, "a_bar", (bn.big_to_bytes(0), bn.big_to_bytes(0))), hid, b"m0", [None] * 4),
    ]
    sigs, disc, msgs, values = (list(c) for c in zip(*lanes))
    return sigs, disc, ipk, msgs, values, RH_INDEX


def _config3(ipk, sign, is_pb, n):
    """bench.py's config #3 signatures (the smoke's idemix_world): every
    attribute hidden, one message, eight distinct signatures repeated."""
    sigs = [sign([0, 0, 0, 0], b"idemix bench message") for _ in range(8)]
    return ([sigs[i % 8] for i in range(n)], [[0, 0, 0, 0]] * n, ipk,
            [b"idemix bench message"] * n, [[None] * 4] * n, RH_INDEX)


@pytest.fixture(scope="module")
def batches():
    jcri = idemix_pb2.CredentialRevocationInformation()
    jcri.revocation_alg = jidemix.ALG_NO_REVOCATION
    out = {}
    for name, make in (("flavours", _flavours), ("config3", lambda i, s, p: _config3(i, s, p, 16))):
        seed = 7 if name == "flavours" else 1234
        jipk, jsign = _world(jidemix, jbn, jcri, seed)
        ipk, sign = _world(idemix, bn, {"revocation_alg": 0}, seed)
        out[name] = (make(ipk, sign, False), make(jipk, jsign, True))
    return out


@pytest.mark.parametrize("name", ["flavours", "config3"])
def test_hostbn_mask_equals_jax(batches, name):
    """On the flavours both packages' hostbn and scheme rungs agree; on
    config #3 (all valid, the oracle's second a signature spared) both
    hostbn rungs accept every lane."""
    port, jax = batches[name]
    want = jib.verify_signatures_batch(*jax, backend="hostbn")
    assert ib.verify_signatures_batch(*port, backend="hostbn") == want
    if name == "flavours":
        assert want == [True, True] + [False] * 6
        assert jib.verify_signatures_batch(*jax, backend="scheme") == want
        assert ib.verify_signatures_batch(*port, backend="scheme") == want
    else:
        assert want == [True] * 16


def _tiled(args, n):
    sigs, disc, ipk, msgs, values, rh = args
    k = len(sigs)
    return ([sigs[i % k] for i in range(n)], [disc[i % k] for i in range(n)], ipk,
            [msgs[i % k] for i in range(n)], [values[i % k] for i in range(n)], rh)


@pytest.fixture
def small_pool(monkeypatch):
    # the port's thresholds are module constants; the environment sets the
    # JAX package's
    monkeypatch.setattr(ib, "MIN_POOL_SIGS", 8)
    monkeypatch.setattr(ib, "MIN_SHARD_SIGS", 8)
    monkeypatch.setenv("FABRIC_TPU_HOSTBN_MIN_POOL", "8")
    monkeypatch.setenv("FABRIC_TPU_HOSTBN_MIN_SHARD", "8")
    monkeypatch.setenv("FABRIC_TPU_HOSTBN_PROCS", "2")
    ib.shutdown_pool()
    ib.reset_pool_cooldown()
    yield
    ib.shutdown_pool()
    ib.reset_pool_cooldown()


def test_pool_keeps_order_and_imports_no_torch(batches, small_pool):
    port, jax = batches["flavours"]
    args = _tiled(port, 16)
    want = [[True, True] + [False] * 6][0] * 2
    with fabobs.obs_installed() as reg:
        assert ib.verify_signatures_batch(*args, backend="hostbn") == want
    assert ib._POOL and ib._POOL_PROCS == 2
    assert reg.value("fabric_pool_rebuilds_total", pool="hostbn") == 1
    assert reg.value("fabric_verify_lanes_total", rung="hostbn") == 16
    assert ib._POOL.submit(eval, "'torch' in __import__('sys').modules").result() is False


@pytest.mark.parametrize("site", ["hostbn.pool.submit", "hostbn.pool.resolve"])
def test_pool_fault_falls_back_inline_as_jax(batches, small_pool, site):
    port, jax = batches["flavours"]
    want = [True, True] + [False] * 6
    plan = f"{site}=raise:1.0"
    with fabobs.obs_installed() as reg, tfaults.plan_installed(
            tfaults.FaultPlan.parse(plan, seed=3)):
        assert ib.verify_signatures_batch(*_tiled(port, 16), backend="hostbn") == want * 2
    assert reg.value("fabric_fault_fired_total", site=site) == 1
    assert reg.value("fabric_degrade_total", seam="hostbn.pool") == 1
    with jfaults.plan_installed(jfaults.FaultPlan.parse(plan, seed=3)):
        assert jib.verify_signatures_batch(*_tiled(jax, 16), backend="hostbn") == want * 2
    jib.shutdown_pool()
    jib.reset_pool_cooldown()


@pytest.mark.parametrize("plan", ["idemix.verdict=corrupt:1.0:lanes=1",
                                  "idemix.verdict=corrupt:1.0:lanes=3",
                                  "idemix.verdict=corrupt:1.0:lanes=0"])
@pytest.mark.parametrize("backend", ["hostbn", "pooled"])
def test_verdict_seam_flips_the_same_lanes(batches, small_pool, plan, backend):
    port, jax = batches["flavours"]
    n = 16 if backend == "pooled" else 8
    rung = "hostbn" if backend == "pooled" else backend
    clean = ([True, True] + [False] * 6) * (n // 8)
    with tfaults.plan_installed(tfaults.FaultPlan.parse(plan, seed=5)):
        got = ib.verify_signatures_batch(*_tiled(port, n), backend=rung)
    with jfaults.plan_installed(jfaults.FaultPlan.parse(plan, seed=5)):
        want = jib.verify_signatures_batch(*_tiled(jax, n), backend=rung)
    assert got == want
    width = 3 if "lanes=3" in plan else (n if "lanes=0" in plan else 1)
    assert [i for i, (a, b) in enumerate(zip(got, clean)) if a != b] == list(range(width))
    if backend == "pooled":
        assert ib._POOL, "the batch did not reach the pool"
        jib.shutdown_pool()


def test_verdict_seam_on_the_scheme_rung(batches):
    port, jax = batches["flavours"]
    plan = "idemix.verdict=corrupt:1.0:lanes=3"
    with tfaults.plan_installed(tfaults.FaultPlan.parse(plan, seed=5)):
        got = ib.verify_signatures_batch(*port, backend="scheme")
    with jfaults.plan_installed(jfaults.FaultPlan.parse(plan, seed=5)):
        assert jib.verify_signatures_batch(*jax, backend="scheme") == got
    assert got == [False, False, True] + [False] * 5


def test_verdict_seam_never_fires_in_a_pool_worker(batches):
    """A worker's chunk (`_pool_ok=False`) is never corrupted: the
    coordinating process flips the whole batch once, so an inherited plan
    cannot cancel itself."""
    port, _ = batches["flavours"]
    with tfaults.plan_installed(tfaults.FaultPlan.parse("idemix.verdict=corrupt:1.0", seed=5)):
        assert ib.verify_signatures_batch(*port, backend="hostbn", _pool_ok=False) == [
            True, True] + [False] * 6


def test_device_route_stays_the_default(batches):
    """The default route is the device (the port's departure): without a
    card it raises, never falling back to the host rung."""
    import torch

    port, _ = batches["flavours"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ib.verify_signatures_batch(*port)
    with pytest.raises(ValueError):
        ib.verify_signatures_batch(*port, backend="msm")


@pytest.fixture
def idemix_pins():
    before = bccsp.idemix_backend_name(), jbccsp.idemix_backend_name()
    yield
    bccsp.select_idemix_backend(before[0])
    jbccsp.select_idemix_backend(before[1])


def test_idemix_ladder_and_factory_pin(batches, idemix_pins, monkeypatch):
    from fabric_tpu.crypto import factory as jfactory
    from fabric_tpu_torch.crypto import factory

    assert bccsp.IDEMIX_TIERS == jbccsp.IDEMIX_TIERS == ("hostbn", "scheme")
    assert bccsp.available_idemix_backends() == jbccsp.available_idemix_backends()
    assert bccsp.select_idemix_backend("auto") is hb
    for value, want in (("scheme", "scheme"), ("hostbn", "hostbn"), ("hostbn_v99", "hostbn")):
        cfg = {"Default": "SW", "SW": {"IdemixBackend": value}}
        factory.provider_from_config(cfg)
        jfactory.provider_from_config(cfg)
        assert bccsp.idemix_backend_name() == jbccsp.idemix_backend_name() == want
    port, _ = batches["flavours"]
    assert ib.verify_signatures_batch(*port, backend=bccsp.idemix_backend_name()) == [
        True, True] + [False] * 6
    monkeypatch.setattr(hb, "HAVE_NUMPY", False)
    monkeypatch.setattr(jhb, "HAVE_NUMPY", False)
    cfg = {"Default": "SW", "SW": {"IdemixBackend": "hostbn"}}
    with pytest.raises(factory.FactoryError):
        factory.provider_from_config(cfg)
    with pytest.raises(jfactory.FactoryError):
        jfactory.provider_from_config(cfg)
    assert bccsp.select_idemix_backend("auto") is None
    assert bccsp.idemix_backend_name() == "scheme"
