"""CUDAProvider's own behaviour, with device="cpu" (the kernels' plain
versions): the key bucket's route choice, off-curve keys, resolvers in any
order, VerifyError on single verify, the empty batch, the key combs kept
by SKI; every batch and single verify one K2 call, whatever its size (no
host route), and a failed launch or resolve raising (no software degrade).

Its masks are held to TPUProvider's in tests/test_torch_p256.py, which
holds the JAX verify programs TPUProvider runs (one test worker compiles
them once); here they are held to the oracle on the same vectors.
"""

import hashlib

import numpy as np
import pytest
import torch

from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey, VerifyError
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider, be_bytes_to_limbs
from fabric_tpu_torch.ops import p256_kernel as pk
from torch_untraced import untraced  # noqa: F401

BAD_DER = b"\x30\x01\x00"


def signature_cases(n, num_keys):
    """(key, signature, digest) rows in the style of test_provider_bytes:
    valid, wrong digest, bad DER, high-S, and every tenth an off-curve key."""
    keys = []
    for k in range(num_keys):
        priv = (k * 0x9E3779B97F4A7C15 + 77) % (p256.N - 1) + 1
        keys.append((priv, ECDSAPublicKey(*p256.scalar_mult(priv, p256.GENERATOR))))
    off_curve = ECDSAPublicKey(keys[0][1].x, (keys[0][1].y + 1) % p256.P)
    out = []
    for i in range(n):
        priv, key = keys[i % num_keys]
        digest = hashlib.sha256(f"bytes {i}".encode()).digest()
        kk = (i * 0xD6E8FEB86659FD93 + 3) % (p256.N - 1) + 1
        r, s = p256.sign_digest(priv, digest, k=kk)
        kind = i % 5
        sig = der.marshal_signature(r, s)
        if kind == 1:
            digest = hashlib.sha256(b"other").digest()
        elif kind == 2:
            sig = BAD_DER
        elif kind == 3:
            sig = der.marshal_signature(r, p256.N - s)  # high-S
        elif i % 10 == 4:
            key = off_curve
        out.append((key, sig, digest))
    return out


def columns(cases, key_type=ECDSAPublicKey):
    """Provider arguments, one key object per distinct key as the MSP
    cache hands them out."""
    objs = {}
    keys = [objs.setdefault((c[0].x, c[0].y), key_type(c[0].x, c[0].y)) for c in cases]
    return keys, [c[1] for c in cases], [c[2] for c in cases]


def oracle(cases):
    """Fabric's verifyECDSA decision per row, errors as False."""
    out = []
    for key, sig, digest in cases:
        try:
            r, s = der.unmarshal_signature(sig)
        except der.DerError:
            out.append(False)
            continue
        out.append(p256.is_low_s(s) and p256.verify_digest(key.point, digest, r, s))
    return out


@pytest.fixture(scope="module")
def provider():
    return CUDAProvider(device="cpu")


@pytest.mark.parametrize("num_keys,route", [(5, "bytes"), (40, "limbs")])
def test_key_bucket_picks_the_route_and_gates_off_curve_keys(provider, num_keys, route):
    cases = signature_cases(40, num_keys)
    prep, limbs = provider.prep_bytes(*columns(cases))
    assert (prep is None) == (route == "limbs")
    ok = (prep or limbs)[-1]
    for (key, sig, _), lane_ok in zip(cases, ok):
        if not p256.is_on_curve(key.point) or sig == BAD_DER:
            assert not lane_ok


def test_resolvers_resolve_in_any_order(provider):
    a_cases, b_cases = signature_cases(40, 5), signature_cases(40, 40)
    first = provider.batch_verify_async(*columns(a_cases))
    second = provider.batch_verify_async(*columns(b_cases))
    assert second() == oracle(b_cases)
    assert first() == oracle(a_cases)


def test_single_verify_keeps_verify_error_semantics(provider):
    cases = signature_cases(5, 1)
    key, sig, digest = cases[0]
    assert provider.verify(key, sig, digest) is True
    with pytest.raises(VerifyError):
        provider.verify(*cases[2])  # bad DER
    with pytest.raises(VerifyError):
        provider.verify(*cases[3])  # high-S


def test_empty_batch_and_backend_label(provider):
    assert provider.batch_verify([], [], []) == []
    assert provider.describe_backend() == "cpu-reference"



@pytest.fixture
def one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_key_tables_kept_by_ski_across_a_cache_clear(one_thread):
    """The provider builds a key's comb once and keeps it by SKI; when the
    cache overflows it is cleared, and a batch still gets every column's
    comb (here through the table kernel's plain version), the padding
    columns repeating the first."""
    pts = [p256.scalar_mult(k, p256.GENERATOR) for k in (3, 5, 7)]
    keys = [ECDSAPublicKey(*pt) for pt in pts]

    def limbs(vals):
        return be_bytes_to_limbs(np.frombuffer(b"".join(v.to_bytes(32, "big") for v in vals),
                                               dtype=np.uint8).reshape(len(vals), 32).copy())

    prov = CUDAProvider(device="cpu")
    prov.KEY_TABLE_CACHE = 2
    kx, ky = limbs([pt[0] for pt in pts]), limbs([pt[1] for pt in pts])
    want = pk.key_tables_ref(torch.from_numpy(kx), torch.from_numpy(ky))
    first = prov.key_tables([k.ski() for k in keys[:2]], kx[:, :2].copy(), ky[:, :2].copy())
    assert torch.equal(first, want[:2])
    # keys[0] is cached, keys[2] is not and overflows the cache; one padding column
    pad = np.zeros((kx.shape[0], 1), dtype=kx.dtype)
    got = prov.key_tables([keys[0].ski(), keys[2].ski()],
                          np.concatenate([kx[:, [0, 2]], pad], axis=1),
                          np.concatenate([ky[:, [0, 2]], pad], axis=1))
    assert torch.equal(got, want[[0, 2, 0]])
    assert set(prov._key_table_cache) == {keys[2].ski()}


@pytest.fixture
def k2_calls(monkeypatch, one_thread):
    """Count the bytes-route wrapper's calls (on the CPU the plain version
    runs and `LAUNCHES` does not move)."""
    calls = []
    orig = pk.verify_batch_bytes

    def counted(*args, **kwargs):
        calls.append(int(args[0].shape[0]))
        return orig(*args, **kwargs)

    monkeypatch.setattr(pk, "verify_batch_bytes", counted)
    return calls


@pytest.mark.parametrize("lanes", [1, 31, 32])
def test_every_batch_is_one_k2_call(k2_calls, lanes):
    """No host route for small batches: batch_verify calls K2 once, at any
    size."""
    prov = CUDAProvider(device="cpu")
    cases = signature_cases(lanes, 3)
    assert prov.batch_verify(*columns(cases)) == oracle(cases)
    assert len(k2_calls) == 1


def test_single_verify_is_one_k2_call(k2_calls):
    """verify() is a one-lane K2 call; bad DER and high-S raise VerifyError
    before any call."""
    prov = CUDAProvider(device="cpu")
    cases = signature_cases(4, 1)
    for bad in (cases[2], cases[3]):  # bad DER, high-S
        with pytest.raises(VerifyError):
            prov.verify(*bad)
    assert k2_calls == []
    assert prov.verify(*cases[0]) is True
    assert len(k2_calls) == 1


def _failing(stage):
    def boom(*args, **kwargs):
        raise RuntimeError(f"injected {stage} failure")
    return boom


@pytest.mark.parametrize("stage", ["launch", "resolve"])
def test_dispatch_failure_raises(monkeypatch, stage):
    """Fail closed: a failed launch or resolve raises, and nothing serves
    the batch from software (retries stay in VerifyBatcher)."""
    prov = CUDAProvider(device="cpu")
    cases = signature_cases(40, 3)
    if stage == "launch":
        monkeypatch.setattr(pk, "verify_batch_bytes", _failing(stage))
        with pytest.raises(RuntimeError, match="injected"):
            prov.batch_verify(*columns(cases))
    else:
        monkeypatch.setattr(prov, "_launch", lambda prep, limbs, size: None)
        monkeypatch.setattr(prov, "_resolver", lambda out, n: _failing(stage))
        resolve = prov.batch_verify_async(*columns(cases))
        with pytest.raises(RuntimeError, match="injected"):
            resolve()
    assert prov.describe_backend() == "cpu-reference"
