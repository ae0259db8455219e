"""The port's native host runtime (`fabric_tpu_torch/native/*.cc` through
`fabric_tpu_torch/utils/native.py`) against the JAX package's native
library (`fabric_tpu.utils.native`, built from `native/`), `hashlib` and
the port's Python DER parse (`crypto/sigparse.batch_der_parse_python`).

Batched SHA-256 at every length from 0 to 200 bytes (the padding's edges at
55/56, 63/64 and 119/120 among them) and at a few long ones; the DER parse
on `tests/test_native.py`'s vectors (valid, malformed, trailing bytes, out
of range, its seeded mutation fuzz) and on the smoke's crafted P-256 lanes
(`chip_smoke.p256_crafted_lanes`). Every comparison is byte for byte. A
missing compiler or a failed build raises: the port has no silent Python
route.
"""

import ctypes
import hashlib
import random

import numpy as np
import pytest

import chip_smoke
from fabric_tpu.crypto import der as jder
from fabric_tpu.utils import native as jnative
from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.crypto.sigparse import batch_der_parse, batch_der_parse_python
from fabric_tpu_torch.utils import native

LENGTHS = list(range(201)) + [1000, 4096, 65536]


def _jax_native():
    assert jnative.available(), "the JAX package's native library must build here"
    return jnative


def test_library_builds_into_build_dir_and_names_its_sha256():
    lib = native.build()
    assert lib == native.library_path() and lib.exists()
    assert lib.parent.name == "torch_native" and lib.parent.parent.name == "build"
    want = "libcrypto" if _jax_native()._load().fn_sha256_backend() else "portable"
    assert native.sha256_backend() == want


@pytest.mark.parametrize("fill", ["random", "zeros", "ones"])
def test_batch_sha256_equals_hashlib_and_jax(fill):
    rng = random.Random(f"sha {fill}")
    byte = {"zeros": 0, "ones": 0xFF}.get(fill)
    msgs = [bytes(rng.randrange(256) if byte is None else byte for _ in range(n))
            for n in LENGTHS]
    got = native.batch_sha256(msgs)
    assert got.shape == (len(msgs), 32) and got.dtype == np.uint8
    assert [bytes(d) for d in got] == [hashlib.sha256(m).digest() for m in msgs]
    assert np.array_equal(got, _jax_native().batch_sha256(msgs))
    assert CUDAProvider(device="cpu").batch_hash(msgs) == [bytes(d) for d in got]


def test_empty_batches():
    assert native.batch_sha256([]).shape == (0, 32)
    for a, shape in zip(native.batch_der_parse([]), ((0, 32), (0, 32), (0,), (0,))):
        assert a.shape == shape


def _raw_der_parse(sigs):
    """fn_batch_der_parse's four outputs as the C function writes them."""
    n = len(sigs)
    out = [np.zeros((n, 32), np.uint8), np.zeros((n, 32), np.uint8), np.zeros(n, np.uint8),
           np.zeros(n, np.uint8)]
    _, blob, offsets, lens = native.pack(sigs)
    u8, u64 = ctypes.c_uint8, ctypes.c_uint64
    native.load().fn_batch_der_parse(native.ptr(blob, u8), native.ptr(offsets, u64),
                                     native.ptr(lens, u64), n, *(native.ptr(a, u8) for a in out))
    return out


def _assert_der_equal(sigs):
    """The port's C function equals the JAX package's byte for byte; the
    port's batch_der_parse (refused rows zeroed) equals its Python parse
    byte for byte."""
    for a, c in zip(_raw_der_parse(sigs), _jax_native().batch_der_parse(sigs)):
        assert np.array_equal(a, c)
    got = batch_der_parse(sigs)
    for a, b in zip(got, batch_der_parse_python(sigs)):
        assert np.array_equal(a, b)
    return got


def test_der_valid_signatures():
    rng = random.Random(5)
    pairs = [(rng.randrange(1, p256.N), rng.randrange(1, p256.N)) for _ in range(100)]
    pairs += [(1, 1), (p256.N - 1, p256.N // 2), (p256.N // 2, p256.N // 2 + 1)]
    r, s, ok, low = _assert_der_equal([der.marshal_signature(a, b) for a, b in pairs])
    assert ok.all()
    for i, (a, b) in enumerate(pairs):
        assert int.from_bytes(bytes(r[i]), "big") == a and int.from_bytes(bytes(s[i]), "big") == b
        assert bool(low[i]) == p256.is_low_s(b)


@pytest.mark.parametrize("bad", [
    b"",
    b"\x30\x02\x02\x00",
    b"\xff" * 16,
    der.marshal_signature(5, 7)[:-1],  # truncated
    b"\x30\x08\x02\x02\x00\x05\x02\x02\x00\x07",  # a leading zero before a low byte
    der.marshal_signature(5, p256.N),  # s == n
    der.marshal_signature(p256.N, 7),  # r == n
    b"\x30\x06\x02\x01\x00\x02\x01\x07",  # r == 0
    b"\x30\x06\x02\x01\x05\x02\x01\x80",  # s negative
    b"\x30\x81\x06\x02\x01\x05\x02\x01\x07",  # non-minimal long-form length
    b"\x30\x80\x02\x01\x05\x02\x01\x07\x00\x00",  # indefinite length
], ids=["empty", "short", "garbage", "truncated", "non-minimal", "s=n", "r=n", "r=0",
        "negative", "long-form", "indefinite"])
def test_der_rejects_malformed_and_out_of_range(bad):
    _, _, ok, _ = _assert_der_equal([bad])
    assert ok[0] == 0


def test_der_tolerates_trailing_bytes():
    sig = der.marshal_signature(5, 7)
    _, _, ok, _ = _assert_der_equal([sig + b"\x00\xff", sig[:-6] + b"\x00" + sig[-6:]])
    assert ok[0] == 1
    assert jder.unmarshal_signature(sig + b"\x00\xff") == (5, 7)


def test_der_fuzz():
    """tests/test_native.py's mutation fuzz (random.Random(1234), 400
    signatures, up to two byte changes, truncations or appended bytes)."""
    rng = random.Random(1234)
    cases = []
    for _ in range(400):
        sig = bytearray(der.marshal_signature(rng.randrange(1, p256.N), rng.randrange(1, p256.N)))
        for _ in range(rng.randrange(0, 3)):
            kind = rng.randrange(3)
            if kind == 0 and sig:
                sig[rng.randrange(len(sig))] = rng.randrange(256)
            elif kind == 1:
                sig = sig[: rng.randrange(len(sig) + 1)]
            else:
                sig += bytes([rng.randrange(256)])
        cases.append(bytes(sig))
    _, _, ok, _ = _assert_der_equal(cases)
    assert 0 < ok.sum() < len(cases)


def test_der_crafted_lanes():
    """The smoke's crafted K1/K2 lanes, DER-encoded: r = 0, s = 0 and r = n
    refused, high-S parsed with low_s 0, the rest accepted."""
    privs = [(k * 0x9E3779B97F4A7C15 + chip_smoke.SEED_PRIV) % (p256.N - 1) + 1 for k in range(64)]
    lanes = chip_smoke.p256_crafted_lanes(p256, privs)
    r, s, ok, low = _assert_der_equal([der.marshal_signature(ln[3], ln[4]) for ln in lanes])
    verdict = {ln[0]: (int(o), int(lo)) for ln, o, lo in zip(lanes, ok, low)}
    assert verdict["r=0"] == verdict["s=0"] == verdict["r=n"] == (0, 0)
    assert verdict["high-S"] == (1, 0)
    assert verdict["Q=G"] == (1, 1)


def test_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_failed_build_raises(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES + native.HEADERS:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))  # no library, no temporary left
