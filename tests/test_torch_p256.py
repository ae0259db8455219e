"""The port's P-256 verify and provider against the JAX package.

One shared batch of edge cases goes through the JAX package's
`verify_batch_device` / `verify_batch_bytes_device` (XLA:CPU) and through
the port's wrappers on CPU tensors, which run the plain versions
`verify_batch_ref` / `verify_batch_bytes_ref`. Each edge lane is a case of
its own: its verdict must be the same in both packages and the oracle's. The batch is padded to
128 dead lanes and 32 key columns, the shapes of the JAX provider's
smallest bucket, so `TPUProvider` reuses the same two compiled programs
when `CUDAProvider(device="cpu")` is held to it below.

The JAX programs are fresh jits traced with FABRIC_TPU_KERNEL_VARIANT=micro,
as the JAX package's own variant test traces them: the same math (that test
holds the variants to the oracle) with a sixth of the graph, which XLA:CPU
compiles in about 8 GB where the default CPU variant takes about 20 GB.
Every JAX verify program of the port's tests lives in this module and runs
in one child process, which hands that memory back when it exits.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fabric_tpu_torch.common import p256
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider, be_bytes_to_limbs
from fabric_tpu_torch.ops import p256_kernel as pk
from test_torch_provider import columns, oracle, signature_cases
from torch_untraced import untraced  # noqa: F401

LANES = 128
KEY_COLUMNS = 32
TESTS = Path(__file__).resolve().parent


def _priv(i):
    return (i * 0x9E3779B97F4A7C15 + 0xC2B2AE3D27D4EB4F) % (p256.N - 1) + 1


# One case per edge lane, in batch order (the names are fixed here so every
# test worker collects the same cases).
EDGE_CASES = [
    "valid-0", "valid-1", "valid-2", "valid-3",
    "Q=G", "e==r", "Q=G,e==r", "zero-digest", "e>=n",
    "flipped-digest", "wrong-key", "s+1", "high-S", "high-S-masked",
    "bad-DER-masked", "r=0", "r=n", "r=2^256-1", "s=0", "s=n",
    "off-curve", "off-curve-masked", "qx>=p", "u1G=-u2Q",
    "r<p-n", "r=p-n-1", "r=p-n", "valid-masked",
]


def _edge_lanes():
    """(point, digest, r, s, valid_in) per EDGE_CASES entry. valid_in is
    forced true on lanes the host prechecks would reject, so the kernel math
    itself is compared on them too."""
    keys = [p256.scalar_mult(_priv(i), p256.GENERATOR) for i in range(6)]
    g = p256.GENERATOR
    lanes = []
    for i in range(4):
        d = hashlib.sha256(f"lane {i}".encode()).digest()
        r, s = p256.sign_digest(_priv(i), d, k=1000 + i)
        lanes.append((keys[i], d, r, s, True))
    d0 = hashlib.sha256(b"edge").digest()
    r1, s1 = p256.sign_digest(1, d0, k=7)  # priv = 1: Q = G
    k_eq = 0x1234567
    d_eq = (p256.scalar_mult(k_eq, g)[0] % p256.N).to_bytes(32, "big")  # e == r
    r2, s2 = p256.sign_digest(_priv(1), d_eq, k=k_eq)
    r3, s3 = p256.sign_digest(1, d_eq, k=k_eq)  # u1 == u2 and Q = G: the ladder doubles
    d_zero = bytes(32)
    r4, s4 = p256.sign_digest(_priv(2), d_zero, k=99)
    d_big = b"\xff" * 32
    r5, s5 = p256.sign_digest(_priv(3), d_big, k=101)
    flipped = bytes([d0[0] ^ 1]) + d0[1:]
    pmn = p256.P - p256.N
    off_curve = (keys[4][0], (keys[4][1] + 1) % p256.P)
    lanes += [
        (g, d0, r1, s1, True),
        (keys[1], d_eq, r2, s2, True),
        (g, d_eq, r3, s3, True),
        (keys[2], d_zero, r4, s4, True),
        (keys[3], d_big, r5, s5, True),
        (g, flipped, r1, s1, True),
        (keys[5], d0, r1, s1, True),
        (g, d0, r1, s1 + 1, True),
        (g, d0, r1, p256.N - s1, True),  # valid math; the host precheck rejects it
        (g, d0, r1, p256.N - s1, False),
        (keys[0], d0, 0, 0, False),  # bad DER reaches the kernel as zeros
        (g, d0, 0, s1, True),
        (g, d0, p256.N, s1, True),
        (g, d0, (1 << 256) - 1, s1, True),  # reduced mod n and mod p
        (g, d0, r1, 0, True),  # no inverse
        (g, d0, r1, p256.N, True),
        (off_curve, d0, r1, s1, True),
        (off_curve, d0, r1, s1, False),
        (((1 << 256) - 1, keys[4][1]), d0, r1, s1, True),
        # Q = G and e = n - r: u1 + u2 = 0, the sum is infinity
        (g, (p256.N - 12345).to_bytes(32, "big"), 12345, 777, True),
        (keys[4], d0, 5, 1234567, True),  # r < p - n: the r + n candidate
        (keys[4], d0, pmn - 1, 4321, True),
        (keys[4], d0, pmn, 4321, True),
        (keys[0], lanes[0][1], lanes[0][2], lanes[0][3], False),
    ]
    assert len(lanes) == len(EDGE_CASES)
    return lanes


def _be(vals):
    return np.frombuffer(
        b"".join(v.to_bytes(32, "big") for v in vals), dtype=np.uint8
    ).reshape(len(vals), 32).copy()


def _build_batch():
    lanes = _edge_lanes()
    want = [bool(v) and p256.verify_digest(pt, d, r, s) for pt, d, r, s, v in lanes]
    assert any(want) and not all(want)
    dead = (p256.GENERATOR, bytes(32), 1, 1, False)
    lanes = lanes + [dead] * (LANES - len(lanes))
    want = want + [False] * (LANES - len(want))
    points = sorted({ln[0] for ln in lanes})
    assert len(points) <= KEY_COLUMNS
    col = {pt: i for i, pt in enumerate(points)}
    e_b = np.stack([np.frombuffer(ln[1], dtype=np.uint8) for ln in lanes])
    r_b = _be([ln[2] for ln in lanes])
    s_b = _be([ln[3] for ln in lanes])
    kx = np.zeros((20, KEY_COLUMNS), dtype=np.uint32)
    ky = np.zeros((20, KEY_COLUMNS), dtype=np.uint32)
    kx[:, : len(points)] = be_bytes_to_limbs(_be([pt[0] for pt in points]))
    ky[:, : len(points)] = be_bytes_to_limbs(_be([pt[1] for pt in points]))
    idx = np.array([col[ln[0]] for ln in lanes], dtype=np.int32)
    valid = np.array([ln[4] for ln in lanes], dtype=bool)
    limbs = tuple(
        be_bytes_to_limbs(a).astype(np.uint32) for a in (e_b, r_b, s_b)
    ) + (np.ascontiguousarray(kx[:, idx]), np.ascontiguousarray(ky[:, idx]))
    return {
        "want": want,
        "bytes": (e_b, r_b, s_b, kx, ky, idx, valid),
        "limbs": limbs + (valid,),
    }


@pytest.fixture(scope="module")
def batch():
    return _build_batch()


def _provider_vectors():
    """test_provider_bytes-style vectors: few keys (the bytes route) and 40
    keys (the limb route)."""
    return {"bytes": signature_cases(48, 5), "limbs": signature_cases(48, 40)}


@pytest.fixture(scope="module")
def provider_vectors():
    return _provider_vectors()


def _torch(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.int64) if t.dtype == torch.uint32 else t


def _jax_child():
    """Run in a child process (see `jax_side`): print, as one JSON line,
    the JAX kernels' masks on the edge batch and TPUProvider's masks on the
    provider vectors, through the same two compiled programs."""
    import jax

    from fabric_tpu.crypto.bccsp import ECDSAPublicKey as JaxKey
    from fabric_tpu.crypto.tpu_provider import TPUProvider
    from fabric_tpu.ops import p256_kernel as jpk
    from fabric_tpu.utils.jaxcache import enable_compile_cache

    jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    batch = _build_batch()
    calls = {"limbs": 0, "bytes": 0}
    limb_jit = jax.jit(jpk.verify_batch_device)
    bytes_jit = jax.jit(jpk.verify_batch_bytes_device)

    def limbs(*args):
        calls["limbs"] += 1
        return limb_jit(*args)

    def bytes_(*args):
        calls["bytes"] += 1
        return bytes_jit(*args)

    def mask(out):
        return [bool(v) for v in np.asarray(out)]

    out = {"limbs": mask(limbs(*batch["limbs"])), "bytes": mask(bytes_(*batch["bytes"]))}
    tpu = TPUProvider()
    tpu._pk = SimpleNamespace(verify_batch_jit=limbs, verify_batch_bytes_jit=bytes_)
    for route, cases in _provider_vectors().items():
        out[f"tpu_{route}"] = tpu.batch_verify(*columns(cases, JaxKey))
    out["calls"] = calls
    print(json.dumps(out))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX side, computed once per module in a child process: XLA:CPU's
    compile memory (about 8 GB for the two programs) is returned when the
    child exits instead of staying with the test worker for the rest of the
    run."""
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        FABRIC_TPU_CIOS_UNROLL="0",
        FABRIC_TPU_KERNEL_VARIANT="micro",
    )
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
        "import test_torch_p256; test_torch_p256._jax_child()"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent)],
        capture_output=True, text=True, env=env, timeout=1200, check=False,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # one direct call of each program and one through each TPUProvider
    # route: no provider batch fell back to its software path
    assert out.pop("calls") == {"limbs": 2, "bytes": 2}
    return out


@pytest.fixture(scope="module")
def port_masks(batch):
    """The port's wrappers on CPU tensors: the plain versions, no launch."""
    before = dict(pk.LAUNCHES)
    out = {
        "limbs": pk.verify_batch(*(_torch(a) for a in batch["limbs"])).tolist(),
        "bytes": pk.verify_batch_bytes(*(_torch(a) for a in batch["bytes"])).tolist(),
    }
    assert pk.LAUNCHES == before
    return out


ROUTES = ["limbs", "bytes"]  # K1: verify_batch(_ref), K2: verify_batch_bytes(_ref)


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("route", ROUTES)
def test_edge_lane_matches_jax(batch, port_masks, jax_side, route, case):
    lane = EDGE_CASES.index(case)
    assert port_masks[route][lane] == jax_side[route][lane] == batch["want"][lane]


@pytest.mark.parametrize("route", ROUTES)
def test_dead_lanes_match_jax(batch, port_masks, jax_side, route):
    dead = slice(len(EDGE_CASES), LANES)
    assert port_masks[route][dead] == jax_side[route][dead] == batch["want"][dead]
    assert not any(port_masks[route][dead])


@pytest.mark.parametrize("route", ["bytes", "limbs"])
def test_provider_matches_tpu_provider(provider_vectors, jax_side, route):
    cases = provider_vectors[route]
    want = jax_side[f"tpu_{route}"]
    assert want == oracle(cases)
    assert any(want) and not all(want)
    prov = CUDAProvider(device="cpu")
    keys, sigs, digests = columns(cases)
    prep, _ = prov.prep_bytes(keys, sigs, digests)
    assert (prep is None) == (route == "limbs")
    assert prov.batch_verify(keys, sigs, digests) == want


@pytest.mark.parametrize(
    "change,error",
    [
        (lambda a: a.to(torch.int32), TypeError),
        (lambda a: a[:, :-1], ValueError),
        (lambda a: a.t().contiguous().t(), ValueError),
        (lambda a: a.to("meta"), ValueError),
    ],
    ids=["dtype", "shape", "contiguity", "device"],
)
def test_wrappers_reject_bad_inputs(batch, change, error):
    args = [_torch(a) for a in batch["limbs"]]
    args[1] = change(args[1])
    with pytest.raises(error):
        pk.verify_batch(*args)
