"""The port's multi-device wrappers (`parallel/{mesh,sharded,provider}.py`,
`MultiChannelValidator(mesh=...)`, `Ate2Kernel.check_sharded`) against the
JAX package and their own unsharded runs, on CPU meshes.

Torch has one CPU device, so a port mesh of n positions lists "cpu" n times
(a departure: a JAX mesh lists each device once). Each position runs its
own call of the kernel wrapper, whose plain version runs on the CPU.

(a) `flat_mesh` / `grid_mesh` shapes and errors equal the JAX ones on 8
CPU devices; without a card the default pool, a CUDA mesh,
`MeshCUDAProvider()` and `check_sharded` raise. (b) The split and the
gather over 1-8 positions, flat and (channel, data), with a stand-in kernel
that marks each lane by its inputs: every lane is seen once, by the
position that owns it, and comes back in its place; a launch that raises on
any position makes the call raise. (c) K1's plain version through
`verify_flat` over 2 and 3 positions and `verify_channels` over a 2x2 grid
gives the unsharded plain mask and the JAX `SoftwareProvider` mask on
`tests/test_parallel.py:58-77`'s mixed lanes (valid, wrong digest, corrupt
DER, high S). (d) `MeshCUDAProvider`: `batch_verify` is one K2 call and no
K1 (the reference's `MeshTPUProvider` overrides only `_run_kernel`), and
`_run_kernel` is one K1 call a position. (e) `check_sharded` over 2 and 3
positions equals `check` and the host pairing oracle on mixed lanes. (f)
`MultiChannelValidator` over a (2, 1) grid: three channels of
`tests/test_torch_multichannel.py` equal to each channel alone and to the
JAX validator.

The JAX `ShardedVerify` is not run: it would compile the sharded K1
program, minutes and about 14 GB on XLA:CPU; its semantics are the
unsharded program's lane for lane, which is what each mask is held to.
"""

import hashlib
import random

import jax
import numpy as np
import pytest
import torch
from torch_untraced import untraced  # noqa: F401

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.crypto import fp256bn as jbn
from fabric_tpu.crypto.bccsp import SoftwareProvider, VerifyError
from fabric_tpu.parallel import mesh as jmesh
from fabric_tpu_torch.common import der, p256
from fabric_tpu_torch.common import fp256bn as bn
from fabric_tpu_torch.common.limbparams import NLIMBS
from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.ops import p256_kernel as pk
from fabric_tpu_torch.ops import pairing_kernel as pkn
from fabric_tpu_torch.parallel import (MeshCUDAProvider, MultiChannelValidator, ShardedVerify,
                                       flat_mesh, grid_mesh)
from fabric_tpu_torch.parallel.mesh import Mesh
from fabric_tpu_torch.parallel.sharded import channel_stack
from fabric_tpu_torch.protos import fabric, wire
from test_torch_multichannel import CHANNELS, _channel_block, _port_validator
from test_torch_validator import SW, net, registries  # noqa: F401  (net: the module fixture)
from fabric_tpu.crypto.bccsp import ECDSAPublicKey as JaxKey
from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import validator as jval


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cpus(n):
    return ["cpu"] * n


# ---------------------------------------------------------------------------
# (a) meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu8():
    devices = jax.devices("cpu")
    assert len(devices) >= 8, "tests/conftest.py asks XLA for 8 CPU devices"
    return devices[:8]


MESHES = [("flat", ()), ("grid", (1,)), ("grid", (2,)), ("grid", (4,)), ("grid", (8,)),
          ("grid", (2, 2)), ("grid", (4, 1)), ("grid", (1, 8)), ("grid", (3,)), ("grid", (4, 4)),
          ("grid", (3, 3))]


@pytest.mark.parametrize("kind,args", MESHES)
def test_mesh_shapes_and_errors_match_jax(cpu8, kind, args):
    def build(make, pool):
        try:
            m = make(*args, devices=pool) if kind == "grid" else make(pool)
            return dict(m.shape), m.devices.shape
        except ValueError as exc:
            return "ValueError", str(exc)

    ours = build(grid_mesh if kind == "grid" else flat_mesh, _cpus(8))
    theirs = build(jmesh.grid_mesh if kind == "grid" else jmesh.flat_mesh, cpu8)
    assert ours == theirs
    if ours[0] != "ValueError":
        assert list(ours[0]) == (["data"] if kind == "flat" else ["channel", "data"])


def test_without_a_card_every_default_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults take it")
    for make in (flat_mesh, lambda: grid_mesh(1), lambda: flat_mesh(["cuda"]),
                 lambda: Mesh(["cuda:0", "cpu"], ("data",)), MeshCUDAProvider):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError, match="no kernels for device"):
        flat_mesh(["meta"])
    kernel = pkn.Ate2Kernel(bn.G2_GEN, device="cpu")

    class CudaMesh:  # a mesh built where a card was, used where none is
        def positions(self, axis):
            return [torch.device("cuda", 0)]

    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel.check_sharded([(bn.G1_GEN, bn.G1_GEN)], CudaMesh())


# ---------------------------------------------------------------------------
# (b) split and gather, with a stand-in kernel
# ---------------------------------------------------------------------------


def _stand_in(seen):
    """K1's stand-in: lane i of a launch is live and e's limb 0 odd; each
    launch's e limb 0 recorded."""

    def verify_batch(e, r, s, qx, qy, ok):
        assert e.shape == (NLIMBS, ok.shape[0]) and e.device.type == "cpu"
        seen.append(e[0].tolist())
        return ok & (e[0] % 2 == 1)

    return verify_batch


def _numbered_limbs(shape_lead, lanes, rng):
    e = np.zeros(shape_lead + (NLIMBS, lanes), dtype=np.int64)
    e[..., 0, :] = np.arange(int(np.prod(shape_lead, dtype=int)) * lanes).reshape(
        shape_lead + (lanes,))
    others = [rng.integers(0, 1 << 13, size=e.shape, dtype=np.int64) for _ in range(4)]
    ok = rng.random(shape_lead + (lanes,)) < 0.8
    return e, others, ok


@pytest.mark.parametrize("positions", range(1, 9))
def test_flat_split_and_gather(monkeypatch, positions):
    seen = []
    monkeypatch.setattr(pk, "verify_batch", _stand_in(seen))
    lanes = 24 * positions
    e, others, ok = _numbered_limbs((), lanes, np.random.default_rng(positions))
    got = ShardedVerify(flat_mesh(_cpus(positions))).verify_flat(e, *others, ok)
    assert got.tolist() == (ok & (e[0] % 2 == 1)).tolist()
    assert seen == [list(range(j * 24, (j + 1) * 24)) for j in range(positions)]
    with pytest.raises(ValueError, match=f"lane count {lanes + 1} not divisible by data axis"):
        ShardedVerify(flat_mesh(_cpus(positions + 1))).verify_flat(
            *(np.zeros((NLIMBS, lanes + 1), dtype=np.int64),) * 5, np.ones(lanes + 1, bool))


@pytest.mark.parametrize("channel,data", [(1, 1), (2, 1), (1, 3), (2, 2), (4, 2), (2, 4)])
def test_channel_split_and_gather(monkeypatch, channel, data):
    seen = []
    monkeypatch.setattr(pk, "verify_batch", _stand_in(seen))
    c, lanes = 4, 16 * data
    e, others, ok = _numbered_limbs((c,), lanes, np.random.default_rng(channel * 10 + data))
    sv = ShardedVerify(grid_mesh(channel, data, _cpus(channel * data)))
    got = sv.verify_channels(e, *others, ok)
    assert got.tolist() == (ok & (e[:, 0] % 2 == 1)).tolist()
    cw, w = c // channel, lanes // data
    # position (i, j): its channels' lanes end to end, channel by channel
    want = [[int(e[ch, 0, lane]) for ch in range(i * cw, (i + 1) * cw)
             for lane in range(j * w, (j + 1) * w)] for i in range(channel) for j in range(data)]
    assert seen == want
    with pytest.raises(ValueError, match=r"stack \(3, 16\) not divisible by mesh"):
        ShardedVerify(grid_mesh(2, 1, _cpus(2))).verify_channels(
            *(np.zeros((3, NLIMBS, 16), dtype=np.int64),) * 5, np.ones((3, 16), bool))


def test_a_failed_launch_on_any_position_raises(monkeypatch):
    calls = []

    def failing(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("p256_verify_limbs launch failed: cudaError 700")
        return args[-1].clone()

    monkeypatch.setattr(pk, "verify_batch", failing)
    e, others, ok = _numbered_limbs((), 64, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        ShardedVerify(flat_mesh(_cpus(4))).verify_flat(e, *others, ok)
    assert len(calls) == 3
    monkeypatch.setattr(pkn, "unity_check", lambda *a: (_ for _ in ()).throw(
        RuntimeError("ate2_unity launch failed: cudaError 719")))
    kernel = pkn.Ate2Kernel(bn.G2_GEN, device="cpu")
    with pytest.raises(RuntimeError, match="cudaError 719"):
        kernel.check_sharded([(bn.G1_GEN, bn.G1_GEN)] * 3, flat_mesh(_cpus(2)))


# ---------------------------------------------------------------------------
# (c) K1's plain version over the mesh, tests/test_parallel.py's lanes
# ---------------------------------------------------------------------------


def _sig_cases(n):
    """tests/test_parallel.py:58-77: valid, wrong digest, corrupt DER and
    high-S lanes, in turn."""
    cases = []
    for i in range(n):
        priv = (i * 0x9E3779B97F4A7C15 + 11) % (p256.N - 1) + 1
        pub = p256.scalar_mult(priv, p256.GENERATOR)
        digest = hashlib.sha256(f"case {i}".encode()).digest()
        k = (i * 0xD6E8FEB86659FD93 + 7) % (p256.N - 1) + 1
        r, s = p256.sign_digest(priv, digest, k=k)
        sig = der.marshal_signature(r, s)
        kind = i % 4
        if kind == 1:
            digest = hashlib.sha256(b"other").digest()
        elif kind == 2:
            sig = b"\x30\x03\x02\x01\x01"
        elif kind == 3:
            sig = der.marshal_signature(r, p256.N - s)
        cases.append((pub, sig, digest))
    return cases


LANES = 24


@pytest.fixture(scope="module")
def lanes():
    cases = _sig_cases(LANES)
    expected = []
    for pub, sig, digest in cases:
        try:
            expected.append(SW.verify(JaxKey(*pub), sig, digest))
        except VerifyError:
            expected.append(False)
    keys = [ECDSAPublicKey(*pub) for pub, _, _ in cases]
    cols = (keys, [c[1] for c in cases], [c[2] for c in cases])
    limbs = CUDAProvider(device="cpu").prep_limbs(*cols)
    unsharded = pk.verify_batch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in limbs))
    assert any(expected) and not all(expected)
    return {"cols": cols, "limbs": limbs, "jax": expected, "plain": unsharded.tolist()}


def test_unsharded_plain_mask_is_the_jax_software_mask(lanes):
    assert lanes["plain"] == lanes["jax"]


@pytest.mark.parametrize("positions", [2, 3])
def test_verify_flat_matches_unsharded_and_jax(lanes, positions):
    got = ShardedVerify(flat_mesh(_cpus(positions))).verify_flat(*lanes["limbs"])
    assert got.tolist() == lanes["plain"] == lanes["jax"]


def test_verify_channels_over_a_grid_matches(lanes):
    """Two channels (the lanes, then the lanes reversed) padded to 32 lanes
    each, over a 2x2 grid: each channel's mask is its lanes' mask."""
    limbs = lanes["limbs"]
    reverse = tuple(a[..., ::-1] for a in limbs)
    stack = channel_stack([limbs, reverse], 32, 2)
    got = ShardedVerify(grid_mesh(2, 2, _cpus(4))).verify_channels(*stack)
    assert got[0, :LANES].tolist() == lanes["jax"]
    assert got[1, :LANES].tolist() == lanes["jax"][::-1]
    assert not got[:, LANES:].any()


# ---------------------------------------------------------------------------
# (d) MeshCUDAProvider
# ---------------------------------------------------------------------------


def _counting(monkeypatch, name, calls):
    real = getattr(pk, name)

    def counted(*args, **kwargs):
        calls.append((name, args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(pk, name, counted)


def test_batch_verify_is_one_k2_call_as_the_reference(monkeypatch, lanes):
    """`MeshTPUProvider` overrides only `_run_kernel`; its `batch_verify`
    is TPUProvider's unsharded bytes route. So one K2 call, no K1."""
    calls = []
    _counting(monkeypatch, "verify_batch", calls)
    _counting(monkeypatch, "verify_batch_bytes", calls)
    prov = MeshCUDAProvider(flat_mesh(_cpus(4)))
    assert prov.describe_backend() == "cpu-reference"
    assert prov.batch_verify(*lanes["cols"]) == lanes["jax"]
    assert [c[0] for c in calls] == ["verify_batch_bytes"]


def test_run_kernel_is_one_k1_call_a_position(monkeypatch, lanes):
    calls = []
    _counting(monkeypatch, "verify_batch", calls)
    prov = MeshCUDAProvider(flat_mesh(_cpus(2)))
    assert prov._run_kernel(lanes["limbs"]) == lanes["jax"]
    # bucket 128 split in two
    assert calls == [("verify_batch", (NLIMBS, 64))] * 2


# ---------------------------------------------------------------------------
# (e) check_sharded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairing():
    rng = random.Random(21)
    isk = bn.rand_mod_order(rng)
    w = bn.g2_mul(bn.G2_GEN, isk)
    pairs = []
    for i in range(5):
        a = bn.g1_mul(bn.G1_GEN, bn.rand_mod_order(rng))
        pairs.append((a, bn.g1_mul(a, isk if i % 2 == 0 else isk + 1)))
    pairs += [None, (pairs[0][0], None)]
    oracle = [p is not None and p[1] is not None and jbn.gt_is_unity(jbn.fexp(jbn.fp12_mul(
        jbn.ate(w, p[0]), jbn.fp12_inv(jbn.ate(jbn.G2_GEN, p[1]))))) for p in pairs]
    kernel = pkn.Ate2Kernel(w, device="cpu")
    return {"kernel": kernel, "pairs": pairs, "oracle": oracle, "check": kernel.check(pairs)}


def test_check_matches_the_oracle(pairing):
    assert pairing["check"] == pairing["oracle"] == [True, False, True, False, True, False, False]


@pytest.mark.parametrize("positions", [2, 3])
def test_check_sharded_equals_check(monkeypatch, pairing, positions):
    widths = []
    real = pkn.unity_check

    def counted(tables, *cols):
        widths.append(cols[0].shape[1])
        return real(tables, *cols)

    monkeypatch.setattr(pkn, "unity_check", counted)
    got = pairing["kernel"].check_sharded(pairing["pairs"], flat_mesh(_cpus(positions)))
    assert got == pairing["check"]
    n = len(pairing["pairs"])
    assert widths == [-(-n // positions)] * positions
    assert pairing["kernel"].check_sharded([], flat_mesh(_cpus(positions))) == []


# ---------------------------------------------------------------------------
# (f) MultiChannelValidator over a mesh
# ---------------------------------------------------------------------------


def test_multichannel_over_a_grid_matches_each_channel(net, monkeypatch):  # noqa: F811
    blocks = {ch: _channel_block(net, ch, 3 + k) for k, ch in enumerate(CHANNELS)}
    raw = {ch: b.SerializeToString() for ch, b in blocks.items()}
    jmgr, _ = net["mgrs"]
    want = {}
    for ch in CHANNELS:
        jb = common_pb2.Block()
        jb.CopyFrom(blocks[ch])
        want[ch] = jval.BlockValidator(ch, jmgr, SW, registries()[0]).validate(jb).tobytes()
        alone = _port_validator(net, ch).validate(wire.decode(fabric.BLOCK, raw[ch])).tobytes()
        assert alone == want[ch], ch
    calls = []
    _counting(monkeypatch, "verify_batch", calls)
    multi = MultiChannelValidator({ch: _port_validator(net, ch) for ch in CHANNELS},
                                  mesh=grid_mesh(2, 1, _cpus(2)))
    flags = multi.validate({ch: wire.decode(fabric.BLOCK, raw[ch]) for ch in CHANNELS})
    assert {ch: f.tobytes() for ch, f in flags.items()} == want
    # 3 channels and a dead one, two a position, each padded to 128 lanes
    assert calls == [("verify_batch", (NLIMBS, 2 * 128))] * 2
