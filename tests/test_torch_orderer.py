"""The port's solo orderer (fabric_tpu_torch.orderer) against the JAX
package's, with no tolerance: the BlockCutter's batches and pending state
for seeded envelope streams under count, preferred bytes and oversized
messages, and `pending_age` on an injected clock; BlockWriter's block bytes
(header, data, LAST_CONFIG and the SIGNATURES metadata, with a deterministic
stand-in signer in both) over chains with config blocks and bootstraps; the
port's signature metadata from real signers verifying under the JAX
`block_signature_verifier` and the JAX writer's under the port's, over
bundles of one genesis config (the port's encoder, an orderer org), and
every refusal (no metadata, a flipped signature, a foreign signer, a
missing policy) the same in both; SoloChain's order / configure / flush /
height / get_block and what it delivers."""

import hashlib

import numpy as np
import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import chip_smoke  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.crypto.bccsp import SoftwareProvider  # noqa: E402
from fabric_tpu.msp.cryptogen import NodeIdentity as JNode  # noqa: E402
from fabric_tpu.msp.signer import SigningIdentity as JSigner  # noqa: E402
from fabric_tpu.orderer import blockcutter as jcut  # noqa: E402
from fabric_tpu.orderer import blockwriter as jbw  # noqa: E402
from fabric_tpu.orderer import solo as jsolo  # noqa: E402
from fabric_tpu.protos import common_pb2  # noqa: E402
from fabric_tpu_torch.channelconfig import bundle as tbundle  # noqa: E402
from fabric_tpu_torch.orderer import BlockCutter, SoloChain  # noqa: E402
from fabric_tpu_torch.orderer import blockcutter as tcut  # noqa: E402
from fabric_tpu_torch.orderer import blockwriter as tbw  # noqa: E402
from fabric_tpu_torch.protos import fabric, protoutil, wire  # noqa: E402

SW = SoftwareProvider()
CHANNEL = "bench"


def envelopes(seed, n, sizes=(10, 400)):
    """`n` seeded envelopes of random payload sizes, as port dicts and as
    protobuf Envelopes of the same bytes."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        size = int(rng.randint(*sizes))
        env = {"payload": bytes(rng.randint(0, 256, size=size).astype(np.uint8)),
               "signature": b"sig%d" % i}
        out.append((env, common_pb2.Envelope.FromString(wire.encode(fabric.ENVELOPE, env))))
    return out


CUTTER_CONFIGS = {
    "count": dict(max_message_count=5, absolute_max_bytes=10 ** 6, preferred_max_bytes=10 ** 6),
    "preferred": dict(max_message_count=100, absolute_max_bytes=10 ** 6,
                      preferred_max_bytes=1200),
    "oversized": dict(max_message_count=7, absolute_max_bytes=10 ** 6, preferred_max_bytes=300),
    "defaults": {},
}


@pytest.mark.parametrize("config", sorted(CUTTER_CONFIGS))
@pytest.mark.parametrize("seed", range(3))
def test_cutter_batches_equal_jax(config, seed):
    """Every `ordered` call's batches (by envelope bytes) and pending flag,
    then `cut`, for the same stream."""
    tc = tcut.BlockCutter(tcut.BatchConfig(**CUTTER_CONFIGS[config]))
    jc = jcut.BlockCutter(jcut.BatchConfig(**CUTTER_CONFIGS[config]))
    assert (tc.config.max_message_count, tc.config.absolute_max_bytes,
            tc.config.preferred_max_bytes) == (jc.config.max_message_count,
                                               jc.config.absolute_max_bytes,
                                               jc.config.preferred_max_bytes)
    cuts = 0
    for env, jenv in envelopes(seed, 60):
        tb, tp = tc.ordered(env)
        jb, jp = jc.ordered(jenv)
        assert tp == jp
        assert [[wire.encode(fabric.ENVELOPE, e) for e in b] for b in tb] == [
            [e.SerializeToString() for e in b] for b in jb]
        cuts += len(tb)
    assert [wire.encode(fabric.ENVELOPE, e) for e in tc.cut()] == [
        e.SerializeToString() for e in jc.cut()]
    assert tc.cut() == [] and jc.cut() == []
    if config != "defaults":
        assert cuts >= 3


def test_oversized_message_isolated():
    cutter = BlockCutter(tcut.BatchConfig(max_message_count=10, preferred_max_bytes=100))
    small, big = {"payload": b"a" * 10}, {"payload": b"b" * 200}
    assert cutter.ordered(small) == ([], True)
    batches, pending = cutter.ordered(big)
    assert batches == [[small], [big]] and not pending
    assert cutter.cut() == []


def test_pending_age_on_an_injected_clock():
    now = [100.0]
    cutter = BlockCutter(tcut.BatchConfig(max_message_count=3), clock=lambda: now[0])
    assert cutter.pending_age() is None
    cutter.ordered({"payload": b"x"})
    now[0] = 102.5
    cutter.ordered({"payload": b"y"})
    assert cutter.pending_age() == 2.5  # the oldest message's age
    now[0] = 103.0
    cutter.ordered({"payload": b"z"})  # the third message cuts the batch
    assert cutter.pending_age() is None
    cutter.ordered({"payload": b"w"})
    now[0] = 104.0
    assert cutter.pending_age() == 1.0


class StandIn:
    """A deterministic signer with the SigningIdentity surface, the same
    for both writers, so whole blocks compare byte for byte."""

    def __init__(self):
        self.n = 0

    def serialize(self):
        return b"orderer-identity"

    def new_nonce(self):
        self.n += 1
        return b"nonce-%d" % self.n

    def sign(self, msg):
        return hashlib.sha256(msg).digest()


@pytest.mark.parametrize("signed", [True, False])
def test_block_writer_bytes_equal_jax(signed):
    """A chain through both writers: a bootstrap genesis, normal and config
    blocks; every written block's bytes, the height and last config index;
    a block out of order refused alike."""
    tout, jout = [], []
    tw = tbw.BlockWriter(signer=StandIn() if signed else None, sink=tout.append)
    jw = jbw.BlockWriter(signer=StandIn() if signed else None, sink=jout.append)
    genesis = protoutil.seal_block(protoutil.new_block(0, b""))
    genesis["data"]["data"] = [b"genesis config"]
    protoutil.seal_block(genesis)
    raw_genesis = wire.encode(fabric.BLOCK, genesis)
    tw.append_bootstrap(wire.decode(fabric.BLOCK, raw_genesis))
    jw.append_bootstrap(common_pb2.Block.FromString(raw_genesis))
    envs = envelopes(9, 12)
    for k, is_config in enumerate([False, True, False, False]):
        batch = envs[3 * k:3 * k + 3]
        tb = tw.create_next_block([e for e, _ in batch])
        jb = jw.create_next_block([j for _, j in batch])
        assert wire.encode(fabric.BLOCK, tb) == jb.SerializeToString()
        tw.write_block(tb, is_config=is_config)
        jw.write_block(jb, is_config=is_config)
        assert (tw.height, tw.last_config_index) == (jw.height, jw.last_config_index)
    assert [wire.encode(fabric.BLOCK, b) for b in tout] == [b.SerializeToString() for b in jout]
    assert tw.last_config_index == 2
    meta = wire.decode(fabric.METADATA, tout[-1]["metadata"]["metadata"][fabric.SIGNATURES])
    assert wire.decode(fabric.LAST_CONFIG, meta["value"]) == {"index": 2}
    assert len(meta.get("signatures", [])) == (1 if signed else 0)
    stale = tw.create_next_block([])
    stale["header"]["number"] = 2
    with pytest.raises(ValueError, match="wrote block 2, expected 5"):
        tw.write_block(stale)
    jstale = jw.create_next_block([])
    jstale.header.number = 2
    with pytest.raises(ValueError, match="wrote block 2, expected 5"):
        jw.write_block(jstale)
    # a writer resumed from its last block continues the chain the same way
    resumed = tbw.BlockWriter(last_block=tout[-1], last_config_index=2)
    jresumed = jbw.BlockWriter(last_block=jout[-1], last_config_index=2)
    assert wire.encode(fabric.BLOCK, resumed.create_next_block([])) == \
        jresumed.create_next_block([]).SerializeToString()


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    net = chip_smoke.Config2Net(seed=3161)
    cn = chip_smoke.ConfigNet(net, seed=3162)
    genesis = cn.genesis(CHANNEL)
    raw = wire.encode(fabric.BLOCK, genesis)
    node = cn.orderer.node
    jorderer = JSigner(JNode(node.name, node.cert_pem, _jkey(node.priv_scalar), node.msp_id), SW)
    return {"net": net, "cn": cn, "genesis_raw": raw,
            "tbundle": tbundle.bundle_from_genesis_block(wire.decode(fabric.BLOCK, raw),
                                                         chip_smoke.oracle_provider({})),
            "jbundle": jbundle.bundle_from_genesis_block(common_pb2.Block.FromString(raw), SW),
            "jorderer": jorderer}


def _jkey(scalar):
    from cryptography.hazmat.primitives.asymmetric import ec

    return ec.derive_private_key(scalar, ec.SECP256R1())


def _signed_blocks(world, writer_pkg, signer):
    """Three blocks after the genesis block, written by `writer_pkg`'s
    BlockWriter with `signer`; their bytes."""
    out = []
    genesis_raw = world["genesis_raw"]
    if writer_pkg == "port":
        w = tbw.BlockWriter(signer=signer, sink=lambda b: out.append(wire.encode(fabric.BLOCK, b)))
        w.append_bootstrap(wire.decode(fabric.BLOCK, genesis_raw))
        for e, _ in envelopes(4, 6)[:3]:
            w.write_block(w.create_next_block([e]))
    else:
        w = jbw.BlockWriter(signer=signer, sink=lambda b: out.append(b.SerializeToString()))
        w.append_bootstrap(common_pb2.Block.FromString(genesis_raw))
        for _, j in envelopes(4, 6)[:3]:
            w.write_block(w.create_next_block([j]))
    return out[1:]


def _verdicts(world, raws):
    tverify = tbw.block_signature_verifier(lambda: world["tbundle"])
    jverify = jbw.block_signature_verifier(lambda: world["jbundle"])
    return ([tverify(wire.decode(fabric.BLOCK, r)) for r in raws],
            [jverify(common_pb2.Block.FromString(r)) for r in raws])


def _flip_signature(raw):
    block = wire.decode(fabric.BLOCK, raw)
    meta = wire.decode(fabric.METADATA, block["metadata"]["metadata"][fabric.SIGNATURES])
    sig = meta["signatures"][0]["signature"]
    meta["signatures"][0]["signature"] = sig[:-1] + bytes([sig[-1] ^ 1])
    block["metadata"]["metadata"][fabric.SIGNATURES] = wire.encode(fabric.METADATA, meta)
    return wire.encode(fabric.BLOCK, block)


def test_block_signatures_verify_across_packages(world):
    """The port writer's blocks (the orderer's port signer) verify under
    both packages' verifiers, and so do the JAX writer's (the same key, the
    JAX signer); a flipped signature, a client's signature and no signature
    metadata are refused by both."""
    cn = world["cn"]
    port_raws = _signed_blocks(world, "port", cn.orderer)
    jax_raws = _signed_blocks(world, "jax", world["jorderer"])
    # header and data equal; the signatures differ (each signer's nonces)
    for p, j in zip(port_raws, jax_raws):
        pb, jb = wire.decode(fabric.BLOCK, p), wire.decode(fabric.BLOCK, j)
        assert (pb["header"], pb["data"]) == (jb["header"], jb["data"])
    assert _verdicts(world, port_raws) == ([True] * 3, [True] * 3)
    assert _verdicts(world, jax_raws) == ([True] * 3, [True] * 3)
    client_raws = _signed_blocks(world, "port", cn.net.client)
    flipped = [_flip_signature(r) for r in port_raws[:2]]
    unsigned = _signed_blocks(world, "port", None)
    bare = wire.decode(fabric.BLOCK, port_raws[0])
    bare["metadata"]["metadata"] = []
    bad = client_raws + flipped + unsigned + [wire.encode(fabric.BLOCK, bare)]
    assert _verdicts(world, bad) == ([False] * len(bad), [False] * len(bad))
    # a policy the bundle lacks, and no bundle at all
    for name, want in (("/Channel/Orderer/Nope", False),):
        t = tbw.block_signature_verifier(lambda: world["tbundle"], name)
        j = jbw.block_signature_verifier(lambda: world["jbundle"], name)
        assert t(wire.decode(fabric.BLOCK, port_raws[0])) == want
        assert j(common_pb2.Block.FromString(port_raws[0])) == want
    assert tbw.block_signature_verifier(lambda: None)(wire.decode(fabric.BLOCK, bad[0]))


def test_block_verifier_lets_a_failing_provider_raise(world):
    """Departure: a provider that fails (not a verdict) raises through the
    port's verifier instead of reading as an invalid block."""
    class Broken(chip_smoke.oracle_provider().__class__):
        def batch_verify(self, keys, signatures, digests):
            raise RuntimeError("device lost")

    raw = wire.decode(fabric.BLOCK, world["genesis_raw"])
    bundle = tbundle.bundle_from_genesis_block(raw, Broken())
    block = wire.decode(fabric.BLOCK, _signed_blocks(world, "port", world["cn"].orderer)[0])
    with pytest.raises(RuntimeError, match="device lost"):
        tbw.block_signature_verifier(lambda: bundle)(block)


def test_solo_chain_equals_jax():
    """order / configure / flush through both SoloChains with stand-in
    signers: the delivered blocks' bytes, height, get_block and the
    on_config_block callback."""
    seen = {"port": [], "jax": [], "port_config": [], "jax_config": []}
    genesis = protoutil.seal_block(protoutil.new_block(0, b""))
    raw_genesis = wire.encode(fabric.BLOCK, genesis)
    tchain = SoloChain(CHANNEL, signer=StandIn(), batch_config=tcut.BatchConfig(
        max_message_count=4, preferred_max_bytes=900),
        deliver=lambda b: seen["port"].append(wire.encode(fabric.BLOCK, b)),
        genesis_block=wire.decode(fabric.BLOCK, raw_genesis),
        on_config_block=lambda b: seen["port_config"].append(b["header"]["number"]))
    jchain = jsolo.SoloChain(CHANNEL, signer=StandIn(), batch_config=jcut.BatchConfig(
        max_message_count=4, preferred_max_bytes=900),
        deliver=lambda b: seen["jax"].append(b.SerializeToString()),
        genesis_block=common_pb2.Block.FromString(raw_genesis),
        on_config_block=lambda b: seen["jax_config"].append(b.header.number))
    envs = envelopes(5, 23)
    for k, (env, jenv) in enumerate(envs):
        if k == 9:
            tchain.configure(env)
            jchain.configure(jenv)
        else:
            tchain.order(env)
            jchain.order(jenv)
    tchain.flush()
    jchain.flush()
    tchain.flush()  # nothing pending: no block
    assert seen["port"] == seen["jax"] and seen["port_config"] == seen["jax_config"]
    assert tchain.height == jchain.height == len(seen["port"])
    assert seen["port_config"] and tchain.get_block(tchain.height) is None
    for n in range(tchain.height):
        assert wire.encode(fabric.BLOCK, tchain.get_block(n)) == jchain.get_block(
            n).SerializeToString()
    # the orderer package exports what the JAX one does, and the cutter
    assert SoloChain.__module__ == "fabric_tpu_torch.orderer.solo"
    assert BlockCutter.__module__ == "fabric_tpu_torch.orderer.blockcutter"
