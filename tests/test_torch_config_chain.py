"""A config update that adds Org4, inside a config #2 chain, through both
packages' Channel and CommitPipeline on the CPU.

chip_smoke.py's config_update_config2 at a small size: 4 orgs (Org1-3 and the
orderer org, then Org4), 6 blocks after the genesis block, 20 txs a plain
block with 2 flipped signatures, the CONFIG block at block 3. One genesis
block (the port's encoder, `ConfigNet.genesis`) and one set of block bytes
feed both packages. Each package's apply_config callback is composed from
its own modules as the JAX orderer composes its hot swap: decode the
ConfigEnvelope, validate it, build the Bundle, hand its MSP manager to the
validator. The port verifies over its P-256 oracle (pipelined: through
BatchingProvider, with K5's plain version), the JAX package over
SoftwareProvider. Serially and pipelined (with a drain after the CONFIG
block, as the smoke's deliver loop does), in both packages: equal filters,
commit hashes, `.chain` bytes and SQLite rows, the expected codes (Org4's
txs refused in block 2, VALID from block 5), bundle sequence 1.

The block after the CONFIG block, pinned in both packages: CommitPipeline
runs stage A (the parse and the identities, deserialized against the
validator's MSP manager) of the blocks after block N while stage B of block
N runs `apply_config`, and neither package has a barrier for config blocks.
With depth 2, stage A of blocks N+1, N+2 and N+3 can all finish before block
N's update is applied (N+1 and N+2 queued, N+3 waiting to be queued). Driven
so here, an Org4 tx in each of those blocks is BAD_CREATOR_SIGNATURE
pipelined and VALID serially, identically in both packages: the reference's
behaviour (ROADMAP Queue 3), which is why the smoke drains after the CONFIG
block and starts Org4's txs two blocks after it.
"""

import threading

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import chip_smoke  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.channelconfig import configtx as jctx  # noqa: E402
from fabric_tpu.crypto.bccsp import SoftwareProvider  # noqa: E402
from fabric_tpu.peer.channel import Channel as JChannel  # noqa: E402
from fabric_tpu.peer.pipeline import CommitPipeline as JPipeline  # noqa: E402
from fabric_tpu.policy import from_dsl as jdsl  # noqa: E402
from fabric_tpu.protos import common_pb2, configtx_pb2  # noqa: E402
from fabric_tpu.validation import validator as jval  # noqa: E402
from fabric_tpu_torch.channelconfig import bundle as tbundle  # noqa: E402
from fabric_tpu_torch.channelconfig.configtx import Validator  # noqa: E402
from fabric_tpu_torch.parallel.batcher import BatchingProvider  # noqa: E402
from fabric_tpu_torch.peer.channel import Channel  # noqa: E402
from fabric_tpu_torch.peer.pipeline import CommitPipeline  # noqa: E402
from fabric_tpu_torch.policy.ast import from_dsl as tdsl  # noqa: E402
from fabric_tpu_torch.protos import fabric, wire  # noqa: E402
from fabric_tpu_torch.validation import validator as tval  # noqa: E402
from torch_untraced import untraced  # noqa: E402, F401

CHANNEL = chip_smoke.CONFIG2_CHANNEL
N_PLAIN = 5  # plain blocks: 6 blocks after the genesis block with the CONFIG block
TXS = 20
FLIPPED = 2
CONFIG_AT = 3
ORG4_TXS = 2
ORG4_FROM = CONFIG_AT + 2
SW = SoftwareProvider()
ORACLE = chip_smoke.oracle_provider({})


class JaxApplier:
    """The JAX package's counterpart of chip_smoke.ConfigApplier, from its
    own modules."""

    def __init__(self, bundle):
        self.bundle = bundle
        self.configtx = jctx.Validator(bundle.channel_id, bundle.config, bundle.policy_manager)
        self.block_validator = None
        self.ms = []

    def __call__(self, config_data):
        cenv = configtx_pb2.ConfigEnvelope.FromString(config_data)
        self.configtx.validate(cenv)
        bundle = jbundle.Bundle(self.bundle.channel_id, cenv.config, SW)
        self.bundle = bundle
        self.configtx = jctx.Validator(bundle.channel_id, bundle.config, bundle.policy_manager)
        self.block_validator.msp_manager = bundle.msp_manager
        self.ms.append(None)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    net = chip_smoke.Config2Net(seed=3131)
    cn = chip_smoke.ConfigNet(net, seed=3132)
    genesis = cn.genesis(CHANNEL)
    orderer = tbundle.bundle_from_genesis_block(genesis, ORACLE)
    update_env = cn.config_update(orderer.config, CHANNEL, cn.admins[:2])
    config_data = cn.config_data(Validator(CHANNEL, orderer.config, orderer.policy_manager),
                                 update_env, CHANNEL)
    plain = [(net.chain_datas(n, TXS, n == 4, CHANNEL, FLIPPED),
              net.chain_codes(n, TXS, n == 4, CHANNEL, FLIPPED)) for n in range(1, N_PLAIN + 1)]
    raws, want = cn.chain(genesis, plain, config_data, CONFIG_AT, ORG4_TXS, ORG4_FROM)
    # the interleaving's chain: one Org4 tx in each of the three blocks
    # after the CONFIG block (none before it)
    pin_raws, _ = cn.chain(genesis, plain, config_data, CONFIG_AT, 0, CONFIG_AT + 1)
    pin_raws = relink_with_org4(cn, genesis, pin_raws)
    return {"net": net, "cn": cn, "genesis_raw": wire.encode(fabric.BLOCK, genesis),
            "raws": raws, "want": want, "pin_raws": pin_raws}


def relink_with_org4(cn, genesis, raws):
    """`raws` with one Org4 tx appended to each of the three blocks after
    the CONFIG block, linked again."""
    from fabric_tpu_torch.protos import protoutil

    datas = [wire.decode(fabric.BLOCK, r)["data"]["data"] for r in raws]
    for number in range(CONFIG_AT + 1, CONFIG_AT + 4):
        datas[number - 1] = list(datas[number - 1]) + cn.org4_datas(number, 1)
    return cn.net.link(datas, first=1, previous_hash=protoutil.block_header_hash(
        genesis["header"]))


def port_channel(world, path, provider, device_mvcc=False):
    genesis = wire.decode(fabric.BLOCK, world["genesis_raw"])
    bundle = tbundle.bundle_from_genesis_block(genesis, provider)
    applier = chip_smoke.ConfigApplier(bundle, provider)
    registry = tval.ChaincodeRegistry([tval.ChaincodeDefinition("benchcc", tdsl(
        chip_smoke.CONFIG2_POLICY))])
    kw = {"device_mvcc": True, "device": "cpu"} if device_mvcc else {}
    ch = Channel(CHANNEL, str(path), bundle.msp_manager, registry, provider,
                 apply_config=applier, **kw)
    applier.block_validator = ch.validator
    ch.ledger.commit(wire.decode(fabric.BLOCK, world["genesis_raw"]))
    return ch, applier


def jax_channel(world, path):
    genesis = common_pb2.Block.FromString(world["genesis_raw"])
    bundle = jbundle.bundle_from_genesis_block(genesis, SW)
    applier = JaxApplier(bundle)
    registry = jval.ChaincodeRegistry([jval.ChaincodeDefinition("benchcc", jdsl(
        chip_smoke.CONFIG2_POLICY))])
    ch = JChannel(CHANNEL, str(path), bundle.msp_manager, registry, SW, apply_config=applier)
    applier.block_validator = ch.validator
    ch.ledger.commit(common_pb2.Block.FromString(world["genesis_raw"]))
    return ch, applier


def decode(package, raw):
    return wire.decode(fabric.BLOCK, raw) if package == "port" else common_pb2.Block.FromString(
        raw)


def commit_hash(package, block):
    if package == "port":
        return block["metadata"]["metadata"][fabric.COMMIT_HASH]
    return block.metadata.metadata[fabric.COMMIT_HASH]


def serial(package, ch, raws):
    out = []
    for raw in raws:
        b = decode(package, raw)
        out.append((ch.store_block(b).tobytes(), commit_hash(package, b)))
    return out


def pipelined(package, ch, raws, drain_after=CONFIG_AT, on_prepared=None):
    """The blocks through the package's CommitPipeline(depth=2) from a
    deliver thread; with `drain_after`, a drain after that block."""
    committed, errors = [], []
    pipe_cls = CommitPipeline if package == "port" else JPipeline
    pipe = pipe_cls(ch, depth=2, on_commit=lambda b, f: committed.append(
        (f.tobytes(), commit_hash(package, b))), on_error=lambda b, exc: errors.append(exc))
    if on_prepared is not None:
        prepare = ch.prepare_block

        def wrapped(block):
            out = prepare(block)
            on_prepared(block)
            return out

        ch.prepare_block = wrapped

    def deliver():
        try:
            for number, raw in enumerate(raws, start=1):
                pipe.submit(decode(package, raw))
                if number == drain_after:
                    assert pipe.drain(timeout=120)
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    thread = threading.Thread(target=deliver, name=f"deliver-{package}")
    thread.start()
    thread.join(timeout=300)
    assert pipe.drain(timeout=300)
    pipe.stop()
    assert not errors, errors
    return committed


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """The chain through four runs: each package serially and pipelined."""
    root = tmp_path_factory.mktemp("config_chain")
    out = {}
    for package, mode in (("port", "serial"), ("port", "pipelined"), ("jax", "serial"),
                          ("jax", "pipelined")):
        path = root / f"{package}-{mode}"
        if package == "port" and mode == "pipelined":
            provider = BatchingProvider(ORACLE)
            ch, applier = port_channel(world, path, provider, device_mvcc=True)
        elif package == "port":
            provider = None
            ch, applier = port_channel(world, path, ORACLE)
        else:
            provider = None
            ch, applier = jax_channel(world, path)
        try:
            got = (serial if mode == "serial" else pipelined)(package, ch, world["raws"])
            out[(package, mode)] = {"blocks": got, "sequence": applier.bundle.sequence,
                                    "applied": len(applier.ms),
                                    "orgs": sorted(o.msp_id for o in
                                                   applier.bundle.application.orgs),
                                    "path": path}
        finally:
            ch.ledger.close()
            if provider is not None:
                provider.stop()
    return out


RUNS = [("port", "serial"), ("port", "pipelined"), ("jax", "serial"), ("jax", "pipelined")]


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
def test_filters_commit_hashes_and_the_update(world, runs, run):
    got = runs[run]
    assert [f for f, _ in got["blocks"]] == world["want"]
    assert got["blocks"] == runs[("jax", "serial")]["blocks"]
    assert got["sequence"] == 1 and got["applied"] == 1
    assert got["orgs"] == ["Org1MSP", "Org2MSP", "Org3MSP", "Org4MSP"]


def test_expected_codes(world):
    """Org4's txs refused before the update and VALID after it; the CONFIG
    block VALID; the flipped signatures and block 4's conflicts coded."""
    want = world["want"]
    assert want[CONFIG_AT - 1] == b"\x00"
    assert want[CONFIG_AT - 2][-ORG4_TXS:] == b"\x04" * ORG4_TXS
    for number in range(ORG4_FROM, N_PLAIN + 2):
        assert want[number - 1][-ORG4_TXS:] == b"\x00" * ORG4_TXS
    assert sum(c == 11 for c in want[4]) == TXS // 10  # block 5 carries block 4's conflicts
    assert all(sum(c in (4, 10) for c in w[:TXS]) == FLIPPED
               for n, w in enumerate(want, start=1) if n != CONFIG_AT)


def test_chain_bytes_and_rows_equal(runs):
    chains = {run: (runs[run]["path"] / f"{CHANNEL}.chain").read_bytes() for run in RUNS}
    assert len(set(chains.values())) == 1
    rows = {run: chip_smoke.ledger_rows(runs[run]["path"] / f"{CHANNEL}.state.db")
            for run in RUNS}
    assert all(rows[run] == rows[RUNS[0]] for run in RUNS)


def pin_run(world, tmp_path, package):
    """The interleaving's chain serially, then pipelined with block 3's
    apply_config held until stage A of block 6 has finished: both runs'
    filters."""
    raws = world["pin_raws"]

    def make(path):
        return port_channel(world, path, ORACLE) if package == "port" else jax_channel(
            world, path)

    ch, _ = make(tmp_path / f"{package}-serial")
    try:
        serial_flags = [f for f, _ in serial(package, ch, raws)]
    finally:
        ch.ledger.close()
    ch, applier = make(tmp_path / f"{package}-pipelined")
    prepared_last = threading.Event()

    def gated(config_data):
        assert prepared_last.wait(timeout=120)
        applier(config_data)

    ch.validator.apply_config = gated

    def on_prepared(block):
        number = block["header"]["number"] if package == "port" else block.header.number
        if number == CONFIG_AT + 3:
            prepared_last.set()

    try:
        got = pipelined(package, ch, raws, drain_after=None, on_prepared=on_prepared)
    finally:
        ch.ledger.close()
    return serial_flags, [f for f, _ in got]


def test_blocks_prepared_before_the_update_refuse_org4(world, tmp_path):
    """Blocks 4-6, all prepared before block 3's update is applied: their
    Org4 tx is BAD_CREATOR_SIGNATURE pipelined and VALID serially, every
    other code equal, and the pipelined filters equal in both packages."""
    out = {package: pin_run(world, tmp_path, package) for package in ("port", "jax")}
    for serial_flags, piped in out.values():
        after = range(CONFIG_AT, CONFIG_AT + 3)  # blocks 4-6
        assert [serial_flags[i][-1] for i in after] == [0, 0, 0]
        assert [piped[i][-1] for i in after] == [4, 4, 4]
        assert [f[:-1] if i in after else f for i, f in enumerate(piped)] == [
            f[:-1] if i in after else f for i, f in enumerate(serial_flags)]
    assert out["port"] == out["jax"]


def test_port_validator_refuses_what_jax_refuses(world):
    """The CONFIG block's envelope validated by both packages' Validators
    over the genesis config; the same envelope validated a second time, at
    sequence 1, is refused by both."""
    genesis_t = tbundle.bundle_from_genesis_block(wire.decode(fabric.BLOCK, world["genesis_raw"]),
                                                  ORACLE)
    genesis_j = jbundle.bundle_from_genesis_block(common_pb2.Block.FromString(
        world["genesis_raw"]), SW)
    config_block = wire.decode(fabric.BLOCK, world["raws"][CONFIG_AT - 1])
    env = wire.decode(fabric.ENVELOPE, config_block["data"]["data"][0])
    cenv_raw = wire.decode(fabric.PAYLOAD, env["payload"])["data"]
    tv = Validator(CHANNEL, genesis_t.config, genesis_t.policy_manager)
    jv = jctx.Validator(CHANNEL, genesis_j.config, genesis_j.policy_manager)
    from fabric_tpu_torch.protos import configtx as C

    tv.apply(wire.decode(C.CONFIG_ENVELOPE, cenv_raw))
    jv.apply(configtx_pb2.ConfigEnvelope.FromString(cenv_raw))
    assert wire.encode(C.CONFIG, tv.config) == jv.config.SerializeToString(deterministic=True)
    errors = []
    for v, cenv in ((tv, wire.decode(C.CONFIG_ENVELOPE, cenv_raw)),
                    (jv, configtx_pb2.ConfigEnvelope.FromString(cenv_raw))):
        with pytest.raises(Exception) as info:
            v.validate(cenv)
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]
    assert "cannot validate config at sequence 1" in errors[0][1]
