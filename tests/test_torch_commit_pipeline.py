"""The port's Channel and CommitPipeline against the JAX package's.

The cases of tests/test_pipeline.py on the port's Channel and pipeline, each
beside the JAX Channel's outcome on the same blocks (minted by the port:
chip_smoke.py's config #2 network, one endorser under an OR policy). The
port validates over its P-256 oracle (memoized, so a block's signatures
are computed once), the JAX package over SoftwareProvider. Flags are
compared with `tobytes()`. Then a 3-block pipelined chain of the invalid
kinds of chip_smoke.MASK_KINDS against the JAX Channel (filters, commit
hashes, `.chain` bytes), and the validator's identity cache under a CRL
rotation during a stage-A fill, in both packages."""

import sys
import threading
import time
from pathlib import Path

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.msp import identity as jid
from fabric_tpu.peer.channel import Channel as JChannel
from fabric_tpu.policy import from_dsl as jdsl
from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch.common import p256
from fabric_tpu_torch.crypto import bccsp as tbccsp
from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
from fabric_tpu_torch.peer.channel import Channel
from fabric_tpu_torch.peer.pipeline import CommitPipeline, PipelineError
from fabric_tpu_torch.policy.ast import from_dsl as tdsl
from fabric_tpu_torch.protos import fabric, protoutil, wire
from fabric_tpu_torch.validation import validator as tval
from torch_untraced import untraced  # noqa: F401

POLICY = "OR('Org1MSP.member','Org2MSP.member')"
SW = SoftwareProvider()


class MemoOracle(tbccsp.Provider):
    """The port's P-256 oracle behind the provider SPI, each verdict
    computed once (test material)."""

    def __init__(self):
        self.memo = {}

    def verify(self, key, signature, digest):
        k = (key.point, signature, digest)
        if k not in self.memo:
            r, s = tbccsp.parse_and_precheck(signature)
            self.memo[k] = p256.verify_digest(key.point, digest, r, s)
        return self.memo[k]


ORACLE = MemoOracle()


@pytest.fixture(scope="module")
def world():
    import chip_smoke

    torch.set_num_threads(1)
    net = chip_smoke.Config2Net(seed=4242)

    def jax_managers(with_crl=False):
        return jid.MSPManager([
            jid.MSP(jid.MSPConfig(c.msp_id, c.root_certs, admins=c.admins,
                                  revocation_list=c.revocation_list,
                                  node_ous=jid.NodeOUs(enable=c.node_ous.enable)), provider=SW)
            for c in net.msp_configs(with_crl)])

    return {"net": net, "smoke": chip_smoke, "jmgr": {False: jax_managers(), True: jax_managers(True)}}


def port_channel(world, path, channel="pipechan", provider=ORACLE, crl=False, policy=POLICY):
    registry = tval.ChaincodeRegistry([tval.ChaincodeDefinition("benchcc", tdsl(policy))])
    return Channel(channel, str(path), world["net"].managers[crl], registry, provider)


def jax_channel(world, path, channel="pipechan", provider=SW, crl=False, policy=POLICY):
    registry = jval.ChaincodeRegistry([jval.ChaincodeDefinition("benchcc", jdsl(policy))])
    return JChannel(channel, str(path), world["jmgr"][crl], registry, provider)


def chain(world, n_blocks, txs_per_block=3, channel="pipechan", corrupt_last=False):
    """Linked blocks as wire bytes; tx i of block b writes {channel}b{b}k{i}.
    With `corrupt_last` each block's last tx has a flipped creator
    signature, so the expected mask is not all-VALID."""
    net = world["net"]
    out, prev = [], b""
    for num in range(n_blocks):
        datas = []
        for i in range(txs_per_block):
            results = serialize_tx_rwset(rw.TxRwSet((rw.NsRwSet(
                "benchcc", (), (rw.KVWrite(f"{channel}b{num}k{i}", False, b"v"),)),)))
            env = net.envelope(i, channel=channel, endorsers=net.endorsers[:1], results=results)
            if corrupt_last and i == txs_per_block - 1:
                env["signature"] = env["signature"][:-1] + bytes([env["signature"][-1] ^ 0xFF])
            datas.append(wire.encode(fabric.ENVELOPE, env))
        block = net.make_block(datas, num, prev)
        prev = protoutil.block_header_hash(block["header"])
        out.append(wire.encode(fabric.BLOCK, block))
    return out


def port_block(raw):
    return wire.decode(fabric.BLOCK, raw)


def jax_serial(world, path, raws, **kw):
    """The JAX Channel storing `raws` one at a time: each block's filter
    and COMMIT_HASH slot, and the channel (closed)."""
    ch = jax_channel(world, path, **kw)
    out = []
    try:
        for raw in raws:
            jb = common_pb2.Block.FromString(raw)
            out.append((ch.store_block(jb).tobytes(), jb.metadata.metadata[4]))
    finally:
        ch.ledger.close()
    return out


def chain_bytes(path, channel="pipechan"):
    return (Path(path) / f"{channel}.chain").read_bytes()


def test_pipeline_commits_in_order_with_overlap(tmp_path, world):
    ch = port_channel(world, tmp_path / "port")
    raws = chain(world, 4)
    events, commits = [], []
    orig_store, orig_prepare = ch.store_block, ch.prepare_block

    def slow_store(block, prepared=None):
        events.append(("commit_start", block["header"].get("number", 0), time.monotonic()))
        time.sleep(0.15)  # make the sequential stage visibly slow
        out = orig_store(block, prepared=prepared)
        events.append(("commit_end", block["header"].get("number", 0), time.monotonic()))
        return out

    def traced_prepare(block):
        events.append(("prepare_start", block["header"].get("number", 0), time.monotonic()))
        return orig_prepare(block)

    ch.store_block, ch.prepare_block = slow_store, traced_prepare
    flags = []
    pipe = CommitPipeline(ch, on_commit=lambda b, f: (commits.append(b["header"].get("number", 0)),
                                                      flags.append(f.tobytes())))
    try:
        for raw in raws:
            pipe.submit(port_block(raw))
        assert pipe.drain(timeout=60)
    finally:
        pipe.stop()
        ch.ledger.close()
    assert commits == [0, 1, 2, 3]
    assert ch.ledger.height == 4
    # overlap: block 2's prepare started before block 1's commit finished
    t_prep2 = next(t for k, n, t in events if k == "prepare_start" and n == 2)
    t_end1 = next(t for k, n, t in events if k == "commit_end" and n == 1)
    assert t_prep2 < t_end1, events
    want = jax_serial(world, tmp_path / "jax", raws)
    assert flags == [f for f, _ in want]
    assert chain_bytes(tmp_path / "port") == chain_bytes(tmp_path / "jax")
    stats = pipe.stage_stats()
    assert stats["prepare"]["n"] == stats["commit"]["n"] == 4


def test_pipeline_8_threads_mask_bitexact_vs_serial(tmp_path, world):
    """8 pipelines on 8 threads at once (shared provider and MSP manager):
    every channel's TRANSACTIONS_FILTER equal to a single-threaded run of
    the port and to the JAX Channel's, byte for byte."""
    n_threads, n_blocks = 8, 5
    chains = {f"hammer{t}": chain(world, n_blocks, channel=f"hammer{t}", corrupt_last=True)
              for t in range(n_threads)}
    reference = {}
    for cid, raws in chains.items():
        ch = port_channel(world, tmp_path / f"serial-{cid}", channel=cid)
        reference[cid] = [ch.store_block(port_block(r)).tobytes() for r in raws]
        ch.ledger.close()
    results = {cid: [] for cid in chains}
    errors = []
    barrier = threading.Barrier(n_threads)

    def drive(cid, raws, pipe):
        try:
            barrier.wait(timeout=30)
            for r in raws:
                pipe.submit(port_block(r))
        except Exception as exc:  # noqa: BLE001 - surfaced via errors
            errors.append((cid, repr(exc)))

    pipes, threads = {}, []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads' bytecode finely
    try:
        for cid in chains:
            ch = port_channel(world, tmp_path / f"par-{cid}", channel=cid)
            pipes[cid] = CommitPipeline(
                ch,
                on_commit=lambda b, f, cid=cid: results[cid].append(f.tobytes()),
                on_error=lambda b, exc, cid=cid: errors.append((cid, repr(exc))),
            )
        for cid, raws in chains.items():
            t = threading.Thread(target=drive, args=(cid, raws, pipes[cid]), daemon=True)
            threads.append(t)
            t.start()
        for t in threads:
            t.join(timeout=120)
        for pipe in pipes.values():
            assert pipe.drain(timeout=120)
    finally:
        sys.setswitchinterval(switch)
        for pipe in pipes.values():
            pipe.stop()
            pipe.channel.ledger.close()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for cid, raws in chains.items():
        assert results[cid] == reference[cid], cid
        assert any(f != b"\x00" * 3 for f in reference[cid])
        want = jax_serial(world, tmp_path / f"jax-{cid}", raws, channel=cid)
        assert reference[cid] == [f for f, _ in want]
        assert chain_bytes(tmp_path / f"par-{cid}", cid) == chain_bytes(tmp_path / f"jax-{cid}", cid)


def test_pipeline_submit_after_stop_raises_fast(tmp_path, world):
    ch = port_channel(world, tmp_path)
    raw = chain(world, 1)[0]
    pipe = CommitPipeline(ch)
    pipe.stop()
    with pytest.raises(PipelineError, match="stopped"):
        pipe.submit(port_block(raw))
    ch.ledger.close()


def _duplicate_submit(pipe, raw):
    pipe.submit(port_block(raw))
    pipe.submit(port_block(raw))  # block 0 again -> the position check rejects
    assert pipe.drain(timeout=30)


def test_pipeline_surfaces_commit_errors(tmp_path, world):
    raw = chain(world, 2)[0]
    outcomes = {}
    for name, make in (("port", port_channel), ("jax", jax_channel)):
        ch = make(world, tmp_path / name)
        errors = []
        if name == "port":
            pipe = CommitPipeline(ch, on_error=lambda b, exc: errors.append(
                (b["header"].get("number", 0), type(exc).__name__)))
            block = port_block
        else:
            from fabric_tpu.peer.pipeline import CommitPipeline as JPipeline

            pipe = JPipeline(ch, on_error=lambda b, exc: errors.append(
                (b.header.number, type(exc).__name__)))
            block = common_pb2.Block.FromString
        try:
            pipe.submit(block(raw))
            pipe.submit(block(raw))
            assert pipe.drain(timeout=30)
        finally:
            pipe.stop()
            ch.ledger.close()
        outcomes[name] = (ch.ledger.height, errors)
    assert outcomes["port"] == outcomes["jax"] == (1, [(0, "BlockVerificationError")])


def test_drain_false_surfaces_last_error(tmp_path, world):
    """A commit-loop failure is recorded on the pipeline (last_error), and
    the loop survives it (not dead)."""
    raw = chain(world, 1)[0]
    ch = port_channel(world, tmp_path)
    pipe = CommitPipeline(ch)
    try:
        assert pipe.last_error is None and not pipe.dead
        _duplicate_submit(pipe, raw)
        assert pipe.last_error is not None
        assert not pipe.dead
    finally:
        pipe.stop()
        ch.ledger.close()
    assert ch.ledger.height == 1


class _AsyncOracle(MemoOracle):
    """The async dispatch seam (CUDAProvider's): records dispatch/resolve
    ordering so the test sees prepare dispatching without waiting."""

    def __init__(self):
        super().__init__()
        self.dispatched = 0
        self.resolved = 0

    def batch_verify_async(self, keys, sigs, digests):
        out = self.batch_verify(keys, sigs, digests)
        self.dispatched += 1

        def resolve():
            self.resolved += 1
            return out

        return resolve


def test_channel_prepare_dispatches_async_and_store_resolves(tmp_path, world):
    prov = _AsyncOracle()
    ch = port_channel(world, tmp_path / "port", provider=prov)
    raw = chain(world, 1)[0]
    block = port_block(raw)
    prepared = ch.prepare_block(block)
    assert prov.dispatched == 1 and prov.resolved == 0, (
        "prepare_block resolved the async dispatch instead of deferring")
    assert callable(prepared[3]), "resolver did not ride the prepared tuple"
    flags = ch.store_block(block, prepared=prepared)
    ch.ledger.close()
    assert prov.resolved == 1
    assert ch.ledger.height == 1
    assert flags.tobytes() == b"\x00" * 3
    assert [flags.tobytes()] == [f for f, _ in jax_serial(world, tmp_path / "jax", [raw])]


def test_channel_async_resolver_failure_fails_closed(tmp_path, world):
    """A resolver that dies at stage B surfaces through the commit error
    path: the block is NOT committed, in the port as in the JAX package."""

    class Dying(MemoOracle):
        def batch_verify_async(self, keys, sigs, digests):
            def resolve():
                raise RuntimeError("dispatch lost")

            return resolve

    class JDying(SoftwareProvider):
        def batch_verify_async(self, keys, sigs, digests):
            def resolve():
                raise RuntimeError("dispatch lost")

            return resolve

    raw = chain(world, 1)[0]
    jch = jax_channel(world, tmp_path / "jax", provider=JDying())
    jb = common_pb2.Block.FromString(raw)
    with pytest.raises(RuntimeError, match="dispatch lost"):
        jch.store_block(jb, prepared=jch.prepare_block(jb))
    assert jch.ledger.height == 0
    jch.ledger.close()

    ch = port_channel(world, tmp_path / "port", provider=Dying())
    block = port_block(raw)
    with pytest.raises(RuntimeError, match="dispatch lost"):
        ch.store_block(block, prepared=ch.prepare_block(block))
    assert ch.ledger.height == 0
    # and through the two-stage pipeline: on_error sees it, no commit
    errors = []
    pipe = CommitPipeline(ch, on_error=lambda b, exc: errors.append(str(exc)))
    try:
        pipe.submit(port_block(raw))
        assert pipe.drain(timeout=30)
    finally:
        pipe.stop()
        ch.ledger.close()
    assert errors == ["dispatch lost"]
    assert ch.ledger.height == 0
    assert isinstance(pipe.last_error, RuntimeError)


def test_pipelined_invalid_kinds_chain_matches_jax(tmp_path, world):
    """Three linked blocks of the smoke's invalid kinds (CRL-revoked
    endorser included), pipelined in the port and stored one at a time by
    the JAX Channel: equal filters, commit hashes and `.chain` bytes, and
    the codes chip_smoke.MASK_CODES pins."""
    net, smoke = world["net"], world["smoke"]
    raws, wants, prev = [], [], b""
    for number in range(3):
        datas, want = net.mask_datas(20)
        block = net.make_block(datas, number, prev)
        prev = protoutil.block_header_hash(block["header"])
        raws.append(wire.encode(fabric.BLOCK, block))
        wants.append(want)
    ch = port_channel(world, tmp_path / "port", channel=smoke.CONFIG2_CHANNEL, crl=True,
                      policy=smoke.CONFIG2_POLICY)
    got = []
    pipe = CommitPipeline(ch, on_commit=lambda b, f: got.append(
        (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH])))
    try:
        for raw in raws:
            pipe.submit(port_block(raw))
        assert pipe.drain(timeout=120) and pipe.last_error is None
    finally:
        pipe.stop()
        ch.ledger.close()
    want = jax_serial(world, tmp_path / "jax", raws, channel=smoke.CONFIG2_CHANNEL, crl=True,
                      policy=smoke.CONFIG2_POLICY)
    assert got == want
    assert [list(f) for f, _ in got] == wants
    assert (chain_bytes(tmp_path / "port", smoke.CONFIG2_CHANNEL)
            == chain_bytes(tmp_path / "jax", smoke.CONFIG2_CHANNEL))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_identity_cache_rotation_during_stage_a_fill(world, package):
    """invalidate_identity_caches (stage B applying a CRL rotation) lands
    while stage A's collect_sig_jobs validates an identity on another
    thread: the identity validated against the old CRL must not enter the
    cache, and the next fill, after the rotation, does."""
    from fabric_tpu.validation.blockparse import parse_block as jparse
    from fabric_tpu_torch.validation.blockparse import parse_block as tparse

    raw = chain(world, 1, txs_per_block=1)[0]
    datas = wire.decode(fabric.BLOCK, raw)["data"]["data"]
    if package == "port":
        v = tval.BlockValidator("pipechan", world["net"].managers[False], ORACLE,
                                tval.ChaincodeRegistry())
        parsed = tparse(datas)
    else:
        v = jval.BlockValidator("pipechan", world["jmgr"][False], SW, jval.ChaincodeRegistry())
        parsed = jparse(datas)
    inside, rotated = threading.Event(), threading.Event()
    real = v.msp_manager.deserialize_identity
    calls = []

    def slow_deserialize(ibytes):
        calls.append(ibytes)
        if len(calls) == 1:
            inside.set()
            assert rotated.wait(10)
        return real(ibytes)

    v.msp_manager.deserialize_identity = slow_deserialize
    try:
        stage_a = threading.Thread(target=v.collect_sig_jobs, args=(parsed,))
        stage_a.start()
        assert inside.wait(10)
        v.invalidate_identity_caches()  # stage B, on this thread
        rotated.set()
        stage_a.join(10)
        assert calls[0] not in v._ident_cache
        v.collect_sig_jobs(parsed)
        assert v._ident_cache.get(calls[0]) is not None
    finally:
        v.msp_manager.deserialize_identity = real


def test_smoke_chain_through_batcher_and_device_mvcc_matches_jax(tmp_path, world):
    """chip_smoke.py's pipelined chain at a small size: linked headers (block
    0's previous hash empty), the conflict block's read conflicts, a flipped
    endorsement and a flipped creator signature a block, signed in spawned
    processes byte for byte as in process; pipelined through
    Channel(BatchingProvider(oracle), device_mvcc=True) on the CPU (K5's
    plain version), the batcher lingering so blocks share launches, against
    the JAX Channel: equal filters, commit hashes and `.chain` bytes, and
    the codes `chain_codes` expects. The phases that do not chain keep
    make_block's fixed previous hash."""
    from fabric_tpu_torch.parallel.batcher import BatchingProvider

    net, smoke = world["net"], world["smoke"]
    raws = net.chain(3, 20, conflict_block=2, invalid=2)
    assert smoke.build_chains(net, {"c": (3, 20, 2, smoke.CONFIG2_CHANNEL, 2)})["c"] == raws
    blocks = [port_block(r) for r in raws]
    assert blocks[0]["header"].get("previous_hash", b"") == b""
    for prev, b in zip(blocks, blocks[1:]):
        assert b["header"]["previous_hash"] == protoutil.block_header_hash(prev["header"])
    assert net.make_block([b"x"], 1)["header"]["previous_hash"] == b"\x33" * 32
    bp = BatchingProvider(MemoOracle(), linger_s=0.2)
    registry = tval.ChaincodeRegistry([tval.ChaincodeDefinition("benchcc", net.policy)])
    ch = Channel(smoke.CONFIG2_CHANNEL, str(tmp_path / "port"), net.managers[False], registry, bp,
                 device_mvcc=True, device="cpu")
    got, paths = [], []
    pipe = CommitPipeline(ch, on_commit=lambda b, f: (got.append(
        (f.tobytes(), b["metadata"]["metadata"][fabric.COMMIT_HASH])),
        paths.append(ch.ledger.last_mvcc_path)))
    try:
        for b in blocks:
            pipe.submit(b)
        assert pipe.drain(timeout=120) and pipe.last_error is None
    finally:
        pipe.stop()
        bp.stop()
        ch.ledger.close()
    assert bp.batcher.launches >= 1
    assert paths == ["device"] * 3
    want = jax_serial(world, tmp_path / "jax", raws, channel=smoke.CONFIG2_CHANNEL,
                      policy=smoke.CONFIG2_POLICY)
    assert got == want
    codes = [list(f) for f, _ in got]
    assert codes == [list(net.chain_codes(n, 20, n == 2, smoke.CONFIG2_CHANNEL, 2))
                     for n in range(3)]
    for number, c in enumerate(codes):
        # txs 3 and 13 flipped, one endorsement and one creator signature
        assert sorted((c[3], c[13])) == [smoke.MASK_CODES["bad_creator_sig"],
                                         smoke.MASK_CODES["bad_endorsement"]]
        conflicts = {9, 19} if number == 2 else set()
        assert [i for i, v in enumerate(c) if v == 11] == sorted(conflicts)
        assert all(v == 0 for i, v in enumerate(c) if i not in conflicts | {3, 13})
    assert (chain_bytes(tmp_path / "port", smoke.CONFIG2_CHANNEL)
            == chain_bytes(tmp_path / "jax", smoke.CONFIG2_CHANNEL))


def test_k2_dispatch_failure_after_retries_fails_closed(tmp_path, world):
    """A launch that keeps failing through a BatchingProvider: the batcher
    retries it under DISPATCH_POLICY, then the error reaches the block's
    resolver, stage B raises through on_error and last_error, and the
    height does not move."""
    from fabric_tpu_torch.common import fabobs
    from fabric_tpu_torch.parallel.batcher import BatchingProvider

    class Broken(MemoOracle):
        def batch_verify_async(self, keys, sigs, digests):
            raise ConnectionError("launch failed")

    raw = chain(world, 1)[0]
    with fabobs.obs_installed() as reg:
        bp = BatchingProvider(Broken())
        ch = port_channel(world, tmp_path, provider=bp)
        errors = []
        pipe = CommitPipeline(ch, on_error=lambda b, exc: errors.append(exc))
        try:
            pipe.submit(port_block(raw))
            assert pipe.drain(timeout=30)
        finally:
            pipe.stop()
            bp.stop()
            ch.ledger.close()
        assert reg.value("fabric_batcher_dispatch_retries_total") == 3
    assert [type(e) for e in errors] == [ConnectionError]
    assert isinstance(pipe.last_error, ConnectionError) and not pipe.dead
    assert ch.ledger.height == 0 and ch.ledger.block_store.height == 0


def test_k5_failure_on_the_committer_thread_fails_closed(tmp_path, world, monkeypatch):
    """K5 failing inside KVLedger.commit (device_mvcc) on the committer
    thread: nothing of the block is stored, the error is the pipeline's
    last_error, and the next delivery of the block commits it."""
    from fabric_tpu_torch.ledger import mvcc_device as md

    raws = chain(world, 2)
    registry = tval.ChaincodeRegistry([tval.ChaincodeDefinition("benchcc", tdsl(POLICY))])
    ch = Channel("pipechan", str(tmp_path), world["net"].managers[False], registry, ORACLE,
                 device_mvcc=True, device="cpu")
    real = md.resolve

    def failing(*args, **kw):
        raise RuntimeError("K5 launch failed")

    monkeypatch.setattr(md, "resolve", failing)
    pipe = CommitPipeline(ch)
    try:
        pipe.submit(port_block(raws[0]))
        assert pipe.drain(timeout=30)
        assert isinstance(pipe.last_error, RuntimeError)
        assert ch.ledger.height == 0
        assert (tmp_path / "pipechan.chain").read_bytes() == b""
        monkeypatch.setattr(md, "resolve", real)
        pipe.last_error = None
        for raw in raws:
            pipe.submit(port_block(raw))
        assert pipe.drain(timeout=30) and pipe.last_error is None
    finally:
        pipe.stop()
        ch.ledger.close()
    assert ch.ledger.height == 2
