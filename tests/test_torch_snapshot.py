"""The port's ledger snapshots (ledger/snapshot), join by snapshot
(BlockStore.bootstrap_from_snapshot) and history (ledger/history) against
the JAX package's.

tests/test_torch_kvledger.py's seeded chain (private data given and missing,
deletes, metadata writes, a stale read, a bad creator signature) commits its
first two blocks into a ledger of each package. Both snapshot at height 2:
the three data files and `_snapshot_signable_metadata.json` are equal byte
for byte, and `verify_snapshot` refuses a tampered copy in both. Each package
joins a new ledger from its snapshot: the `.base` and `.pretxids` sidecars
and the SQLite rows are equal; after the chain's three remaining blocks the
filters, commit hashes (which start again from the empty hash at the join,
in both packages), `.chain`, `.pvtdata` and rows are equal; a block that
resubmits a pre-snapshot transaction is coded DUPLICATE_TXID by both
validators; `rebuild_dbs` and `rollback` raise the same errors; and a second
snapshot of the joined ledgers is equal too. `SnapshotRequestManager`'s
accepted and refused requests match, and so do `get_history_for_key`'s
KeyModifications. Last, an export that a commit overtakes between its reads
mixes two heights in both packages alike (the reference's behaviour)."""

import shutil
import sqlite3
from pathlib import Path

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.ledger import history as jhist
from fabric_tpu.ledger import kvledger as jkv
from fabric_tpu.ledger import snapshot as jsnap
from fabric_tpu.msp import identity as jid
from fabric_tpu.policy import from_dsl as jdsl
from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch.common.txflags import TxValidationCode as V
from fabric_tpu_torch.ledger import history as thist
from fabric_tpu_torch.ledger import kvledger as tkv
from fabric_tpu_torch.ledger import snapshot as tsnap
from fabric_tpu_torch.protos import fabric, protoutil, wire
from test_torch_kvledger import (  # noqa: F401
    CC, COLL, N_BLOCKS, SEED, TABLES, commit_jax, commit_port, world)

AT = 2  # the snapshot's height: blocks 0 and 1 before it, 2-4 after
FILES = (tsnap.PUBLIC_STATE, tsnap.PVT_HASHES, tsnap.TXIDS, tsnap.SIGNABLE_METADATA)


def rows(path):
    """Every row of a ledger's SQLite tables (the history table included),
    sorted."""
    db = sqlite3.connect(str(Path(path) / "benchchan.state.db"))
    try:
        return {t: sorted(db.execute(f"SELECT * FROM {t}").fetchall()) for t in TABLES}
    finally:
        db.close()


def snapshot_bytes(path):
    return {name: (Path(path) / name).read_bytes() for name in FILES}


def ledger_files(path, suffixes=(".chain", ".pvtdata", ".chain.base", ".chain.pretxids")):
    return {s: (Path(path) / f"benchchan{s}").read_bytes() for s in suffixes
            if (Path(path) / f"benchchan{s}").exists()}


def _dup_block(world, joined_height, prev_hash):
    """A block at the joined height whose one tx is block 0's first tx again
    (a pre-snapshot TxID), as raw bytes."""
    old = wire.decode(fabric.BLOCK, world["blocks"][0][0])
    block = protoutil.new_block(joined_height, prev_hash)
    block["data"]["data"] = [old["data"]["data"][0]]
    return wire.encode(fabric.BLOCK, protoutil.seal_block(block))


def _validators():
    """The chain's validators in both packages (chip_smoke.Config2Net at
    the chain's seed: the same MSPs and policy)."""
    import chip_smoke

    net = chip_smoke.Config2Net(seed=SEED)
    sw = SoftwareProvider()
    jmgr = jid.MSPManager([
        jid.MSP(jid.MSPConfig(c.msp_id, c.root_certs, admins=c.admins,
                              revocation_list=c.revocation_list,
                              node_ous=jid.NodeOUs(enable=c.node_ous.enable)), provider=sw)
        for c in net.msp_configs()])
    jreg = jval.ChaincodeRegistry([jval.ChaincodeDefinition(CC, jdsl(chip_smoke.CONFIG2_POLICY))])

    def jvalidator(tx_exists):
        return jval.BlockValidator(chip_smoke.CONFIG2_CHANNEL, jmgr, sw, jreg, tx_exists=tx_exists)

    def tvalidator(tx_exists):
        v = net.validator(chip_smoke.oracle_provider())
        v.tx_exists = tx_exists
        return v

    return jvalidator, tvalidator


@pytest.fixture(scope="module")
def run(world, tmp_path_factory):  # noqa: F811
    """Everything the tests read: both source ledgers snapshot at height 2,
    both join, commit blocks 2-4 and the duplicate block, and snapshot
    again."""
    root = tmp_path_factory.mktemp("snapshots")
    blocks = world["blocks"]
    out = {"root": root}
    tsrc = tkv.KVLedger(str(root / "port-src"), "benchchan")
    commit_port(tsrc, blocks[:AT])
    commit_jax(root / "jax-src", blocks[:AT])
    jsrc = jkv.KVLedger(str(root / "jax-src"), "benchchan")
    try:
        out["meta"] = (tsnap.generate_snapshot(tsrc, str(root / "port-snap")),
                       jsnap.generate_snapshot(jsrc, str(root / "jax-snap")))
    finally:
        tsrc.close()
        jsrc.close()
    tsnap.create_from_snapshot(str(root / "port-snap"), str(root / "port-join")).close()
    jsnap.create_from_snapshot(str(root / "jax-snap"), str(root / "jax-join")).close()
    out["joined_files"] = (ledger_files(root / "port-join"), ledger_files(root / "jax-join"))
    out["joined_rows"] = (rows(root / "port-join"), rows(root / "jax-join"))

    # the peer's way: the stores built, then the ledger reopened
    tj = tkv.KVLedger(str(root / "port-join"), "benchchan")
    jj = jkv.KVLedger(str(root / "jax-join"), "benchchan")
    try:
        out["reopen"] = (tj.height, tj.recovered_blocks, tj.commit_hash)
        out["results"] = (commit_port(tj, blocks, AT), commit_jax(None, blocks, start=AT, ledger=jj))
        jvalidator, tvalidator = _validators()
        raw = _dup_block(world, tj.height, tj.block_store.last_block_hash)
        tb, jb = wire.decode(fabric.BLOCK, raw), common_pb2.Block.FromString(raw)
        out["dup_codes"] = (tvalidator(tj.tx_exists).validate(tb).tobytes(),
                            jvalidator(jj.tx_exists).validate(jb).tobytes())
        out["dup_results"] = (tj.commit(tb).tobytes(), jj.commit(jb).tobytes(),
                              tb["metadata"]["metadata"][fabric.COMMIT_HASH],
                              jb.metadata.metadata[common_pb2.COMMIT_HASH])
        out["admin"] = []
        for ledger in (tj, jj):
            errors = []
            for op in (ledger.rebuild_dbs, lambda ledger=ledger: ledger.rollback(AT + 1)):
                with pytest.raises(ValueError) as exc:
                    op()
                errors.append(str(exc.value))
            out["admin"].append(errors)
        out["meta2"] = (tsnap.generate_snapshot(tj, str(root / "port-snap2")),
                        jsnap.generate_snapshot(jj, str(root / "jax-snap2")))
        out["height"] = (tj.height, jj.height)
    finally:
        tj.close()
        jj.close()
    return out


def test_snapshot_files_equal_jax(run):
    root = run["root"]
    assert run["meta"][0] == run["meta"][1]
    assert run["meta"][0]["last_block_number"] == AT - 1
    assert snapshot_bytes(root / "port-snap") == snapshot_bytes(root / "jax-snap")
    assert tsnap.verify_snapshot(str(root / "port-snap")) == run["meta"][0]
    assert jsnap.verify_snapshot(str(root / "port-snap")) == run["meta"][0]
    assert tsnap.verify_snapshot(str(root / "jax-snap")) == run["meta"][0]


@pytest.mark.parametrize("name", [tsnap.PUBLIC_STATE, tsnap.PVT_HASHES, tsnap.TXIDS])
def test_verify_snapshot_detects_tampering_in_both(run, tmp_path, name):
    for side, verify in (("port-snap", tsnap.verify_snapshot), ("jax-snap", jsnap.verify_snapshot)):
        copy = tmp_path / side
        shutil.copytree(run["root"] / side, copy)
        with open(copy / name, "ab") as f:
            f.write(b"junk")
        with pytest.raises(ValueError, match=f"snapshot file {name} hash mismatch"):
            verify(str(copy))
        with pytest.raises(ValueError, match="hash mismatch"):
            tsnap.create_from_snapshot(str(copy), str(tmp_path / f"{side}-join"))


def test_join_sidecars_and_rows_equal_jax(run):
    tfiles, jfiles = run["joined_files"]
    assert tfiles == jfiles
    # the block store and the pvt store start empty beside the sidecars
    assert {k for k, v in tfiles.items() if v} == {".chain.base", ".chain.pretxids"}
    assert tfiles[".chain.base"].split(b"\n")[0] == str(AT).encode()
    assert run["joined_rows"][0] == run["joined_rows"][1]
    # the reopen neither replays nor clears: height 2, nothing replayed, and
    # the commit-hash chain starts again from the empty hash
    assert run["reopen"] == (AT, 0, b"")


def test_joined_ledger_commits_as_jax(run):
    tres, jres = run["results"]
    assert tres == jres
    assert [[V(c) for c in f] for f, _ in tres] == [
        [V.VALID, V.MVCC_READ_CONFLICT, V.MVCC_READ_CONFLICT, V.VALID, V.VALID, V.VALID,
         V.VALID, V.BAD_CREATOR_SIGNATURE]] * (N_BLOCKS - AT)
    root = run["root"]
    assert ledger_files(root / "port-join") == ledger_files(root / "jax-join")
    assert rows(root / "port-join") == rows(root / "jax-join")


def test_commit_hash_restarts_at_the_join(run, world):  # noqa: F811
    """The joined chain's commit hashes are the JAX joined ledger's, not the
    uninterrupted chain's (the snapshot carries no commit hash)."""
    whole = commit_jax(run["root"] / "jax-whole", world["blocks"])
    assert [h for _, h in run["results"][0]] != [h for _, h in whole[AT:]]
    assert [f for f, _ in run["results"][0]] == [f for f, _ in whole[AT:]]


def test_pre_snapshot_txid_is_duplicate_in_both(run):
    tcodes, jcodes = run["dup_codes"]
    assert tcodes == jcodes == bytes([V.DUPLICATE_TXID])
    tflags, jflags, thash, jhash = run["dup_results"]
    assert tflags == jflags == bytes([V.DUPLICATE_TXID]) and thash == jhash
    assert run["height"] == (N_BLOCKS + 1, N_BLOCKS + 1)


def test_rebuild_and_rollback_raise_in_both(run):
    terrors, jerrors = run["admin"]
    assert terrors == jerrors
    assert "snapshot-bootstrapped" in terrors[0] and "snapshot-bootstrapped" in terrors[1]


def test_second_generation_snapshot_equal(run):
    root = run["root"]
    assert run["meta2"][0] == run["meta2"][1]
    assert run["meta2"][0]["last_block_number"] == N_BLOCKS
    assert snapshot_bytes(root / "port-snap2") == snapshot_bytes(root / "jax-snap2")


def _requests(snapshot_mod, ledger, root, commit_next):
    """A fixed sequence of requests on a manager over `ledger` at height 2:
    each outcome (a height, a pending list, or the error's message)."""
    mgr = snapshot_mod.SnapshotRequestManager(ledger, str(root))
    out = []
    for call in (lambda: mgr.submit(0), lambda: mgr.submit(AT - 1), lambda: mgr.submit(AT),
                 lambda: mgr.submit(AT + 2), mgr.pending, lambda: mgr.cancel(AT + 1),
                 lambda: mgr.cancel(AT + 2), mgr.pending, lambda: mgr.submit(AT + 2),
                 lambda: mgr.on_block_committed(wait=True), mgr.pending):
        try:
            out.append(call())
        except ValueError as exc:
            out.append(("error", str(exc)))
    commit_next()
    mgr.on_block_committed(wait=True)
    out.append(mgr.pending())
    out.append(sorted(mgr.generated))
    return out, mgr.generated


def test_snapshot_request_manager_matches_jax(world, tmp_path):  # noqa: F811
    blocks = world["blocks"]
    tl = tkv.KVLedger(str(tmp_path / "port"), "benchchan")
    commit_port(tl, blocks[:AT])
    commit_jax(tmp_path / "jax", blocks[:AT])
    jl = jkv.KVLedger(str(tmp_path / "jax"), "benchchan")
    try:
        tout, tgen = _requests(tsnap, tl, tmp_path / "port-snaps",
                               lambda: commit_port(tl, blocks[AT:AT + 1]))
        jout, jgen = _requests(jsnap, jl, tmp_path / "jax-snaps",
                               lambda: commit_jax(None, blocks[AT:AT + 1], ledger=jl))
    finally:
        tl.close()
        jl.close()
    assert tout == jout
    assert [o for o in tout if isinstance(o, tuple)] == [
        ("error", f"requested snapshot height {AT - 1} cannot be less than the current height {AT}"),
        ("error", f"duplicate snapshot request for height {AT}"),
        ("error", f"no snapshot request exists for height {AT + 1}")]
    assert tout[-1] == [AT] and tout[-2] == [AT + 2]
    assert snapshot_bytes(tgen[AT]) == snapshot_bytes(jgen[AT])
    assert Path(tgen[AT]) == tmp_path / "port-snaps" / "benchchan" / str(AT)


def test_history_key_modifications_equal(world, tmp_path):  # noqa: F811
    """get_history_for_key on the whole chain, deletes included, newest
    first, against the JAX ledger that committed it."""
    ledger = tkv.KVLedger(str(tmp_path), "benchchan")
    commit_port(ledger, world["blocks"])
    jledger = jkv.KVLedger(str(world["jax_dir"]), "benchchan")
    try:
        seen_delete = False
        for key in ("hot", "warm", "k0", "k1", "k3", "m1", "r2", "x1", "gone", "absent"):
            got = [(m.tx_id, (m.version.block_num, m.version.tx_num), m.value, m.is_delete)
                   for m in thist.get_history_for_key(ledger, CC, key)]
            want = [(m.tx_id, (m.version.block_num, m.version.tx_num), m.value, m.is_delete)
                    for m in jhist.get_history_for_key(jledger, CC, key)]
            assert got == want, key
            assert [v for _, v, _, _ in got] == sorted((v for _, v, _, _ in got), reverse=True)
            seen_delete |= any(d for *_, d in got)
        assert seen_delete
        assert len(thist.get_history_for_key(ledger, CC, "hot")) == N_BLOCKS
    finally:
        ledger.close()
        jledger.close()


def test_export_overtaken_by_a_commit_mixes_heights_in_both(world, tmp_path):  # noqa: F811
    """generate_snapshot reads the state table, then the hashed table, then
    the height, each on its own: a commit between the reads (what
    on_block_committed(wait=False) allows, its export on a thread beside
    the committer) gives metadata of the later height over the earlier
    state, and verify_snapshot accepts it. Both packages do the same."""
    blocks = world["blocks"]
    out = []
    for side, snapshot_mod, make, commit in (
            ("port", tsnap, lambda p: tkv.KVLedger(str(p), "benchchan"), commit_port),
            ("jax", jsnap, lambda p: jkv.KVLedger(str(p), "benchchan"),
             lambda ledger, bs: commit_jax(None, bs, ledger=ledger))):
        ledger = make(tmp_path / side)
        try:
            commit(ledger, blocks[:AT])
            real = ledger.state_db.iter_all_hashed

            def overtaken(ledger=ledger, real=real, commit=commit):
                commit(ledger, blocks[AT:AT + 1])  # the committer runs here
                return real()

            ledger.state_db.iter_all_hashed = overtaken
            meta = snapshot_mod.generate_snapshot(ledger, str(tmp_path / f"{side}-snap"))
            snapshot_mod.verify_snapshot(str(tmp_path / f"{side}-snap"))
        finally:
            ledger.close()
        out.append((meta, snapshot_bytes(tmp_path / f"{side}-snap")))
    assert out[0] == out[1]
    meta, files = out[0]
    assert meta["last_block_number"] == AT  # the later height ...
    # ... over the earlier public state: block 2's blind write of "hot" is
    # absent, block 1's is there
    assert b"h%d" % (AT - 1) in files[tsnap.PUBLIC_STATE]
    assert b"h%d" % AT not in files[tsnap.PUBLIC_STATE]
