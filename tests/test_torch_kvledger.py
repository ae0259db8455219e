"""The port's persistent KVLedger against the JAX package's, file for file.

A seeded chain of 5 blocks x 8 txs is minted by the port (chip_smoke.py's
config #2 network: Org1-3, OutOf(2, ...) on benchcc) with, in every block,
blind writes, an in-block read conflict, a read that is stale from block 2
on, a delete, a collection's hashed write whose cleartext is given for even
blocks and missing for odd ones, a second hashed write never given, an
invalid creator signature, and a metadata write in blocks 1 and 3. Each
package validates its own copy (the JAX validator over SoftwareProvider,
the port's over its P-256 oracle) and commits it through its KVLedger. The
`.chain` and `.pvtdata` files must be equal byte for byte, the rows of every
SQLite table equal, and so every TRANSACTIONS_FILTER, COMMIT_HASH slot and
query; then after reopening, after losing the SQLite file, after a chain
truncated behind the savepoint, after rollback(2) and rebuild_dbs(), and
after a child process of the port is killed in each of the six kill
windows at block 3 and the chain redelivered."""

import hashlib
import os
import pickle
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.ledger import kvledger as jkv
from fabric_tpu.ledger.blockstore import LedgerCorruptionError as JCorrupt
from fabric_tpu.ledger.pvtdatastore import MissingEntry as JMissing
from fabric_tpu.msp import identity as jid
from fabric_tpu.policy import from_dsl as jdsl
from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch.common.txflags import TxValidationCode as V
from fabric_tpu_torch.ledger import kvledger as tkv
from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.ledger.blockstore import LedgerCorruptionError as TCorrupt
from fabric_tpu_torch.ledger.pvtdatastore import MissingEntry as TMissing
from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
from fabric_tpu_torch.protos import fabric, wire

REPO = Path(__file__).resolve().parent.parent
SEED = 1017
N_BLOCKS, N_TXS = 5, 8
CC, COLL = "benchcc", "secret"
TABLES = ("state", "hashed", "pvt", "history", "meta", "confighistory")
KILL_SITES = (
    "blockstore.append.pre_fsync",
    "blockstore.append.post_fsync",
    "blockstore.append.pre_index",
    "kvledger.commit.pre_pvt",
    "kvledger.commit.post_block",
    "persistent.commit.mid",
)
KILL_AT = 3
# the codes of every block's txs, from the chain's construction
CODES = [
    [V.VALID, V.MVCC_READ_CONFLICT, V.VALID, V.VALID, V.VALID, V.VALID, V.VALID,
     V.BAD_CREATOR_SIGNATURE],
    [V.VALID, V.MVCC_READ_CONFLICT, V.VALID, V.VALID, V.VALID, V.VALID, V.VALID,
     V.BAD_CREATOR_SIGNATURE],
] + [
    [V.VALID, V.MVCC_READ_CONFLICT, V.MVCC_READ_CONFLICT, V.VALID, V.VALID, V.VALID, V.VALID,
     V.BAD_CREATOR_SIGNATURE]
] * 3


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def _hashed(key: str, value: bytes, delete: bool = False) -> rw.CollHashedRwSet:
    return rw.CollHashedRwSet(COLL, hashed_writes=(
        rw.KVWriteHash(_sha(key.encode()), delete, b"" if delete else _sha(value)),))


def _pvt_bytes(key: str, value: bytes, delete: bool = False) -> bytes:
    return wire.encode(wire.KV_RWSET, {"writes": [{"key": key, "is_delete": delete, "value": value}]})


def _tx_rwset(b: int, t: int):
    """Tx t of block b: its TxRwSet and its private data, (cleartext or
    None, a missing marker or not)."""
    reads, writes, md, colls = (), (), (), ()
    pvt, missing = None, False
    if t == 0:  # blind writes
        writes = (rw.KVWrite("hot", False, b"h%d" % b), rw.KVWrite(f"k{b}", False, b"k%d" % b))
    elif t == 1:  # reads what t0 of this block writes first: a conflict
        reads = (rw.KVRead("hot", rw.Version(b - 1, 0) if b else None),)
        writes = (rw.KVWrite(f"r{b}", False, b"r"),)
    elif t == 2:  # block 1 reads block 0's write; later blocks read it stale
        reads = (rw.KVRead("warm", rw.Version(0, 2)),) if b else ()
        writes = (rw.KVWrite("warm", False, b"w%d" % b),)
    elif t == 3:  # a delete of the previous block's k
        writes = (rw.KVWrite(f"k{b - 1}", True, b""),) if b else (rw.KVWrite("gone", False, b"g"),)
    elif t == 4:  # JSON values; a metadata write in blocks 1 and 3
        writes = (rw.KVWrite(f"m{b}", False, b'{"owner": "org%d", "n": %d}' % (b % 3, b)),)
        if b in (1, 3):
            md = (rw.KVMetadataWrite(f"k{b}", (("note", b"m%d" % b),)),)
    elif t == 5:  # a collection write, its cleartext given in even blocks
        if b == 4:
            colls, pvt = (_hashed("s2", b"", delete=True),), _pvt_bytes("s2", b"", delete=True)
        else:
            colls, pvt = (_hashed(f"s{b}", b"sv%d" % b),), _pvt_bytes(f"s{b}", b"sv%d" % b)
        if b % 2:
            pvt, missing = None, True
    elif t == 6:  # a collection write whose cleartext never comes
        colls, missing = (_hashed(f"p{b}", b"pv"),), True
    else:  # an invalid creator signature
        writes = (rw.KVWrite(f"x{b}", False, b"x"),)
    ns = rw.NsRwSet(CC, reads, writes, coll_hashed=colls, metadata_writes=md)
    return rw.TxRwSet((ns,)), pvt, missing


def build_chain(net):
    """[(raw block, {(tx, ns, coll): cleartext}, [(tx, ns, coll)] missing)]."""
    from fabric_tpu_torch.protos import protoutil

    out, prev = [], b""
    for b in range(N_BLOCKS):
        datas, pvt_data, missing = [], {}, []
        for t in range(N_TXS):
            txrw, pvt, miss = _tx_rwset(b, t)
            env = net.envelope(t, results=serialize_tx_rwset(txrw))
            if t == 7:
                env["signature"] = env["signature"][:-1] + bytes([env["signature"][-1] ^ 0x01])
            datas.append(wire.encode(fabric.ENVELOPE, env))
            if pvt is not None:
                pvt_data[(t, CC, COLL)] = pvt
            if miss:
                missing.append((t, CC, COLL))
        block = net.make_block(datas, b, prev)
        prev = protoutil.block_header_hash(block["header"])
        out.append((wire.encode(fabric.BLOCK, block), pvt_data, missing))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The chain validated by both packages: the validated block bytes
    (equal in both), their private data, and a JAX ledger that committed
    the whole chain uninterrupted."""
    import chip_smoke

    torch.set_num_threads(1)
    net = chip_smoke.Config2Net(seed=SEED)
    sw = SoftwareProvider()
    msps = [jid.MSP(jid.MSPConfig(c.msp_id, c.root_certs, admins=c.admins,
                                  revocation_list=c.revocation_list,
                                  node_ous=jid.NodeOUs(enable=c.node_ous.enable)), provider=sw)
            for c in net.msp_configs()]
    jvalidator = jval.BlockValidator(chip_smoke.CONFIG2_CHANNEL, jid.MSPManager(msps), sw,
                                     jval.ChaincodeRegistry([jval.ChaincodeDefinition(
                                         CC, jdsl(chip_smoke.CONFIG2_POLICY))]))
    tvalidator = net.validator(chip_smoke.oracle_provider())
    validated = []
    for raw, pvt_data, missing in build_chain(net):
        jb = common_pb2.Block.FromString(raw)
        want = jvalidator.validate(jb)
        tb = wire.decode(fabric.BLOCK, raw)
        got = tvalidator.validate(tb)
        assert got.tobytes() == want.tobytes()
        assert wire.encode(fabric.BLOCK, tb) == jb.SerializeToString()
        validated.append((wire.encode(fabric.BLOCK, tb), pvt_data, missing))
    jax_dir = tmp_path_factory.mktemp("jax-whole")
    commit_jax(jax_dir, validated)
    return {"blocks": validated, "jax_dir": jax_dir}


def commit_jax(path, blocks, device_mvcc=False, start=0, ledger=None):
    """Commit blocks[start:] through the JAX KVLedger; returns each block's
    (filter, COMMIT_HASH slot)."""
    own = ledger is None
    ledger = ledger or jkv.KVLedger(str(path), "benchchan", device_mvcc=device_mvcc)
    out = []
    try:
        for raw, pvt_data, missing in blocks[start:]:
            jb = common_pb2.Block.FromString(raw)
            flags = ledger.commit(jb, pvt_data=pvt_data,
                                  missing_pvt=[JMissing(*m) for m in missing])
            out.append((flags.tobytes(), jb.metadata.metadata[4]))
    finally:
        if own:
            ledger.close()
    return out


def commit_port(ledger, blocks, start=0):
    out = []
    for raw, pvt_data, missing in blocks[start:]:
        tb = wire.decode(fabric.BLOCK, raw)
        flags = ledger.commit(tb, pvt_data=pvt_data, missing_pvt=[TMissing(*m) for m in missing])
        out.append((flags.tobytes(), tb["metadata"]["metadata"][fabric.COMMIT_HASH]))
    return out


def port_ledger(path, device_mvcc=False):
    return tkv.KVLedger(str(path), "benchchan", device_mvcc=device_mvcc,
                        device="cpu" if device_mvcc else None)


def rows(path):
    db = sqlite3.connect(str(Path(path) / "benchchan.state.db"))
    try:
        return {t: db.execute(f"SELECT * FROM {t}").fetchall() for t in TABLES}
    finally:
        db.close()


def assert_same_ledger(port_dir, jax_dir):
    for suffix in (".chain", ".pvtdata"):
        got = (Path(port_dir) / f"benchchan{suffix}").read_bytes()
        want = (Path(jax_dir) / f"benchchan{suffix}").read_bytes()
        assert got == want, suffix
    got, want = rows(port_dir), rows(jax_dir)
    for table in TABLES:
        assert sorted(got[table]) == sorted(want[table]), table


@pytest.mark.parametrize("device_mvcc", [False, True])
def test_chain_files_rows_and_queries_match_jax(world, tmp_path, device_mvcc):
    """The whole chain through both ledgers: equal files, rows, per-block
    filters and commit hashes, queries; the port's K5 plain version runs
    for every block without a metadata write."""
    blocks = world["blocks"]
    jax_results = commit_jax(tmp_path / "jax", blocks, device_mvcc=device_mvcc)
    ledger = port_ledger(tmp_path / "port", device_mvcc)
    got, paths = [], []
    try:
        for i in range(N_BLOCKS):
            got += commit_port(ledger, blocks[i:i + 1])
            paths.append(ledger.last_mvcc_path)
        assert got == jax_results
        assert [[V(c) for c in f] for f, _ in got] == CODES
        assert paths == (["device", "host", "device", "host", "device"] if device_mvcc
                         else ["host"] * N_BLOCKS)
        jledger = jkv.KVLedger(str(tmp_path / "jax"), "benchchan")
        try:
            assert ledger.height == jledger.height == N_BLOCKS
            assert ledger.commit_hash == jledger.commit_hash
            txids = [wire.decode(fabric.CHANNEL_HEADER, wire.decode(fabric.PAYLOAD, wire.decode(
                fabric.ENVELOPE, d)["payload"])["header"]["channel_header"])["tx_id"]
                for d in wire.decode(fabric.BLOCK, blocks[2][0])["data"]["data"]]
            for txid in txids + ["absent"]:
                assert ledger.tx_exists(txid) == jledger.tx_exists(txid)
            for key in ("hot", "warm", "k0", "k2", "k4", "m1", "r3", "x2", "gone"):
                assert ledger.get_state(CC, key) == jledger.get_state(CC, key)
                assert ([(v.block_num, v.tx_num) for v in ledger.get_history_for_key(CC, key)]
                        == [(v.block_num, v.tx_num) for v in jledger.get_history_for_key(CC, key)])
            for key in ("s0", "s1", "s2", "s4", "p0"):
                assert ledger.get_private_data(CC, COLL, key) == jledger.get_private_data(CC, COLL, key)
            assert ledger.get_private_data(CC, COLL, "s0") == b"sv0"
            query = {"selector": {"owner": "org1"}}
            assert ledger.execute_query(CC, query) == jledger.execute_query(CC, query) != []
            assert (ledger.pvt_store.get_missing_pvt_data()
                    .keys() == jledger.pvt_store.get_missing_pvt_data().keys())
        finally:
            jledger.close()
    finally:
        ledger.close()
    assert_same_ledger(tmp_path / "port", tmp_path / "jax")


def test_reopen_replays_nothing(world, tmp_path):
    ledger = port_ledger(tmp_path)
    commit_port(ledger, world["blocks"])
    want_hash = ledger.commit_hash
    ledger.close()
    ledger = port_ledger(tmp_path)
    try:
        assert ledger.recovered_blocks == 0
        assert ledger.height == N_BLOCKS and ledger.commit_hash == want_hash
    finally:
        ledger.close()
    assert_same_ledger(tmp_path, world["jax_dir"])


def test_lost_state_db_replays_the_whole_chain(world, tmp_path):
    ledger = port_ledger(tmp_path)
    commit_port(ledger, world["blocks"])
    ledger.close()
    for suffix in ("", "-wal", "-shm"):
        (tmp_path / f"benchchan.state.db{suffix}").unlink(missing_ok=True)
    ledger = port_ledger(tmp_path)
    try:
        assert ledger.recovered_blocks == N_BLOCKS
        jledger = jkv.KVLedger(str(world["jax_dir"]), "benchchan")
        assert ledger.commit_hash == jledger.commit_hash
        jledger.close()
    finally:
        ledger.close()
    assert_same_ledger(tmp_path, world["jax_dir"])


def test_chain_truncated_behind_savepoint(world, tmp_path, monkeypatch):
    """A chain cut back to 3 blocks under a state db at savepoint 4: both
    packages refuse under strict recovery, and both rebuild the same state
    from the surviving chain when FABRIC_TPU_RECOVERY_STRICT=0."""
    for side in ("port", "jax"):
        ledger = port_ledger(tmp_path / side)
        commit_port(ledger, world["blocks"])
        cut = ledger.block_store._offsets[3]
        ledger.close()
        with open(tmp_path / side / "benchchan.chain", "r+b") as f:
            f.truncate(cut)
    with pytest.raises(TCorrupt, match="AHEAD"):
        port_ledger(tmp_path / "port")
    with pytest.raises(JCorrupt, match="AHEAD"):
        jkv.KVLedger(str(tmp_path / "jax"), "benchchan")
    monkeypatch.setenv("FABRIC_TPU_RECOVERY_STRICT", "0")
    ledger = port_ledger(tmp_path / "port")
    jledger = jkv.KVLedger(str(tmp_path / "jax"), "benchchan")
    try:
        assert ledger.height == jledger.height == 3
        assert ledger.recovered_blocks == 3
        assert ledger.commit_hash == jledger.commit_hash
    finally:
        ledger.close()
        jledger.close()
    assert_same_ledger(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("op", ["rollback", "rebuild_dbs"])
def test_admin_ops_match_jax(world, tmp_path, op):
    ledger = port_ledger(tmp_path / "port")
    commit_port(ledger, world["blocks"])
    jledger = jkv.KVLedger(str(tmp_path / "jax"), "benchchan")
    commit_jax(None, world["blocks"], ledger=jledger)
    try:
        if op == "rollback":
            ledger.rollback(2)
            jledger.rollback(2)
            assert ledger.height == jledger.height == 3
            # the rolled-back chain takes blocks 3 and 4 again
            assert commit_port(ledger, world["blocks"], 3) == commit_jax(
                None, world["blocks"], start=3, ledger=jledger)
        else:
            ledger.rebuild_dbs()
            jledger.rebuild_dbs()
        assert ledger.commit_hash == jledger.commit_hash
    finally:
        ledger.close()
        jledger.close()
    assert_same_ledger(tmp_path / "port", tmp_path / "jax")


_CHILD = r"""
import pickle, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch.ledger.kvledger import KVLedger
from fabric_tpu_torch.ledger.pvtdatastore import MissingEntry
from fabric_tpu_torch.protos import fabric, wire
blocks = pickle.loads(open(sys.argv[2], "rb").read())
ledger = KVLedger(sys.argv[3], "benchchan")
for raw, pvt_data, missing in blocks:
    ledger.commit(wire.decode(fabric.BLOCK, raw), pvt_data=pvt_data,
                  missing_pvt=[MissingEntry(*m) for m in missing])
ledger.close()
"""


@pytest.fixture(scope="module")
def killed(world, tmp_path_factory):
    """One child process of the port a kill window, all started together:
    each commits the chain and dies in its window at block 3."""
    root = tmp_path_factory.mktemp("killed")
    blob = root / "blocks.pickle"
    blob.write_bytes(pickle.dumps(world["blocks"]))
    procs = {}
    for site in KILL_SITES:
        env = {**os.environ, "FABRIC_TPU_CRASH_SITES": f"{site}@{KILL_AT}"}
        env.pop("FABRIC_TPU_FAULTS", None)
        procs[site] = subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(REPO), str(blob), str(root / site)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for site, proc in procs.items():
        _, err = proc.communicate(timeout=240)
        out[site] = (proc.returncode, err.decode(errors="replace"), root / site)
    return out


@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_window_then_redelivery_matches_uninterrupted_jax(world, killed, site):
    rc, err, path = killed[site]
    assert rc == 137, err
    ledger = port_ledger(path)
    try:
        height = ledger.height
        # the window decides how much of block 3 survived the kill
        assert height == (KILL_AT if site in ("blockstore.append.pre_fsync",
                                              "kvledger.commit.pre_pvt") else KILL_AT + 1)
        commit_port(ledger, world["blocks"], height)
        assert ledger.height == N_BLOCKS
        jledger = jkv.KVLedger(str(world["jax_dir"]), "benchchan")
        assert ledger.commit_hash == jledger.commit_hash
        jledger.close()
    finally:
        ledger.close()
    assert_same_ledger(path, world["jax_dir"])


def test_block_header_helpers_match_jax():
    """block_header_bytes / _hash and block_data_hash byte for byte, on
    seeded headers with number 0, an empty previous hash and a number
    above 2^32; the Metadata message of the COMMIT_HASH slot."""
    import random

    from fabric_tpu.protos import protoutil as jpu
    from fabric_tpu_torch.protos import protoutil as tpu

    rng = random.Random(SEED)
    numbers = [0, 1, 127, 128, 255, 256, 2**31, 2**32 + 7, 2**63 - 1] + [
        rng.randrange(2**40) for _ in range(8)]
    for n in numbers:
        prev = rng.choice([b"", rng.randbytes(32), rng.randbytes(rng.randrange(1, 300))])
        data = [rng.randbytes(rng.randrange(0, 200)) for _ in range(rng.randrange(0, 4))]
        header = {"number": n, "previous_hash": prev,
                  "data_hash": tpu.block_data_hash({"data": data})}
        jh = common_pb2.BlockHeader(number=n, previous_hash=prev,
                                    data_hash=jpu.block_data_hash(common_pb2.BlockData(data=data)))
        assert header["data_hash"] == jh.data_hash
        assert tpu.block_header_bytes(header) == jpu.block_header_bytes(jh)
        assert tpu.block_header_hash(header) == jpu.block_header_hash(jh)
        # a header as wire.decode gives it: absent fields are defaults
        decoded = wire.decode(fabric.BLOCK_HEADER, jh.SerializeToString())
        assert tpu.block_header_hash(decoded) == jpu.block_header_hash(jh)
        h = rng.randbytes(32)
        assert wire.encode(fabric.METADATA, {"value": h}) == common_pb2.Metadata(
            value=h).SerializeToString()
    assert fabric.COMMIT_HASH == common_pb2.COMMIT_HASH
    assert wire.encode(fabric.METADATA, {"value": b""}) == common_pb2.Metadata().SerializeToString()


def test_extract_tx_ids_and_pvt_screening_match_jax(world):
    """The block store's txid extraction on valid, nil and unparsable
    envelopes, and pvt_data_matches_hashes on matching, foreign, tampered
    and garbled cleartext, against the JAX functions."""
    from fabric_tpu.ledger.blockstore import extract_tx_ids as jextract
    from fabric_tpu.ledger.txparse import parse_transaction as jparse
    from fabric_tpu_torch.ledger.blockstore import extract_tx_ids as textract
    from fabric_tpu_torch.ledger.txparse import parse_transaction as tparse

    raw = world["blocks"][0][0]
    block = wire.decode(fabric.BLOCK, raw)
    block["data"]["data"] += [b"", b"\x0a\x05abc", b"\x0a\x03\x0a\x01\xff", b"\xff"]
    jb = common_pb2.Block.FromString(wire.encode(fabric.BLOCK, block))
    assert textract(block) == jextract(jb)
    assert textract(block)[-4:] == ["", "", "", ""]
    data = block["data"]["data"][5]
    trw, jrw = tparse(5, data).rwset, jparse(5, data).rwset
    cases = [_pvt_bytes("s0", b"sv0"), _pvt_bytes("s0", b"tampered"), _pvt_bytes("zz", b"x"),
             _pvt_bytes("s0", b"", delete=True), b"\xff\xff", b""]
    for ns, coll in ((CC, COLL), (CC, "other"), ("otherns", COLL)):
        got = [tkv.pvt_data_matches_hashes(trw, ns, coll, c) for c in cases]
        assert got == [jkv.pvt_data_matches_hashes(jrw, ns, coll, c) for c in cases]
    assert tkv.pvt_data_matches_hashes(trw, CC, COLL, cases[0])


def test_device_mvcc_ledger_needs_a_device_or_cpu(tmp_path):
    """device_mvcc without a device resolves to the card: without one it
    raises at construction, never running on the CPU; no device_mvcc needs
    no card, and neither does a state mirror (tests/test_torch_statecouch.py
    holds what the mirror receives)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.KVLedger(str(tmp_path / "a"), "benchchan", device_mvcc=True)
    tkv.KVLedger(str(tmp_path / "b"), "benchchan").close()
    mirror = object()
    ledger = tkv.KVLedger(str(tmp_path / "c"), "benchchan", state_mirror=mirror)
    assert ledger.state_mirror is mirror
    ledger.close()


def test_in_memory_ledger_matches_jax(world, tmp_path):
    """persistent=False: the block store and private-data store on disk,
    state and history in memory; the same files, filters, commit hashes,
    states and histories as the JAX in-memory ledger, after a reopen that
    replays the whole chain and after rebuild_dbs()."""
    blocks = world["blocks"]
    ledger = tkv.KVLedger(str(tmp_path / "port"), "benchchan", persistent=False)
    jledger = jkv.KVLedger(str(tmp_path / "jax"), "benchchan", persistent=False)
    try:
        assert commit_port(ledger, blocks) == commit_jax(None, blocks, ledger=jledger)
    finally:
        ledger.close()
        jledger.close()
    for suffix in (".chain", ".pvtdata"):
        assert ((tmp_path / "port" / f"benchchan{suffix}").read_bytes()
                == (tmp_path / "jax" / f"benchchan{suffix}").read_bytes())
    assert not (tmp_path / "port" / "benchchan.state.db").exists()
    ledger = tkv.KVLedger(str(tmp_path / "port"), "benchchan", persistent=False)
    jledger = jkv.KVLedger(str(tmp_path / "jax"), "benchchan", persistent=False)
    try:
        for reopened in (True, False):
            if not reopened:
                ledger.rebuild_dbs()
                jledger.rebuild_dbs()
            assert ledger.recovered_blocks == N_BLOCKS
            assert ledger.commit_hash == jledger.commit_hash
            for key in ("hot", "warm", "k0", "k4", "m1", "m2"):
                assert ledger.get_state(CC, key) == jledger.get_state(CC, key)
                assert ([(v.block_num, v.tx_num) for v in ledger.get_history_for_key(CC, key)]
                        == [(v.block_num, v.tx_num) for v in jledger.get_history_for_key(CC, key)])
            for key in ("s0", "s2", "s4"):
                assert ledger.get_private_data(CC, COLL, key) == jledger.get_private_data(CC, COLL, key)
            query = {"selector": {"owner": "org2"}}
            assert ledger.execute_query(CC, query) == jledger.execute_query(CC, query) != []
    finally:
        ledger.close()
        jledger.close()
