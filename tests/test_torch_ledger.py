"""The port's ledger path against the JAX package: wire codec, rwset parse and
serialize, Merkle summaries, metadata, update bytes and the commit hash.

The JAX side reaches protobuf (`protoutil.unmarshal`, `SerializeToString`);
the port's side goes through its hand-written codec (`protos/wire.py`).
Every comparison is exact: parsed rwsets equal field for field, bytes equal
byte for byte, the same inputs raise in both or in neither, and the chained
commit hash is the same digest. Inputs come from fixed numpy seeds.
"""

import dataclasses

import numpy as np
import pytest

from fabric_tpu.common.txflags import TxValidationCode as JCode
from fabric_tpu.ledger import kvledger as jkv
from fabric_tpu.ledger import merkle as jmerkle
from fabric_tpu.ledger import mvcc as jmvcc
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.ledger import statedb as jdb
from fabric_tpu.ledger.rwset_proto import serialize_tx_rwset as jserialize
from fabric_tpu.ledger.txparse import parse_tx_rwset as jparse
from fabric_tpu.protos import common_pb2, kv_rwset_pb2, protoutil, rwset_pb2, txmgr_updates_pb2
from fabric_tpu_torch.common.txflags import TxValidationCode
from fabric_tpu_torch.ledger import kvledger as tkv
from fabric_tpu_torch.ledger import merkle as tmerkle
from fabric_tpu_torch.ledger import mvcc as tmvcc
from fabric_tpu_torch.ledger import rwset as trw
from fabric_tpu_torch.ledger import statedb as tdb
from fabric_tpu_torch.ledger.mvcc_device import DeviceValidator, ResidentDeviceValidator
from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset as tserialize
from fabric_tpu_torch.ledger.txparse import parse_tx_rwset as tparse
from fabric_tpu_torch.protos import wire

# ---------------------------------------------------------------------------
# Helpers shared with test_torch_mvcc
# ---------------------------------------------------------------------------


def to_port(obj):
    """A JAX `ledger.rwset` object tree as the port's dataclasses."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(trw, type(obj).__name__)
        return cls(*(to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)))
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    return obj


def batch_dict(batch):
    """An update batch of either package as plain values."""
    return {
        key: (e.value, (e.version.block_num, e.version.tx_num), e.metadata)
        for key, e in batch.items()
    }


def seeded_dbs(n_keys=40, n_colls=2):
    """The same committed state in both packages (test_mvcc_device.seeded_db)."""
    out = []
    for db_mod, rw in ((jdb, jrw), (tdb, trw)):
        db = db_mod.VersionedDB()
        seed = db_mod.UpdateBatch()
        for i in range(n_keys):
            seed.put("cc", f"k{i}", b"v0", rw.Version(0, i))
        hseed = db_mod.HashedUpdateBatch()
        for c in range(n_colls):
            for i in range(n_keys // 2):
                hseed.put("cc", f"coll{c}", f"h{i}".encode(), b"\x01" * 32, rw.Version(0, i))
        db.apply_updates(seed, hashed=hseed)
        out.append(db)
    return out


_KEY_CHARS = list("abcxyz019_") + ["é", "ключ", "中", "\U0001f600", "\x00"]


def _key(rng, short=False):
    n = int(rng.integers(0 if not short else 1, 6))
    return "".join(_KEY_CHARS[int(i)] for i in rng.integers(0, len(_KEY_CHARS), n))


def _bytes(rng, max_len=8):
    return bytes(rng.integers(0, 256, int(rng.integers(0, max_len + 1)), dtype=np.uint8))


def _version(rng):
    roll = rng.random()
    if roll < 0.25:
        return None
    if roll < 0.4:
        return jrw.Version(0, 0)  # present but empty on the wire
    if roll < 0.5:
        return jrw.Version(2**64 - 1, int(rng.integers(0, 2**40)))
    return jrw.Version(int(rng.integers(0, 1000)), int(rng.integers(0, 1000)))


def _entries(rng):
    if rng.random() < 0.3:
        return None
    return tuple((_key(rng), _bytes(rng)) for _ in range(int(rng.integers(1, 3))))


def random_tx_rwset(rng) -> jrw.TxRwSet:
    """A JAX TxRwSet over every shape the wire carries: absent, present-but-
    empty and set versions, raw-read and Merkle range queries, metadata
    writes with and without entries, hashed collections."""
    ns_sets = []
    for _ in range(int(rng.integers(0, 3))):
        reads = tuple(jrw.KVRead(_key(rng), _version(rng)) for _ in range(int(rng.integers(0, 4))))
        writes = tuple(
            jrw.KVWrite(_key(rng), bool(rng.random() < 0.3), _bytes(rng))
            for _ in range(int(rng.integers(0, 4)))
        )
        rqs = []
        for _ in range(int(rng.integers(0, 3))):
            if rng.random() < 0.5:
                raw = tuple(jrw.KVRead(_key(rng), _version(rng)) for _ in range(int(rng.integers(0, 3))))
                rqs.append(jrw.RangeQueryInfo(_key(rng), _key(rng), bool(rng.random() < 0.5), raw))
            else:
                summary = (
                    int(rng.integers(0, 2**32)), int(rng.integers(0, 5)),
                    tuple(_bytes(rng, 32) for _ in range(int(rng.integers(0, 3)))),
                )
                rqs.append(jrw.RangeQueryInfo(_key(rng), _key(rng), bool(rng.random() < 0.5), (), summary))
        md = tuple(jrw.KVMetadataWrite(_key(rng), _entries(rng)) for _ in range(int(rng.integers(0, 2))))
        colls = []
        for _ in range(int(rng.integers(0, 3))):
            colls.append(jrw.CollHashedRwSet(
                _key(rng, short=True),
                tuple(jrw.KVReadHash(_bytes(rng), _version(rng)) for _ in range(int(rng.integers(0, 3)))),
                tuple(
                    jrw.KVWriteHash(_bytes(rng), bool(rng.random() < 0.3), _bytes(rng))
                    for _ in range(int(rng.integers(0, 3)))
                ),
                tuple(
                    jrw.KVMetadataWriteHash(_bytes(rng), _entries(rng))
                    for _ in range(int(rng.integers(0, 2)))
                ),
            ))
        ns_sets.append(jrw.NsRwSet(_key(rng), reads, writes, tuple(rqs), tuple(colls), md))
    return jrw.TxRwSet(tuple(ns_sets))


def _outcome(parse, raw):
    try:
        return ("ok", parse(raw))
    except ValueError:
        return ("raises", None)


# ---------------------------------------------------------------------------
# rwset parse and serialize
# ---------------------------------------------------------------------------

SEEDS = list(range(12))


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_and_serialize_match_protobuf(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(8):
        tx = random_tx_rwset(rng)
        raw = jserialize(tx)
        assert tserialize(to_port(tx)) == raw
        assert tparse(raw) == to_port(jparse(raw))


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_corrupted_rwsets_raise_alike(seed):
    """Every truncation, and seeded byte flips, insertions and deletions, of
    the outer message and of the nested KVRWSet / HashedRWSet bytes: the
    port raises exactly where protoutil.unmarshal raises, and parses to the
    same rwset elsewhere."""
    rng = np.random.default_rng(2000 + seed)
    tx = random_tx_rwset(rng)
    while not tx.ns_rw_sets:
        tx = random_tx_rwset(rng)
    raw = jserialize(tx)
    outer = rwset_pb2.TxReadWriteSet.FromString(raw)
    variants = [raw[:n] for n in range(len(raw))]
    for _ in range(150):
        b = bytearray(raw)
        pos = int(rng.integers(0, len(b)))
        op = rng.random()
        if op < 0.5:
            b[pos] = int(rng.integers(0, 256))
        elif op < 0.75:
            b.insert(pos, int(rng.integers(0, 256)))
        else:
            del b[pos]
        variants.append(bytes(b))
    # corrupt the nested messages inside an otherwise well-formed envelope
    for _ in range(100):
        msg = rwset_pb2.TxReadWriteSet()
        msg.CopyFrom(outer)
        ns = msg.ns_rwset[int(rng.integers(0, len(msg.ns_rwset)))]
        target = ns
        field = "rwset"
        if ns.collection_hashed_rwset and rng.random() < 0.5:
            target = ns.collection_hashed_rwset[int(rng.integers(0, len(ns.collection_hashed_rwset)))]
            field = "hashed_rwset"
        inner = bytearray(getattr(target, field))
        if inner:
            pos = int(rng.integers(0, len(inner)))
            if rng.random() < 0.5:
                inner[pos] = int(rng.integers(0, 256))
            else:
                inner = inner[:pos]
        setattr(target, field, bytes(inner))
        variants.append(msg.SerializeToString())
    raised = 0
    for v in variants:
        want = _outcome(jparse, v)
        got = _outcome(tparse, v)
        assert got[0] == want[0], v.hex()
        if want[0] == "ok":
            assert got[1] == to_port(want[1]), v.hex()
        else:
            raised += 1
    assert raised > 0


# ---------------------------------------------------------------------------
# The wire reader itself, message by message
# ---------------------------------------------------------------------------

_PB = {
    "TxReadWriteSet": (rwset_pb2.TxReadWriteSet, wire.TX_RWSET),
    "KVRWSet": (kv_rwset_pb2.KVRWSet, wire.KV_RWSET),
    "HashedRWSet": (kv_rwset_pb2.HashedRWSet, wire.HASHED_RWSET),
    "RangeQueryInfo": (kv_rwset_pb2.RangeQueryInfo, wire.RANGE_QUERY_INFO),
    "KVMetadataWrite": (kv_rwset_pb2.KVMetadataWrite, wire.KV_METADATA_WRITE),
    "Updates": (txmgr_updates_pb2.Updates, wire.UPDATES),
}


def _pb_to_dict(msg, schema):
    """A protobuf message in wire.decode's form, defaults left out."""
    out = {}
    for field in schema.values():
        if field.kind == "message":
            if field.repeated:
                vals = [_pb_to_dict(m, field.message) for m in getattr(msg, field.name)]
                if vals:
                    out[field.name] = vals
            elif msg.HasField(field.name):
                out[field.name] = _pb_to_dict(getattr(msg, field.name), field.message)
        elif field.repeated:
            vals = list(getattr(msg, field.name))
            if vals:
                out[field.name] = vals
        else:
            v = getattr(msg, field.name)
            if v:
                out[field.name] = v
    return out


def _normal(msg, schema):
    """wire.decode's output with default scalars dropped (protobuf keeps no
    presence for them)."""
    out = {}
    for field in schema.values():
        if field.name not in msg:
            continue
        v = msg[field.name]
        if field.kind == "message":
            v = [_normal(m, field.message) for m in v] if field.repeated else _normal(v, field.message)
        if field.kind == "enum":
            v = v - (1 << 32) if v >= 1 << 31 else v  # an int32 enum
        if v or (field.kind == "message" and not field.repeated):
            out[field.name] = v
    return out


def _wire_outcome(cls, schema, raw):
    want_msg = cls()
    try:
        want_msg.ParseFromString(raw)
        want = ("ok", _pb_to_dict(want_msg, schema))
    except Exception:  # protobuf's DecodeError
        want = ("raises", None)
    try:
        got = ("ok", _normal(wire.decode(schema, raw), schema))
    except wire.WireError:
        got = ("raises", None)
    return want, got


def _sample_message(name, rng):
    tx = random_tx_rwset(rng)
    while not any(ns.reads or ns.range_queries or ns.coll_hashed for ns in tx.ns_rw_sets):
        tx = random_tx_rwset(rng)
    outer = rwset_pb2.TxReadWriteSet.FromString(jserialize(tx))
    if name == "TxReadWriteSet":
        return outer.SerializeToString()
    kvs = [kv_rwset_pb2.KVRWSet.FromString(ns.rwset) for ns in outer.ns_rwset]
    if name == "KVRWSet":
        return max((ns.rwset for ns in outer.ns_rwset), key=len)
    if name == "HashedRWSet":
        hashed = [c.hashed_rwset for ns in outer.ns_rwset for c in ns.collection_hashed_rwset]
        return max(hashed, key=len) if hashed else b""
    if name == "RangeQueryInfo":
        rqs = [q.SerializeToString() for kv in kvs for q in kv.range_queries_info]
        return max(rqs, key=len) if rqs else b""
    if name == "KVMetadataWrite":
        return tmvcc.serialize_metadata_entries([("a", b"1"), ("", b""), ("é", b"\x00")])
    u = jdb.UpdateBatch()
    u.put("ns", "k", b"v", jrw.Version(1, 2))
    u.delete("ns", "d", jrw.Version(1, 3))
    h = jdb.HashedUpdateBatch()
    h.put("ns", "c", b"\x01", b"\x02", jrw.Version(1, 4))
    return jkv.deterministic_update_bytes(u, h)


@pytest.mark.parametrize("name", sorted(_PB))
def test_wire_reader_matches_protobuf(name):
    cls, schema = _PB[name]
    rng = np.random.default_rng(sorted(_PB).index(name) + 3000)
    raised = 0
    for _ in range(4):
        raw = _sample_message(name, rng)
        variants = [raw] + [raw[:n] for n in range(len(raw))]
        for _ in range(200):
            b = bytearray(raw)
            for _ in range(int(rng.integers(1, 3))):
                pos = int(rng.integers(0, len(b) + 1))
                op = rng.random()
                if op < 0.45 and pos < len(b):
                    b[pos] = int(rng.integers(0, 256))
                elif op < 0.6 and pos < len(b):
                    b[pos] ^= 0x07  # another wire type, same field
                elif op < 0.85:
                    b[pos:pos] = bytes(rng.integers(0, 256, int(rng.integers(1, 4)), dtype=np.uint8))
                elif pos < len(b):
                    del b[pos]
            variants.append(bytes(b))
        for v in variants:
            want, got = _wire_outcome(cls, schema, v)
            assert got == want, v.hex()
            raised += want[0] == "raises"
    assert raised > 0


# Hand-written wire inputs, each at a rule of the format.
WIRE_EDGES = {
    "empty-version-present": ("KVRead", "1200"),
    "version-merged": ("KVRead", "12020805" "12021007"),
    "version-merged-last-wins": ("KVRead", "12020805" "12020807"),
    "key-last-wins": ("KVRead", "0a0161" "0a0162"),
    "unknown-varint": ("KVRead", "1805" "0a0161"),
    "unknown-fixed64": ("KVRead", "19" + "00" * 8 + "0a0161"),
    "unknown-fixed32": ("KVRead", "1d" + "00" * 4),
    "unknown-len": ("KVRead", "3a03616263"),
    "unknown-group": ("Version", "1b" "0805" "1c" "0802"),
    "nested-groups": ("Version", "1b" "23" "24" "1c"),
    "group-unterminated": ("Version", "1b0805"),
    "group-end-mismatch": ("Version", "1b24"),
    "group-end-stray": ("Version", "1c"),
    "group-crosses-submessage": ("KVRead", "12011b1c"),
    "known-field-as-group": ("Version", "0b0c"),
    "varint-field-as-len": ("Version", "0a0105"),
    "string-field-as-varint": ("KVRead", "0805"),
    "message-field-as-varint": ("KVRead", "1005"),
    "bool-as-len": ("KVWrite", "12020100"),
    "bool-2": ("KVWrite", "1002"),
    "uint32-overflow": ("QueryReadsMerkleSummary", "08ffffffff1f"),
    "uint64-max": ("Version", "08" + "ff" * 9 + "01"),
    "uint64-10th-byte-overflow": ("Version", "08" + "ff" * 9 + "7f"),
    "varint-11-bytes": ("Version", "08" + "ff" * 10 + "01"),
    "varint-truncated": ("Version", "08ff"),
    "tag-overlong": ("Version", "880005"),
    "tag-5-bytes": ("Version", "888080800005"),
    "tag-6-bytes": ("Version", "88808080800005"),
    "tag-max-field": ("Version", "f8ffffff0f05"),
    "tag-above-32-bits": ("Version", "f8ffffff1f05"),
    "field-0": ("Version", "0001"),
    "wire-type-6": ("Version", "0e01"),
    "wire-type-7": ("Version", "0f01"),
    "len-past-end": ("KVRead", "0a0561"),
    "len-huge": ("KVRead", "0affffffff0f"),
    "len-10-bytes": ("KVRead", "0a80808080808080808000"),
    "submessage-cuts-varint": ("KVRead", "12010805"),
    "utf8-invalid": ("KVRead", "0a01ff"),
    "utf8-surrogate": ("KVRead", "0a03eda080"),
    "utf8-overlong": ("KVRead", "0a02c080"),
    "utf8-max": ("KVRead", "0a04f48fbfbf"),
    "utf8-beyond-max": ("KVRead", "0a04f4908080"),
    "bytes-not-utf8": ("KVReadHash", "0a01ff"),
    "oneof-replaced": ("RangeQueryInfo", "22020a00" "2a020803" "22020a00"),
    "oneof-merged": ("RangeQueryInfo", "22020a00" "22020a00"),
    "oneof-other-last": ("RangeQueryInfo", "22020a00" "2a020803"),
    "repeated-bytes-empty": ("QueryReadsMerkleSummary", "1a00" "1a0161"),
    "enum-negative": ("TxReadWriteSet", "08" + "ff" * 9 + "01"),
    "groups-100-deep": ("Version", "1b" * 100 + "1c" * 100),
    "groups-101-deep": ("Version", "1b" * 101 + "1c" * 101),
    "groups-99-deep-in-submessage": ("KVRead", "12c601" + "1b" * 99 + "1c" * 99),
    "groups-100-deep-in-submessage": ("KVRead", "12c801" + "1b" * 100 + "1c" * 100),
}

_EDGE_SCHEMAS = {
    "KVRead": (kv_rwset_pb2.KVRead, wire.KV_READ),
    "KVWrite": (kv_rwset_pb2.KVWrite, wire.KV_WRITE),
    "KVReadHash": (kv_rwset_pb2.KVReadHash, wire.KV_READ_HASH),
    "Version": (kv_rwset_pb2.Version, wire.VERSION),
    "QueryReadsMerkleSummary": (kv_rwset_pb2.QueryReadsMerkleSummary, wire.QUERY_READS_MERKLE_SUMMARY),
    "RangeQueryInfo": (kv_rwset_pb2.RangeQueryInfo, wire.RANGE_QUERY_INFO),
    "TxReadWriteSet": (rwset_pb2.TxReadWriteSet, wire.TX_RWSET),
}


@pytest.mark.parametrize("case", sorted(WIRE_EDGES))
def test_wire_edge_matches_protobuf(case):
    name, hexed = WIRE_EDGES[case]
    cls, schema = _EDGE_SCHEMAS[name]
    want, got = _wire_outcome(cls, schema, bytes.fromhex(hexed))
    assert got == want


def test_presence_survives_the_parse():
    """A present but empty Version is Version(0, 0); an absent one None; an
    empty raw-read range query keeps raw_reads present."""
    tx = jrw.TxRwSet((jrw.NsRwSet(
        "cc",
        (jrw.KVRead("a", jrw.Version(0, 0)), jrw.KVRead("b", None)),
        range_queries=(jrw.RangeQueryInfo("a", "b", True, ()),),
    ),))
    raw = jserialize(tx)
    kv = wire.decode(wire.KV_RWSET, wire.decode(wire.TX_RWSET, raw)["ns_rwset"][0]["rwset"])
    assert kv["reads"][0]["version"] == {} and "version" not in kv["reads"][1]
    assert kv["range_queries_info"][0]["raw_reads"] == {}
    assert tparse(raw) == to_port(tx)


# ---------------------------------------------------------------------------
# Metadata, Merkle summaries and update bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entries", [
    [], [("owner", b"org1")], [("a", b""), ("", b"v"), ("é", b"\x00\xff")],
], ids=["none", "one", "edge"])
def test_metadata_codec_matches(entries):
    raw = jmvcc.serialize_metadata_entries(entries)
    assert tmvcc.serialize_metadata_entries(entries) == raw
    assert tmvcc.deserialize_metadata(raw) == jmvcc.deserialize_metadata(raw)
    assert tmvcc.deserialize_metadata(None) is None


@pytest.mark.parametrize("n,degree", [(0, 2), (3, 2), (7, 2), (50, 3), (120, 5), (9, 50)])
def test_merkle_summaries_match(n, degree):
    rng = np.random.default_rng(n * 100 + degree)
    reads = [
        jrw.KVRead(f"k{i:04d}", None if rng.random() < 0.2 else jrw.Version(int(rng.integers(0, 9)), i))
        for i in range(n)
    ]
    assert tmerkle.serialize_kv_reads(to_port(tuple(reads))) == jmerkle.serialize_kv_reads(reads)
    jh = jmerkle.RangeQueryResultsHelper(True, degree)
    th = tmerkle.RangeQueryResultsHelper(True, degree)
    for r in reads:
        jh.add_result(r)
        th.add_result(to_port(r))
        assert th.merkle_summary() == jh.merkle_summary()
    assert th.done() == to_port(jh.done())


def _random_batches(rng, rw, db_mod):
    u, h = db_mod.UpdateBatch(), db_mod.HashedUpdateBatch()
    for i in range(int(rng.integers(0, 30))):
        ns = ["", "cc", "lscc", "é"][int(rng.integers(0, 4))]
        v = rw.Version(int(rng.integers(0, 2**40)), int(rng.integers(0, 300)))
        if rng.random() < 0.2:
            u.delete(ns, f"k{int(rng.integers(0, 50))}", v)
        else:
            u.put(ns, f"k{int(rng.integers(0, 50))}", bytes([i]) * int(rng.integers(0, 3)), v,
                  b"md" if rng.random() < 0.3 else None)
    for i in range(int(rng.integers(0, 20))):
        v = rw.Version(int(rng.integers(0, 2**20)), i)
        vh = None if rng.random() < 0.2 else bytes([i]) * int(rng.integers(0, 3))
        h.put(["cc", "x"][int(rng.integers(0, 2))], f"c{int(rng.integers(0, 3))}",
              bytes([int(rng.integers(0, 256))]), vh, v)
    return u, h


@pytest.mark.parametrize("seed", range(4))
def test_deterministic_update_bytes_match(seed):
    ju, jh = _random_batches(np.random.default_rng(seed), jrw, jdb)
    tu, th = _random_batches(np.random.default_rng(seed), trw, tdb)
    want = jkv.deterministic_update_bytes(ju, jh)
    assert tkv.deterministic_update_bytes(tu, th) == want
    for n in (0, 1, 127, 128, 2**40):
        assert tkv._proto_varint(n) == jkv._proto_varint(n)
        assert tkv.encode_order_preserving_varuint64(n) == jkv.encode_order_preserving_varuint64(n)


# ---------------------------------------------------------------------------
# The commit hash chain: 5 blocks through the JAX KVLedger and the port
# ---------------------------------------------------------------------------


def chain_blocks(n_blocks=5, n_txs=30, seed=77):
    """Blocks of wire bytes over the seeded state, built with the JAX
    package as the state evolves: (rwset bytes or None, incoming codes)."""
    rng = np.random.default_rng(seed)
    db, _ = seeded_dbs()
    oracle = jmvcc.Validator(db)
    blocks = []
    for b in range(n_blocks):
        rwsets, codes = [], []
        for t in range(n_txs):
            special = (b, t) in ((1, 4), (2, 3), (3, 5))
            if rng.random() < 0.05 and not special:
                rwsets.append(None)
                codes.append(JCode.VALID)
                continue
            ok = rng.random() < 0.9 or special
            codes.append(JCode.VALID if ok else JCode.ENDORSEMENT_POLICY_FAILURE)
            reads = []
            for _ in range(int(rng.integers(0, 3))):
                k = f"k{int(rng.integers(0, 45))}"
                reads.append(jrw.KVRead(k, db.get_version("cc", k) if rng.random() < 0.8 else jrw.Version(0, 99)))
            writes = tuple(
                jrw.KVWrite(f"k{int(rng.integers(0, 45))}", bool(rng.random() < 0.15), b"v%d" % t)
                for _ in range(int(rng.integers(0, 3)))
            )
            hk = f"h{int(rng.integers(0, 20))}".encode()
            colls = ()
            if rng.random() < 0.3:
                colls = (jrw.CollHashedRwSet(
                    "coll0",
                    (jrw.KVReadHash(hk, db.get_key_hash_version("cc", "coll0", hk)),),
                    (jrw.KVWriteHash(hk, bool(rng.random() < 0.2), b"\x02" * 32),),
                ),)
            rqs, md = (), ()
            if b == 2 and t == 3:  # a Merkle range query: the host route
                helper = jmerkle.RangeQueryResultsHelper(True, 2)
                for key, vv in db.get_state_range("cc", "k1", "k2", False):
                    helper.add_result(jrw.KVRead(key, vv.version))
                _raw, summary = helper.done()
                rqs = (jrw.RangeQueryInfo("k1", "k2", True, (), summary),)
            if b == 3 and t == 5:  # a metadata write: the host route
                md = (jrw.KVMetadataWrite("k7", (("owner", b"org%d" % t),)),)
            rwsets.append(jrw.TxRwSet((jrw.NsRwSet("cc", tuple(reads), writes, rqs, colls, md),)))
        raw = [None if r is None else jserialize(r) for r in rwsets]
        if b == 1:
            raw[4] = b"\x0f\x01"  # wire type 7 does not parse: BAD_RWSET
        blocks.append((raw, codes))
        parsed = []
        jcodes = list(codes)
        for i, r in enumerate(raw):
            parsed.append(_outcome(jparse, r)[1] if r is not None else None)
            if r is not None and parsed[-1] is None and jcodes[i] == JCode.VALID:
                jcodes[i] = JCode.BAD_RWSET
        _codes, up, hup = oracle.validate_and_prepare_batch(b, parsed, jcodes)
        db.apply_updates(up, hashed=hup)
    return blocks


def _jax_chain(tmp_path, blocks):
    """The JAX KVLedger's commit path (in memory) over the same blocks; the
    transaction parse is stood in for by parsing each tx's rwset bytes and
    flagging a failure BAD_RWSET, as parse_transaction does."""
    ledger = jkv.KVLedger(str(tmp_path), "ch", persistent=False)
    db, _ = seeded_dbs()
    ledger.state_db = db
    prev = b""
    hashes, filters = [], []
    try:
        for number, (raw, codes) in enumerate(blocks):
            rwsets, flags = [], []
            for r, code in zip(raw, codes):
                parsed = _outcome(jparse, r)[1] if r is not None else None
                rwsets.append(parsed)
                bad = r is not None and parsed is None and code == JCode.VALID
                flags.append(JCode.BAD_RWSET if bad else code)
            block = protoutil.new_block(number, prev)
            for _ in raw:
                block.data.data.append(b"")
            block.metadata.metadata[common_pb2.TRANSACTIONS_FILTER] = bytes(int(c) for c in flags)
            protoutil.seal_block(block)
            out = ledger.commit(block, rwsets=rwsets)
            prev = protoutil.block_header_hash(block.header)
            hashes.append(ledger.commit_hash)
            filters.append(out.tobytes())
        return hashes, filters, ledger.history, ledger.state_db
    finally:
        ledger.close()


@pytest.mark.parametrize("kind", ["host", "device", "resident"])
def test_commit_hash_chain_matches_kvledger(tmp_path, kind):
    blocks = chain_blocks()
    want_hashes, want_filters, want_history, jax_db = _jax_chain(tmp_path, blocks)
    _, db = seeded_dbs()
    validator = {
        "host": lambda: tmvcc.Validator(db),
        "device": lambda: DeviceValidator(db, device="cpu"),
        "resident": lambda: ResidentDeviceValidator(db, capacity=16, device="cpu"),
    }[kind]()
    prev = b""
    history = {}
    paths = []
    for number, (raw, codes) in enumerate(blocks):
        out = tkv.commit_block_state(
            validator, number, raw, [TxValidationCode(int(c)) for c in codes], prev, history
        )
        assert out.flags.tobytes() == want_filters[number]
        assert out.commit_hash == want_hashes[number]
        prev = out.commit_hash
        paths.append(getattr(validator, "last_path", "host"))
    assert {k: [(v.block_num, v.tx_num) for v in vs] for k, vs in history.items()} == {
        k: [(v.block_num, v.tx_num) for v in vs] for k, vs in want_history.items()
    }
    assert [(ns, k, v.value, (v.version.block_num, v.version.tx_num), v.metadata)
            for ns, k, v in db.iter_all_state()] == [
        (ns, k, v.value, (v.version.block_num, v.version.tx_num), v.metadata)
        for ns, k, v in jax_db.iter_all_state()
    ]
    assert [(ns, c, k, v.value, (v.version.block_num, v.version.tx_num))
            for ns, c, k, v in db.iter_all_hashed()] == [
        (ns, c, k, v.value, (v.version.block_num, v.version.tx_num))
        for ns, c, k, v in jax_db.iter_all_hashed()
    ]
    if kind != "host":
        assert paths == ["device", "device", "host", "host", "device"]
    assert want_filters[1][4] == int(TxValidationCode.BAD_RWSET)
