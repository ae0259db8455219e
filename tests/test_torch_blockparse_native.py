"""The port's native block parse (`validation/blockparse.parse_block`, one
C++ pass through `fabric_tpu_torch/native/blockparse.cc`) against the JAX
package's native parse (`fabric_tpu.validation.blockparse.parse_block`,
built from `native/`) and against the port's per-transaction Python parse
(`parse_block_python`), field by field: codes, header types, channel and tx
ids, creators, namespaces, config data, signature jobs with their digests
(the Python parse's jobs hashed with hashlib), namespace entries, metadata
flags, the lazy rwsets, the rwset bytes kept for the commit, and the
written-keys table.

The blocks: config #2's 1,000-tx block and the validator's 70-tx block of
ten invalid kinds as `chip_smoke.Config2Net` builds them; config #4
rwsets with hashed keys, deletes, range queries, metadata writes and
config txs; and `tests/test_blockparse_native.py`'s corpus (its generators
imported from it): structured wire edge cases, group nesting at every
depth boundary, its mutation fuzz and random bytes at fixed seeds. Then the
BAD_RWSET demotion, on a ParsedTx and through the validator. Every
comparison is exact.
"""

import dataclasses
import hashlib
import random

import pytest
import torch

import chip_smoke
import test_blockparse_native as corpus
from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import blockparse as jblockparse
from fabric_tpu_torch.common.txflags import TxValidationCode as V
from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.ledger import txparse
from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
from fabric_tpu_torch.ledger.txparse import ParsedTx
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.validation.blockparse import parse_block, parse_block_python
from torch_untraced import untraced  # noqa: F401

_ld, _varint_field = corpus._ld, corpus._varint_field


def _job(job, hashed):
    if job is None:
        return None
    return job.identity_bytes, job.signature, (hashlib.sha256(job.data).digest() if hashed
                                               else job.digest)


def _view(tx, hashed):
    """Every field the validator reads, in one tuple; the rwset as plain
    tuples (the two packages' rwset classes differ, their fields do not).
    ns_entries and has_md_writes are read before the lazy rwset is built."""
    head = (int(tx.code), tx.header_type, tx.channel_id, tx.tx_id, tx.creator, tx.namespace,
            tx.config_data, _job(tx.creator_sig_job, hashed),
            [_job(j, hashed) for j in tx.endorsement_jobs], tx.ns_entries, tx.has_md_writes)
    rwset = tx.rwset
    return head + (None if rwset is None else dataclasses.astuple(rwset), int(tx.code))


def assert_parse_equal(datas):
    """The three parses agree on every tx and on the written keys; returns
    the port's native parse (its rwsets still lazy)."""
    jax_native = jblockparse.parse_block(datas)
    assert jax_native.native, "the JAX package's native parse did not run"
    got = parse_block(datas)
    assert got.native
    plain = parse_block_python(datas)
    assert not plain.native
    keys = list(got.iter_written_keys())
    assert keys == list(plain.iter_written_keys()) == list(jax_native.iter_written_keys())
    fresh = parse_block(datas)
    for i, (g, p, j) in enumerate(zip(fresh, plain, jax_native)):
        want = _view(p, hashed=True)
        assert _view(g, hashed=False) == want, i
        assert _view(j, hashed=False) == want, i
        assert g.results == p.results, i
    assert len(got) == len(plain) == len(datas)
    return got


def test_config2_block():
    net = chip_smoke.Config2Net()
    block = net.block(chip_smoke.CONFIG2_TXS)
    got = assert_parse_equal(block["data"]["data"])
    assert all(tx.code == V.NOT_VALIDATED for tx in got)
    assert sum(len(tx.endorsement_jobs) + 1 for tx in got) == 3 * chip_smoke.CONFIG2_TXS
    # one bytes object per distinct identity: the client and two endorsers
    assert len({id(job.identity_bytes) for tx in got
                for job in [tx.creator_sig_job, *tx.endorsement_jobs]}) == 3


def test_mask_block_of_ten_kinds():
    block, want = chip_smoke.Config2Net().mask_block()
    got = assert_parse_equal(block["data"]["data"])
    codes = {int(tx.code) for tx in got}
    assert {V.NIL_ENVELOPE, V.BAD_PAYLOAD, V.BAD_PROPOSAL_TXID, V.NOT_VALIDATED} <= codes
    assert len(got) == len(want)


def _config4_rwsets():
    """config #4's reads and writes (bench.py bench_mvcc), then the same
    shape with a collection's hashed read and write, deletes, a range query
    with raw reads and one with a Merkle summary, metadata writes (public,
    hashed, and a delete of all entries) and a second namespace."""
    out = chip_smoke.mvcc_config4_rwsets(rw, n_txs=40)
    for i in range(24):
        kh = hashlib.sha256(b"h%d" % i).digest()
        colls = (rw.CollHashedRwSet(
            "coll0", (rw.KVReadHash(kh, rw.Version(3, i)),),
            (rw.KVWriteHash(kh, i % 3 == 0, b"" if i % 3 == 0 else hashlib.sha256(kh).digest()),),
            (rw.KVMetadataWriteHash(kh, (("vp", b"p%d" % i),)),) if i % 4 == 1 else ()),)
        rqs = ()
        if i % 5 == 2:
            rqs = (rw.RangeQueryInfo("k1", "k3", True,
                                     (rw.KVRead("k1", rw.Version(1, 1)), rw.KVRead("k2", None))),)
        elif i % 5 == 3:
            rqs = (rw.RangeQueryInfo("a", "z", False, (), (2, 1, (b"\x01" * 32, b"\x02" * 32))),)
        md = ()
        if i % 6 == 4:
            md = (rw.KVMetadataWrite(f"k{i}", (("owner", b"org1MSP"), ("vp", b"x"))),)
        elif i % 6 == 5:
            md = (rw.KVMetadataWrite(f"k{i}", None),)
        ns = [rw.NsRwSet("cc", (rw.KVRead(f"k{i}", rw.Version(0, i)),),
                         (rw.KVWrite(f"k{i}", i % 7 == 0, b"" if i % 7 == 0 else b"v"),),
                         rqs, colls, md)]
        if i % 2:
            ns.append(rw.NsRwSet("other", (), (rw.KVWrite(f"o{i}", False, b"x"),)))
        out.append(rw.TxRwSet(tuple(ns)))
    return out


def test_config4_rwsets_hashed_keys_metadata_and_config_txs():
    rng = random.Random(404)
    datas = [corpus.make_endorser_tx(rng, rwset=serialize_tx_rwset(t)) for t in _config4_rwsets()]
    datas[7:7] = [corpus.make_config_tx(rng)]
    datas.append(corpus.make_config_tx(rng))
    got = assert_parse_equal(datas)
    assert sum(tx.has_md_writes for tx in got) == 12
    assert any(coll for _i, _ns, coll, _k in got.iter_written_keys())
    assert sum(tx.header_type == common_pb2.CONFIG for tx in got) == 2


def _edge_cases():
    """tests/test_blockparse_native.py's structured cases."""
    rng = random.Random(9)
    base = corpus.make_endorser_tx(rng, rwset=corpus.make_rwset(rng))
    cases = [b"", b"\x00", b"\xff" * 4, base + b"\x1a\x03abc"]
    chdr = common_pb2.ChannelHeader(type=common_pb2.CONFIG, channel_id="chX", tx_id="t", epoch=0)
    shdr = common_pb2.SignatureHeader(creator=b"c", nonce=b"n")
    h1 = common_pb2.Header(channel_header=chdr.SerializeToString())
    h2 = common_pb2.Header(signature_header=shdr.SerializeToString())
    merged = _ld(1, h1.SerializeToString()) + _ld(1, h2.SerializeToString()) + _ld(2, b"cfg")
    cases.append(_ld(1, merged) + _ld(2, b"s"))
    grp = bytes([15 << 3 | 3]) + _varint_field(1, 5) + bytes([15 << 3 | 4])
    cases.append(grp + base)
    cases.append(bytes([15 << 3 | 3]) + base)
    for depth in (89, 90, 91, 99, 100, 101, 105):
        cases.append(bytes([15 << 3 | 3]) * depth + bytes([15 << 3 | 4]) * depth + base)
    cases.append(bytes([0x08]) + b"\x80" * 10 + b"\x01")
    cases.append(_varint_field(1, 7) + _ld(2, b"s"))
    bad_chdr = _varint_field(1, 3) + _ld(4, b"\xff\xfe") + _ld(5, b"t")
    bad_header = _ld(1, bad_chdr) + _ld(2, shdr.SerializeToString())
    cases.append(_ld(1, _ld(1, bad_header) + _ld(2, b"d")) + _ld(2, b"s"))
    for ctype, epoch in ((common_pb2.CONFIG, 5), (99, 0)):
        h = common_pb2.ChannelHeader(type=ctype, channel_id="c", tx_id="t", epoch=epoch)
        p = common_pb2.Payload(data=b"d")
        p.header.channel_header = h.SerializeToString()
        p.header.signature_header = shdr.SerializeToString()
        cases.append(common_pb2.Envelope(payload=p.SerializeToString(),
                                         signature=b"s").SerializeToString())
    return cases


def _group_depth_cases():
    """tests/test_blockparse_native.py's nested group depths: in Header,
    in the ChannelHeader's Timestamp and in a KVRead's Version, at each side
    of protobuf's budget of 100 levels."""
    rng = random.Random(11)
    base = corpus.make_endorser_tx(rng, rwset=corpus.make_rwset(rng))
    env = common_pb2.Envelope()
    env.ParseFromString(base)
    payload = common_pb2.Payload()
    payload.ParseFromString(env.payload)

    def grp(depth):
        return bytes([15 << 3 | 3]) * depth + bytes([15 << 3 | 4]) * depth

    cases = []
    for d in (98, 99, 100, 101):
        p = _ld(1, payload.header.SerializeToString() + grp(d)) + _ld(2, payload.data)
        cases.append(_ld(1, p) + _ld(2, b"s"))
    for d in (98, 99, 100):
        hdr = _ld(1, payload.header.channel_header + _ld(3, grp(d))) + _ld(
            2, payload.header.signature_header)
        cases.append(_ld(1, _ld(1, hdr) + _ld(2, payload.data)) + _ld(2, b"s"))
    for d in (97, 98, 99):
        ns = _ld(1, b"mycc") + _ld(2, _ld(1, _ld(1, b"k") + _ld(2, grp(d))))
        cases.append(corpus.make_endorser_tx(rng, rwset=_ld(2, ns)))
    return cases


def _mutants():
    """tests/test_blockparse_native.py's mutation fuzz (random.Random(1234))."""
    rng = random.Random(1234)
    originals = [corpus.make_endorser_tx(rng, rwset=corpus.make_rwset(rng)),
                 corpus.make_endorser_tx(rng, n_endorsements=1), corpus.make_config_tx(rng)]
    mutants = []
    for _ in range(400):
        base = bytearray(rng.choice(originals))
        kind = rng.randrange(4)
        if kind == 0:
            for _ in range(rng.randrange(1, 4)):
                base[rng.randrange(len(base))] = rng.randrange(256)
        elif kind == 1:
            base = base[: rng.randrange(len(base))]
        elif kind == 2:
            pos = rng.randrange(len(base))
            base[pos:pos] = rng.randbytes(rng.randrange(1, 6))
        else:
            other = rng.choice(originals)
            cut = rng.randrange(len(base))
            base = base[:cut] + other[cut:]
        mutants.append(bytes(base))
    return mutants


def _random_bytes():
    rng = random.Random(99)
    return [rng.randbytes(rng.randrange(0, 200)) for _ in range(300)]


def _valid_corpus():
    rng = random.Random(7)
    datas = [corpus.make_endorser_tx(rng, rwset=corpus.make_rwset(rng)) for _ in range(8)]
    datas += [corpus.make_config_tx(rng), b"", corpus.make_endorser_tx(rng, valid_txid=False),
              corpus.make_endorser_tx(rng, valid_phash=False),
              corpus.make_endorser_tx(rng, rwset=corpus.make_rwset(rng, with_md=True))]
    return datas


@pytest.mark.parametrize("make", [_valid_corpus, _edge_cases, _group_depth_cases, _mutants,
                                  _random_bytes],
                         ids=["valid", "edge_cases", "group_depth", "mutation_fuzz",
                              "random_bytes"])
def test_corpus(make):
    assert_parse_equal(make())


def test_empty_block():
    """The native pass on no envelopes (the JAX package's parse_block
    returns before its native pass there)."""
    got = parse_block([])
    assert got.native and list(got) == [] and list(got.iter_written_keys()) == []


def test_lazy_rwset_divergence_demotes_to_bad_rwset():
    tx = ParsedTx(3)
    tx._rwset_raw = b"\xff\xff\xff\xff"  # not a TxReadWriteSet
    assert tx.rwset is None
    assert tx.code == V.BAD_RWSET
    assert tx.rwset is None  # not parsed again


def test_validator_honours_bad_rwset_demotion(monkeypatch):
    """A tx whose rwset the native walk accepted and the Python parse
    refuses: the block validates on, that tx is BAD_RWSET, the others keep
    their codes. The refusal is forced (the two parses agree on every
    corpus above); a metadata write sends the block through the
    state-based pass, which builds every rwset."""
    torch.set_num_threads(1)
    net = chip_smoke.Config2Net()
    envs = [net.envelope(i) for i in range(3)]
    results = serialize_tx_rwset(rw.TxRwSet((rw.NsRwSet(
        "benchcc", (), (rw.KVWrite("k1", False, b"v"),), (), (),
        (rw.KVMetadataWrite("k1", (("owner", b"x"),)),)),)))
    from fabric_tpu_torch.endorser import txbuilder as tb

    bundle = tb.create_proposal(net.client, chip_smoke.CONFIG2_CHANNEL, "benchcc", [b"md"])
    envs[1] = tb.create_signed_tx(bundle, net.client, [tb.endorse_proposal(bundle, e, results)
                                                        for e in net.endorsers])
    block = net.make_block([wire.encode(fabric.ENVELOPE, e) for e in envs], 1)
    parsed = parse_block(block["data"]["data"])
    assert parsed[1].has_md_writes and parsed[1]._rwset_raw == results
    real = txparse.parse_tx_rwset

    def refuse(raw):
        if raw == results:
            raise wire.WireError("refused")
        return real(raw)

    monkeypatch.setattr(txparse, "parse_tx_rwset", refuse)
    validator = net.validator(chip_smoke.oracle_provider())
    flags = validator.validate(block, parsed=parsed)
    assert [V(c) for c in flags.tobytes()] == [V.VALID, V.BAD_RWSET, V.VALID]
    assert validator.last_parser == "native"


def test_validator_flags_equal_on_either_parse():
    """The mask block validated from the native parse (digests from C++) and
    from `parse_block_python` (digests hashed by the provider): equal flags,
    each route recorded in `last_parser`."""
    net = chip_smoke.Config2Net()
    block, want = net.mask_block()
    raw = wire.encode(fabric.BLOCK, block)
    flags = {}
    for route, parse in (("native", parse_block), ("python", parse_block_python)):
        b = wire.decode(fabric.BLOCK, raw)
        validator = net.validator(chip_smoke.oracle_provider(), with_crl=True)
        flags[route] = validator.validate(b, parsed=parse(b["data"]["data"])).tobytes()
        assert validator.last_parser == route
    assert flags["native"] == flags["python"] == bytes(want)
