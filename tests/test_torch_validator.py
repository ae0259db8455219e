"""The port's block validator against the JAX package's, block by block.

Blocks are built with the JAX package (its cryptogen, txbuilder and
protobuf) and validated by both validators: the JAX one over
`SoftwareProvider`, the port's over a provider defined here on the port's
P-256 oracle, one block over `CUDAProvider(device="cpu")`. The flag bytes
and the block bytes written back must be equal. The scenarios are those of
test_validator.py, test_statebased.py (at the validator: committed key
metadata through `get_state_metadata`) and test_validator_fuzz.py's
corpus; then the per-transaction parse against the JAX package's native
and per-transaction parses, a config #2 block built by the port and
validated by the JAX validator, and a three-block chain whose commit hashes
equal the JAX KVLedger's. Every comparison is exact."""

import hashlib
import random

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.endorser import create_proposal, create_signed_tx, endorse_proposal
from fabric_tpu.ledger import kvledger as jkv
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.ledger.mvcc import serialize_metadata_entries
from fabric_tpu.ledger.rwset_proto import serialize_tx_rwset
from fabric_tpu.ledger.txparse import parse_transaction as jparse_tx
from fabric_tpu.msp.cryptogen import generate_org
from fabric_tpu.msp import identity as jid
from fabric_tpu.msp.signer import SigningIdentity
from fabric_tpu.policy import from_dsl as jdsl
from fabric_tpu.policy.proto_convert import marshal_application_policy
from fabric_tpu.protos import common_pb2, peer_pb2, protoutil
from fabric_tpu.validation import blockparse as jblockparse
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch.common import p256
from fabric_tpu_torch.common import x509 as tx509
from fabric_tpu_torch.common.txflags import TxValidationCode as V
from fabric_tpu_torch.crypto import bccsp as tbccsp
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.ledger import kvledger as tkv
from fabric_tpu_torch.ledger import mvcc as tmvcc
from fabric_tpu_torch.ledger import statedb as tstatedb
from fabric_tpu_torch.ledger.txparse import parse_transaction as tparse_tx
from fabric_tpu_torch.msp import identity as tid
from fabric_tpu_torch.policy.ast import from_dsl as tdsl
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.validation import validator as tval
from fabric_tpu_torch.validation.blockparse import parse_block
from torch_untraced import untraced  # noqa: F401

CHANNEL = "testchannel"
SW = SoftwareProvider()
VP = "VALIDATION_PARAMETER"
POLICIES = {
    "mycc": "AND('Org1MSP.member','Org2MSP.member')",
    "anycc": "OR('Org1MSP.member','Org2MSP.member')",
    "fuzzcc": "OutOf(2,'Org1MSP.member','Org2MSP.member','Org3MSP.member')",
}


class OracleProvider(tbccsp.Provider):
    """The port's P-256 oracle behind the provider SPI (test material)."""

    def verify(self, key, signature, digest):
        r, s = tbccsp.parse_and_precheck(signature)
        return p256.verify_digest(key.point, digest, r, s)


@pytest.fixture(scope="module")
def net():
    torch.set_num_threads(1)
    orgs = [generate_org(f"org{i}.example.com", f"Org{i}MSP") for i in (1, 2, 3)]
    revoked = orgs[0].ca.enroll("peer9.org1.example.com", ou="peer")
    orgs[0].ca.revoke(revoked)

    def managers(with_crl):
        jmsps, tmsps = [], []
        for k, org in enumerate(orgs):
            cfg = org.msp_config(with_crl=with_crl and k == 0)
            jmsps.append(jid.MSP(cfg, provider=SW))
            tmsps.append(tid.MSP(tid.msp_config_from_pems(
                cfg.msp_id, cfg.root_certs, cfg.intermediate_certs, cfg.admins,
                cfg.revocation_list, tid.NodeOUs(enable=cfg.node_ous.enable))))
        return jid.MSPManager(jmsps), tid.MSPManager(tmsps)

    return {
        "orgs": orgs,
        "mgrs": managers(False),
        "crl_mgrs": managers(True),
        "client": SigningIdentity(orgs[0].users[0], SW),
        "p1": SigningIdentity(orgs[0].peers[0], SW),
        "p2": SigningIdentity(orgs[1].peers[0], SW),
        "p3": SigningIdentity(orgs[2].peers[0], SW),
        "revoked": SigningIdentity(revoked, SW),
        "stranger": SigningIdentity(generate_org("org9.example.com", "Org9MSP").users[0], SW),
    }


def registries(policies=POLICIES, plugin="builtin"):
    return (
        jval.ChaincodeRegistry([jval.ChaincodeDefinition(n, jdsl(p), plugin) for n, p in policies.items()]),
        tval.ChaincodeRegistry([tval.ChaincodeDefinition(n, tdsl(p), plugin) for n, p in policies.items()]),
    )


def results_bytes(ns="mycc", writes=(("k1", b"v1"),), reads=(), md=(), extra=()):
    return serialize_tx_rwset(jrw.TxRwSet((
        jrw.NsRwSet(ns, tuple(reads), tuple(jrw.KVWrite(k, False, v) for k, v in writes),
                    metadata_writes=tuple(md)),
        *extra,
    )))


def make_tx(net, cc="mycc", endorsers=("p1", "p2"), channel=CHANNEL, client="client",
            results=None):
    bundle = create_proposal(net[client], channel, cc, [b"invoke", b"a"])
    res = results if results is not None else results_bytes(ns=cc)
    return create_signed_tx(bundle, net[client], [endorse_proposal(bundle, net[e], res)
                                                   for e in endorsers])


def make_block(envelopes, number=7):
    block = protoutil.new_block(number, b"\x11" * 32)
    for env in envelopes:
        block.data.data.append(env if isinstance(env, bytes) else env.SerializeToString())
    protoutil.seal_block(block)
    return block


def run_both(net, block, crl=False, provider=None, policies=POLICIES, plugin="builtin", **kw):
    """Validate `block` with both validators; assert equal flags and equal
    written-back bytes; returns the flags as codes."""
    jmgr, tmgr = net["crl_mgrs" if crl else "mgrs"]
    jreg, treg = registries(policies, plugin)
    jb = common_pb2.Block()
    jb.CopyFrom(block)
    want = jval.BlockValidator(CHANNEL, jmgr, SW, jreg, **kw).validate(jb)
    tb = wire.decode(fabric.BLOCK, block.SerializeToString())
    tv = tval.BlockValidator(CHANNEL, tmgr, provider or OracleProvider(), treg, **kw)
    got = tv.validate(tb)
    assert got.tobytes() == want.tobytes()
    assert wire.encode(fabric.BLOCK, tb) == jb.SerializeToString()
    return [V(c) for c in got.tobytes()], tv


# ---------------------------------------------------------------------------
# test_validator.py's scenarios
# ---------------------------------------------------------------------------


def _mangle_payload(net, env, fn):
    payload = protoutil.unmarshal(common_pb2.Payload, env.payload)
    fn(payload)
    env.payload = payload.SerializeToString()
    env.signature = net["client"].sign(env.payload)
    return env


def _mangle_cap(net, env, fn):
    def inner(payload):
        tx = protoutil.unmarshal(peer_pb2.Transaction, payload.data)
        cap = protoutil.unmarshal(peer_pb2.ChaincodeActionPayload, tx.actions[0].payload)
        fn(cap)
        tx.actions[0].payload = cap.SerializeToString()
        payload.data = tx.SerializeToString()
    return _mangle_payload(net, env, inner)


def bad_txid(net, env):
    def inner(payload):
        chdr = protoutil.unmarshal(common_pb2.ChannelHeader, payload.header.channel_header)
        chdr.tx_id = "deadbeef" * 8
        payload.header.channel_header = chdr.SerializeToString()
    return _mangle_payload(net, env, inner)


def bad_creator_sig(net, env):
    env.signature = env.signature[:-6] + b"\x00\x01\x02\x03\x04\x05"
    return env


def tampered_proposal_payload(net, env):
    def inner(cap):
        cap.chaincode_proposal_payload = cap.chaincode_proposal_payload + b"x"
    return _mangle_cap(net, env, inner)


def tampered_endorsement(net, env, k=1):
    def inner(cap):
        sig = bytearray(cap.action.endorsements[k].signature)
        sig[-1] ^= 0xFF
        cap.action.endorsements[k].signature = bytes(sig)
    return _mangle_cap(net, env, inner)


def scenario_envelopes(net):
    dup = make_tx(net)
    return [
        make_tx(net),
        make_tx(net, endorsers=("p1",)),
        bad_creator_sig(net, make_tx(net)),
        bad_txid(net, make_tx(net)),
        b"\x03\x01garbage-not-an-envelope",
        b"",
        dup,
        dup,
        make_tx(net, cc="nosuchcc"),
        make_tx(net, channel="otherchannel"),
        tampered_proposal_payload(net, make_tx(net)),
        tampered_endorsement(net, make_tx(net)),
        make_tx(net, cc="anycc", endorsers=("p2",)),
    ]


SCENARIO_CODES = [
    V.VALID, V.ENDORSEMENT_POLICY_FAILURE, V.BAD_CREATOR_SIGNATURE, V.BAD_PROPOSAL_TXID,
    V.INVALID_OTHER_REASON, V.NIL_ENVELOPE, V.VALID, V.DUPLICATE_TXID, V.INVALID_CHAINCODE,
    V.TARGET_CHAIN_NOT_FOUND, V.INVALID_ENDORSER_TRANSACTION, V.ENDORSEMENT_POLICY_FAILURE,
    V.VALID,
]


def test_scenarios(net):
    got, v = run_both(net, make_block(scenario_envelopes(net)))
    assert got == SCENARIO_CODES
    assert v.last_sig_backend == "OracleProvider"
    assert set(v.last_ms) == {"parse", "identity", "host_prep", "verify_wait", "assembly",
                              "policy"}


def test_ledger_duplicate(net):
    env = make_tx(net)
    payload = protoutil.unmarshal(common_pb2.Payload, env.payload)
    chdr = protoutil.unmarshal(common_pb2.ChannelHeader, payload.header.channel_header)
    got, _ = run_both(net, make_block([env]), tx_exists=lambda t: t == chdr.tx_id)
    assert got == [V.DUPLICATE_TXID]


@pytest.mark.parametrize("endorsers,crl,want", [
    (("p1", "p1"), False, V.ENDORSEMENT_POLICY_FAILURE),  # one signer, deduped
    (("revoked", "p2"), True, V.ENDORSEMENT_POLICY_FAILURE),  # revoked by Org1's CRL
    (("revoked", "p2"), False, V.VALID),
    (("stranger", "p1", "p2"), False, V.VALID),  # an unknown MSP's endorsement drops
    (("p2", "p1"), False, V.VALID),
])
def test_endorser_sets(net, endorsers, crl, want):
    got, _ = run_both(net, make_block([make_tx(net, endorsers=endorsers)]), crl=crl)
    assert got == [want]


def test_unknown_creator_msp_and_revoked_creator(net):
    envs = [make_tx(net, client="stranger"), make_tx(net, client="revoked")]
    assert run_both(net, make_block(envs), crl=True)[0] == [V.BAD_CREATOR_SIGNATURE] * 2


def test_config_tx_valid(net):
    applied = []
    env = common_pb2.Envelope()
    payload = common_pb2.Payload()
    payload.header.channel_header = protoutil.make_channel_header(
        common_pb2.CONFIG, CHANNEL).SerializeToString()
    payload.header.signature_header = protoutil.make_signature_header(
        net["client"].serialize(), b"\x01" * 24).SerializeToString()
    payload.data = b"\x0a\x00"
    env.payload = payload.SerializeToString()
    env.signature = net["client"].sign(env.payload)
    got, _ = run_both(net, make_block([env, make_tx(net)]), apply_config=applied.append)
    assert got == [V.VALID, V.VALID] and applied == [b"\x0a\x00", b"\x0a\x00"]


def _cross_ns(net, endorsers, second=None, first_ns="anycc"):
    res = results_bytes(ns=first_ns, writes=(("a", b"1"),), extra=(
        second or jrw.NsRwSet("mycc", (), (jrw.KVWrite("k", False, b"2"),)),))
    return make_tx(net, cc="anycc", endorsers=endorsers, results=res)


def test_cross_namespace_dispatch(net):
    envs = [
        _cross_ns(net, ("p2",)),  # mycc's AND must hold too
        _cross_ns(net, ("p1", "p2")),
        _cross_ns(net, ("p1", "p2"), first_ns="mycc"),  # mycc twice
        make_tx(net, results=results_bytes(extra=(
            jrw.NsRwSet("mycc", (), (jrw.KVWrite("b", False, b"2"),)),))),  # dup namespace
        _cross_ns(net, ("p2",), second=jrw.NsRwSet("mycc", (jrw.KVRead("k", jrw.Version(1, 0)),), ())),
        _cross_ns(net, ("p2",), second=jrw.NsRwSet("ghostcc", (), (jrw.KVWrite("k", False, b"2"),))),
    ]
    got, _ = run_both(net, make_block(envs))
    assert got == [V.ENDORSEMENT_POLICY_FAILURE, V.VALID, V.ILLEGAL_WRITESET, V.ILLEGAL_WRITESET,
                   V.VALID, V.INVALID_CHAINCODE]


def test_named_plugin_without_registry_is_invalid_chaincode(net):
    got, _ = run_both(net, make_block([make_tx(net)]), plugin="custom")
    assert got == [V.INVALID_CHAINCODE]
    # both validators take a plugin registry and a write-set rule: a registry
    # that lacks the named plugin leaves the tx INVALID_CHAINCODE, and a rule
    # that passes changes nothing (tests/test_torch_plugins.py holds the rest)
    got, _ = run_both(net, make_block([make_tx(net)]), plugin="custom", plugin_registry={})
    assert got == [V.INVALID_CHAINCODE]
    got, _ = run_both(net, make_block([make_tx(net)]), writeset_check=lambda rw, ns: None)
    assert got == [V.VALID]


# ---------------------------------------------------------------------------
# test_statebased.py's scenarios, at the validator
# ---------------------------------------------------------------------------


def _vp(dsl):
    return ((VP, marshal_application_policy(jdsl(dsl))),)


SBE = {"sbecc": "OR('Org1MSP.member','Org2MSP.member')"}


def _sbe_tx(net, writes=(), md=(), endorsers=("p1",)):
    return make_tx(net, cc="sbecc", endorsers=endorsers,
                   results=results_bytes(ns="sbecc", writes=writes, md=md))


def test_statebased_scenarios(net):
    committed = {("sbecc", "", "k"): serialize_metadata_entries(_vp("AND('Org2MSP.member')")),
                 ("sbecc", "", "j"): serialize_metadata_entries((("other", b"x"),))}

    def md(ns, coll, key):
        return committed.get((ns, coll, key))

    mw = jrw.KVMetadataWrite
    envs = [
        _sbe_tx(net, writes=[("k", b"v1")]),  # key policy needs Org2
        _sbe_tx(net, writes=[("k", b"v2")], endorsers=("p2",)),
        _sbe_tx(net, writes=[("j", b"v")]),  # metadata without a VP: the cc EP
        _sbe_tx(net, writes=[("m", b"v0")], md=[mw("m", _vp("AND('Org1MSP.member')"))]),
        _sbe_tx(net, writes=[("m", b"v1")], endorsers=("p1", "p2")),  # m's VP updated above
        _sbe_tx(net, writes=[("k", b"x")], md=[mw("k", _vp("AND('Org1MSP.member')"))]),  # fails
        _sbe_tx(net, writes=[("k", b"v3")], endorsers=("p2",)),  # not blocked by the invalid writer
        _sbe_tx(net, md=[mw("n", None)]),  # metadata delete, no value write
        _sbe_tx(net, writes=[("z", b"v")], endorsers=("p3",)),  # cc EP fails
    ]
    got, _ = run_both(net, make_block(envs), policies=SBE, get_state_metadata=md)
    assert got == [V.ENDORSEMENT_POLICY_FAILURE, V.VALID, V.VALID, V.VALID,
                   V.ENDORSEMENT_POLICY_FAILURE, V.ENDORSEMENT_POLICY_FAILURE, V.VALID, V.VALID,
                   V.ENDORSEMENT_POLICY_FAILURE]
    # a committed VP alone (no metadata write in the block) takes the SBE pass
    got, _ = run_both(net, make_block(envs[:3]), policies=SBE, get_state_metadata=md)
    assert got == [V.ENDORSEMENT_POLICY_FAILURE, V.VALID, V.VALID]


# ---------------------------------------------------------------------------
# test_validator_fuzz.py's corpus
# ---------------------------------------------------------------------------

MUTATIONS = ["valid", "valid", "valid", "wrong_channel", "unknown_cc", "under_endorsed",
             "corrupt_bytes"]


def _fuzz_tx(net, rng, i, mutate):
    results = results_bytes(ns="fuzzcc", writes=((f"k{i}", b"v"),))
    channel = "otherchan" if mutate == "wrong_channel" else CHANNEL
    cc = "ghostcc" if mutate == "unknown_cc" else "fuzzcc"
    bundle = create_proposal(net["client"], channel, cc, [b"x", b"%d" % i])
    picks = rng.sample([net["p1"], net["p2"], net["p3"]], 1 if mutate == "under_endorsed" else 2)
    env = create_signed_tx(bundle, net["client"], [endorse_proposal(bundle, e, results)
                                                    for e in picks])
    raw = bytearray(env.SerializeToString())
    if mutate == "corrupt_bytes":
        raw[-rng.randrange(1, 40)] ^= 0x40
    return bytes(raw)


def fuzz_block(net, rng, n_txs, number):
    datas = [_fuzz_tx(net, rng, i, rng.choice(MUTATIONS)) for i in range(n_txs)]
    if n_txs >= 4 and rng.random() < 0.8:
        datas[rng.randrange(n_txs // 2, n_txs)] = datas[rng.randrange(0, n_txs // 2)]
    return make_block(datas, number=number)


@pytest.mark.parametrize("round_num", range(6))
def test_fuzz_corpus(net, round_num):
    rng = random.Random(20260801 + round_num)
    block = fuzz_block(net, rng, rng.randrange(6, 18), round_num + 1)
    got, _ = run_both(net, block)
    if round_num == 0:
        assert len(set(got)) >= 2


def _mutated_envelopes(net):
    """Envelopes whose bytes exercise the parse's error paths: wrong wire
    types, absent and empty headers, invalid UTF-8, epochs, header types,
    truncations and flipped bytes."""
    env = make_tx(net)
    payload = protoutil.unmarshal(common_pb2.Payload, env.payload)
    chdr = protoutil.unmarshal(common_pb2.ChannelHeader, payload.header.channel_header)
    out = [env.SerializeToString()]

    def with_payload(p):
        return common_pb2.Envelope(payload=p.SerializeToString(), signature=env.signature)

    p = common_pb2.Payload(data=payload.data)
    out.append(with_payload(p).SerializeToString())  # absent header
    p.header.SetInParent()
    out.append(with_payload(p).SerializeToString())  # empty header
    for field, value in (("epoch", 3), ("type", 2), ("type", 1), ("type", 9), ("type", -1)):
        c = common_pb2.ChannelHeader()
        c.CopyFrom(chdr)
        setattr(c, field, value)
        q = common_pb2.Payload()
        q.CopyFrom(payload)
        q.header.channel_header = c.SerializeToString()
        out.append(with_payload(q).SerializeToString())
    raw_chdr = payload.header.channel_header
    i = raw_chdr.index(chdr.tx_id.encode())
    for bad in (raw_chdr[:i] + b"\xff" + raw_chdr[i + 1:], raw_chdr[:-3], b"\x08\x03\x0a"):
        q = common_pb2.Payload()
        q.CopyFrom(payload)
        q.header.channel_header = bad
        out.append(with_payload(q).SerializeToString())
    raw = env.SerializeToString()
    out += [raw[:n] for n in (1, 2, 40, len(raw) // 2, len(raw) - 1)]
    out += [b"\x0a\x00", b"\x12\x03abc", raw + b"\x08\x01", raw + b"\x10"]
    return out


def _flipped_envelopes(net):
    """One bit flipped anywhere in an envelope, certificates included."""
    raw = make_tx(net).SerializeToString()
    rng = random.Random(4)
    out = []
    for _ in range(48):
        b = bytearray(raw)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        out.append(bytes(b))
    return out


def _job_view(job):
    """(identity, signature, digest of the signed bytes): the JAX native
    parse keeps the digest, the per-transaction parses the bytes."""
    if job is None:
        return None
    digest = getattr(job, "digest", None)
    return job.identity_bytes, job.signature, digest or hashlib.sha256(job.data).digest()


def _tx_view(tx):
    return (int(tx.code), tx.header_type, tx.channel_id, tx.tx_id, tx.creator, tx.namespace,
            tx.config_data, _job_view(tx.creator_sig_job),
            [_job_view(j) for j in tx.endorsement_jobs], tx.ns_entries, tx.has_md_writes)


def test_parse_matches_native_and_per_tx_parse(net):
    block_datas = ([e if isinstance(e, bytes) else e.SerializeToString()
                    for e in scenario_envelopes(net)] + _mutated_envelopes(net))
    datas = block_datas + _flipped_envelopes(net)
    jnative = jblockparse.parse_block(datas)
    tparsed = [tparse_tx(i, d) for i, d in enumerate(datas)]
    for i, d in enumerate(datas):
        jpy = jparse_tx(i, d)
        want = _tx_view(jpy)
        assert _tx_view(tparsed[i]) == want, i
        if jnative.native:
            assert _tx_view(jnative[i]) == want, i
        assert (tparsed[i].rwset is None) == (jpy.rwset is None)
    assert len({int(t.code) for t in tparsed}) >= 6
    run_both(net, make_block(block_datas))


def test_creator_key_off_the_curve(net):
    """A creator certificate whose key is not on P-256: the JAX validator
    raises `cryptography`'s ValueError for the whole block; the port codes
    the transaction BAD_CREATOR_SIGNATURE, as Fabric does for an identity
    that does not deserialize."""
    der = bytearray(jid.x509.load_pem_x509_certificate(net["orgs"][0].users[0].cert_pem)
                    .public_bytes(jid.serialization.Encoding.DER))
    der[der.index(bytes.fromhex("03420004")) + 40] ^= 1  # inside the key's BIT STRING
    creator = protoutil.serialize_identity("Org1MSP", tx509.pem_encode("CERTIFICATE", bytes(der)))

    class BadCreator(SigningIdentity):
        def serialize(self):
            return creator

    block = make_block([make_tx({**net, "bad": BadCreator(net["orgs"][0].users[0], SW)},
                                client="bad")])
    jmgr, tmgr = net["mgrs"]
    jreg, treg = registries()
    with pytest.raises(ValueError):
        jval.BlockValidator(CHANNEL, jmgr, SW, jreg).validate(block)
    with pytest.raises(tid.MSPError):
        tmgr.deserialize_identity(creator)
    flags = tval.BlockValidator(CHANNEL, tmgr, OracleProvider(), treg).validate(
        wire.decode(fabric.BLOCK, block.SerializeToString()))
    assert [V(c) for c in flags.tobytes()] == [V.BAD_CREATOR_SIGNATURE]


# ---------------------------------------------------------------------------
# The port's own blocks, the CUDA provider's plain route, the commit chain
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def config2():
    """chip_smoke.py's config #2 network, minted by the port, and the JAX
    validator over the same PEMs."""
    import chip_smoke

    net2 = chip_smoke.Config2Net()

    def jax_validator(with_crl=False):
        msps = [jid.MSP(jid.MSPConfig(c.msp_id, c.root_certs, admins=c.admins,
                                      revocation_list=c.revocation_list,
                                      node_ous=jid.NodeOUs(enable=c.node_ous.enable)), provider=SW)
                for c in net2.msp_configs(with_crl)]
        return jval.BlockValidator(chip_smoke.CONFIG2_CHANNEL, jid.MSPManager(msps), SW,
                                   jval.ChaincodeRegistry([jval.ChaincodeDefinition(
                                       "benchcc", jdsl(chip_smoke.CONFIG2_POLICY))]))

    return chip_smoke, net2, jax_validator


def _both_on_port_block(config2, block, with_crl=False):
    _, net2, jax_validator = config2
    raw = wire.encode(fabric.BLOCK, block)
    jb = common_pb2.Block()
    jb.ParseFromString(raw)
    assert jb.SerializeToString() == raw
    want = jax_validator(with_crl).validate(jb)
    got = net2.validator(OracleProvider(), with_crl).validate(block)
    assert got.tobytes() == want.tobytes()
    assert wire.encode(fabric.BLOCK, block) == jb.SerializeToString()
    for i, d in enumerate(jb.data.data):  # the JAX parse reads the port's envelopes alike
        assert _tx_view(jparse_tx(i, d)) == _tx_view(tparse_tx(i, d))
    return list(got.tobytes())


def test_port_built_config2_block_validates_in_jax(config2):
    """A 16-tx config #2 block minted and signed by the port (the smoke's
    construction at 16 txs): every tx VALID in both validators."""
    _, net2, _ = config2
    block = net2.block(16)
    assert block["header"]["data_hash"] == protoutil.block_data_hash(
        common_pb2.BlockData(data=block["data"]["data"]))
    assert _both_on_port_block(config2, block) == [0] * 16


def test_smoke_mask_block_codes_pinned_by_jax(config2):
    """validator_mask's block: the JAX validator gives chip_smoke.MASK_CODES
    lane by lane, and so does the port's."""
    chip_smoke, net2, _ = config2
    block, want = net2.mask_block()
    assert len(want) >= 64 and set(want) == set(chip_smoke.MASK_CODES.values())
    assert _both_on_port_block(config2, block, with_crl=True) == want


def test_combined_block_through_cuda_provider_plain_route(net):
    """Scenarios, an SBE-free fuzz block and revoked endorsers in one block
    through CUDAProvider(device="cpu"), the route the card takes."""
    rng = random.Random(11)
    fuzz = fuzz_block(net, rng, 8, 3)
    envs = (scenario_envelopes(net) + list(fuzz.data.data)
            + [make_tx(net, endorsers=("revoked", "p2")), make_tx(net, client="stranger")])
    got, v = run_both(net, make_block(envs), crl=True, provider=CUDAProvider(device="cpu"))
    assert got[:13] == SCENARIO_CODES
    assert got[-2:] == [V.ENDORSEMENT_POLICY_FAILURE, V.BAD_CREATOR_SIGNATURE]
    assert v.last_sig_backend == "cpu-reference"
    assert v.last_ms["principals"] >= 0.0


def test_three_block_chain_commit_hashes_match_kvledger(net, tmp_path):
    """Three validated blocks committed by the JAX KVLedger and by
    kvledger.commit_block_state from the port's flags and rwset bytes."""
    jreg, treg = registries()
    jmgr, tmgr = net["mgrs"]
    ledger = jkv.KVLedger(str(tmp_path), CHANNEL, persistent=False)
    tdb = tstatedb.VersionedDB()
    prev_hash, prev_commit = b"", b""
    try:
        for number in range(3):
            envs = [make_tx(net, results=results_bytes(writes=((f"k{i % 4}", b"v%d" % number),),
                                                       reads=((jrw.KVRead(f"k{i % 4}", None),)
                                                              if number == 0 else ())))
                    for i in range(5)]
            envs += [make_tx(net, endorsers=("p1",)), b""]
            block = protoutil.new_block(number, prev_hash)
            for e in envs:
                block.data.data.append(e if isinstance(e, bytes) else e.SerializeToString())
            protoutil.seal_block(block)
            tb = wire.decode(fabric.BLOCK, block.SerializeToString())
            jval.BlockValidator(CHANNEL, jmgr, SW, jreg).validate(block)
            ledger.commit(block)
            tv = tval.BlockValidator(CHANNEL, tmgr, OracleProvider(), treg)
            parsed = parse_block(tb["data"]["data"])
            flags = tv.validate(tb, parsed=parsed)
            out = tkv.commit_block_state(tmvcc.Validator(tdb), number,
                                         [tx.results for tx in parsed],
                                         [V(c) for c in flags.tobytes()], prev_commit)
            assert out.commit_hash == ledger.commit_hash
            prev_commit = out.commit_hash
            prev_hash = protoutil.block_header_hash(block.header)
            assert [V(c) for c in flags.tobytes()] == [V.VALID] * 5 + [
                V.ENDORSEMENT_POLICY_FAILURE, V.NIL_ENVELOPE]
        for i in range(4):
            assert tdb.get_state("mycc", f"k{i}").value == ledger.get_state("mycc", f"k{i}") == b"v2"
    finally:
        ledger.close()
