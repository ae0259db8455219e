"""The port's system chaincodes (fabric_tpu_torch.scc) against the JAX
package's, with no tolerance: qscc over the same committed chain (the port's
KVLedger and the JAX KVLedger fed the same block bytes: chain info, blocks
by number and hash, processed transactions with their validation codes,
blocks by txid and every error); cscc (JoinChain, GetChannels,
GetConfigBlock, GetChannelConfig, JoinChainBySnapshot, each failure); lscc
(deploy and upgrade through the simulator, their rwset bytes and records,
the name and version rules, the V2_0 refusal, the queries over committed
records and lifecycle definitions); `_lifecycle` over a package store. Each
SCC runs through each package's ChaincodeSupport.execute, and the
responses (status, message, payload bytes) are equal."""

import json
import random

import pytest

from fabric_tpu.chaincode import package as jpkg
from fabric_tpu.chaincode import support as jsup
from fabric_tpu.ledger import kvledger as jkv
from fabric_tpu.ledger import simulator as jsim
from fabric_tpu.ledger import statedb as jdb
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.protos import common_pb2
from fabric_tpu.scc import cscc as jcscc
from fabric_tpu.scc import lifecycle_scc as jlife
from fabric_tpu.scc import lscc as jlscc
from fabric_tpu.scc import qscc as jqscc
from fabric_tpu_torch.chaincode import package as tpkg
from fabric_tpu_torch.chaincode import support as tsup
from fabric_tpu_torch.endorser import txbuilder as tb
from fabric_tpu_torch.ledger import kvledger as tkv
from fabric_tpu_torch.ledger import rwset as trw
from fabric_tpu_torch.ledger import simulator as tsim
from fabric_tpu_torch.ledger import statedb as tdb
from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
from fabric_tpu_torch.msp.cryptogen import generate_org
from fabric_tpu_torch.msp.signer import SigningIdentity
from fabric_tpu_torch.orderer.blockwriter import BlockWriter
from fabric_tpu_torch.policy.ast import from_dsl
from fabric_tpu_torch.policy.proto_convert import marshal_envelope
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire
from fabric_tpu_torch.scc import cscc as tcscc
from fabric_tpu_torch.scc import lifecycle_scc as tlife
from fabric_tpu_torch.scc import lscc as tlscc
from fabric_tpu_torch.scc import qscc as tqscc

CHANNEL = "ch"
PKG = {"jax": (jsup, jsim, jdb, jrw), "port": (tsup, tsim, tdb, trw)}


def execute(pkg, scc, args, db=None, channel=CHANNEL):
    """Run `args` on `scc` through `pkg`'s ChaincodeSupport; the response
    as a tuple and the simulation's public rwset bytes."""
    sup, sim_mod, db_mod, _ = PKG[pkg]
    support = sup.ChaincodeSupport()
    support.register("scc", scc, system=True)
    sim = sim_mod.TxSimulator(db if db is not None else db_mod.VersionedDB(), tx_id="t")
    resp, _ = support.execute(sup.TxParams(channel, "t", sim), "scc", list(args))
    return (resp.status, resp.message, resp.payload), sim.get_tx_simulation_results().public_bytes


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Four blocks (the last two with invalid codes) from the port's
    BlockWriter, committed into both packages' KVLedger; and the txids."""
    rng = random.Random(16)
    org = generate_org("org1.scc", "Org1MSP", rng=rng)
    client, peer = SigningIdentity(org.users[0], rng), SigningIdentity(org.peers[0], rng)
    raws, txids, blocks = [], [], []
    writer = BlockWriter(signer=SigningIdentity(org.peers[0], rng), sink=blocks.append)
    for number in range(4):
        envs = []
        for i in range(3):
            results = serialize_tx_rwset(trw.TxRwSet((trw.NsRwSet(
                "benchcc", (), (trw.KVWrite(f"k{number}-{i}", False, b"v"),)),)))
            bundle = tb.create_proposal(client, CHANNEL, "benchcc", [b"put", b"%d" % i])
            envs.append(tb.create_signed_tx(bundle, client,
                                            [tb.endorse_proposal(bundle, peer, results)]))
            txids.append(bundle.tx_id)
        block = writer.create_next_block(envs)
        writer.write_block(block)
        codes = bytes([0, 11 if number >= 2 else 0, 10 if number == 3 else 0])
        block["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER] = codes
        raws.append(wire.encode(fabric.BLOCK, block))
    root = tmp_path_factory.mktemp("scc")
    tl = tkv.KVLedger(str(root / "port"), CHANNEL)
    jl = jkv.KVLedger(str(root / "jax"), CHANNEL)
    for raw in raws:
        tl.commit(wire.decode(fabric.BLOCK, raw))
        jl.commit(common_pb2.Block.FromString(raw))
    yield {"ledgers": {"port": tl, "jax": jl}, "raws": raws, "txids": txids}
    tl.close()
    jl.close()


def qscc_cases(chain):
    blocks = [wire.decode(fabric.BLOCK, raw) for raw in chain["raws"]]
    hash2 = protoutil.block_header_hash(blocks[2]["header"])
    t = chain["txids"]
    return {
        "chain-info": [b"GetChainInfo", b"ch"],
        "block-0": [b"GetBlockByNumber", b"ch", b"0"],
        "block-3": [b"GetBlockByNumber", b"ch", b"3"],
        "block-9": [b"GetBlockByNumber", b"ch", b"9"],
        "block-nan": [b"GetBlockByNumber", b"ch", b"x1"],
        "by-hash": [b"GetBlockByHash", b"ch", hash2],
        "by-bad-hash": [b"GetBlockByHash", b"ch", b"\x00" * 32],
        "tx-valid": [b"GetTransactionByID", b"ch", t[0].encode()],
        "tx-conflict": [b"GetTransactionByID", b"ch", t[7].encode()],
        "tx-endorsement": [b"GetTransactionByID", b"ch", t[11].encode()],
        "tx-unknown": [b"GetTransactionByID", b"ch", b"nope"],
        "block-by-tx": [b"GetBlockByTxID", b"ch", t[5].encode()],
        "block-by-unknown-tx": [b"GetBlockByTxID", b"ch", b"nope"],
        "no-channel": [b"GetChainInfo", b"other"],
        "one-arg": [b"GetChainInfo"],
        "missing-3rd": [b"GetBlockByNumber", b"ch"],
        "unknown-fn": [b"Nope", b"ch", b"1"],
    }


QSCC_CASES = ("chain-info", "block-0", "block-3", "block-9", "block-nan", "by-hash",
              "by-bad-hash", "tx-valid", "tx-conflict", "tx-endorsement", "tx-unknown",
              "block-by-tx", "block-by-unknown-tx", "no-channel", "one-arg", "missing-3rd",
              "unknown-fn")


@pytest.mark.parametrize("case", QSCC_CASES)
def test_qscc_equals_jax(chain, case):
    args = qscc_cases(chain)[case]
    out = {}
    for pkg, mod in (("jax", jqscc), ("port", tqscc)):
        ledger = chain["ledgers"][pkg]
        out[pkg] = execute(pkg, mod.QSCC(lambda cid, lg=ledger: lg if cid == CHANNEL else None),
                           args)
    assert out["port"] == out["jax"]
    resp = out["port"][0]
    if case in ("block-0", "block-3"):
        # the delivered block, with the commit hash the ledger added
        got, sent = (wire.decode(fabric.BLOCK, raw) for raw in (resp[2],
                                                                chain["raws"][int(case[-1])]))
        assert (got["header"], got["data"]) == (sent["header"], sent["data"])
        assert got["metadata"]["metadata"][:fabric.COMMIT_HASH] == sent["metadata"]["metadata"][
            :fabric.COMMIT_HASH]
    if case == "tx-conflict":
        pt = wire.decode(fabric.PROCESSED_TRANSACTION, resp[2])
        assert pt["validationCode"] == 11
    if case == "chain-info":
        info = wire.decode(fabric.BLOCKCHAIN_INFO, resp[2])
        assert info["height"] == 4


# ---------------------------------------------------------------------------
# cscc
# ---------------------------------------------------------------------------


def config_block():
    """A CONFIG block whose ConfigEnvelope holds a small Config."""
    config = {"sequence": 3, "channel_group": {"version": 1, "mod_policy": "Admins",
                                               "values": {"Consortium": {"value": b"c"}}}}
    payload = wire.encode(fabric.PAYLOAD, {
        "header": {"channel_header": wire.encode(fabric.CHANNEL_HEADER, protoutil.
                                                 make_channel_header(fabric.CONFIG, CHANNEL))},
        "data": wire.encode(cfgpb.CONFIG_ENVELOPE, {"config": config})})
    block = protoutil.new_block(5, b"\x01" * 32)
    block["data"]["data"] = [wire.encode(fabric.ENVELOPE, {"payload": payload})]
    return wire.encode(fabric.BLOCK, protoutil.seal_block(block))


CSCC_CASES = {
    "join": [b"JoinChain", b"GENESIS"],
    "join-fails": [b"JoinChain", b"FAIL"],
    "join-missing": [b"JoinChain"],
    "channels": [b"GetChannels"],
    "config-block": [b"GetConfigBlock", b"ch"],
    "config-block-unknown": [b"GetConfigBlock", b"zz"],
    "config-block-missing": [b"GetConfigBlock"],
    "channel-config": [b"GetChannelConfig", b"ch"],
    "channel-config-bad": [b"GetChannelConfig", b"bad"],
    "channel-config-unknown": [b"GetChannelConfig", b"zz"],
    "snapshot": [b"JoinChainBySnapshot", b"/snapshots/ch/7"],
    "snapshot-fails": [b"JoinChainBySnapshot", b"/fail"],
    "snapshot-missing": [b"JoinChainBySnapshot", b""],
    "none": [],
    "unknown": [b"Nope"],
}


@pytest.mark.parametrize("case", sorted(CSCC_CASES))
@pytest.mark.parametrize("with_snapshot", [True, False])
def test_cscc_equals_jax(case, with_snapshot):
    cfg_raw = config_block()
    bad = protoutil.new_block(6, b"")
    bad["data"]["data"] = [b"\x0a\x02zz"]
    bad_raw = wire.encode(fabric.BLOCK, bad)
    genesis = wire.encode(fabric.BLOCK, protoutil.seal_block(protoutil.new_block(0, b"")))
    args = [a.replace(b"GENESIS", genesis).replace(b"FAIL", b"\x0a\x05ab") if a in (
        b"GENESIS", b"FAIL") else a for a in CSCC_CASES[case]]
    out, joined = {}, {}
    for pkg, mod in (("jax", jcscc), ("port", tcscc)):
        def to_block(raw, pkg=pkg):
            return common_pb2.Block.FromString(raw) if pkg == "jax" else wire.decode(
                fabric.BLOCK, raw)

        def snapshot(path):
            if path == "/fail":
                raise RuntimeError("snapshot is corrupt")
            return "ch-from-" + path.rsplit("/", 1)[-1]

        def join(block, pkg=pkg):
            raw = block.SerializeToString() if pkg == "jax" else wire.encode(fabric.BLOCK, block)
            joined.setdefault(pkg, []).append(raw)

        scc = mod.CSCC(join, lambda: ["ch", "ch2"],
                       lambda cid: {"ch": to_block(cfg_raw), "bad": to_block(bad_raw)}.get(cid),
                       join_by_snapshot=snapshot if with_snapshot else None)
        out[pkg] = execute(pkg, scc, args)
    assert out["port"] == out["jax"]
    assert joined.get("port") == joined.get("jax")
    if case == "channel-config":
        assert wire.decode(cfgpb.CONFIG, out["port"][0][2])["sequence"] == 3


# ---------------------------------------------------------------------------
# lscc
# ---------------------------------------------------------------------------

POLICY = marshal_envelope(from_dsl("OR('Org1MSP.member','Org2MSP.member')"))


def deployment_spec(name, version, code=b"code"):
    return wire.encode(fabric.CHAINCODE_DEPLOYMENT_SPEC, {
        "chaincode_spec": {"type": 1, "chaincode_id": {"name": name, "version": version}},
        "code_package": code})


def lscc_db(pkg, records=()):
    _, _, db_mod, rw_mod = PKG[pkg]
    db = db_mod.VersionedDB()
    batch = db_mod.UpdateBatch()
    for n, (key, value) in enumerate(records):
        batch.put("scc", key, value, rw_mod.Version(1, n))
    db.apply_updates(batch)
    return db


COMMITTED = [
    ("mycc", wire.encode(fabric.CHAINCODE_DATA, {"name": "mycc", "version": "1.0", "escc": "escc",
                                                 "vscc": "vscc", "policy": POLICY, "id": b"i"})),
    ("mycc~collection", b"collections"),
    ("bare", wire.encode(fabric.CHAINCODE_DATA, {"version": "0.1"})),
    ("foreign", b"\xff\xff"),
]

LSCC_CASES = {
    "deploy": [b"deploy", b"ch", deployment_spec("newcc", "1.0"), POLICY],
    "deploy-escc-vscc-coll": [b"deploy", b"ch", deployment_spec("newcc", "1.0"), POLICY,
                              b"myescc", b"myvscc", b"collpkg"],
    "deploy-exists": [b"deploy", b"ch", deployment_spec("mycc", "2.0"), POLICY],
    "deploy-bad-name": [b"deploy", b"ch", deployment_spec("bad name", "1.0"), POLICY],
    "deploy-bad-version": [b"deploy", b"ch", deployment_spec("newcc", "1.0 beta"), POLICY],
    "deploy-no-policy": [b"deploy", b"ch", deployment_spec("newcc", "1.0")],
    "deploy-bad-spec": [b"deploy", b"ch", b"\x0a\x09x", POLICY],
    "deploy-few-args": [b"deploy", b"ch"],
    "upgrade": [b"upgrade", b"ch", deployment_spec("mycc", "2.0"), POLICY],
    "upgrade-same-version": [b"upgrade", b"ch", deployment_spec("mycc", "1.0"), POLICY],
    "upgrade-missing": [b"upgrade", b"ch", deployment_spec("ghost", "1.0"), POLICY],
    "getchaincodes": [b"getchaincodes"],
    "getchaincodesinfo": [b"GetChaincodesInfo"],
    "getid": [b"getid", b"ch", b"mycc"],
    "getid-definition": [b"getid", b"ch", b"lifecc"],
    "getccdata": [b"getccdata", b"ch", b"mycc"],
    "getccdata-definition": [b"getccdata", b"ch", b"lifecc"],
    "getccdata-missing": [b"getccdata", b"ch", b"ghost"],
    "getid-few-args": [b"getid", b"ch"],
    "collections": [b"getcollectionsconfig", b"mycc"],
    "collections-missing": [b"getcollectionsconfig", b"lifecc"],
    "collections-few-args": [b"getcollectionsconfig"],
    "none": [],
    "unknown": [b"install"],
}


@pytest.mark.parametrize("case", sorted(LSCC_CASES))
@pytest.mark.parametrize("v20", [False, True])
def test_lscc_equals_jax(case, v20):
    """Responses and the rwsets deploy/upgrade write, over the same
    committed records and lifecycle definitions."""
    out = {}
    for pkg, mod in (("jax", jlscc), ("port", tlscc)):
        scc = mod.LSCC(lambda: [("lifecc", "3.0"), ("mycc", "9.9")],
                       v20_active=(lambda cid: cid == CHANNEL) if v20 else None)
        out[pkg] = execute(pkg, scc, LSCC_CASES[case], db=lscc_db(pkg, COMMITTED))
    assert out["port"] == out["jax"]
    if case == "deploy" and not v20:
        assert out["port"][0][0] == 200 and out["port"][1]


def test_lscc_invalid_policy_refused_in_both():
    """A policy that does not parse: both refuse the deploy; the parse
    error's text is each package's own."""
    out = {}
    for pkg, mod in (("jax", jlscc), ("port", tlscc)):
        out[pkg] = execute(pkg, mod.LSCC(lambda: []),
                           [b"deploy", b"ch", deployment_spec("newcc", "1.0"), b"\x12\x03abc"],
                           db=lscc_db(pkg))
    for pkg in out:
        assert out[pkg][0][0] == 500 and out[pkg][0][1].startswith("invalid endorsement policy: ")


# ---------------------------------------------------------------------------
# _lifecycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["install", "query", "approve", "approve-bad", "get", "get-missing",
                                  "install-missing", "install-bad", "approve-missing",
                                  "get-missing-arg", "none", "unknown"])
def test_lifecycle_scc_equals_jax(case, tmp_path):
    raw = tpkg.package("lifecc_1", {"chaincode.py": b"x"})
    args = {
        "install": [b"InstallChaincode", raw],
        "install-missing": [b"InstallChaincode"],
        "install-bad": [b"InstallChaincode", b"not a package"],
        "query": [b"QueryInstalledChaincodes"],
        "approve": [b"ApproveChaincodeDefinitionForOrg", json.dumps(
            {"channel": "ch", "name": "lifecc", "package_id": "lifecc_1:00"}).encode()],
        "approve-bad": [b"ApproveChaincodeDefinitionForOrg", b'{"channel": "ch"}'],
        "approve-missing": [b"ApproveChaincodeDefinitionForOrg"],
        "get": [b"GetInstalledChaincodePackage", tpkg.package_id(raw).encode()],
        "get-missing": [b"GetInstalledChaincodePackage", b"ghost:00"],
        "get-missing-arg": [b"GetInstalledChaincodePackage"],
        "none": [],
        "unknown": [b"Nope"],
    }[case]
    out, approved = {}, {}
    for pkg, mod, pmod in (("jax", jlife, jpkg), ("port", tlife, tpkg)):
        store = pmod.PackageStore(str(tmp_path / pkg))
        store.install(raw)
        scc = mod.LifecycleSCC(lambda b, s=store: s.install(b).package_id, store.list_installed,
                               lambda ch, n, p, k=pkg: approved.setdefault(k, []).append((ch, n, p)),
                               store.load)
        out[pkg] = execute(pkg, scc, args)
    assert out["port"] == out["jax"]
    assert approved.get("port") == approved.get("jax")
