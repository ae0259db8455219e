"""The port's custom validation plugins (validation/plugin_api, dispatcher,
the validator's `plugin_registry`) and write-set rules (`writeset_check`)
against the JAX package's.

tests/test_pluggable.py's unit layer, without its subprocess network, on
blocks minted by the port (chip_smoke.py's config #2 network; each package's
MSP over the same certificates). Both validators take the same block bytes,
each with a plugin of its own package doing the same thing: the flags are
equal when the plugin accepts, when it rejects (ENDORSEMENT_POLICY_FAILURE),
when it is missing from the registry (INVALID_CHAINCODE), and when it raises
anything else both halt the block with ValidationError; the plugin sees the
same contexts; a plugin-validated tx's key-metadata write applies to a later
builtin tx of the block; `PluginRegistry.load` loads by module path. Last, a
Channel with `writeset_check`, `plugin_registry` and `state_mirror` all set
commits a chain whose filters, commit hashes, `.chain`, `.pvtdata`, SQLite
rows and mirrored documents equal the JAX Channel's, and a plugin that
raises on the pipelined path leaves the block unstored (fail closed)."""

import json
import sys
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.ledger import statecouch as jsc
from fabric_tpu.msp import identity as jid
from fabric_tpu.peer.channel import Channel as JChannel
from fabric_tpu.policy import from_dsl as jdsl
from fabric_tpu.policy.proto_convert import marshal_application_policy as jmarshal_app
from fabric_tpu.protos import common_pb2
from fabric_tpu.validation import dispatcher as jdisp
from fabric_tpu.validation import legacy as jleg
from fabric_tpu.validation import plugin_api as japi
from fabric_tpu.validation import validator as jval
from fabric_tpu_torch.common.txflags import TxValidationCode as V
from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.ledger import statecouch as tsc
from fabric_tpu_torch.ledger.rwset_proto import serialize_tx_rwset
from fabric_tpu_torch.peer.channel import Channel
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.policy.ast import from_dsl as tdsl
from fabric_tpu_torch.protos import fabric, protoutil, wire
from fabric_tpu_torch.validation import dispatcher as tdisp
from fabric_tpu_torch.validation import legacy as tleg
from fabric_tpu_torch.validation import plugin_api as tapi
from fabric_tpu_torch.validation import validator as tval
from fabric_tpu_torch.validation.statebased import VALIDATION_PARAMETER
from test_torch_commit_pipeline import MemoOracle
from test_torch_statecouch import FakeCouch, reset_fake

CHANNEL = "plugchannel"
AND2 = "AND('Org1MSP.member','Org2MSP.member')"
OR2 = "OR('Org1MSP.member','Org2MSP.member')"
SW = SoftwareProvider()
ORACLE = MemoOracle()


@pytest.fixture(scope="module")
def net():
    import chip_smoke

    torch.set_num_threads(1)
    n = chip_smoke.Config2Net(seed=909)
    jmgr = jid.MSPManager([
        jid.MSP(jid.MSPConfig(c.msp_id, c.root_certs, admins=c.admins,
                              revocation_list=c.revocation_list,
                              node_ous=jid.NodeOUs(enable=c.node_ous.enable)), provider=SW)
        for c in n.msp_configs()])
    return {"net": n, "jmgr": jmgr}


def envelope(net, i, cc="plugcc", ns_sets=None, endorsers=None, flip=False):
    """Tx i invoking `cc`: writes p{i} in `cc` unless `ns_sets` (rwset.NsRwSet
    objects) replace the rwset; with `flip` the second endorsement's
    signature has a flipped byte."""
    n = net["net"]
    ns_sets = ns_sets or (rw.NsRwSet(cc, (), (rw.KVWrite(f"p{i}", False, b"v"),)),)
    env = n.envelope(i, cc=cc, channel=CHANNEL, endorsers=endorsers,
                     results=serialize_tx_rwset(rw.TxRwSet(tuple(ns_sets))))
    if flip:
        env = n.resigned(env, n.flip_endorsement)
    return wire.encode(fabric.ENVELOPE, env)


def block(datas, number=7, prev=b"\x11" * 32):
    b = protoutil.new_block(number, prev)
    b["data"]["data"] = list(datas)
    return wire.encode(fabric.BLOCK, protoutil.seal_block(b))


def make_plugin(api, kind, log):
    """A plugin of `api`'s package: it records what it sees and then accepts
    (after the default check, "check"), rejects ("reject") or fails
    ("boom")."""

    class Plugin(api.ValidationPlugin):
        def validate(self, ctx):
            log.append((ctx.channel_id, ctx.block_num, ctx.tx_index, ctx.namespace, ctx.tx_id,
                        ctx.envelope_bytes, [(s.msp_id, s.identity_bytes, s.sig_valid)
                                             for s in ctx.signers],
                        list(ctx.ns_entries), ctx.get_state_metadata(ctx.namespace, "", "p")))
            if kind == "reject":
                raise api.EndorsementInvalid("nope")
            if kind == "boom":
                raise RuntimeError("infra down")
            if not ctx.default_check():
                raise api.EndorsementInvalid("default policy failed")

    return Plugin()


def validate_both(net, raw, plugin_name, kind=None, defs=(("plugcc", AND2, None),), **kw):
    """Both validators over `raw`: the JAX flags, the port's flags (or the
    ValidationError messages), and each plugin's log."""
    out = []
    for api, disp, val, dsl, mgr, provider, decode in (
            (japi, jdisp, jval, jdsl, net["jmgr"], SW, common_pb2.Block.FromString),
            (tapi, tdisp, tval, tdsl, net["net"].managers[False], ORACLE,
             lambda r: wire.decode(fabric.BLOCK, r))):
        log = []
        registry = val.ChaincodeRegistry([
            val.ChaincodeDefinition(name, dsl(policy), plugin or plugin_name)
            for name, policy, plugin in defs])
        plugins = disp.PluginRegistry()
        if kind is not None:
            plugins.register(plugin_name, make_plugin(api, kind, log))
        v = val.BlockValidator(CHANNEL, mgr, provider, registry, plugin_registry=plugins, **kw)
        try:
            result = [V(c) for c in v.validate(decode(raw)).tobytes()]
        except val.ValidationError as exc:
            result = ("ValidationError", str(exc))
        out.append((result, log))
    (jflags, jlog), (tflags, tlog) = out
    assert tflags == jflags
    assert tlog == jlog
    return tflags, tlog


@pytest.mark.parametrize("kind,want", [
    ("check", [V.VALID, V.ENDORSEMENT_POLICY_FAILURE, V.VALID]),
    ("reject", [V.ENDORSEMENT_POLICY_FAILURE] * 3),
])
def test_plugin_verdicts_equal(net, kind, want):
    raw = block([envelope(net, 0), envelope(net, 1, flip=True), envelope(net, 2)])
    flags, log = validate_both(net, raw, "recorder", kind)
    assert flags == want
    # once a tx, with the batch's verdicts: the flipped endorsement is False
    assert [entry[2] for entry in log] == [0, 1, 2]
    assert [[s[2] for s in entry[6]] for entry in log] == [[True, True], [True, False], [True, True]]
    assert log[0][:4] == (CHANNEL, 7, 0, "plugcc") and log[0][7] == [("plugcc", True)]
    assert log[0][5] == wire.decode(fabric.BLOCK, raw)["data"]["data"][0]


def test_plugin_failure_halts_the_block_in_both(net):
    raw = block([envelope(net, 0)])
    result, _ = validate_both(net, raw, "boom", "boom")
    assert result == ("ValidationError",
                      "validation plugin 'boom' failed on tx 0 ns plugcc: infra down")


def test_missing_plugin_is_invalid_chaincode_in_both(net):
    raw = block([envelope(net, 0), envelope(net, 1, cc="bincc")])
    flags, log = validate_both(net, raw, "ghost", None,
                               defs=(("plugcc", AND2, None), ("bincc", OR2, "builtin")))
    assert flags == [V.INVALID_CHAINCODE, V.VALID] and log == []


def test_plugin_registry_load_by_module_path(tmp_path):
    (tmp_path / "ext_torch_plug.py").write_text(
        "from fabric_tpu_torch.validation.plugin_api import ValidationPlugin\n"
        "class MyPlugin(ValidationPlugin):\n"
        "    def validate(self, ctx):\n"
        "        pass\n"
    )
    sys.path.insert(0, str(tmp_path))
    try:
        reg = tdisp.PluginRegistry()
        plugin = reg.load("mine", "ext_torch_plug:MyPlugin")
        assert callable(plugin.validate) and reg.get("mine") is plugin and reg.exists("mine")
        assert reg.exists("builtin") and reg.exists("vscc") and not reg.exists("ghost")
        assert reg.load("jsonplugin", "json:dumps") is json.dumps
        with pytest.raises(ModuleNotFoundError):
            reg.load("nope", "no_such_module_xyz:thing")
    finally:
        sys.path.remove(str(tmp_path))


def _mixed(net, i, with_vp):
    """A plugcc tx that also writes bincc's key k, with a key-level
    validation parameter when `with_vp`."""
    vp = ((VALIDATION_PARAMETER, jmarshal_app(jdsl("OR('Org1MSP.member')"))),)
    sets = [rw.NsRwSet("plugcc", (), (rw.KVWrite("p", False, b"v"),))]
    sets.append(rw.NsRwSet("bincc", (), (rw.KVWrite("k", False, b"v0"),),
                           metadata_writes=(rw.KVMetadataWrite("k", vp),) if with_vp else ()))
    return envelope(net, i, ns_sets=sets)


@pytest.mark.parametrize("with_vp,want", [(True, [V.VALID, V.ENDORSEMENT_POLICY_FAILURE]),
                                          (False, [V.VALID, V.VALID])])
def test_plugin_md_write_applies_to_later_builtin_tx(net, with_vp, want):
    """The plugin-validated tx 0 sets a key policy on bincc/k that tx 1 (a
    builtin tx endorsed by Org2's peer alone) must then satisfy."""
    n = net["net"]
    raw = block([_mixed(net, 0, with_vp),
                 envelope(net, 1, cc="bincc", endorsers=n.endorsers[1:],
                          ns_sets=(rw.NsRwSet("bincc", (), (rw.KVWrite("k", False, b"v1"),)),))])
    flags, log = validate_both(net, raw, "recorder", "check",
                               defs=(("plugcc", AND2, None), ("bincc", OR2, "builtin")))
    assert flags == want
    assert [(entry[2], entry[3]) for entry in log] == [(0, "plugcc")]  # bincc is builtin


def test_writeset_check_codes_illegal_writeset_in_both(net):
    """The v12 and v13 guards as `writeset_check`: a tx writing lscc from
    plugcc is ILLEGAL_WRITESET before any plugin runs."""
    raw = block([envelope(net, 0),
                 envelope(net, 1, ns_sets=(rw.NsRwSet("plugcc", (), (rw.KVWrite("a", False, b"v"),)),
                                           rw.NsRwSet("lscc", (), (rw.KVWrite("x", False, b"v"),))))])
    for jcheck, tcheck in ((jleg.check_v12_writeset, tleg.check_v12_writeset),
                           (jleg.check_v13_writeset, tleg.check_v13_writeset)):
        out = []
        for check in (jcheck, tcheck):
            out.append(validate_both(net, raw, "recorder", "check", writeset_check=check))
        # the same kwargs cannot name two packages' checks at once: compare the runs
        assert out[0] == out[1]
        flags, log = out[1]
        assert flags == [V.VALID, V.ILLEGAL_WRITESET] and [e[2] for e in log] == [0]


# ---------------------------------------------------------------------------
# A Channel with all three arguments
# ---------------------------------------------------------------------------


@pytest.fixture
def couch_url():
    reset_fake()
    server = ThreadingHTTPServer(("127.0.0.1", 0), FakeCouch)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    t.join()


def chain(net, n_blocks=3):
    """Linked blocks as wire bytes: plugcc txs (one with a flipped
    endorsement), a bincc builtin tx, a tx writing lscc, JSON and binary
    values."""
    out, prev = [], b""
    for number in range(n_blocks):
        datas = [
            envelope(net, 0, ns_sets=(rw.NsRwSet("plugcc", (), (
                rw.KVWrite(f"j{number}", False, b'{"owner": "org%d"}' % number),)),)),
            envelope(net, 1, flip=number == 1),
            envelope(net, 2, cc="bincc", ns_sets=(rw.NsRwSet("bincc", (), (
                rw.KVWrite(f"b{number}", False, b"\x00\x01"),)),)),
            envelope(net, 3, ns_sets=(rw.NsRwSet("plugcc", (), (rw.KVWrite("a", False, b"v"),)),
                                      rw.NsRwSet("lscc", (), (rw.KVWrite("x", False, b"v"),)))),
        ]
        b = protoutil.new_block(number, prev)
        b["data"]["data"] = datas
        protoutil.seal_block(b)
        prev = protoutil.block_header_hash(b["header"])
        out.append(wire.encode(fabric.BLOCK, b))
    return out


def test_channel_with_all_three_arguments_matches_jax(net, tmp_path, couch_url):
    raws = chain(net)
    results = []
    for side in ("jax", "port"):
        reset_fake()
        log = []
        if side == "jax":
            api, disp, val, dsl, sc, leg = japi, jdisp, jval, jdsl, jsc, jleg
            make, mgr, provider = JChannel, net["jmgr"], SW
        else:
            api, disp, val, dsl, sc, leg = tapi, tdisp, tval, tdsl, tsc, tleg
            make, mgr, provider = Channel, net["net"].managers[False], ORACLE
        plugins = disp.PluginRegistry()
        plugins.register("guard", make_plugin(api, "check", log))
        registry = val.ChaincodeRegistry([val.ChaincodeDefinition("plugcc", dsl(AND2), "guard"),
                                          val.ChaincodeDefinition("bincc", dsl(OR2))])
        mirror = sc.CouchStateAdapter(sc.CouchClient(couch_url), CHANNEL)
        ch = make(CHANNEL, str(tmp_path / side), mgr, registry, provider,
                  writeset_check=leg.check_v13_writeset, plugin_registry=plugins,
                  state_mirror=mirror)
        out = []
        try:
            for raw in raws:
                if side == "jax":
                    b = common_pb2.Block.FromString(raw)
                    out.append((ch.store_block(b).tobytes(), b.metadata.metadata[4]))
                else:
                    b = wire.decode(fabric.BLOCK, raw)
                    out.append((ch.store_block(b).tobytes(),
                                b["metadata"]["metadata"][fabric.COMMIT_HASH]))
        finally:
            ch.ledger.close()
        results.append((out, log, list(FakeCouch.requests), json.loads(json.dumps(FakeCouch.dbs))))
    (jout, jlog, jreq, jdocs), (tout, tlog, treq, tdocs) = results
    assert tout == jout and tlog == jlog and treq == jreq and tdocs == jdocs
    assert [[V(c) for c in f] for f, _ in tout] == [
        [V.VALID, V.VALID, V.VALID, V.ILLEGAL_WRITESET],
        [V.VALID, V.ENDORSEMENT_POLICY_FAILURE, V.VALID, V.ILLEGAL_WRITESET],
        [V.VALID, V.VALID, V.VALID, V.ILLEGAL_WRITESET]]
    assert sorted(tdocs[tsc.couch_db_name(CHANNEL, "plugcc")]) == ["j0", "j1", "j2", "p1"]
    for suffix in (".chain", ".pvtdata"):
        assert (Path(tmp_path / "port" / f"{CHANNEL}{suffix}").read_bytes()
                == Path(tmp_path / "jax" / f"{CHANNEL}{suffix}").read_bytes())
    from test_torch_kvledger import TABLES
    import sqlite3

    def rows(path):
        db = sqlite3.connect(str(path / f"{CHANNEL}.state.db"))
        try:
            return {t: sorted(db.execute(f"SELECT * FROM {t}").fetchall()) for t in TABLES}
        finally:
            db.close()

    assert rows(tmp_path / "port") == rows(tmp_path / "jax")


def test_plugin_failure_on_the_pipelined_path_fails_closed(net, tmp_path):
    """A plugin that raises on stage B reaches CommitPipeline's error path
    as ValidationError, and the block is not stored."""
    plugins = tdisp.PluginRegistry()
    plugins.register("boom", make_plugin(tapi, "boom", []))
    registry = tval.ChaincodeRegistry([tval.ChaincodeDefinition("plugcc", tdsl(AND2), "boom")])
    ch = Channel(CHANNEL, str(tmp_path), net["net"].managers[False], registry, ORACLE,
                 plugin_registry=plugins)
    errors = []
    pipe = CommitPipeline(ch, on_error=lambda b, exc: errors.append(exc))
    try:
        pipe.submit(wire.decode(fabric.BLOCK, chain(net, 1)[0]))
        assert pipe.drain(timeout=60)
    finally:
        pipe.stop()
        ch.ledger.close()
    assert [type(e) for e in errors] == [tval.ValidationError]
    assert isinstance(pipe.last_error, tval.ValidationError) and ch.ledger.height == 0
