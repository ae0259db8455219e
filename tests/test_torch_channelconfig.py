"""The port's channel configuration (`fabric_tpu_torch.channelconfig`) against
the JAX package's, and the wire codec's map fields against protobuf.

The cases of tests/test_channelconfig.py run through both packages over one
and the same config bytes (built by the port's encoder, parsed by each
package), with the same signatures (the port's seeded signers): the genesis
shape, the typed views, the policy-manager paths, implicit-meta ANY,
MAJORITY and a missing sub-policy, a non-member, and the config updates
(applied, tampered content at the same version, a bad read version, a
version skip, a wrong channel, mod-policy authorization). Each case's
outcome (the result's deterministic bytes and typed views, or the error's
text) is equal in both. The port verifies over its P-256 oracle, the JAX
package over SoftwareProvider.

Maps: the codec writes what `SerializeToString(deterministic=True)` writes
(an empty key, an empty message value, a key that arrives twice, upb's key
order, 200 random ConfigGroup trees). Cross-validation: an update built and
signed by the JAX package validates in the port and the reverse, and a JAX
genesis block reads into a port Bundle with equal typed views.

What was found about raw bytes: the JAX encoder serializes without
`deterministic=True`, and upb then writes a map in its table's order, which
is not key order (a ConfigGroup's values come in insertion order, its groups
in hash order), so the two packages' genesis blocks differ byte for byte
though their decoded trees are equal; the JAX ACLs value, a map inside
opaque value bytes, differs too. The tests compare decoded trees and
deterministic encodings, never the JAX encoder's raw bytes.
"""

import random

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import chip_smoke  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.channelconfig import configtx as jctx  # noqa: E402
from fabric_tpu.channelconfig import encoder as jenc  # noqa: E402
from fabric_tpu.crypto.bccsp import SoftwareProvider  # noqa: E402
from fabric_tpu.msp import identity as jid  # noqa: E402
from fabric_tpu.peer.aclmgmt import DEFAULT_ACLS  # noqa: E402
from fabric_tpu.policy import manager as jman  # noqa: E402
from fabric_tpu.protos import common_pb2, configtx_pb2  # noqa: E402
from fabric_tpu.protos import protoutil as jpu  # noqa: E402
from fabric_tpu_torch.channelconfig import bundle as tbundle  # noqa: E402
from fabric_tpu_torch.channelconfig import configtx as tctx  # noqa: E402
from fabric_tpu_torch.channelconfig import encoder as tenc  # noqa: E402
from fabric_tpu_torch.msp.cryptogen import generate_org  # noqa: E402
from fabric_tpu_torch.msp.signer import SigningIdentity  # noqa: E402
from fabric_tpu_torch.policy import manager as tman  # noqa: E402
from fabric_tpu_torch.protos import configtx as C  # noqa: E402
from fabric_tpu_torch.protos import fabric, protoutil, wire  # noqa: E402

CHANNEL = "testchannel"
SW = SoftwareProvider()
MEMO: dict = {}
ORACLE = chip_smoke.oracle_provider(MEMO)


def to_jax_msp(c):
    return jid.MSPConfig(c.msp_id, c.root_certs, c.intermediate_certs, c.admins,
                         c.revocation_list, jid.NodeOUs(enable=c.node_ous.enable))


def profile(enc, orgs, to_msp=lambda c: c, acls=None):
    """tests/test_channelconfig.py's profile in the encoder module `enc`."""
    org1, org2, oorg = orgs
    return enc.Profile(
        consortium="SampleConsortium",
        application=enc.ApplicationProfile(organizations=[
            enc.OrganizationProfile("Org1MSP", to_msp(org1.msp_config()),
                                    anchor_peers=[("peer0.org1", 7051)]),
            enc.OrganizationProfile("Org2MSP", to_msp(org2.msp_config())),
        ], acls=dict(acls or {})),
        orderer=enc.OrdererProfile(orderer_type="solo", addresses=["127.0.0.1:7050"],
                                   organizations=[enc.OrganizationProfile(
                                       "OrdererMSP", to_msp(oorg.msp_config()),
                                       orderer_endpoints=["127.0.0.1:7050"])]),
    )


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    rng = random.Random(1212)
    orgs = (generate_org("org1", "Org1MSP", rng=rng), generate_org("org2", "Org2MSP", rng=rng),
            generate_org("orderer-org", "OrdererMSP", rng=rng))
    stranger = generate_org("org1", "Org1MSP", rng=rng)  # same MSP name, another CA
    signer = {name: SigningIdentity(node, rng) for name, node in (
        ("org1_admin", orgs[0].admin), ("org2_admin", orgs[1].admin),
        ("org1_peer", orgs[0].peers[0]), ("orderer_admin", orgs[2].admin),
        ("stranger_peer", stranger.peers[0]))}
    config = tenc.new_config(profile(tenc, orgs))
    raw = wire.encode(C.CONFIG, config)
    return {"orgs": orgs, "signer": signer, "config_raw": raw, "rng": rng}


class Jax:
    name = "jax"

    @staticmethod
    def config(raw):
        return configtx_pb2.Config.FromString(raw)

    @staticmethod
    def bundle(config):
        return jbundle.Bundle(CHANNEL, config, SW)

    @staticmethod
    def validator(config, pm=None):
        return jctx.Validator(CHANNEL, config, pm)

    @staticmethod
    def cue(update_raw, signatures=()):
        cue = configtx_pb2.ConfigUpdateEnvelope(config_update=update_raw)
        for s in signatures:
            cue.signatures.add(signature_header=s["signature_header"], signature=s["signature"])
        return cue

    @staticmethod
    def result(env):
        return env.config.sequence, env.config.channel_group.SerializeToString(deterministic=True)

    @staticmethod
    def result_config(env):
        return env.config

    @staticmethod
    def signed(sd):
        return jman.SignedData(sd.data, sd.identity, sd.signature)


class Port:
    name = "port"

    @staticmethod
    def config(raw):
        return wire.decode(C.CONFIG, raw)

    @staticmethod
    def bundle(config):
        return tbundle.Bundle(CHANNEL, config, ORACLE)

    @staticmethod
    def validator(config, pm=None):
        return tctx.Validator(CHANNEL, config, pm)

    @staticmethod
    def cue(update_raw, signatures=()):
        return {"config_update": update_raw, "signatures": [dict(s) for s in signatures]}

    @staticmethod
    def result(env):
        return env["config"]["sequence"], wire.encode(C.CONFIG_GROUP, env["config"]["channel_group"])

    @staticmethod
    def result_config(env):
        return env["config"]

    @staticmethod
    def signed(sd):
        return tman.SignedData(sd.data, sd.identity, sd.signature)


SIDES = (Jax, Port)


def org_view(o):
    return (o.name, o.msp_id, tuple(tuple(a) for a in o.anchor_peers), tuple(o.ordererendpoints))


def policy_tree(m):
    return (tuple(m.policy_names), {name: policy_tree(c) for name, c in sorted(m.children.items())})


def views(b):
    """A Bundle's typed views as plain values, equal across the packages."""
    o, a = b.orderer, b.application
    return {
        "channel_id": b.channel_id, "hashing": b.hashing_algorithm,
        "width": b.block_data_hashing_width, "addresses": list(b.orderer_addresses),
        "consortium": b.consortium_name, "sequence": b.sequence,
        "channel_caps": sorted(b.channel_capabilities.required),
        "orderer": None if o is None else (
            o.consensus_type, o.consensus_metadata, o.consensus_state, o.batch_size_max_messages,
            o.batch_size_absolute_max_bytes, o.batch_size_preferred_max_bytes, o.batch_timeout,
            tuple(org_view(x) for x in o.orgs), sorted(o.capabilities.required), o.max_channels),
        "application": None if a is None else (
            tuple(org_view(x) for x in a.orgs), sorted(a.capabilities.required),
            a.capabilities.v20_validation, dict(a.acls)),
        "consortiums": {k: [org_view(x) for x in v] for k, v in b.consortiums.items()},
        "msps": sorted(m.msp_id for m in b.msp_manager.msps()),
        "policies": policy_tree(b.policy_manager),
    }


def signed_by(world, name, msg=b"payload"):
    s = world["signer"][name]
    return tman.SignedData(msg, s.serialize(), s.sign(msg))


def outcome(fn):
    try:
        return ("ok", fn())
    except (jctx.ConfigTxError, tctx.ConfigTxError, jman.PolicyError, tman.PolicyError) as exc:
        return ("error", type(exc).__name__, str(exc))


# ---------------------------------------------------------------------------
# tests/test_channelconfig.py's cases, through both packages
# ---------------------------------------------------------------------------


def test_genesis_block_shape(world):
    orgs = world["orgs"]
    tblock = tenc.genesis_block(profile(tenc, orgs), CHANNEL)
    jblock = jenc.genesis_block(profile(jenc, orgs, to_jax_msp), CHANNEL)
    assert tblock["header"]["number"] == jblock.header.number == 0
    assert tblock["header"]["data_hash"] == protoutil.block_data_hash(tblock["data"])
    assert jblock.header.data_hash == protoutil.block_data_hash(
        wire.decode(fabric.BLOCK_DATA, jblock.data.SerializeToString()))
    # equal trees: the JAX block decoded and written again by the port's
    # deterministic codec, level by level, and sealed again, is the port's
    assert canonical_genesis(jblock.SerializeToString()) == wire.encode(fabric.BLOCK, tblock)
    assert canonical_genesis(wire.encode(fabric.BLOCK, tblock)) == wire.encode(fabric.BLOCK, tblock)


def canonical_genesis(raw: bytes) -> bytes:
    block = wire.decode(fabric.BLOCK, raw)
    env = wire.decode(fabric.ENVELOPE, block["data"]["data"][0])
    payload = wire.decode(fabric.PAYLOAD, env["payload"])
    payload["data"] = wire.encode(C.CONFIG_ENVELOPE, wire.decode(C.CONFIG_ENVELOPE, payload["data"]))
    env["payload"] = wire.encode(fabric.PAYLOAD, payload)
    block["data"]["data"][0] = wire.encode(fabric.ENVELOPE, env)
    return wire.encode(fabric.BLOCK, protoutil.seal_block(block))


def test_bundle_typed_views(world):
    got = {side.name: views(side.bundle(side.config(world["config_raw"]))) for side in SIDES}
    assert got["jax"] == got["port"]
    v = got["port"]
    assert v["channel_id"] == CHANNEL and v["hashing"] == "SHA256"
    assert v["addresses"] == ["127.0.0.1:7050"] and v["consortium"] == "SampleConsortium"
    assert v["orderer"][0] == "solo" and v["orderer"][3] == 500
    assert v["application"][2]  # V2_0 validation
    assert v["msps"] == ["OrdererMSP", "Org1MSP", "Org2MSP"]


def test_bundle_needs_a_provider(world):
    """The port's Bundle makes no software provider: None is an error."""
    with pytest.raises(tbundle.ConfigError, match="provider"):
        tbundle.Bundle(CHANNEL, Port.config(world["config_raw"]), None)


POLICY_PATHS = ("/Channel/Readers", "/Channel/Writers", "/Channel/Admins",
                "/Channel/Application/Readers", "/Channel/Application/Writers",
                "/Channel/Application/Admins", "/Channel/Application/Endorsement",
                "/Channel/Orderer/BlockValidation", "/Channel/Nope",
                "/Channel/Application/Org1MSP/Admins", "Readers", "/")


def test_policy_manager_paths(world):
    found = {side.name: [side.bundle(side.config(world["config_raw"])).policy_manager.get_policy(
        p)[1] for p in POLICY_PATHS] for side in SIDES}
    assert found["jax"] == found["port"] == [True] * 8 + [False, True, True, False]


POLICY_CASES = {
    # (policy path, signers): tests/test_channelconfig.py's implicit-meta cases
    "implicit_meta_any_writer": ("/Channel/Application/Writers", ["org1_peer"], True),
    "implicit_meta_majority_one_admin": ("/Channel/Application/Admins", ["org1_admin"], False),
    "implicit_meta_majority_two_admins": ("/Channel/Application/Admins",
                                          ["org1_admin", "org2_admin"], True),
    "non_member_rejected": ("/Channel/Application/Writers", ["stranger_peer"], False),
    "orderer_admin_not_application_admin": ("/Channel/Application/Admins", ["orderer_admin"],
                                            False),
    "orderer_block_validation_needs_orderer": ("/Channel/Orderer/BlockValidation",
                                               ["org1_peer"], False),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_evaluation(world, case):
    path, names, want = POLICY_CASES[case]
    sds = [signed_by(world, n) for n in names]
    got = {}
    for side in SIDES:
        pol, ok = side.bundle(side.config(world["config_raw"])).policy_manager.get_policy(path)
        assert ok
        got[side.name] = outcome(lambda: pol.evaluate_signed_data([side.signed(s) for s in sds]))
    assert got["jax"] == got["port"]
    assert (got["port"][0] == "ok") == want


def test_implicit_meta_counts_children_missing_subpolicy(world):
    """A child group lacking the named sub-policy still counts in the
    MAJORITY denominator as an always-deny, in both packages."""
    config = Port.config(world["config_raw"])
    del config["channel_group"]["groups"]["Application"]["groups"]["Org2MSP"]["policies"]["Admins"]
    raw = wire.encode(C.CONFIG, config)
    got = {}
    for side in SIDES:
        pol, ok = side.bundle(side.config(raw)).policy_manager.get_policy(
            "/Channel/Application/Admins")
        assert ok
        got[side.name] = (outcome(lambda: pol.evaluate_signed_data(
            [side.signed(signed_by(world, "org1_admin"))])), outcome(
            lambda: pol.evaluate_signed_data([side.signed(signed_by(world, n))
                                              for n in ("org1_admin", "org2_admin")])))
    assert got["jax"] == got["port"]
    assert got["port"][0][0] == got["port"][1][0] == "error"


def _batch_size(n):
    return wire.encode(C.BATCH_SIZE, {"max_message_count": n, "absolute_max_bytes": 1 << 20,
                                      "preferred_max_bytes": 1 << 19})


def _update(kind):
    """The ConfigUpdate of tests/test_channelconfig.py's case `kind`, as
    wire bytes."""
    if kind == "applies":
        read = {"groups": {"Orderer": {"values": {"BatchSize": {}}}}}
        write = {"groups": {"Orderer": {"values": {"BatchSize": {
            "value": _batch_size(100), "version": 1, "mod_policy": "Admins"}}}}}
    elif kind == "tampered":
        read = {"groups": {"Orderer": {"values": {"BatchSize": {}, "BatchTimeout": {}}}}}
        write = {"groups": {"Orderer": {"values": {
            "BatchSize": {"value": wire.encode(C.BATCH_SIZE, {"max_message_count": 42}),
                          "version": 1, "mod_policy": "Admins"},
            "BatchTimeout": {"value": wire.encode(C.BATCH_TIMEOUT, {"timeout": "666s"})}}}}}
    elif kind == "bad_read_version":
        read = {"groups": {"Orderer": {"values": {"BatchSize": {"version": 7}}}}}
        write = {}
    elif kind == "version_skip":
        read = {}
        write = {"groups": {"Orderer": {"values": {"BatchSize": {"value": b"x", "version": 5}}}}}
    elif kind == "wrong_channel":
        return wire.encode(C.CONFIG_UPDATE, {"channel_id": "other"})
    else:
        raise ValueError(kind)
    return wire.encode(C.CONFIG_UPDATE, {"channel_id": CHANNEL, "read_set": read,
                                         "write_set": write})


UPDATE_CASES = {"applies": True, "tampered": True, "bad_read_version": False,
                "version_skip": False, "wrong_channel": False}


@pytest.mark.parametrize("kind", sorted(UPDATE_CASES))
def test_config_update_unauthenticated(world, kind):
    """A Validator without a policy manager: the result's bytes and the new
    Bundle's views, or the error, equal in both packages."""
    raw = _update(kind)
    got = {}
    for side in SIDES:
        v = side.validator(side.config(world["config_raw"]))

        def run():
            env = v.propose_config_update_envelope(side.cue(raw))
            return side.result(env), views(side.bundle(side.result_config(env)))

        got[side.name] = outcome(run)
    assert got["jax"] == got["port"]
    assert (got["port"][0] == "ok") == UPDATE_CASES[kind]
    if kind == "applies":
        (sequence, _), v = got["port"][1]
        assert sequence == 1 and v["orderer"][3] == 100 and v["orderer"][6] == "2s"
        assert v["application"] is not None
    if kind == "tampered":
        _, v = got["port"][1]
        assert v["orderer"][3] == 42 and v["orderer"][6] == "2s"


def _signatures(raw, names, world):
    cue = {"config_update": raw}
    for n in names:
        tctx.sign_config_update(cue, world["signer"][n])
    return cue.get("signatures", [])


@pytest.mark.parametrize("signers,want", [((), False), (("orderer_admin",), True),
                                          (("org1_peer",), False)],
                         ids=["unsigned", "orderer_admin", "non_admin"])
def test_config_update_mod_policy_authorization(world, signers, want):
    raw = _update("applies")
    sigs = _signatures(raw, signers, world)
    got = {}
    for side in SIDES:
        config = side.config(world["config_raw"])
        v = side.validator(config, side.bundle(config).policy_manager)
        got[side.name] = outcome(lambda: side.result(
            v.propose_config_update_envelope(side.cue(raw, sigs))))
    assert got["jax"] == got["port"]
    assert (got["port"][0] == "ok") == want


def test_adding_an_org_under_relative_admins_is_refused_in_both(world):
    """The reference resolves a new element's inherited relative mod policy
    against the new element's own path: under the encoder's Application
    mod policy "Admins", an update adding an org asks for
    /Channel/Application/Org3MSP/Admins and is refused, in both packages,
    though Org1's and Org2's admins sign it. (Fabric authorizes new elements
    through the enclosing group's version bump.) chip_smoke's ConfigNet
    writes that mod policy absolute for this reason."""
    org3 = generate_org("org3", "Org3MSP", rng=world["rng"])
    config = Port.config(world["config_raw"])
    app = config["channel_group"]["groups"]["Application"]
    versions = {k: {n: {"version": e.get("version", 0)} for n, e in app.get(k, {}).items()}
                for k in ("groups", "values", "policies")}
    write = {k: dict(v) for k, v in versions.items()}
    write["groups"]["Org3MSP"] = tenc.new_org_group(
        tenc.OrganizationProfile("Org3MSP", org3.msp_config()), with_anchors=True)
    write.update(version=1, mod_policy="Admins")
    raw = wire.encode(C.CONFIG_UPDATE, {
        "channel_id": CHANNEL, "read_set": {"groups": {"Application": versions}},
        "write_set": {"groups": {"Application": write}}})
    sigs = _signatures(raw, ("org1_admin", "org2_admin"), world)
    got = {}
    for side in SIDES:
        cfg = side.config(world["config_raw"])
        v = side.validator(cfg, side.bundle(cfg).policy_manager)
        got[side.name] = outcome(lambda: side.result(
            v.propose_config_update_envelope(side.cue(raw, sigs))))
    assert got["jax"] == got["port"]
    assert got["port"] == ("error", "ConfigTxError",
                           "mod policy /Channel/Application/Org3MSP/Admins not found")


# ---------------------------------------------------------------------------
# Cross-validation: updates and genesis blocks from one package in the other
# ---------------------------------------------------------------------------


def _update_envelope_jax(cue, signer):
    payload = common_pb2.Payload()
    payload.header.channel_header = jpu.make_channel_header(
        common_pb2.CONFIG_UPDATE, CHANNEL).SerializeToString()
    payload.data = cue.SerializeToString()
    raw = payload.SerializeToString()
    return common_pb2.Envelope(payload=raw, signature=signer.sign(raw))


def test_jax_built_update_validates_in_the_port(world):
    """The JAX package builds the update, signs it (its sign_config_update
    over the port's signer), proposes the ConfigEnvelope; the port proposes
    the same channel group and validates the JAX ConfigEnvelope."""
    jcfg = Jax.config(world["config_raw"])
    jv = Jax.validator(jcfg, Jax.bundle(jcfg).policy_manager)
    update = configtx_pb2.ConfigUpdate()
    update.channel_id = CHANNEL
    update.read_set.groups["Orderer"].values["BatchSize"].SetInParent()
    ws = update.write_set.groups["Orderer"].values["BatchSize"]
    ws.value, ws.version, ws.mod_policy = _batch_size(77), 1, "Admins"
    cue = configtx_pb2.ConfigUpdateEnvelope(config_update=update.SerializeToString())
    jctx.sign_config_update(cue, world["signer"]["orderer_admin"])
    env = _update_envelope_jax(cue, world["signer"]["orderer_admin"])
    jresult = jv.propose_config_update(env)
    tcfg = Port.config(world["config_raw"])
    tv = Port.validator(tcfg, Port.bundle(tcfg).policy_manager)
    tenv = wire.decode(fabric.ENVELOPE, env.SerializeToString())
    assert Port.result(tv.propose_config_update(tenv)) == Jax.result(jresult)
    tv.validate(wire.decode(C.CONFIG_ENVELOPE, jresult.SerializeToString()))
    # a JAX ConfigEnvelope whose channel group was altered after the fact
    bad = configtx_pb2.ConfigEnvelope()
    bad.CopyFrom(jresult)
    bad.config.channel_group.groups["Orderer"].values["BatchTimeout"].value = b"\x0a\x023s"
    with pytest.raises(tctx.ConfigTxError, match="does not match calculated config"):
        tv.validate(wire.decode(C.CONFIG_ENVELOPE, bad.SerializeToString()))


def test_port_built_update_validates_in_jax(world):
    """The port builds, signs and proposes; the JAX Validator validates the
    port's ConfigEnvelope, and the new Bundles' views are equal."""
    tcfg = Port.config(world["config_raw"])
    tv = Port.validator(tcfg, Port.bundle(tcfg).policy_manager)
    cue = {"config_update": _update("applies")}
    tctx.sign_config_update(cue, world["signer"]["orderer_admin"])
    signer = world["signer"]["orderer_admin"]
    payload = wire.encode(fabric.PAYLOAD, {
        "header": {"channel_header": wire.encode(fabric.CHANNEL_HEADER,
                                                 protoutil.make_channel_header(
                                                     fabric.CONFIG_UPDATE, CHANNEL))},
        "data": wire.encode(C.CONFIG_UPDATE_ENVELOPE, cue)})
    env = {"payload": payload, "signature": signer.sign(payload)}
    tresult = tv.propose_config_update(env)
    raw = wire.encode(C.CONFIG_ENVELOPE, tresult)
    jcfg = Jax.config(world["config_raw"])
    jv = Jax.validator(jcfg, Jax.bundle(jcfg).policy_manager)
    jenv = configtx_pb2.ConfigEnvelope.FromString(raw)
    jv.validate(jenv)
    assert views(Jax.bundle(jenv.config)) == views(Port.bundle(tresult["config"]))
    # the port's validate accepts its own envelope after a round trip
    tv.validate(wire.decode(C.CONFIG_ENVELOPE, raw))


def test_jax_genesis_block_reads_into_a_port_bundle(world):
    orgs = world["orgs"]
    acls = {k: v for k, v in DEFAULT_ACLS.items() if v.startswith("/")}
    jblock = jenc.genesis_block(profile(jenc, orgs, to_jax_msp, acls), CHANNEL)
    tb = tbundle.bundle_from_genesis_block(wire.decode(fabric.BLOCK, jblock.SerializeToString()),
                                          ORACLE)
    assert views(tb) == views(jbundle.bundle_from_genesis_block(jblock, SW))
    assert tb.application.acls == acls
    assert tb.acl_policy_ref("event/Block", "") == "/Channel/Application/Readers"


def test_channel_creation_update_equal(world):
    orgs = world["orgs"]
    japp = profile(jenc, orgs, to_jax_msp).application
    tapp = profile(tenc, orgs).application
    j = jenc.channel_creation_config_update("newchan", "SampleConsortium", japp)
    t = tenc.channel_creation_config_update("newchan", "SampleConsortium", tapp)
    assert wire.encode(C.CONFIG_UPDATE, t) == j.SerializeToString(deterministic=True)


def test_etcdraft_orderer_group_equal(world):
    orgs = world["orgs"]
    consenters = [("o1", 7050, b"client-cert", b"server-cert"), ("o2", 7051, b"c2", b"s2")]

    def group(enc, to_msp):
        p = profile(enc, orgs, to_msp).orderer
        p.orderer_type = "etcdraft"
        p.raft_consenters = consenters
        return enc.new_orderer_group(p)

    t = group(tenc, lambda c: c)
    j = group(jenc, to_jax_msp)
    assert wire.encode(C.CONFIG_GROUP, t) == j.SerializeToString(deterministic=True)


# ---------------------------------------------------------------------------
# Map fields against the protobuf runtime
# ---------------------------------------------------------------------------


def _both(jmsg, schema):
    """The port's decode of the runtime's bytes, written again, is the
    runtime's deterministic serialization."""
    det = jmsg.SerializeToString(deterministic=True)
    decoded = wire.decode(schema, jmsg.SerializeToString())
    assert wire.encode(schema, decoded) == det
    return decoded


def test_map_empty_key_and_empty_message_value():
    g = configtx_pb2.ConfigGroup()
    g.groups[""].SetInParent()
    g.values["a"].SetInParent()
    g.policies[""].policy.SetInParent()
    decoded = _both(g, C.CONFIG_GROUP)
    assert decoded == {"groups": {"": {}}, "values": {"a": {}}, "policies": {"": {"policy": {}}}}
    # an entry is written with its key and value even where both are defaults
    assert wire.encode(C.CONFIG_GROUP, {"groups": {"": {}}}) == b"\x12\x04\x0a\x00\x12\x00"
    u = configtx_pb2.ConfigUpdate(channel_id="c")
    u.isolated_data[""] = b""
    assert _both(u, C.CONFIG_UPDATE) == {"channel_id": "c", "isolated_data": {"": b""}}


def test_map_repeated_key_keeps_its_last_value():
    first = configtx_pb2.ConfigGroup()
    first.values["k"].version = 3
    first.values["k"].mod_policy = "x"
    second = configtx_pb2.ConfigGroup()
    second.values["k"].value = b"v"
    raw = first.SerializeToString() + second.SerializeToString()
    want = configtx_pb2.ConfigGroup.FromString(raw)
    got = wire.decode(C.CONFIG_GROUP, raw)
    assert got == {"values": {"k": {"value": b"v"}}}  # replaced, not merged
    assert wire.encode(C.CONFIG_GROUP, got) == want.SerializeToString(deterministic=True)
    # an entry without its key or value
    assert wire.decode(C.CONFIG_GROUP, b"\x1a\x00") == {"values": {"": {}}}
    assert configtx_pb2.ConfigGroup.FromString(b"\x1a\x00").values[""].version == 0


def test_map_key_order_is_upbs():
    """upb sorts string keys by their bytes but puts a key that is a prefix
    of another after it."""
    keys = ["a", "b", "ab", "", "ba", "B", "é", "zz", "a\x00", "Org10MSP", "Org1MSP"]
    caps = configtx_pb2.ConfigUpdate()
    for k in keys:
        caps.isolated_data[k] = k.encode()
    decoded = _both(caps, C.CONFIG_UPDATE)
    assert set(decoded["isolated_data"]) == set(keys)


NAMES = ["", "a", "ab", "Org1MSP", "Org10MSP", "Admins", "é", "z" * 3]


def _random_group(rng, depth):
    """A random ConfigGroup as a JAX message and a port dict, built alike."""
    jg, tg = configtx_pb2.ConfigGroup(), {}
    if rng.random() < 0.5:
        jg.version = tg["version"] = rng.choice([0, 1, 2**40])
    if rng.random() < 0.5:
        jg.mod_policy = tg["mod_policy"] = rng.choice(["", "Admins", "/Channel/Orderer/Admins"])
    for name in rng.sample(NAMES, rng.randrange(0, 4)):
        jv, tv = jg.values[name], tg.setdefault("values", {}).setdefault(name, {})
        if rng.random() < 0.5:
            jv.version = tv["version"] = rng.randrange(0, 3)
        if rng.random() < 0.5:
            jv.value = tv["value"] = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 4)))
        if rng.random() < 0.3:
            jv.mod_policy = tv["mod_policy"] = rng.choice(NAMES)
    for name in rng.sample(NAMES, rng.randrange(0, 3)):
        jp, tp = jg.policies[name], tg.setdefault("policies", {}).setdefault(name, {})
        if rng.random() < 0.6:
            jp.policy.SetInParent()
            tp["policy"] = {}
            if rng.random() < 0.5:
                jp.policy.type = tp["policy"]["type"] = rng.randrange(0, 4)
            if rng.random() < 0.5:
                jp.policy.value = tp["policy"]["value"] = b"\x01\x02"
    if depth:
        for name in rng.sample(NAMES, rng.randrange(0, 3)):
            jsub, tsub = _random_group(rng, depth - 1)
            jg.groups[name].CopyFrom(jsub)
            tg.setdefault("groups", {})[name] = tsub
    return jg, tg


def test_map_deterministic_order_over_random_trees():
    rng = random.Random(2012)
    for _ in range(200):
        jg, tg = _random_group(rng, 3)
        assert wire.encode(C.CONFIG_GROUP, tg) == jg.SerializeToString(deterministic=True)
        assert _both(jg, C.CONFIG_GROUP) == wire.decode(C.CONFIG_GROUP, wire.encode(
            C.CONFIG_GROUP, tg))


def test_config_value_schemas_against_protobuf(world):
    """Each value schema of the config against its `_pb2` message on a
    populated instance."""
    from fabric_tpu.protos import configuration_pb2, msp_config_pb2

    ct = configuration_pb2.ConsensusType(type="etcdraft", metadata=b"m", state=1)
    bs = configuration_pb2.BatchSize(max_message_count=1, absolute_max_bytes=2,
                                     preferred_max_bytes=3)
    acls = configuration_pb2.ACLs()
    acls.acls["peer/Propose"].policy_ref = "/Channel/Application/Writers"
    acls.acls["event/Block"].policy_ref = ""
    caps = configuration_pb2.Capabilities()
    caps.capabilities["V2_0"].SetInParent()
    ap = configuration_pb2.AnchorPeers()
    ap.anchor_peers.add(host="h", port=-1)
    meta = configuration_pb2.RaftConfigMetadata()
    meta.consenters.add(host="h", port=1, client_tls_cert=b"c", server_tls_cert=b"s")
    meta.options.tick_interval = "1s"
    meta.options.snapshot_interval_size = 5
    f = msp_config_pb2.FabricMSPConfig(name="m", root_certs=[b"r"], admins=[b"a", b""])
    f.fabric_node_ous.enable = True
    f.fabric_node_ous.peer_ou_identifier.organizational_unit_identifier = "peer"
    f.crypto_config.signature_hash_family = "SHA2"
    f.organizational_unit_identifiers.add(certificate=b"c", organizational_unit_identifier="ou")
    for msg, schema in ((ct, C.CONSENSUS_TYPE), (bs, C.BATCH_SIZE), (acls, C.ACLS),
                        (caps, C.CAPABILITIES), (ap, C.ANCHOR_PEERS),
                        (meta, C.RAFT_CONFIG_METADATA), (f, C.FABRIC_MSP_CONFIG),
                        (configuration_pb2.ChannelRestrictions(max_count=9),
                         C.CHANNEL_RESTRICTIONS),
                        (configuration_pb2.OrdererAddresses(addresses=["a", ""]),
                         C.ORDERER_ADDRESSES),
                        (msp_config_pb2.MSPConfig(type=1, config=b"x"), C.MSP_CONFIG)):
        _both(msg, schema)


def test_fabric_msp_config_round_trip(world):
    """local_msp_config_to_proto and back, in both packages: equal bytes."""
    c = world["orgs"][0].msp_config()
    t = tbundle.local_msp_config_to_proto(c)
    j = jbundle.local_msp_config_to_proto(to_jax_msp(c))
    assert wire.encode(C.MSP_CONFIG, t) == j.SerializeToString(deterministic=True)
    back = tbundle.fabric_msp_config_to_local(wire.decode(C.FABRIC_MSP_CONFIG, t["config"]))
    assert back == c
