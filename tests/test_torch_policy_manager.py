"""The port's policy manager (`fabric_tpu_torch.policy.manager`) against the
JAX package's.

SignaturePolicy and ImplicitMetaPolicy in both packages over the same
SignedData (the port's seeded signers; the port verifies over its P-256
oracle, the JAX package over SoftwareProvider): duplicate identities (the
first of them is the one verified), an unknown MSP, an identity that does
not deserialize, a flipped signature, a signature that is not DER, an empty
set, principals of each role; ANY, ALL and MAJORITY with a missing
sub-policy; the manager tree built from one ConfigGroup's bytes. Each
outcome (allowed, or the PolicyError's text) is equal in both.

The one intended difference: a provider that raises. The JAX policy catches
every exception of a signer and of a sub-policy and denies; the port's lets
anything but a verdict propagate, so a CUDA failure inside a policy
evaluation raises instead of reading as a denial. One batch_verify call
verifies a signature policy's signers.
"""

import random

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import chip_smoke  # noqa: E402
from fabric_tpu.channelconfig import encoder as jenc  # noqa: E402
from fabric_tpu.crypto.bccsp import SoftwareProvider  # noqa: E402
from fabric_tpu.msp import identity as jid  # noqa: E402
from fabric_tpu.policy import from_dsl as jdsl  # noqa: E402
from fabric_tpu.policy import manager as jman  # noqa: E402
from fabric_tpu.protos import configtx_pb2, policies_pb2  # noqa: E402
from fabric_tpu_torch.channelconfig import encoder as tenc  # noqa: E402
from fabric_tpu_torch.crypto import bccsp as tbccsp  # noqa: E402
from fabric_tpu_torch.msp.cryptogen import generate_org  # noqa: E402
from fabric_tpu_torch.msp.identity import MSP, MSPManager  # noqa: E402
from fabric_tpu_torch.msp.signer import SigningIdentity  # noqa: E402
from fabric_tpu_torch.policy import manager as tman  # noqa: E402
from fabric_tpu_torch.policy.ast import from_dsl as tdsl  # noqa: E402
from fabric_tpu_torch.protos import configtx as C  # noqa: E402
from fabric_tpu_torch.protos import wire  # noqa: E402

SW = SoftwareProvider()
ORACLE = chip_smoke.oracle_provider({})


def to_jax_msp(c):
    return jid.MSPConfig(c.msp_id, c.root_certs, c.intermediate_certs, c.admins,
                         c.revocation_list, jid.NodeOUs(enable=c.node_ous.enable))


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    rng = random.Random(4141)
    org1 = generate_org("org1", "Org1MSP", num_peers=2, rng=rng)
    org2 = generate_org("org2", "Org2MSP", rng=rng)
    org9 = generate_org("org9", "Org9MSP", rng=rng)  # no manager knows it
    signers = {name: SigningIdentity(node, rng) for name, node in (
        ("org1_peer", org1.peers[0]), ("org1_peer2", org1.peers[1]), ("org1_admin", org1.admin),
        ("org1_user", org1.users[0]), ("org2_peer", org2.peers[0]), ("org2_user", org2.users[0]),
        ("org9_peer", org9.peers[0]))}
    configs = [org1.msp_config(), org2.msp_config()]
    return {
        "signers": signers, "configs": configs,
        "tmgr": MSPManager([MSP(c) for c in configs]),
        "jmgr": jid.MSPManager([jid.MSP(to_jax_msp(c), provider=SW) for c in configs]),
    }


MSG = b"signed bytes"


def sd_for(world, spec):
    """A SignedData from a spec: "name" signs MSG; "name!" with its
    signature's last byte flipped; "name?" with a signature that is not DER;
    "garbage" an identity that does not deserialize."""
    if spec == "garbage":
        return tman.SignedData(MSG, b"\x0a\x03Org", b"\x30\x00")
    name = spec.rstrip("!?")
    s = world["signers"][name]
    sig = s.sign(MSG)
    if spec.endswith("!"):
        sig = sig[:-1] + bytes([sig[-1] ^ 0x01])
    if spec.endswith("?"):
        sig = b"\x31" + sig[1:]
    return tman.SignedData(MSG, s.serialize(), sig)


SETS = {
    "empty": [],
    "one_member": ["org1_peer"],
    "duplicate_identity": ["org1_peer", "org1_peer"],
    "duplicate_first_flipped": ["org1_peer!", "org1_peer"],
    "flipped": ["org1_peer!"],
    "not_der": ["org1_peer?"],
    "unknown_msp": ["org9_peer"],
    "garbage_identity": ["garbage", "org2_peer"],
    "two_orgs": ["org1_peer", "org2_peer"],
    "two_org1_peers": ["org1_peer", "org1_peer2"],
    "admin_and_user": ["org1_admin", "org2_user"],
    "flipped_and_good": ["org2_peer!", "org1_user"],
}

POLICIES = {
    "or_members": "OR('Org1MSP.member','Org2MSP.member')",
    "and_members": "AND('Org1MSP.member','Org2MSP.member')",
    "two_of_three": "OutOf(2,'Org1MSP.member','Org2MSP.member','Org1MSP.admin')",
    "org1_admin": "AND('Org1MSP.admin')",
    "org1_peer": "OR('Org1MSP.peer')",
    "org2_client": "OR('Org2MSP.client')",
    "two_org1_members": "AND('Org1MSP.member','Org1MSP.member')",
}


def outcome(policy, signed):
    try:
        policy.evaluate_signed_data(signed)
        return ("allowed",)
    except (jman.PolicyError, tman.PolicyError) as exc:
        return ("denied", str(exc))


def both(world, tpolicy, jpolicy, specs):
    sds = [sd_for(world, s) for s in specs]
    jsds = [jman.SignedData(s.data, s.identity, s.signature) for s in sds]
    return outcome(jpolicy, jsds), outcome(tpolicy, sds)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("signers", sorted(SETS))
def test_signature_policy_verdicts_equal(world, policy, signers):
    dsl = POLICIES[policy]
    j = jman.SignaturePolicy(jdsl(dsl), world["jmgr"], SW)
    t = tman.SignaturePolicy(tdsl(dsl), world["tmgr"], ORACLE)
    got_j, got_t = both(world, t, j, SETS[signers])
    assert got_j == got_t


class CountingOracle(tbccsp.Provider):
    def __init__(self):
        self.calls = []

    def batch_verify(self, keys, signatures, digests):
        self.calls.append(len(keys))
        return ORACLE.batch_verify(keys, signatures, digests)


def test_one_batch_verify_per_signature_policy(world):
    """Deduped, deserialized signers verify in one provider call; an identity
    that does not deserialize never reaches it."""
    provider = CountingOracle()
    t = tman.SignaturePolicy(tdsl(POLICIES["and_members"]), world["tmgr"], provider)
    t.evaluate_signed_data([sd_for(world, s) for s in
                            ("org1_peer", "org1_peer", "org9_peer", "garbage", "org2_peer")])
    assert provider.calls == [2]
    with pytest.raises(tman.PolicyError, match="no valid signatures"):
        t.evaluate_signed_data([sd_for(world, "org9_peer")])
    assert provider.calls == [2]


RULES = {"any": ("ANY", 0), "all": ("ALL", 1), "majority": ("MAJORITY", 2)}
SUBS = ("OR('Org1MSP.member')", "OR('Org2MSP.member')", None)  # None: a missing sub-policy


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("signers", ["empty", "one_member", "two_orgs", "flipped_and_good",
                                     "unknown_msp"])
def test_implicit_meta_verdicts_equal(world, rule, signers):
    name, value = RULES[rule]
    jsubs = [jman.SignaturePolicy(jdsl(d), world["jmgr"], SW) if d else jman.RejectPolicy("Gone")
             for d in SUBS]
    tsubs = [tman.SignaturePolicy(tdsl(d), world["tmgr"], ORACLE) if d else tman.RejectPolicy(
        "Gone") for d in SUBS]
    assert getattr(policies_pb2.ImplicitMetaPolicy, name) == value == getattr(C, name)
    j = jman.ImplicitMetaPolicy(value, "Writers", jsubs)
    t = tman.ImplicitMetaPolicy(value, "Writers", tsubs)
    assert j.threshold == t.threshold
    got_j, got_t = both(world, t, j, SETS[signers])
    assert got_j == got_t


def test_implicit_meta_unknown_rule_and_empty_children():
    for mod in (jman, tman):
        with pytest.raises(mod.PolicyError, match="unknown implicit meta rule"):
            mod.ImplicitMetaPolicy(7, "Admins", [])
        assert outcome(mod.ImplicitMetaPolicy(0, "Readers", []), [])[0] == "denied"
        assert outcome(mod.ImplicitMetaPolicy(1, "Readers", []), []) == ("allowed",)


def test_manager_built_from_one_group(world):
    """build_manager over one Application group's bytes: the same policy
    names, the same paths found, the same verdicts."""
    orgs = [tenc.OrganizationProfile(c.msp_id, c) for c in world["configs"]]
    raw = wire.encode(C.CONFIG_GROUP, tenc.new_application_group(
        tenc.ApplicationProfile(organizations=orgs)))
    t = tman.build_manager("Channel", wire.decode(C.CONFIG_GROUP, raw), world["tmgr"], ORACLE)
    j = jman.build_manager("Channel", configtx_pb2.ConfigGroup.FromString(raw), world["jmgr"],
                           SW)
    assert t.policy_names == j.policy_names
    assert sorted(t.children) == sorted(j.children) == ["Org1MSP", "Org2MSP"]
    for path in ("Admins", "/Channel/Org1MSP/Endorsement", "/Channel/Org2MSP/Nope", "/Nope/X",
                 "/", "Readers", "/Channel/Readers"):
        assert t.get_policy(path)[1] == j.get_policy(path)[1], path
    assert t.manager(["Org1MSP"]).policy_names == j.manager(["Org1MSP"]).policy_names
    assert t.manager(["Org3MSP", "x"]) is j.manager(["Org3MSP", "x"]) is None
    for path in ("Admins", "Writers", "Endorsement", "LifecycleEndorsement"):
        for signers in ("one_member", "two_orgs", "admin_and_user", "empty"):
            got_j, got_t = both(world, t.get_policy(path)[0], j.get_policy(path)[0],
                                SETS[signers])
            assert got_j == got_t, (path, signers)
    assert jenc.ADMINS_POLICY_KEY == tenc.ADMINS_POLICY_KEY


def test_unsupported_policy_type_rejects_in_both(world):
    group = {"policies": {"Odd": {"policy": {"type": C.MSP, "value": b""}}}}
    raw = wire.encode(C.CONFIG_GROUP, group)
    t = tman.build_manager("Channel", wire.decode(C.CONFIG_GROUP, raw), world["tmgr"], ORACLE)
    j = jman.build_manager("Channel", configtx_pb2.ConfigGroup.FromString(raw), world["jmgr"], SW)
    assert both(world, t.get_policy("Odd")[0], j.get_policy("Odd")[0], SETS["one_member"]) == (
        ("denied", "no such policy: 'Odd (unsupported type 2)'"),) * 2


class DeviceFailure(RuntimeError):
    pass


class RaisingProvider(tbccsp.Provider):
    """A provider whose launch fails, as a CUDA build, launch or copy
    error would."""

    def batch_verify(self, keys, signatures, digests):
        raise DeviceFailure("CUDA error: an illegal memory access was encountered")

    def verify(self, key, signature, digest):
        raise DeviceFailure("CUDA error: an illegal memory access was encountered")


def test_a_raising_provider_raises_in_the_port_and_denies_in_jax(world):
    """The narrowed exception path, the intended difference from the JAX
    package: its SignaturePolicy and ImplicitMetaPolicy turn the failure
    into a denial; the port's raise it."""
    specs = ["org1_peer", "org2_peer"]
    t = tman.SignaturePolicy(tdsl(POLICIES["or_members"]), world["tmgr"], RaisingProvider())
    with pytest.raises(DeviceFailure):
        t.evaluate_signed_data([sd_for(world, s) for s in specs])
    meta = tman.ImplicitMetaPolicy(0, "Writers", [t])
    with pytest.raises(DeviceFailure):
        meta.evaluate_signed_data([sd_for(world, s) for s in specs])
    jmgr = jid.MSPManager([jid.MSP(to_jax_msp(c), provider=RaisingProvider())
                           for c in world["configs"]])
    j = jman.SignaturePolicy(jdsl(POLICIES["or_members"]), jmgr, RaisingProvider())
    jsds = [jman.SignedData(s.data, s.identity, s.signature)
            for s in (sd_for(world, x) for x in specs)]
    assert outcome(j, jsds)[0] == "denied"
    assert outcome(jman.ImplicitMetaPolicy(0, "Writers", [j]), jsds)[0] == "denied"
    # no signer to verify: nothing reaches the provider, a denial in both
    assert outcome(t, [sd_for(world, "org9_peer")]) == outcome(j, [])
