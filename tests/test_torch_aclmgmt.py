"""The port's ACL provider (`fabric_tpu_torch.peer.aclmgmt`) against the JAX
package's.

Every resource of DEFAULT_ACLS, without and with channel-config overrides
(an absolute policy path, a bare Application sub-policy name, a path that
does not exist), checked in both packages over the same SignedData (an
Org1 peer, Org1's admin, Org2's user, an unknown MSP, a flipped signature,
an empty set) on one channel config read by both (the port's encoder's
bytes; the port verifies over its P-256 oracle, the JAX package over
SoftwareProvider). Each outcome (allowed, or the ACLError's text) is equal
in both. Local-MSP resources go to `local_check`: none installed, a denial
and an allowance are equal in both; a local check that raises anything but a
PolicyError is the one intended difference (the JAX provider turns it into
an access denial, the port's lets it through), and so is a channel policy
whose provider raises.
"""

import random

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

import chip_smoke  # noqa: E402
from fabric_tpu.channelconfig import bundle as jbundle  # noqa: E402
from fabric_tpu.crypto.bccsp import SoftwareProvider  # noqa: E402
from fabric_tpu.peer import aclmgmt as jacl  # noqa: E402
from fabric_tpu.policy import manager as jman  # noqa: E402
from fabric_tpu.protos import configtx_pb2  # noqa: E402
from fabric_tpu_torch.channelconfig import bundle as tbundle  # noqa: E402
from fabric_tpu_torch.channelconfig import encoder as tenc  # noqa: E402
from fabric_tpu_torch.crypto import bccsp as tbccsp  # noqa: E402
from fabric_tpu_torch.msp.cryptogen import generate_org  # noqa: E402
from fabric_tpu_torch.msp.signer import SigningIdentity  # noqa: E402
from fabric_tpu_torch.peer import aclmgmt as tacl  # noqa: E402
from fabric_tpu_torch.policy import manager as tman  # noqa: E402
from fabric_tpu_torch.protos import configtx as C  # noqa: E402
from fabric_tpu_torch.protos import wire  # noqa: E402

CHANNEL = "aclchannel"
SW = SoftwareProvider()
ORACLE = chip_smoke.oracle_provider({})
MSG = b"a request"

OVERRIDES = {
    "none": {},
    "absolute": {tacl.EVENT_BLOCK: "/Channel/Application/Writers",
                 tacl.QSCC_GET_CHAIN_INFO: "/Channel/Application/Admins",
                 tacl.PEER_PROPOSE: "/Channel/Orderer/Admins"},
    "bare_names": {tacl.EVENT_FILTERED_BLOCK: "Admins", tacl.LSCC_GET_CC_DATA: "Writers",
                   tacl.CSCC_GET_CHANNELS: "Readers"},
    "missing_policy": {tacl.QSCC_GET_BLOCK_BY_NUMBER: "/Channel/Application/Nope"},
}
SIGNERS = ("org1_peer", "org1_admin", "org2_user", "org9_peer", "org1_peer!", "nobody")


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    rng = random.Random(5151)
    org1, org2, oorg, org9 = (generate_org(n, m, rng=rng) for n, m in (
        ("org1", "Org1MSP"), ("org2", "Org2MSP"), ("orderer", "OrdererMSP"), ("org9", "Org9MSP")))
    signers = {"org1_peer": SigningIdentity(org1.peers[0], rng),
               "org1_admin": SigningIdentity(org1.admin, rng),
               "org2_user": SigningIdentity(org2.users[0], rng),
               "org9_peer": SigningIdentity(org9.peers[0], rng)}
    profile = tenc.Profile(
        application=tenc.ApplicationProfile(organizations=[
            tenc.OrganizationProfile(o.msp_id, o.msp_config()) for o in (org1, org2)]),
        orderer=tenc.OrdererProfile(organizations=[
            tenc.OrganizationProfile("OrdererMSP", oorg.msp_config())]))
    raw = wire.encode(C.CONFIG, tenc.new_config(profile))
    return {"signers": signers, "config_raw": raw,
            "tbundle": tbundle.Bundle(CHANNEL, wire.decode(C.CONFIG, raw), ORACLE),
            "jbundle": jbundle.Bundle(CHANNEL, configtx_pb2.Config.FromString(raw), SW)}


def signed(world, spec):
    if spec == "nobody":
        return []
    s = world["signers"][spec.rstrip("!")]
    sig = s.sign(MSG)
    if spec.endswith("!"):
        sig = sig[:-1] + bytes([sig[-1] ^ 0x01])
    return [tman.SignedData(MSG, s.serialize(), sig)]


def local_check(mod, allowed):
    def check(policy, sds):
        if policy not in allowed:
            raise mod.PolicyError(f"local policy {policy} not satisfied")
    return check


def providers(world, overrides, local=None):
    return (
        jacl.ACLProvider(lambda cid: world["jbundle"].policy_manager if cid == CHANNEL else None,
                         lambda cid: overrides,
                         local_check(jman, local) if local is not None else None),
        tacl.ACLProvider(lambda cid: world["tbundle"].policy_manager if cid == CHANNEL else None,
                         lambda cid: overrides,
                         local_check(tman, local) if local is not None else None),
    )


def outcome(acl, resource, channel, sds):
    try:
        acl.check_acl(resource, channel, sds)
        return ("allowed",)
    except (jacl.ACLError, tacl.ACLError) as exc:
        return ("denied", str(exc))


def test_default_acls_and_resources_equal():
    assert tacl.DEFAULT_ACLS == jacl.DEFAULT_ACLS
    names = [n for n in dir(jacl) if n.isupper() and isinstance(getattr(jacl, n), str)]
    assert {n: getattr(tacl, n) for n in names} == {n: getattr(jacl, n) for n in names}


@pytest.mark.parametrize("overrides", sorted(OVERRIDES))
@pytest.mark.parametrize("resource", sorted(jacl.DEFAULT_ACLS))
def test_every_resource_checks_equal(world, resource, overrides):
    jp, tp = providers(world, OVERRIDES[overrides], local={"Members"})
    assert jp.policy_for(resource, CHANNEL) == tp.policy_for(resource, CHANNEL)
    jsds = {s: [jman.SignedData(x.data, x.identity, x.signature) for x in signed(world, s)]
            for s in SIGNERS}
    got = [(outcome(jp, resource, CHANNEL, jsds[s]), outcome(tp, resource, CHANNEL,
                                                             signed(world, s))) for s in SIGNERS]
    assert [j for j, _ in got] == [t for _, t in got]
    if tp.policy_for(resource, CHANNEL).startswith("/Channel/Application/Readers"):
        assert [t[0] for _, t in got] == ["allowed"] * 3 + ["denied"] * 3


def test_unknown_resource_channel_and_missing_local_check(world):
    jp, tp = providers(world, {})
    for resource, channel in (("nope/Nope", CHANNEL), (tacl.PEER_PROPOSE, "otherchannel"),
                              (tacl.CSCC_JOIN_CHAIN, CHANNEL)):
        assert outcome(jp, resource, channel, []) == outcome(tp, resource, channel, [])
        assert outcome(tp, resource, channel, [])[0] == "denied"


class DeviceFailure(RuntimeError):
    pass


def test_a_failure_in_a_local_check_raises_in_the_port_only(world):
    """JAX: any exception of local_check is an access denial. Port: only a
    PolicyError is; anything else propagates."""

    def failing(policy, sds):
        raise DeviceFailure("CUDA error: launch failed")

    jp = jacl.ACLProvider(lambda cid: None, local_check=failing)
    tp = tacl.ACLProvider(lambda cid: None, local_check=failing)
    assert outcome(jp, tacl.CSCC_JOIN_CHAIN, CHANNEL, [])[0] == "denied"
    with pytest.raises(DeviceFailure):
        tp.check_acl(tacl.CSCC_JOIN_CHAIN, CHANNEL, [])


class RaisingProvider(tbccsp.Provider):
    def batch_verify(self, keys, signatures, digests):
        raise DeviceFailure("CUDA error: an illegal memory access was encountered")


def test_a_raising_provider_raises_through_check_acl(world):
    bundle = tbundle.Bundle(CHANNEL, wire.decode(C.CONFIG, world["config_raw"]), RaisingProvider())
    tp = tacl.ACLProvider(lambda cid: bundle.policy_manager)
    with pytest.raises(DeviceFailure):
        tp.check_acl(tacl.PEER_PROPOSE, CHANNEL, signed(world, "org1_peer"))
    # nothing to verify (an unknown MSP): a denial, no launch
    assert outcome(tp, tacl.PEER_PROPOSE, CHANNEL, signed(world, "org9_peer"))[0] == "denied"


def test_bundle_acl_policy_ref_equal(world):
    """Bundle.acl_policy_ref reads the config's ACLs as the JAX one does."""
    acls = {tacl.EVENT_BLOCK: "Writers", tacl.PEER_PROPOSE: "/Channel/Application/Admins"}
    config = wire.decode(C.CONFIG, world["config_raw"])
    config["channel_group"]["groups"]["Application"].setdefault("values", {})["ACLs"] = {
        "value": wire.encode(C.ACLS, {"acls": {k: {"policy_ref": v} for k, v in acls.items()}})}
    raw = wire.encode(C.CONFIG, config)
    t = tbundle.Bundle(CHANNEL, wire.decode(C.CONFIG, raw), ORACLE)
    j = jbundle.Bundle(CHANNEL, configtx_pb2.Config.FromString(raw), SW)
    for resource in (tacl.EVENT_BLOCK, tacl.PEER_PROPOSE, tacl.QSCC_GET_CHAIN_INFO):
        assert t.acl_policy_ref(resource, "dflt") == j.acl_policy_ref(resource, "dflt")
    assert t.application.acls == acls
