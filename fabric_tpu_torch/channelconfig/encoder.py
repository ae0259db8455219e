"""Genesis/config-tx generation (reference cmd/configtxgen +
internal/configtxgen/encoder/encoder.go).

The port's counterpart of the JAX package's `channelconfig/encoder.py`, over
the wire codec: groups, configs and blocks are dicts in `wire.decode`'s form.
Profiles are plain dataclasses (the reference reads configtx.yaml into
equivalent structs). The encoder builds the ConfigGroup tree with the
reference's default implicit-meta channel policies and per-org signature
policies, then wraps it as a genesis block or a channel-creation
ConfigUpdate. Every message is written by `wire.encode`, so a value holding
a map (ACLs, Capabilities) has its entries in upb's key order, as protobuf's
deterministic serialization writes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.channelconfig import bundle as bundlemod
from fabric_tpu_torch.msp.identity import MSPConfig
from fabric_tpu_torch.policy import ast as policy_ast
from fabric_tpu_torch.policy import proto_convert
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire

ADMINS_POLICY_KEY = "Admins"
READERS_POLICY_KEY = "Readers"
WRITERS_POLICY_KEY = "Writers"
ENDORSEMENT_POLICY_KEY = "Endorsement"
LIFECYCLE_ENDORSEMENT_POLICY_KEY = "LifecycleEndorsement"
BLOCK_VALIDATION_POLICY_KEY = "BlockValidation"


@dataclass
class OrganizationProfile:
    name: str
    msp: MSPConfig
    anchor_peers: List[Tuple[str, int]] = field(default_factory=list)
    orderer_endpoints: List[str] = field(default_factory=list)
    # policy name -> policy DSL string; defaults derived from msp_id if empty
    policies: Dict[str, str] = field(default_factory=dict)


@dataclass
class ApplicationProfile:
    organizations: List[OrganizationProfile] = field(default_factory=list)
    capabilities: List[str] = field(default_factory=lambda: ["V2_0"])
    acls: Dict[str, str] = field(default_factory=dict)


@dataclass
class OrdererProfile:
    orderer_type: str = "solo"
    addresses: List[str] = field(default_factory=list)
    batch_timeout: str = "2s"
    max_message_count: int = 500
    absolute_max_bytes: int = 10 * 1024 * 1024
    preferred_max_bytes: int = 2 * 1024 * 1024
    organizations: List[OrganizationProfile] = field(default_factory=list)
    capabilities: List[str] = field(default_factory=lambda: ["V2_0"])
    raft_consenters: List[Tuple[str, int, bytes, bytes]] = field(
        default_factory=list
    )  # (host, port, client_tls_cert, server_tls_cert)


@dataclass
class Profile:
    """One configtx.yaml profile."""

    consortium: str = ""
    application: Optional[ApplicationProfile] = None
    orderer: Optional[OrdererProfile] = None
    consortiums: Dict[str, List[OrganizationProfile]] = field(default_factory=dict)
    capabilities: List[str] = field(default_factory=lambda: ["V2_0"])
    policies: Dict[str, str] = field(default_factory=dict)


def _implicit_meta(rule: int, sub_policy: str) -> dict:
    meta = wire.encode(cfgpb.IMPLICIT_META_POLICY, {"rule": rule, "sub_policy": sub_policy})
    return {"type": cfgpb.IMPLICIT_META, "value": meta}


def _signature_policy(dsl: str) -> dict:
    env = policy_ast.from_dsl(dsl)
    return {"type": cfgpb.SIGNATURE, "value": proto_convert.marshal_envelope(env)}


def _add_policy(group: dict, name: str, policy: dict, mod_policy: str = ADMINS_POLICY_KEY) -> None:
    group.setdefault("policies", {})[name] = {"policy": policy, "mod_policy": mod_policy}


def _add_value(group: dict, name: str, schema: wire.Schema, msg: dict,
               mod_policy: str = ADMINS_POLICY_KEY) -> None:
    group.setdefault("values", {})[name] = {"value": wire.encode(schema, msg),
                                            "mod_policy": mod_policy}


def _implicit_meta_defaults(group: dict) -> None:
    _add_policy(group, READERS_POLICY_KEY, _implicit_meta(cfgpb.ANY, READERS_POLICY_KEY))
    _add_policy(group, WRITERS_POLICY_KEY, _implicit_meta(cfgpb.ANY, WRITERS_POLICY_KEY))
    _add_policy(group, ADMINS_POLICY_KEY, _implicit_meta(cfgpb.MAJORITY, ADMINS_POLICY_KEY))


def _capabilities_value(names: Sequence[str]) -> dict:
    return {"capabilities": {n: {} for n in names}}


def new_org_group(org: OrganizationProfile, with_anchors: bool = False,
                  orderer_org: bool = False) -> dict:
    """Reference encoder.NewOrgConfigGroup: MSP value + org-scoped
    Readers/Writers/Admins (+Endorsement) signature policies."""
    g: dict = {"mod_policy": ADMINS_POLICY_KEY}
    msp_id = org.msp.msp_id
    defaults = {
        READERS_POLICY_KEY: f"OR('{msp_id}.member')",
        WRITERS_POLICY_KEY: f"OR('{msp_id}.member')",
        ADMINS_POLICY_KEY: f"OR('{msp_id}.admin')",
    }
    if not orderer_org:
        defaults[ENDORSEMENT_POLICY_KEY] = f"OR('{msp_id}.member')"
    defaults.update(org.policies)
    for name, dsl in defaults.items():
        _add_policy(g, name, _signature_policy(dsl))
    _add_value(g, bundlemod.MSP_KEY, cfgpb.MSP_CONFIG,
               bundlemod.local_msp_config_to_proto(org.msp))
    if with_anchors and org.anchor_peers:
        _add_value(g, bundlemod.ANCHOR_PEERS_KEY, cfgpb.ANCHOR_PEERS,
                   {"anchor_peers": [{"host": h, "port": p} for h, p in org.anchor_peers]})
    if orderer_org and org.orderer_endpoints:
        _add_value(g, bundlemod.ENDPOINTS_KEY, cfgpb.ORDERER_ADDRESSES,
                   {"addresses": list(org.orderer_endpoints)})
    return g


def new_application_group(profile: ApplicationProfile) -> dict:
    g: dict = {"mod_policy": ADMINS_POLICY_KEY}
    _implicit_meta_defaults(g)
    _add_policy(g, ENDORSEMENT_POLICY_KEY, _implicit_meta(cfgpb.MAJORITY, ENDORSEMENT_POLICY_KEY))
    _add_policy(g, LIFECYCLE_ENDORSEMENT_POLICY_KEY,
                _implicit_meta(cfgpb.MAJORITY, ENDORSEMENT_POLICY_KEY))
    if profile.capabilities:
        _add_value(g, bundlemod.CAPABILITIES_KEY, cfgpb.CAPABILITIES,
                   _capabilities_value(profile.capabilities))
    if profile.acls:
        _add_value(g, bundlemod.ACLS_KEY, cfgpb.ACLS,
                   {"acls": {k: {"policy_ref": ref} for k, ref in profile.acls.items()}})
    for org in profile.organizations:
        g.setdefault("groups", {})[org.name] = new_org_group(org, with_anchors=True)
    return g


def new_orderer_group(profile: OrdererProfile) -> dict:
    g: dict = {"mod_policy": ADMINS_POLICY_KEY}
    _implicit_meta_defaults(g)
    _add_policy(g, BLOCK_VALIDATION_POLICY_KEY, _implicit_meta(cfgpb.ANY, WRITERS_POLICY_KEY))
    ct = {"type": profile.orderer_type}
    if profile.orderer_type == "etcdraft":
        meta = {
            "consenters": [
                {"host": host, "port": port, "client_tls_cert": client_cert,
                 "server_tls_cert": server_cert}
                for host, port, client_cert, server_cert in profile.raft_consenters],
            "options": {"tick_interval": "500ms", "election_tick": 10, "heartbeat_tick": 1,
                        "max_inflight_blocks": 5, "snapshot_interval_size": 16 * 1024 * 1024},
        }
        ct["metadata"] = wire.encode(cfgpb.RAFT_CONFIG_METADATA, meta)
    _add_value(g, bundlemod.CONSENSUS_TYPE_KEY, cfgpb.CONSENSUS_TYPE, ct)
    _add_value(g, bundlemod.BATCH_SIZE_KEY, cfgpb.BATCH_SIZE, {
        "max_message_count": profile.max_message_count,
        "absolute_max_bytes": profile.absolute_max_bytes,
        "preferred_max_bytes": profile.preferred_max_bytes,
    })
    _add_value(g, bundlemod.BATCH_TIMEOUT_KEY, cfgpb.BATCH_TIMEOUT,
               {"timeout": profile.batch_timeout})
    if profile.capabilities:
        _add_value(g, bundlemod.CAPABILITIES_KEY, cfgpb.CAPABILITIES,
                   _capabilities_value(profile.capabilities))
    for org in profile.organizations:
        g.setdefault("groups", {})[org.name] = new_org_group(org, orderer_org=True)
    return g


def new_channel_group(profile: Profile) -> dict:
    """Reference encoder.NewChannelGroup."""
    root: dict = {"mod_policy": ADMINS_POLICY_KEY}
    _implicit_meta_defaults(root)
    _add_value(root, bundlemod.HASHING_ALGORITHM_KEY, cfgpb.HASHING_ALGORITHM, {"name": "SHA256"})
    _add_value(root, bundlemod.BLOCK_DATA_HASHING_STRUCTURE_KEY,
               cfgpb.BLOCK_DATA_HASHING_STRUCTURE, {"width": 2**32 - 1})
    if profile.orderer is not None and profile.orderer.addresses:
        _add_value(root, bundlemod.ORDERER_ADDRESSES_KEY, cfgpb.ORDERER_ADDRESSES,
                   {"addresses": list(profile.orderer.addresses)})
    if profile.consortium:
        _add_value(root, bundlemod.CONSORTIUM_KEY, cfgpb.CONSORTIUM, {"name": profile.consortium})
    if profile.capabilities:
        _add_value(root, bundlemod.CAPABILITIES_KEY, cfgpb.CAPABILITIES,
                   _capabilities_value(profile.capabilities))
    groups: dict = {}
    if profile.orderer is not None:
        groups[bundlemod.ORDERER_GROUP] = new_orderer_group(profile.orderer)
    if profile.application is not None:
        groups[bundlemod.APPLICATION_GROUP] = new_application_group(profile.application)
    if profile.consortiums:
        cg: dict = {"mod_policy": "/Channel/Orderer/Admins"}
        for cname, orgs in profile.consortiums.items():
            consortium: dict = {"mod_policy": "/Channel/Orderer/Admins"}
            creation = wire.encode(cfgpb.POLICY, _implicit_meta(cfgpb.ANY, ADMINS_POLICY_KEY))
            consortium["values"] = {bundlemod.CHANNEL_CREATION_POLICY_KEY: {"value": creation}}
            for org in orgs:
                consortium.setdefault("groups", {})[org.name] = new_org_group(org)
            cg.setdefault("groups", {})[cname] = consortium
        groups[bundlemod.CONSORTIUMS_GROUP] = cg
    if groups:
        root["groups"] = groups
    return root


def new_config(profile: Profile, sequence: int = 0) -> dict:
    return {"sequence": sequence, "channel_group": new_channel_group(profile)}


def genesis_block(profile: Profile, channel_id: str) -> dict:
    """Reference encoder.Bootstrapper.GenesisBlockForChannel: block 0 holds
    one CONFIG envelope carrying the full Config."""
    cenv = {"config": new_config(profile)}
    chdr = protoutil.make_channel_header(fabric.CONFIG, channel_id)
    payload = {
        "header": {"channel_header": wire.encode(fabric.CHANNEL_HEADER, chdr),
                   "signature_header": b""},
        "data": wire.encode(cfgpb.CONFIG_ENVELOPE, cenv),
    }
    env = {"payload": wire.encode(fabric.PAYLOAD, payload)}
    block = protoutil.new_block(0, b"")
    block["data"]["data"].append(wire.encode(fabric.ENVELOPE, env))
    return protoutil.seal_block(block)


def channel_creation_config_update(channel_id: str, consortium: str,
                                   application: ApplicationProfile) -> dict:
    """Reference encoder.NewChannelCreateConfigUpdate (template form): the
    read set pins consortium + org groups at version 0; the write set
    bumps the Application group to version 1 with the full app config."""
    cons = wire.encode(cfgpb.CONSORTIUM, {"name": consortium})
    ws_app = new_application_group(application)
    ws_app["version"] = 1
    return {
        "channel_id": channel_id,
        "read_set": {
            "values": {bundlemod.CONSORTIUM_KEY: {"value": cons}},
            "groups": {bundlemod.APPLICATION_GROUP: {
                "groups": {org.name: {} for org in application.organizations}}},
        },
        "write_set": {
            "values": {bundlemod.CONSORTIUM_KEY: {"value": cons}},
            "groups": {bundlemod.APPLICATION_GROUP: ws_app},
        },
    }
