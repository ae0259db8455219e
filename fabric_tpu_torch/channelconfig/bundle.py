"""Typed view over the on-ledger channel config tree (reference
common/channelconfig/bundle.go + {channel,orderer,application,org,msp}
config handlers).

The port's counterpart of the JAX package's `channelconfig/bundle.py`, over
the wire codec: a config is a dict in `wire.decode`'s form
(`protos/configtx.CONFIG`). A Bundle is an immutable snapshot of one Config:
typed accessors for the channel/orderer/application values, the per-channel
MSPManager assembled from every org's MSP config value (each MSP parsed by
the port's own X.509 reader), and the policy Manager tree. Config blocks
swap in a whole new Bundle (reference bundlesource.go); nothing here
mutates.

Unlike the JAX Bundle, this one makes no provider: the caller passes the
one the policy tree verifies with (`CUDAProvider`, or a `BatchingProvider`
over it, on the card), and a Bundle without one raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.channelconfig import capabilities as caps
from fabric_tpu_torch.msp.identity import MSP, MSPConfig, MSPManager, NodeOUs
from fabric_tpu_torch.policy.manager import Manager, build_manager
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire

# Config tree group names (reference common/channelconfig/channel.go etc.)
APPLICATION_GROUP = "Application"
ORDERER_GROUP = "Orderer"
CONSORTIUMS_GROUP = "Consortiums"

# Config value names
HASHING_ALGORITHM_KEY = "HashingAlgorithm"
BLOCK_DATA_HASHING_STRUCTURE_KEY = "BlockDataHashingStructure"
ORDERER_ADDRESSES_KEY = "OrdererAddresses"
CONSORTIUM_KEY = "Consortium"
CAPABILITIES_KEY = "Capabilities"
MSP_KEY = "MSP"
ANCHOR_PEERS_KEY = "AnchorPeers"
ACLS_KEY = "ACLs"
ENDPOINTS_KEY = "Endpoints"
CONSENSUS_TYPE_KEY = "ConsensusType"
BATCH_SIZE_KEY = "BatchSize"
BATCH_TIMEOUT_KEY = "BatchTimeout"
CHANNEL_RESTRICTIONS_KEY = "ChannelRestrictions"
CHANNEL_CREATION_POLICY_KEY = "ChannelCreationPolicy"

# MSPConfig.type values (reference msp/msp.go ProviderType)
MSP_TYPE_FABRIC = 0
MSP_TYPE_IDEMIX = 1


class ConfigError(Exception):
    pass


def _value(group: dict, key: str, schema: wire.Schema) -> Optional[dict]:
    cv = group.get("values", {}).get(key)
    if cv is None:
        return None
    return protoutil.unmarshal(schema, cv.get("value", b""))


def _capability_names(group: dict) -> List[str]:
    v = _value(group, CAPABILITIES_KEY, cfgpb.CAPABILITIES)
    return sorted(v.get("capabilities", {})) if v is not None else []


@dataclass(frozen=True)
class OrgConfig:
    name: str
    msp_id: str
    anchor_peers: Tuple[Tuple[str, int], ...] = ()
    ordererendpoints: Tuple[str, ...] = ()


@dataclass(frozen=True)
class OrdererConfig:
    consensus_type: str
    consensus_metadata: bytes
    consensus_state: int
    batch_size_max_messages: int
    batch_size_absolute_max_bytes: int
    batch_size_preferred_max_bytes: int
    batch_timeout: str
    orgs: Tuple[OrgConfig, ...]
    capabilities: caps.OrdererCapabilities
    max_channels: int = 0


@dataclass(frozen=True)
class ApplicationConfig:
    orgs: Tuple[OrgConfig, ...]
    capabilities: caps.ApplicationCapabilities
    acls: Dict[str, str] = field(default_factory=dict)


def _ou(node_ous: dict, name: str, default: str) -> str:
    return node_ous.get(name, {}).get("organizational_unit_identifier", "") or default


def fabric_msp_config_to_local(cfg: dict) -> MSPConfig:
    """A decoded FabricMSPConfig -> the MSP's MSPConfig."""
    node_ous = NodeOUs()
    if "fabric_node_ous" in cfg:
        f = cfg["fabric_node_ous"]
        node_ous = NodeOUs(
            enable=f.get("enable", False),
            client_ou=_ou(f, "client_ou_identifier", "client"),
            peer_ou=_ou(f, "peer_ou_identifier", "peer"),
            admin_ou=_ou(f, "admin_ou_identifier", "admin"),
            orderer_ou=_ou(f, "orderer_ou_identifier", "orderer"),
        )
    return MSPConfig(
        msp_id=cfg.get("name", ""),
        root_certs=list(cfg.get("root_certs", ())),
        intermediate_certs=list(cfg.get("intermediate_certs", ())),
        admins=list(cfg.get("admins", ())),
        revocation_list=list(cfg.get("revocation_list", ())),
        node_ous=node_ous,
    )


def local_msp_config_to_proto(cfg: MSPConfig) -> dict:
    """An MSPConfig -> a decoded msp.MSPConfig holding its FabricMSPConfig."""
    f = {
        "name": cfg.msp_id,
        "root_certs": list(cfg.root_certs),
        "intermediate_certs": list(cfg.intermediate_certs),
        "admins": list(cfg.admins),
        "revocation_list": list(cfg.revocation_list),
    }
    if cfg.node_ous.enable:
        f["fabric_node_ous"] = {
            "enable": True,
            "client_ou_identifier": {"organizational_unit_identifier": cfg.node_ous.client_ou},
            "peer_ou_identifier": {"organizational_unit_identifier": cfg.node_ous.peer_ou},
            "admin_ou_identifier": {"organizational_unit_identifier": cfg.node_ous.admin_ou},
            "orderer_ou_identifier": {"organizational_unit_identifier": cfg.node_ous.orderer_ou},
        }
    return {"type": MSP_TYPE_FABRIC, "config": wire.encode(cfgpb.FABRIC_MSP_CONFIG, f)}


def _parse_org(name: str, group: dict, provider=None) -> Tuple[OrgConfig, Optional[MSP]]:
    msp_cfg = _value(group, MSP_KEY, cfgpb.MSP_CONFIG)
    msp_obj = None
    msp_id = name
    if msp_cfg is not None and msp_cfg.get("type", 0) == MSP_TYPE_FABRIC:
        fabric_cfg = protoutil.unmarshal(cfgpb.FABRIC_MSP_CONFIG, msp_cfg.get("config", b""))
        local = fabric_msp_config_to_local(fabric_cfg)
        msp_id = local.msp_id
        msp_obj = MSP(local, provider)
    anchors: Tuple[Tuple[str, int], ...] = ()
    ap = _value(group, ANCHOR_PEERS_KEY, cfgpb.ANCHOR_PEERS)
    if ap is not None:
        anchors = tuple((p.get("host", ""), p.get("port", 0)) for p in ap.get("anchor_peers", ()))
    endpoints: Tuple[str, ...] = ()
    ep = _value(group, ENDPOINTS_KEY, cfgpb.ORDERER_ADDRESSES)
    if ep is not None:
        endpoints = tuple(ep.get("addresses", ()))
    return OrgConfig(name, msp_id, anchors, endpoints), msp_obj


class Bundle:
    """Immutable typed snapshot of one channel Config (a decoded
    `protos/configtx.CONFIG`)."""

    def __init__(self, channel_id: str, config: dict, provider):
        if "channel_group" not in config:
            raise ConfigError("config must contain a channel group")
        if provider is None:
            raise ConfigError("a Bundle needs the provider its policies verify with")
        self.channel_id = channel_id
        self.config = config
        root = config["channel_group"]

        # -- channel-level values ------------------------------------------
        ha = _value(root, HASHING_ALGORITHM_KEY, cfgpb.HASHING_ALGORITHM)
        self.hashing_algorithm = ha.get("name", "") if ha is not None else "SHA256"
        if self.hashing_algorithm not in ("SHA256", "SHA2_256"):
            raise ConfigError(f"unsupported hashing algorithm {self.hashing_algorithm}")
        bdhs = _value(root, BLOCK_DATA_HASHING_STRUCTURE_KEY, cfgpb.BLOCK_DATA_HASHING_STRUCTURE)
        self.block_data_hashing_width = bdhs.get("width", 0) if bdhs is not None else 2**32 - 1
        oa = _value(root, ORDERER_ADDRESSES_KEY, cfgpb.ORDERER_ADDRESSES)
        self.orderer_addresses = list(oa.get("addresses", ())) if oa is not None else []
        cons = _value(root, CONSORTIUM_KEY, cfgpb.CONSORTIUM)
        self.consortium_name = cons.get("name", "") if cons is not None else ""
        self.channel_capabilities = caps.ChannelCapabilities(_capability_names(root))

        msps: List[MSP] = []

        # -- orderer group --------------------------------------------------
        self.orderer: Optional[OrdererConfig] = None
        og = root.get("groups", {}).get(ORDERER_GROUP)
        if og is not None:
            ct = _value(og, CONSENSUS_TYPE_KEY, cfgpb.CONSENSUS_TYPE)
            bs = _value(og, BATCH_SIZE_KEY, cfgpb.BATCH_SIZE)
            bt = _value(og, BATCH_TIMEOUT_KEY, cfgpb.BATCH_TIMEOUT)
            cr = _value(og, CHANNEL_RESTRICTIONS_KEY, cfgpb.CHANNEL_RESTRICTIONS)
            orgs = []
            for name, sub in sorted(og.get("groups", {}).items()):
                org, msp_obj = _parse_org(name, sub, provider)
                orgs.append(org)
                if msp_obj is not None:
                    msps.append(msp_obj)
            self.orderer = OrdererConfig(
                consensus_type=ct.get("type", "") if ct is not None else "solo",
                consensus_metadata=ct.get("metadata", b"") if ct is not None else b"",
                consensus_state=ct.get("state", 0) if ct is not None else 0,
                batch_size_max_messages=bs.get("max_message_count", 0) if bs is not None else 500,
                batch_size_absolute_max_bytes=bs.get("absolute_max_bytes", 0)
                if bs is not None else 10 * 1024 * 1024,
                batch_size_preferred_max_bytes=bs.get("preferred_max_bytes", 0)
                if bs is not None else 2 * 1024 * 1024,
                batch_timeout=bt.get("timeout", "") if bt is not None else "2s",
                orgs=tuple(orgs),
                capabilities=caps.OrdererCapabilities(_capability_names(og)),
                max_channels=cr.get("max_count", 0) if cr is not None else 0,
            )

        # -- application group ----------------------------------------------
        self.application: Optional[ApplicationConfig] = None
        ag = root.get("groups", {}).get(APPLICATION_GROUP)
        if ag is not None:
            orgs = []
            for name, sub in sorted(ag.get("groups", {}).items()):
                org, msp_obj = _parse_org(name, sub, provider)
                orgs.append(org)
                if msp_obj is not None:
                    msps.append(msp_obj)
            acls: Dict[str, str] = {}
            av = _value(ag, ACLS_KEY, cfgpb.ACLS)
            if av is not None:
                acls = {k: v.get("policy_ref", "") for k, v in av.get("acls", {}).items()}
            self.application = ApplicationConfig(
                orgs=tuple(orgs),
                capabilities=caps.ApplicationCapabilities(_capability_names(ag)),
                acls=acls,
            )

        # -- consortiums (system channel only) ------------------------------
        self.consortiums: Dict[str, List[OrgConfig]] = {}
        cg = root.get("groups", {}).get(CONSORTIUMS_GROUP)
        if cg is not None:
            for cname, consortium in sorted(cg.get("groups", {}).items()):
                corgs = []
                for name, sub in sorted(consortium.get("groups", {}).items()):
                    org, msp_obj = _parse_org(name, sub, provider)
                    corgs.append(org)
                    if msp_obj is not None:
                        msps.append(msp_obj)
                self.consortiums[cname] = corgs

        self.msp_manager = MSPManager(msps)
        self.policy_manager: Manager = build_manager("Channel", root, self.msp_manager, provider)

    # convenience ----------------------------------------------------------
    @property
    def sequence(self) -> int:
        return self.config.get("sequence", 0)

    def acl_policy_ref(self, resource: str, default: str) -> str:
        if self.application is not None and resource in self.application.acls:
            ref = self.application.acls[resource]
            return ref if ref.startswith("/") else f"/Channel/Application/{ref}"
        return default


def bundle_from_envelope(env: dict, provider) -> Bundle:
    """Extract a Bundle from a CONFIG envelope (e.g. from a genesis block)."""
    payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
    chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER,
                               payload.get("header", {}).get("channel_header", b""))
    cenv = protoutil.unmarshal(cfgpb.CONFIG_ENVELOPE, payload.get("data", b""))
    return Bundle(chdr.get("channel_id", ""), cenv.get("config", {}), provider)


def bundle_from_genesis_block(block: dict, provider) -> Bundle:
    env = protoutil.get_envelope_from_block_data(block["data"]["data"][0])
    return bundle_from_envelope(env, provider)
