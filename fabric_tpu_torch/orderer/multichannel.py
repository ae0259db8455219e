"""Multichannel registrar (reference orderer/common/multichannel/
registrar.go): per-channel chain resources on the ordering side.

Each channel owns: a config Bundle + configtx Validator (hot-swapped on
config blocks), a msgprocessor, and a consenter chain (solo or raft).
Channel creation happens either through the system channel's Consortiums
group (a CONFIG_UPDATE for an unknown channel id) or by direct join with
a genesis/config block (channel participation API,
registrar.go JoinChannel).

The port's counterpart of the JAX package's `orderer/multichannel.py`:
blocks, envelopes and configs are message dicts, a Bundle verifies through
the registrar's `provider` (required: the port's bundles take one), and the
msgprocessors read the registrar's `clock`. A channel-creation policy that
is not met (`PolicyError`) refuses the channel; a provider that fails
raises.
"""

from __future__ import annotations

import copy
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from fabric_tpu_torch.channelconfig.bundle import (
    CHANNEL_CREATION_POLICY_KEY,
    Bundle,
    bundle_from_genesis_block,
)
from fabric_tpu_torch.channelconfig.configtx import Validator, _config_update_signed_data
from fabric_tpu_torch.orderer.blockcutter import BatchConfig
from fabric_tpu_torch.orderer.consenter_ids import ConsenterIdTracker
from fabric_tpu_torch.orderer.follower import FollowerChain, consenter_addresses, is_member
from fabric_tpu_torch.orderer.msgprocessor import Clock, StandardChannelProcessor
from fabric_tpu_torch.orderer.raft_chain import NotLeaderError, RaftChain
from fabric_tpu_torch.orderer.solo import SoloChain
from fabric_tpu_torch.policy import proto_convert
from fabric_tpu_torch.policy.manager import (
    ImplicitMetaPolicy,
    PolicyError,
    SignaturePolicy,
    SignedData,
)
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire


class RegistrarError(Exception):
    pass


@dataclass
class ChainSupport:
    channel_id: str
    bundle: Bundle
    validator: Validator
    processor: StandardChannelProcessor
    chain: object  # SoloChain | RaftChain

    @property
    def height(self) -> int:
        return self.chain.height

    def get_block(self, number: int):
        return self.chain.get_block(number)


class Registrar:
    def __init__(
        self,
        work_dir: str,
        signer=None,
        system_channel_id: Optional[str] = None,
        raft_node_id: int = 1,
        raft_transport_factory: Optional[Callable[[str, int], Callable]] = None,
        provider=None,
        follower_endpoint_factory: Optional[Callable] = None,
        clock: Optional[Clock] = None,
    ):
        if provider is None:
            raise RegistrarError("a Registrar needs the provider its bundles verify with")
        self.work_dir = work_dir
        self.signer = signer
        self.provider = provider
        self.clock = clock
        self.system_channel_id = system_channel_id
        self.raft_node_id = raft_node_id
        self.raft_transport_factory = raft_transport_factory or (
            lambda channel_id, node_id: (lambda to, msg: None)
        )
        # addresses -> deliver endpoints; enables follower/onboarding mode
        # for joins where this node is not (yet) a consenter or joins from
        # a non-genesis block
        self.follower_endpoint_factory = follower_endpoint_factory
        self.chains: Dict[str, ChainSupport] = {}
        self.followers: Dict[str, FollowerChain] = {}
        # serializes chains/followers mutations: join_channel races
        # _promote_follower (the follower's pull thread)
        self._registry_lock = threading.RLock()
        self._block_listeners: List[Callable[[str, dict], None]] = []
        self._chain_listeners: List[Callable[[ChainSupport], None]] = []

    # -- wiring -------------------------------------------------------------
    def on_block(self, fn: Callable[[str, dict], None]) -> None:
        """Deliver-service hook: called for every block written anywhere."""
        self._block_listeners.append(fn)

    def on_chain(self, fn: Callable[[ChainSupport], None]) -> None:
        """Called when a chain starts AND after every config block it
        applies — the hook a node uses to keep cluster consenter endpoints
        current for channels created any way."""
        self._chain_listeners.append(fn)
        for support in self.chains.values():
            fn(support)

    def _sink_for(self, channel_id: str) -> Callable[[dict], None]:
        def sink(block: dict) -> None:
            for fn in self._block_listeners:
                fn(channel_id, block)

        return sink

    # -- channel lifecycle --------------------------------------------------
    def join_channel(self, genesis_block: dict):
        """Channel-participation join (registrar.go JoinChannel): bootstrap
        a chain from its genesis (or latest config) block.

        With a follower endpoint factory configured, a join where this
        node is not in the consenter set — or a join from a non-genesis
        config block — starts a FollowerChain that replicates the ledger
        from the cluster and promotes itself to a consenter when the
        config says so (orderer/common/follower + onboarding)."""
        bundle = bundle_from_genesis_block(genesis_block, self.provider)
        channel_id = bundle.channel_id
        with self._registry_lock:
            if channel_id in self.chains or channel_id in self.followers:
                raise RegistrarError(f"channel {channel_id} already exists")
            if (
                self.follower_endpoint_factory is not None
                and bundle.orderer is not None
                and bundle.orderer.consensus_type == "etcdraft"
            ):
                # a join block carrying the cluster's id mapping decides
                # membership by stable id; genesis joins are positional
                tracker = ConsenterIdTracker.from_block(genesis_block)
                member = (
                    tracker.is_member(self.raft_node_id)
                    if tracker is not None
                    else is_member(bundle, self.raft_node_id)
                )
                if not member or genesis_block["header"].get("number", 0) > 0:
                    return self._start_follower(channel_id, bundle, genesis_block)
            return self._start_chain(channel_id, bundle, genesis_block)

    def _start_follower(self, channel_id: str, bundle: Bundle, join_block: dict) -> FollowerChain:
        follower = FollowerChain(
            channel_id,
            join_block,
            bundle,
            node_id=self.raft_node_id,
            wal_dir=os.path.join(self.work_dir, "etcdraft"),
            endpoint_factory=self.follower_endpoint_factory,
            on_become_member=self._promote_follower,
            provider=self.provider,
        )
        follower.check_join_block_membership()
        self.followers[channel_id] = follower
        follower.start()
        return follower

    def _promote_follower(self, follower: FollowerChain) -> ChainSupport:
        """The follower reached a config where this node is a consenter:
        restart the channel as a raft member on the same ledger
        (follower_chain.go halt + registrar SwitchFollowerToChain)."""
        with self._registry_lock:
            # start the chain BEFORE dropping the follower entry so deliver
            # lookups never see the channel in neither map
            support = self._start_chain(follower.channel_id, follower.bundle, None)
            self.followers.pop(follower.channel_id, None)
            return support

    def channel_info(self, channel_id: str) -> Optional[Dict[str, object]]:
        """Channel-participation style status
        (orderer/common/types/channel_info.go)."""
        support = self.chains.get(channel_id)
        if support is not None:
            return {
                "name": channel_id,
                "height": support.height,
                "status": "active",
                "consensusRelation": "consenter" if hasattr(support.chain, "node") else "none",
            }
        follower = self.followers.get(channel_id)
        if follower is not None:
            return {
                "name": channel_id,
                "height": follower.height,
                "status": follower.status,
                "consensusRelation": follower.consensus_relation,
            }
        return None

    def _start_chain(self, channel_id: str, bundle: Bundle,
                     genesis_block: Optional[dict]) -> ChainSupport:
        validator = Validator(channel_id, bundle.config, policy_manager=bundle.policy_manager)
        processor = StandardChannelProcessor(channel_id, bundle, validator, clock=self.clock)
        if bundle.orderer:
            batch_config = BatchConfig(
                max_message_count=bundle.orderer.batch_size_max_messages,
                absolute_max_bytes=bundle.orderer.batch_size_absolute_max_bytes,
                preferred_max_bytes=bundle.orderer.batch_size_preferred_max_bytes,
            )
        else:
            batch_config = BatchConfig()

        support_holder: List[ChainSupport] = []

        def on_config_block(block: dict) -> None:
            self._apply_config_block(support_holder[0], block)

        consensus = bundle.orderer.consensus_type if bundle.orderer else "solo"
        if consensus == "etcdraft":
            addresses = consenter_addresses(bundle)
            # positional fallback only; RaftChain prefers the stable id
            # mapping recovered from the ledger's ORDERER block metadata
            peer_ids = list(range(1, len(addresses) + 1)) or [1]
            chain = RaftChain(
                channel_id,
                self.raft_node_id,
                peer_ids,
                initial_consenters=addresses,
                wal_dir=os.path.join(self.work_dir, "etcdraft"),
                signer=self.signer,
                batch_config=batch_config,
                sink=self._sink_for(channel_id),
                genesis_block=genesis_block,
                transport=self.raft_transport_factory(channel_id, self.raft_node_id),
                on_config_block=on_config_block,
            )
        else:
            chain = SoloChain(
                channel_id,
                signer=self.signer,
                batch_config=batch_config,
                deliver=self._sink_for(channel_id),
                genesis_block=genesis_block,
                on_config_block=on_config_block,
            )
        support = ChainSupport(channel_id, bundle, validator, processor, chain)
        support_holder.append(support)
        self.chains[channel_id] = support
        for fn in self._chain_listeners:
            fn(support)
        return support

    def _apply_config_block(self, support: ChainSupport, block: dict) -> None:
        """Hot-swap the bundle when a config block commits (reference
        bundlesource.go + registrar's config-block callback). A change to
        the etcdraft consenter set additionally bridges into a raft
        membership change (etcdraft chain.go detectConfChange ->
        ProposeConfChange): the leader proposes the new peer set; the
        replicated ENTRY_CONF applies it on every member."""
        env = protoutil.get_envelope_from_block_data(block["data"]["data"][0])
        payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
        cenv = protoutil.unmarshal(cfgpb.CONFIG_ENVELOPE, payload.get("data", b""))
        new_bundle = Bundle(support.channel_id, cenv.get("config", {}), self.provider)
        support.bundle = new_bundle
        support.validator.config = cenv.get("config", {})
        support.processor.update_bundle(new_bundle)
        new_consenters = len(consenter_addresses(new_bundle))
        chain = support.chain
        # Stable per-consenter raft ids come from the chain's tracker
        # (updated when the config block was written), NOT from list
        # positions: removing or reordering a non-tail consenter must
        # evict exactly the departed node.
        desired = (
            set(chain.tracker.peer_ids())
            if isinstance(chain, RaftChain) and chain.tracker is not None
            else set(range(1, new_consenters + 1))
        )
        if (
            new_consenters > 0
            and isinstance(chain, RaftChain)
            # compare against the chain's LIVE peer set, not the old
            # bundle: a leader that died between committing the config
            # block and its ENTRY_CONF is repaired by the next apply
            and desired != chain.node.peers
        ):
            # Called from inside the chain's own apply loop; the nested
            # propose->pump->apply re-entry is benign because
            # _apply_entry's writer-height guard skips the written block.
            try:
                chain.propose_conf_change(sorted(desired))
            except NotLeaderError:
                pass  # the leader's own apply proposes; replication covers us
        for fn in self._chain_listeners:
            fn(support)

    # -- lookup -------------------------------------------------------------
    def get_chain(self, channel_id: str) -> Optional[ChainSupport]:
        return self.chains.get(channel_id)

    def channel_list(self) -> List[str]:
        return sorted(set(self.chains) | set(self.followers))

    # -- system-channel channel creation ------------------------------------
    def new_channel_from_update(self, env: dict) -> ChainSupport:
        """CONFIG_UPDATE addressed to a non-existent channel, arriving via
        the system channel (reference systemchannel.go NewChannelConfig):
        instantiate the channel from the consortium definition + the
        update's Application write set."""
        with self._registry_lock:
            return self._new_channel_from_update_locked(env)

    def _new_channel_from_update_locked(self, env: dict) -> ChainSupport:
        # under _registry_lock: the exists-check and the _start_chain
        # insert must be atomic vs concurrent creations and promotions
        if self.system_channel_id is None:
            raise RegistrarError("no system channel: create channels via join_channel")
        sys_support = self.chains[self.system_channel_id]
        # Expiration + size filters apply to the client envelope; the
        # authorization check is the consortium's ChannelCreationPolicy
        # (below), matching systemchannel.go.
        sys_support.processor.apply_filters(env, include_sig=False)
        payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
        cue = protoutil.unmarshal(cfgpb.CONFIG_UPDATE_ENVELOPE, payload.get("data", b""))
        update = protoutil.unmarshal(cfgpb.CONFIG_UPDATE, cue.get("config_update", b""))
        channel_id = update.get("channel_id", "")
        if channel_id in self.chains or channel_id in self.followers:
            raise RegistrarError(f"channel {channel_id} already exists")

        write_set = update.get("write_set", {})
        cons_value = write_set.get("values", {}).get("Consortium")
        if cons_value is None:
            raise RegistrarError("channel creation update names no consortium")
        consortium = protoutil.unmarshal(cfgpb.CONSORTIUM, cons_value.get("value", b"")).get(
            "name", "")
        sys_root = sys_support.validator.config["channel_group"]
        consortiums = sys_root.get("groups", {}).get("Consortiums")
        if consortiums is None or consortium not in consortiums.get("groups", {}):
            raise RegistrarError(f"unknown consortium {consortium}")

        # template: channel root from the system channel minus Consortiums,
        # with the Application group from the update's write set and org
        # definitions resolved from the consortium.
        template = copy.deepcopy(sys_root)
        groups = template.setdefault("groups", {})
        del groups["Consortiums"]
        template.setdefault("values", {}).setdefault("Consortium", {})["value"] = cons_value.get(
            "value", b"")
        app = write_set.get("groups", {}).get("Application")
        if app is None:
            raise RegistrarError("channel creation update has no Application group")
        new_app = copy.deepcopy(app)
        new_app.pop("version", None)
        groups["Application"] = new_app
        cons_group = consortiums["groups"][consortium]
        for org_name in list(new_app.get("groups", {})):
            if org_name in cons_group.get("groups", {}):
                new_app["groups"][org_name] = copy.deepcopy(cons_group["groups"][org_name])
            elif not new_app["groups"][org_name].get("values"):
                raise RegistrarError(f"org {org_name} not defined in consortium {consortium}")

        cfg = {"sequence": 0, "channel_group": template}
        bundle = Bundle(channel_id, cfg, self.provider)
        self._check_creation_policy(cons_group, bundle, payload.get("data", b""))

        genesis = _config_block(channel_id, {"config": cfg, "last_update": env}, 0, b"")
        return self._start_chain(channel_id, bundle, genesis)

    def _check_creation_policy(self, cons_group: dict, new_bundle: Bundle,
                               cue_bytes: bytes) -> None:
        """Enforce the consortium's ChannelCreationPolicy over the config
        update's signatures (reference systemchannel.go NewChannelConfig:
        the templator pins the Application group's mod_policy to the
        creation policy, evaluated with the NEW channel's org MSPs)."""
        cp_value = cons_group.get("values", {}).get(CHANNEL_CREATION_POLICY_KEY)
        if cp_value is None:
            raise RegistrarError("consortium has no ChannelCreationPolicy")
        pol = protoutil.unmarshal(cfgpb.POLICY, cp_value.get("value", b""))
        kind = pol.get("type", 0)
        if kind == cfgpb.IMPLICIT_META:
            meta = wire.decode(cfgpb.IMPLICIT_META_POLICY, pol.get("value", b""))
            sub = meta.get("sub_policy", "")
            app_mgr = new_bundle.policy_manager.manager(["Application"])
            children = app_mgr.children if app_mgr is not None else {}
            subs = [child.get_policy(sub)[0] for child in children.values()]
            policy = ImplicitMetaPolicy(meta.get("rule", 0), sub, subs)
        elif kind == cfgpb.SIGNATURE:
            policy = SignaturePolicy(proto_convert.unmarshal_envelope(pol.get("value", b"")),
                                     new_bundle.msp_manager, self.provider)
        else:
            raise RegistrarError(f"unsupported ChannelCreationPolicy type {kind}")
        cue = protoutil.unmarshal(cfgpb.CONFIG_UPDATE_ENVELOPE, cue_bytes)
        signed = []
        for s in cue.get("signatures", ()):
            data, creator = _config_update_signed_data(cue, s)
            signed.append(SignedData(data, creator, s.get("signature", b"")))
        try:
            policy.evaluate_signed_data(signed)
        except PolicyError as e:
            raise RegistrarError(f"channel creation request failed authorization: {e}") from e


def _config_block(channel_id: str, cenv: dict, number: int, prev_hash: bytes) -> dict:
    chdr = protoutil.make_channel_header(fabric.CONFIG, channel_id)
    payload = {"header": {"channel_header": wire.encode(fabric.CHANNEL_HEADER, chdr),
                          "signature_header": b""},
               "data": wire.encode(cfgpb.CONFIG_ENVELOPE, cenv)}
    block = protoutil.new_block(number, prev_hash)
    block["data"]["data"].append(wire.encode(fabric.ENVELOPE, {
        "payload": wire.encode(fabric.PAYLOAD, payload)}))
    return protoutil.seal_block(block)
