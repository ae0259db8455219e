"""Follower chain: onboarding an orderer into a channel it does not yet
consent on (reference orderer/common/follower/follower_chain.go +
orderer/common/onboarding).

A follower runs when this node joins a channel where it is NOT in the
consenter set, or joins with a non-genesis join block (so the local
ledger must first be replicated from the cluster).  It:

- pulls blocks from the channel's consenters with the deliver-client
  failure discipline (backoff + endpoint failover), verifying hash-chain
  linkage as it appends;
- re-derives the channel bundle at every config block and watches the
  consenter set;
- once this node IS a consenter and the ledger has reached the join
  block, halts pulling and invokes the promotion callback so the
  registrar restarts the channel as a full raft member
  (follower_chain.go run -> checkMembership -> halt + chain re-create).

The block store path is the one RaftChain would use, so promotion is a
pure restart: the raft chain opens the same ledger at the same height.

Node identity: raft ids are stable per consenter (`consenter_ids`): a
node's configured raft_node_id must be the id the cluster assigned when its
endpoint entered the consenter set. Membership checks read the mapping from
replicated blocks' ORDERER metadata; the positional convention (node_id ==
1-based list index) remains only as the fallback for ledgers written before
id tracking existed.

The port's counterpart of the JAX package's `orderer/follower.py`: blocks are
message dicts. A config block whose bundle does not parse (a `ConfigError` or
malformed bytes) leaves the follower on its old bundle; any other error of
the bundle's construction raises on the pull thread.
"""

from __future__ import annotations

import os
import threading
from dataclasses import replace
from typing import Callable, List, Optional, Sequence

from fabric_tpu_torch.channelconfig.bundle import ConfigError, bundle_from_genesis_block
from fabric_tpu_torch.common.retry import DELIVER_POLICY
from fabric_tpu_torch.deliver.client import BlockDeliverer
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.orderer.consenter_ids import ConsenterIdTracker
from fabric_tpu_torch.orderer.raft_chain import is_config_block
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import protoutil

# status / consensus-relation strings mirror the channel-participation
# API (orderer/common/types/channel_info.go)
STATUS_ONBOARDING = "onboarding"
STATUS_ACTIVE = "active"
RELATION_FOLLOWER = "follower"
RELATION_CONSENTER = "consenter"


def consenter_addresses(bundle) -> List[str]:
    """host:port list from the bundle's etcdraft consensus metadata."""
    if bundle.orderer is None or bundle.orderer.consensus_type != "etcdraft":
        return []
    try:
        meta = protoutil.unmarshal(cfgpb.RAFT_CONFIG_METADATA, bundle.orderer.consensus_metadata)
    except ValueError:
        return []
    return [f"{c.get('host', '')}:{c.get('port', 0)}" for c in meta.get("consenters", ())]


def is_member(bundle, node_id: int) -> bool:
    return 1 <= node_id <= len(consenter_addresses(bundle))


class FollowerChain:
    consensus_relation = RELATION_FOLLOWER

    def __init__(
        self,
        channel_id: str,
        join_block: dict,
        bundle,
        node_id: int,
        wal_dir: str,
        endpoint_factory: Callable[[Sequence[str]], List[Callable]],
        on_become_member: Callable[["FollowerChain"], None],
        provider=None,
    ):
        if provider is None:
            # the port's Bundle verifies through a provider: without one no
            # config block would parse and the follower would never promote
            raise ValueError("a FollowerChain needs the provider its bundles verify with")
        self.channel_id = channel_id
        self.join_block = join_block
        self.join_number = join_block["header"].get("number", 0)
        self.bundle = bundle
        self.node_id = node_id
        self.provider = provider
        self._endpoint_factory = endpoint_factory
        self._on_become_member = on_become_member
        base = os.path.join(wal_dir, channel_id)
        os.makedirs(base, exist_ok=True)
        self.block_store = BlockStore(os.path.join(base, "chain.blocks"))
        if self.join_number == 0 and self.block_store.height == 0:
            self.block_store.add_block(join_block)
        # A restarted follower prefers its LAST stored block's mapping —
        # the join block's goes stale as soon as a replicated config block
        # changes the set.
        last = (
            self.block_store.get_block_by_number(self.block_store.height - 1)
            if self.block_store.height
            else None
        )
        self.tracker = ConsenterIdTracker.from_block(last) or ConsenterIdTracker.from_block(
            join_block)
        self._member = threading.Event()
        self._stop = threading.Event()
        self._promote_at_join = False
        self._deliverer: Optional[BlockDeliverer] = None
        self._thread: Optional[threading.Thread] = None

    # -- participation-API style introspection ---------------------------
    @property
    def height(self) -> int:
        return self.block_store.height

    def get_block(self, number: int) -> Optional[dict]:
        return self.block_store.get_block_by_number(number)

    @property
    def status(self) -> str:
        """onboarding until the ledger reaches the join block, then an
        active follower (channel_info.go Status)."""
        return STATUS_ONBOARDING if self.height <= self.join_number else STATUS_ACTIVE

    # -- pull loop -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name=f"follower-{self.channel_id}",
                                        daemon=True)
        self._thread.start()

    def _is_member(self) -> bool:
        """Membership by stable raft id when the mapping is known, else the
        positional convention (pre-tracking blocks)."""
        if self.tracker is not None:
            return self.tracker.is_member(self.node_id)
        return is_member(self.bundle, self.node_id)

    def _exclude_self(self, addrs: Sequence[str]) -> List[str]:
        if self.tracker is not None:
            return [a for a in addrs if self.tracker.id_for(a) != self.node_id]
        out = list(addrs)
        if 1 <= self.node_id <= len(out):
            out.pop(self.node_id - 1)
        return out

    def _run(self) -> None:
        while not self._stop.is_set() and not self._member.is_set():
            endpoints = self._endpoint_factory(self._exclude_self(consenter_addresses(self.bundle)))
            self._deliverer = BlockDeliverer(
                self.channel_id,
                endpoints,
                on_block=self._append,
                next_block=lambda: self.block_store.height,
                # re-derive endpoints periodically
                retry_policy=replace(DELIVER_POLICY, deadline_s=5.0),
            )
            self._deliverer.run()
            if not self._member.is_set():
                self._stop.wait(0.1)
        if self._member.is_set() and not self._stop.is_set():
            self.block_store.close()
            self._on_become_member(self)

    def _append(self, block: dict) -> None:
        h = self.block_store.height
        header = block.get("header", {})
        if header.get("number", 0) != h:
            raise ConnectionError(f"follower expected block {h}, got {header.get('number', 0)}")
        if h > 0 and header.get("previous_hash", b"") != self.block_store.last_block_hash:
            raise ConnectionError(f"block {h} breaks the hash chain")
        if protoutil.block_data_hash(block.get("data", {})) != header.get("data_hash", b""):
            raise ConnectionError(f"block {h} DataHash mismatch")
        self.block_store.add_block(block)
        pulled = ConsenterIdTracker.from_block(block)
        if pulled is not None:
            self.tracker = pulled
        if is_config_block(block):
            self._on_config_block(block)
        if self._promote_at_join:
            self._promote_if_joined()

    def _promote_if_joined(self) -> None:
        if not self._member.is_set() and self.height > self.join_number:
            self._member.set()
            if self._deliverer is not None:
                self._deliverer.stop()

    def _on_config_block(self, block: dict) -> None:
        try:
            self.bundle = bundle_from_genesis_block(block, self.provider)
        except (ConfigError, ValueError):
            return  # keep following on a bundle that does not parse
        if self._is_member():
            self._promote_if_joined()

    def check_join_block_membership(self) -> None:
        """Joining with a non-genesis block where we're already a member:
        onboarding mode — replicate up to the join block, then promote
        (onboarding.go ReplicateChains); every appended block, plain ones
        too, is then checked against the join block."""
        if self._is_member():
            self._promote_at_join = True

    def stop(self) -> None:
        self._stop.set()
        if self._deliverer is not None:
            self._deliverer.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if not self._member.is_set():
            self.block_store.close()
