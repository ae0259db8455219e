"""Stable consenter -> raft-id tracking for the etcdraft consenter.

The reference keeps per-consenter raft IDs in the etcdraft BlockMetadata
stamped into every block's ORDERER metadata slot
(orderer/consensus/etcdraft/etcdraft.proto BlockMetadata;
chain.go writeBlock + util.go MembershipChanges): a consenter keeps its id
for the channel's lifetime, removed consenters retire their id forever, and
new consenters draw fresh ids from a monotonic counter.  Positional ids
(list index) break on any non-tail removal or reorder — the departing node
would keep consenting while an innocent one is evicted.

The mapping is keyed by the consenter's host:port endpoint (the transport
identity); the serialized form carries the endpoints explicitly so a node
joining mid-life reads the authoritative mapping straight from any
replicated block instead of re-deriving it positionally from the config.

The port's counterpart of the JAX package's `orderer/consenter_ids.py`:
blocks are message dicts, and the ORDERER slot's bytes are the JAX
package's RaftBlockMetadata bytes for the same mapping.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire


def consenters_from_config_block(block: dict) -> Optional[List[str]]:
    """host:port consenter endpoints from a CONFIG block's etcdraft
    metadata; None for non-config blocks, non-raft channels, or parse
    failures (callers then leave the mapping untouched)."""
    try:
        env = protoutil.get_envelope_from_block_data(block["data"]["data"][0])
        payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
        cenv = protoutil.unmarshal(cfgpb.CONFIG_ENVELOPE, payload.get("data", b""))
        og = cenv.get("config", {}).get("channel_group", {}).get("groups", {}).get("Orderer")
        if og is None:
            return None
        ct_value = og.get("values", {}).get("ConsensusType")
        if ct_value is None:
            return None
        ct = protoutil.unmarshal(cfgpb.CONSENSUS_TYPE, ct_value.get("value", b""))
        if ct.get("type", "") != "etcdraft":
            return None
        meta = protoutil.unmarshal(cfgpb.RAFT_CONFIG_METADATA, ct.get("metadata", b""))
    except (ValueError, IndexError, KeyError):
        # a leader-flagged "config" entry whose payload is not a valid
        # Envelope must not kill the channel's apply loop
        return None
    return [f"{c.get('host', '')}:{c.get('port', 0)}" for c in meta.get("consenters", ())]


class ConsenterIdTracker:
    """The (endpoint -> raft id, next id) state machine.

    Deterministic: every node that applies the same sequence of consenter
    sets reaches the same mapping, so each node stamping its own blocks
    (like the reference's per-node writeBlock) yields identical bytes.
    """

    def __init__(self, ids: Dict[str, int], next_id: int):
        self.ids = dict(ids)
        self.next_id = next_id

    @classmethod
    def bootstrap(cls, addresses: Sequence[str]) -> "ConsenterIdTracker":
        """Genesis rule: ids 1..n in config order (etcdraft chain start)."""
        ids = {a: i + 1 for i, a in enumerate(addresses)}
        return cls(ids, len(addresses) + 1)

    def apply(self, new_addresses: Sequence[str]) -> None:
        """Consenter-set change: removed endpoints retire their ids, added
        endpoints draw fresh ones (util.go MembershipChanges semantics)."""
        new_set = set(new_addresses)
        for addr in [a for a in self.ids if a not in new_set]:
            del self.ids[addr]
        for addr in new_addresses:
            if addr not in self.ids:
                self.ids[addr] = self.next_id
                self.next_id += 1

    def peer_ids(self) -> List[int]:
        return sorted(self.ids.values())

    def id_for(self, address: str) -> Optional[int]:
        return self.ids.get(address)

    def is_member(self, node_id: int) -> bool:
        return node_id in self.ids.values()

    # -- block metadata (ORDERER slot) --------------------------------------
    def to_bytes(self) -> bytes:
        order = sorted(self.ids, key=self.ids.__getitem__)
        return wire.encode(cfgpb.RAFT_BLOCK_METADATA, {
            "consenter_addresses": order,
            "consenter_ids": [self.ids[a] for a in order],
            "next_consenter_id": self.next_id,
        })

    def stamp(self, block: dict) -> None:
        """Write the mapping into the block's ORDERER metadata slot (the
        reference stamps etcdraft BlockMetadata the same way)."""
        protoutil.init_block_metadata(block)
        block["metadata"]["metadata"][fabric.ORDERER_METADATA] = self.to_bytes()

    @classmethod
    def from_block(cls, block: Optional[dict]) -> Optional["ConsenterIdTracker"]:
        """Recover the mapping from a stored/replicated block; None when the
        block predates id tracking (then callers fall back to bootstrap)."""
        if block is None:
            return None
        metas = block.get("metadata", {}).get("metadata", [])
        if len(metas) <= fabric.ORDERER_METADATA or not metas[fabric.ORDERER_METADATA]:
            return None
        try:
            meta = protoutil.unmarshal(cfgpb.RAFT_BLOCK_METADATA, metas[fabric.ORDERER_METADATA])
        except ValueError:
            return None
        addrs = meta.get("consenter_addresses", [])
        ids_list = meta.get("consenter_ids", [])
        if not ids_list or len(ids_list) != len(addrs):
            return None
        ids = dict(zip(addrs, ids_list))
        return cls(ids, meta.get("next_consenter_id", 0) or max(ids.values()) + 1)
