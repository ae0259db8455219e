"""Service discovery (reference discovery/service.go:88 +
discovery/endorsement/endorsement.go PeersForEndorsement).

Three query kinds, mirroring the reference's Request/Response surface:

* ``peers(channel)`` — membership view: per-org online peers with
  endpoints, ledger heights and installed chaincodes;
* ``config(channel)`` — MSP ids + orderer endpoints from channel config;
* ``endorsers(channel, chaincode)`` — an EndorsementDescriptor: peers
  grouped by principal, plus the minimal layouts (group -> quantity)
  that satisfy the chaincode's endorsement policy, computed with the
  principal-set algebra in `discovery/inquire.py`.

Access control: every query authenticates the client against the
channel's Readers policy (service.go authCache + acl support), with a
small result cache keyed by the raw identity.

The port's counterpart of the JAX package's `discovery/service.py`, over the
port's bundles (`channelconfig/bundle.py`), whose policies verify through
their provider (K2 on `CUDAProvider`). Only a failed policy (`PolicyError`)
is a denial, and only a verdict is cached; a provider that fails raises out
of the query and leaves no verdict behind.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.discovery.inquire import satisfied_by
from fabric_tpu_torch.policy.ast import MSPPrincipal, Role, SignaturePolicyEnvelope
from fabric_tpu_torch.policy.manager import PolicyError, SignedData


class DiscoveryError(Exception):
    pass


@dataclass(frozen=True)
class PeerInfo:
    """One online peer as gossip membership sees it (discovery's
    peers-of-channel input)."""

    msp_id: str
    endpoint: str
    ledger_height: int = 0
    chaincodes: Tuple[str, ...] = ()
    is_peer_role: bool = True


@dataclass
class EndorsementDescriptor:
    chaincode: str
    # group name ("G0", "G1", ...) -> peers
    endorsers_by_groups: Dict[str, List[PeerInfo]]
    # each layout: group name -> how many endorsements needed from it
    layouts: List[Dict[str, int]]


class DiscoveryService:
    def __init__(
        self,
        # channel -> live peers (gossip membership + identity mapping)
        peers_provider: Callable[[str], Sequence[PeerInfo]],
        # channel -> channelconfig Bundle (msps, orderer endpoints, policies)
        bundle_provider: Callable[[str], Optional[object]],
        # (chaincode, channel) -> endorsement policy envelope
        policy_provider: Callable[[str, str], Optional[SignaturePolicyEnvelope]],
    ):
        self._peers = peers_provider
        self._bundle = bundle_provider
        self._policy = policy_provider
        self._auth_cache: Dict[Tuple[str, bytes], bool] = {}

    # -- access control (service.go processQuery -> acl check) ----------
    def _authorize(self, channel: str, client: SignedData) -> None:
        bundle = self._bundle(channel)
        if bundle is None:
            raise DiscoveryError(f"channel {channel} not found")
        key = (channel, client.identity)
        cached = self._auth_cache.get(key)
        if cached is True:
            return
        if cached is False:
            raise DiscoveryError("access denied")
        policy, ok = bundle.policy_manager.get_policy(
            "/Channel/Application/Readers"
        )
        if not ok:
            policy, ok = bundle.policy_manager.get_policy("/Channel/Readers")
        try:
            policy.evaluate_signed_data([client])
            self._auth_cache[key] = True
        except PolicyError as e:
            self._auth_cache[key] = False
            raise DiscoveryError(f"access denied: {e}") from e

    # -- queries ----------------------------------------------------------
    def peers(self, channel: str, client: SignedData) -> List[PeerInfo]:
        self._authorize(channel, client)
        return sorted(
            self._peers(channel), key=lambda p: (p.msp_id, p.endpoint)
        )

    def config(self, channel: str, client: SignedData) -> Dict:
        self._authorize(channel, client)
        bundle = self._bundle(channel)
        orderers: Dict[str, List[str]] = {}
        if bundle.orderer is not None:
            for org in bundle.orderer.orgs:
                if org.ordererendpoints:
                    orderers[org.msp_id] = list(org.ordererendpoints)
        if not orderers and getattr(bundle, "orderer_addresses", None):
            orderers[""] = list(bundle.orderer_addresses)
        return {
            "msps": sorted(m.msp_id for m in bundle.msp_manager.msps()),
            "orderers": orderers,
        }

    def endorsers(
        self, channel: str, chaincode: str, client: SignedData
    ) -> EndorsementDescriptor:
        """PeersForEndorsement: minimal principal combinations -> layouts
        over groups of online peers (endorsement.go:84,221-240)."""
        self._authorize(channel, client)
        policy = self._policy(chaincode, channel)
        if policy is None:
            raise DiscoveryError(
                f"failed constructing descriptor for chaincode {chaincode}"
            )
        peers = [
            p
            for p in self._peers(channel)
            if chaincode in p.chaincodes and p.is_peer_role
        ]
        principal_sets = satisfied_by(policy)

        # group per distinct principal; membership = peers whose identity
        # satisfies it (role matching by MSP here — OU-level matching goes
        # through the MSP in the reference)
        principals: List[MSPPrincipal] = []
        for ps in principal_sets:
            for p in ps:
                if p not in principals:
                    principals.append(p)
        group_name = {p: f"G{i}" for i, p in enumerate(principals)}
        groups: Dict[str, List[PeerInfo]] = {}
        for principal, name in group_name.items():
            members = [
                peer for peer in peers if _peer_satisfies(peer, principal)
            ]
            groups[name] = sorted(
                members, key=lambda p: (-p.ledger_height, p.endpoint)
            )

        layouts: List[Dict[str, int]] = []
        for ps in principal_sets:
            layout: Dict[str, int] = {}
            for principal in ps:
                layout[group_name[principal]] = (
                    layout.get(group_name[principal], 0) + 1
                )
            # a layout is viable only if every group has enough peers
            if all(
                len(groups.get(g, [])) >= qty for g, qty in layout.items()
            ):
                if layout not in layouts:
                    layouts.append(layout)
        if not layouts:
            raise DiscoveryError(
                f"no endorsement combination can be satisfied for "
                f"{chaincode} on {channel}"
            )
        return EndorsementDescriptor(
            chaincode=chaincode,
            endorsers_by_groups={
                g: members for g, members in groups.items() if members
            },
            layouts=layouts,
        )


def _peer_satisfies(peer: PeerInfo, principal: MSPPrincipal) -> bool:
    if peer.msp_id != principal.msp_id:
        return False
    if principal.role in (Role.MEMBER, Role.PEER):
        return True
    return False  # admins/clients don't endorse
