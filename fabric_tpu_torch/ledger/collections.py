"""Private-data collection model (reference core/common/privdata/
collection.go, simplecollection.go, membershipinfo.go).

The port's counterpart of the JAX package's `ledger/collections`, over the
port's dict messages (`protos/fabric.COLLECTION_CONFIG_PACKAGE`; the bytes
are protobuf's). CollectionAccess wraps a StaticCollectionConfig:
membership is a signature-policy evaluation over the peer's identity
(SimpleCollection.AccessFilter), BTL feeds the pvtdata store's purge
policy, and member_only_read/write gate chaincode access at simulation time
(core/chaincode/handler.go errorIfCreatorHasNoReadAccess).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from fabric_tpu_torch.policy import proto_convert
from fabric_tpu_torch.policy.ast import SignaturePolicyEnvelope, from_dsl
from fabric_tpu_torch.policy.evaluator import evaluate_host
from fabric_tpu_torch.protos import fabric, wire


class NoSuchCollectionError(Exception):
    pass


class CollectionAccess:
    def __init__(self, cfg: dict):
        """`cfg` is a StaticCollectionConfig message (a dict)."""
        self.name = cfg.get("name", "")
        self.required_peer_count = cfg.get("required_peer_count", 0)
        self.maximum_peer_count = cfg.get("maximum_peer_count", 0)
        self.block_to_live = cfg.get("block_to_live", 0)
        self.member_only_read = cfg.get("member_only_read", False)
        self.member_only_write = cfg.get("member_only_write", False)
        self._policy_env: Optional[SignaturePolicyEnvelope] = None
        member_orgs = cfg.get("member_orgs_policy", {})
        if "signature_policy" in member_orgs:
            self._policy_env = proto_convert.unmarshal_envelope(
                wire.encode(fabric.SIGNATURE_POLICY_ENVELOPE, member_orgs["signature_policy"])
            )

    def is_member(self, identity, msp) -> bool:
        """AccessFilter: does the identity satisfy the member-orgs policy?
        Principal matching only, no signature involved (the reference
        evaluates the policy over a SignedData with the membership
        identity; satisfaction is by principal)."""
        if self._policy_env is None:
            return False
        num_p = len(self._policy_env.identities)
        sat = np.zeros((1, num_p), dtype=bool)
        for p, principal in enumerate(self._policy_env.identities):
            try:
                msp.satisfies_principal(identity, proto_convert.principal_for(principal))
                sat[0, p] = True
            except Exception:  # a mismatch leaves the bit False
                pass
        return evaluate_host(self._policy_env, sat)


class CollectionStore:
    """Per-channel collection registry resolved from lifecycle definitions
    (reference core/common/privdata/store.go backed by lscc/_lifecycle)."""

    def __init__(self, get_collections_bytes: Callable[[str], bytes]):
        """`get_collections_bytes(ns)` is the namespace's serialized
        CollectionConfigPackage (a definition's `collections`)."""
        self._get = get_collections_bytes

    def package(self, ns: str) -> dict:
        raw = self._get(ns) or b""
        return wire.decode(fabric.COLLECTION_CONFIG_PACKAGE, raw) if raw else {}

    def collection(self, ns: str, coll: str) -> CollectionAccess:
        for cfg in self.package(ns).get("config", ()):
            static = cfg.get("static_collection_config", {})
            if static.get("name", "") == coll:
                return CollectionAccess(static)
        raise NoSuchCollectionError(f"collection {ns}/{coll} not found")

    def has_collection(self, ns: str, coll: str) -> bool:
        try:
            self.collection(ns, coll)
            return True
        except NoSuchCollectionError:
            return False

    def btl_policy(self) -> Callable[[str, str], int]:
        """(ns, coll) -> block_to_live for the pvtdata store (0 = forever)."""

        def btl(ns: str, coll: str) -> int:
            try:
                return int(self.collection(ns, coll).block_to_live)
            except NoSuchCollectionError:
                return 0

        return btl


def build_collection_config_package(collections: Sequence[Dict]) -> dict:
    """Helper for tests/tools: [{name, policy (DSL or env), required/max/
    btl/member_only_*}] -> a CollectionConfigPackage message (a dict;
    `wire.encode(fabric.COLLECTION_CONFIG_PACKAGE, ...)` gives its bytes)."""
    configs = []
    for c in collections:
        static = {"name": c["name"]}
        policy = c.get("policy")
        if isinstance(policy, str):
            policy = from_dsl(policy)
        if policy is not None:
            static["member_orgs_policy"] = {"signature_policy": wire.decode(
                fabric.SIGNATURE_POLICY_ENVELOPE, proto_convert.marshal_envelope(policy))}
        static["required_peer_count"] = c.get("required_peer_count", 0)
        static["maximum_peer_count"] = c.get("maximum_peer_count", 1)
        static["block_to_live"] = c.get("block_to_live", 0)
        static["member_only_read"] = c.get("member_only_read", False)
        static["member_only_write"] = c.get("member_only_write", False)
        configs.append({"static_collection_config": static})
    return {"config": configs}
