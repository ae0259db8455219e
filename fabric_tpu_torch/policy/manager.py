"""Policy manager hierarchy (reference common/policies/policy.go +
implicitmeta.go + cauthdsl/policy.go).

The port's counterpart of the JAX package's `policy/manager.py`. The manager
tree mirrors the channel config group tree: one Manager per config group,
holding that group's policies plus child managers. Paths are resolved like
the reference: "/Channel/Application/Writers" walks the hierarchy from the
root; a bare name resolves in the current manager.

Policy kinds:
- SignaturePolicy (cauthdsl): dedupe by identity bytes
  (SignatureSetToValidIdentities, policies/policy.go:365-402), then verify,
  then evaluate;
- ImplicitMetaPolicy: ANY/ALL/MAJORITY over the same-named sub-policy of
  every child manager (implicitmeta.go).

Departures from the JAX package, both deliberate:
- A SignaturePolicy verifies every surviving signature of a set in one
  `provider.batch_verify` call (K2 through `CUDAProvider` on the card)
  instead of one `Identity.verify` a signer.
- The JAX policies catch every exception of a signer (`manager.py:90`) and of
  a sub-policy (`:139`). The port catches only what is a verdict: an identity
  that fails to deserialize (`MSPError`, `WireError`) and a lane the provider
  refuses drop that signer, a principal that does not match leaves its
  satisfaction false, and a `PolicyError` fails the sub-policy. Anything else
  (a CUDA build, launch or copy error) propagates, so a failing device never
  reads as a denial.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fabric_tpu_torch.msp.identity import MSPError
from fabric_tpu_torch.policy import proto_convert
from fabric_tpu_torch.policy.ast import SignaturePolicyEnvelope
from fabric_tpu_torch.policy.evaluator import evaluate_host
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import wire

# Reference common/policies/policy.go:27-47: well-known policy names.
CHANNEL_PREFIX = "Channel"
APPLICATION_PREFIX = "Application"
ORDERER_PREFIX = "Orderer"
CHANNEL_READERS = "/Channel/Readers"
CHANNEL_WRITERS = "/Channel/Writers"
CHANNEL_APPLICATION_READERS = "/Channel/Application/Readers"
CHANNEL_APPLICATION_WRITERS = "/Channel/Application/Writers"
CHANNEL_APPLICATION_ADMINS = "/Channel/Application/Admins"
BLOCK_VALIDATION = "/Channel/Orderer/BlockValidation"


@dataclass(frozen=True)
class SignedData:
    """One (data, identity, signature) triple (reference protoutil
    signeddata.go SignedData)."""

    data: bytes
    identity: bytes
    signature: bytes


class PolicyError(Exception):
    pass


class Policy:
    """Reference policies.Policy interface."""

    def evaluate_signed_data(self, signature_set: Sequence[SignedData]) -> None:
        """Raise PolicyError unless the signature set satisfies the policy."""
        raise NotImplementedError


class SignaturePolicy(Policy):
    """cauthdsl policy: dedupe, deserialize and verify the signers in one
    batch, then run the greedy evaluation (reference
    common/cauthdsl/policy.go:87-95)."""

    def __init__(self, envelope: SignaturePolicyEnvelope, msp_manager, provider):
        self.envelope = envelope
        self._msp_manager = msp_manager
        self._provider = provider
        self._principals = [proto_convert.principal_for(p) for p in envelope.identities]

    def evaluate_signed_data(self, signature_set: Sequence[SignedData]) -> None:
        # Dedupe by raw identity bytes BEFORE verifying (anti-DoS,
        # policies/policy.go:383-388).
        seen = set()
        lanes: List[Tuple[object, object, SignedData]] = []
        for sd in signature_set:
            if sd.identity in seen:
                continue
            seen.add(sd.identity)
            try:
                identity, msp = self._msp_manager.deserialize_identity(sd.identity)
            except (MSPError, wire.WireError):
                continue  # an identity that does not deserialize: lane dropped
            lanes.append((identity, msp, sd))
        valid = []
        if lanes:
            ok = self._provider.batch_verify(
                [identity.public_key for identity, _, _ in lanes],
                [sd.signature for _, _, sd in lanes],
                [self._provider.hash(sd.data) for _, _, sd in lanes])
            valid = [(identity, msp) for (identity, msp, _), v in zip(lanes, ok, strict=True)
                     if v]
        if not valid:
            raise PolicyError("signature set did not satisfy policy: no valid signatures")

        sat = np.zeros((len(valid), len(self._principals)), dtype=bool)
        for s, (identity, msp) in enumerate(valid):
            for p, principal in enumerate(self._principals):
                try:
                    msp.satisfies_principal(identity, principal)
                    sat[s, p] = True
                except (MSPError, wire.WireError):
                    pass  # a principal it does not satisfy
        if not evaluate_host(self.envelope, sat):
            raise PolicyError("signature set did not satisfy policy")


class ImplicitMetaPolicy(Policy):
    """ANY/ALL/MAJORITY of the same-named sub-policy across child managers
    (reference common/policies/implicitmeta.go)."""

    def __init__(self, rule: int, sub_policy: str, sub_policies: Sequence[Policy]):
        self.rule = rule
        self.sub_policy = sub_policy
        self._subs = list(sub_policies)
        n = len(self._subs)
        if rule == cfgpb.ANY:
            self.threshold = 1  # an empty sub-policy set always denies
        elif rule == cfgpb.ALL:
            self.threshold = n
        elif rule == cfgpb.MAJORITY:
            self.threshold = n // 2 + 1
        else:
            raise PolicyError(f"unknown implicit meta rule {rule}")

    def evaluate_signed_data(self, signature_set: Sequence[SignedData]) -> None:
        remaining = self.threshold
        if remaining == 0:
            return
        for sub in self._subs:
            try:
                sub.evaluate_signed_data(signature_set)
            except PolicyError:
                continue
            remaining -= 1
            if remaining == 0:
                return
        raise PolicyError(
            f"implicit policy evaluation failed - {self.threshold - remaining} "
            f"sub-policies were satisfied, but this policy requires "
            f"{self.threshold} of the '{self.sub_policy}' sub-policies to be "
            f"satisfied"
        )


class RejectPolicy(Policy):
    """Placeholder for undefined policies referenced by the tree (the
    reference returns an error from Manager.GetPolicy; callers treat a
    missing policy as always-deny)."""

    def __init__(self, name: str):
        self.name = name

    def evaluate_signed_data(self, signature_set: Sequence[SignedData]) -> None:
        raise PolicyError(f"no such policy: '{self.name}'")


class Manager:
    """One config-group's policies + children (reference ManagerImpl,
    common/policies/policy.go:152-236)."""

    def __init__(
        self,
        path: str,
        policies: Optional[Dict[str, Policy]] = None,
        children: Optional[Dict[str, "Manager"]] = None,
    ):
        self.path = path
        self._policies = dict(policies or {})
        self._children = dict(children or {})

    def manager(self, relpath: Sequence[str]) -> Optional["Manager"]:
        m: Optional[Manager] = self
        for seg in relpath:
            if m is None:
                return None
            m = m._children.get(seg)
        return m

    def get_policy(self, name: str) -> Tuple[Policy, bool]:
        """Returns (policy, found). Absolute paths ('/Channel/...') resolve
        from this manager as root, like the reference's root manager."""
        if name.startswith("/"):
            segs = [s for s in name.split("/") if s]
            # segs[0] names the root group itself (e.g. "Channel")
            if not segs:
                return RejectPolicy(name), False
            m: Optional[Manager] = self
            for seg in segs[1:-1]:
                m = m._children.get(seg) if m else None
            if m is None:
                return RejectPolicy(name), False
            return m.get_policy(segs[-1])
        p = self._policies.get(name)
        if p is None:
            return RejectPolicy(name), False
        return p, True

    @property
    def policy_names(self) -> List[str]:
        return sorted(self._policies)

    @property
    def children(self) -> Dict[str, "Manager"]:
        return dict(self._children)


def build_manager(path: str, group: dict, msp_manager, provider) -> Manager:
    """Recursively build the manager tree from a decoded ConfigGroup
    (reference NewManagerImpl walking ConfigGroup.Policies/Groups)."""
    children = {
        name: build_manager(f"{path}/{name}", sub, msp_manager, provider)
        for name, sub in group.get("groups", {}).items()
    }
    policies: Dict[str, Policy] = {}
    for name, cfg_policy in group.get("policies", {}).items():
        pol = cfg_policy.get("policy", {})
        kind = pol.get("type", cfgpb.UNKNOWN)
        if kind == cfgpb.SIGNATURE:
            env = proto_convert.unmarshal_envelope(pol.get("value", b""))
            policies[name] = SignaturePolicy(env, msp_manager, provider)
        elif kind == cfgpb.IMPLICIT_META:
            meta = wire.decode(cfgpb.IMPLICIT_META_POLICY, pol.get("value", b""))
            sub_policy = meta.get("sub_policy", "")
            # Every child counts toward the denominator; a child lacking
            # the sub-policy contributes an always-deny RejectPolicy
            # (implicitmeta.go counts all children, so MAJORITY/ALL must
            # not shrink when a child omits the policy).
            subs = [child.get_policy(sub_policy)[0] for child in children.values()]
            policies[name] = ImplicitMetaPolicy(meta.get("rule", cfgpb.ANY), sub_policy, subs)
        else:
            policies[name] = RejectPolicy(f"{name} (unsupported type {kind})")
    return Manager(path, policies, children)
