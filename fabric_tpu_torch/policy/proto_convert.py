"""ast <-> proto conversion for signature policies, over the wire codec.

The port's counterpart of the JAX package's `policy/proto_convert.py`.
Messages are dicts in `wire.decode`'s form (`protos/fabric.py`); the bytes
are protobuf's. Policies arrive as serialized SignaturePolicyEnvelope
(chaincode definitions) or wrapped in ApplicationPolicy (key-level
VALIDATION_PARAMETER metadata, reference validation_logic.go:44-67).
"""

from __future__ import annotations

from fabric_tpu_torch.policy.ast import MSPRole, NOutOf, Role, SignaturePolicyEnvelope, SignedBy
from fabric_tpu_torch.protos import fabric, wire

_ROLE_TO_PROTO = {
    Role.MEMBER: fabric.MEMBER,
    Role.ADMIN: fabric.ADMIN,
    Role.CLIENT: fabric.CLIENT,
    Role.PEER: fabric.PEER,
    Role.ORDERER: fabric.ORDERER,
}
_ROLE_FROM_PROTO = {v: k for k, v in _ROLE_TO_PROTO.items()}


class PolicyConversionError(ValueError):
    pass


def principal_for(ast_principal) -> dict:
    """policy.ast principal -> MSPPrincipal message."""
    if not isinstance(ast_principal, MSPRole):
        raise TypeError(f"unsupported policy principal {type(ast_principal).__name__!r}")
    role = {"msp_identifier": ast_principal.msp_id, "role": _ROLE_TO_PROTO[ast_principal.role]}
    return {"principal_classification": fabric.ROLE,
            "principal": wire.encode(fabric.MSP_ROLE, role)}


def envelope_to_proto(env: SignaturePolicyEnvelope) -> dict:
    return {
        "version": env.version,
        "rule": _rule_to_proto(env.rule),
        "identities": [principal_for(pr) for pr in env.identities],
    }


def _rule_to_proto(rule) -> dict:
    if isinstance(rule, SignedBy):
        return {"signed_by": rule.index}
    return {"n_out_of": {"n": rule.n, "rules": [_rule_to_proto(r) for r in rule.rules]}}


def envelope_from_proto(msg: dict) -> SignaturePolicyEnvelope:
    identities = []
    for p in msg.get("identities", ()):
        cls = p.get("principal_classification", fabric.ROLE)
        if cls != fabric.ROLE:
            raise PolicyConversionError(f"unsupported principal classification {cls}")
        role = wire.decode(fabric.MSP_ROLE, p.get("principal", b""))
        identities.append(
            MSPRole(role.get("msp_identifier", ""), _ROLE_FROM_PROTO[role.get("role", fabric.MEMBER)])
        )
    return SignaturePolicyEnvelope(
        _rule_from_proto(msg.get("rule", {})), identities, msg.get("version", 0)
    )


def _rule_from_proto(msg: dict):
    if "signed_by" in msg:
        return SignedBy(msg["signed_by"])
    if "n_out_of" in msg:
        n_out_of = msg["n_out_of"]
        return NOutOf(n_out_of.get("n", 0), [_rule_from_proto(r) for r in n_out_of.get("rules", ())])
    raise PolicyConversionError("empty signature policy rule")


def marshal_envelope(env: SignaturePolicyEnvelope) -> bytes:
    return wire.encode(fabric.SIGNATURE_POLICY_ENVELOPE, envelope_to_proto(env))


def unmarshal_envelope(raw: bytes) -> SignaturePolicyEnvelope:
    return envelope_from_proto(wire.decode(fabric.SIGNATURE_POLICY_ENVELOPE, raw))


def marshal_application_policy(env: SignaturePolicyEnvelope) -> bytes:
    """Wrap as ApplicationPolicy{signature_policy}: the on-ledger form of
    chaincode EPs and key-level validation parameters."""
    return wire.encode(fabric.APPLICATION_POLICY, {"signature_policy": envelope_to_proto(env)})


def unmarshal_application_policy(raw: bytes) -> SignaturePolicyEnvelope:
    ap = wire.decode(fabric.APPLICATION_POLICY, raw)
    if "signature_policy" not in ap:
        kind = "channel_config_policy_reference" if ap else None
        raise PolicyConversionError(f"unsupported application policy type {kind!r}")
    return envelope_from_proto(ap["signature_policy"])
