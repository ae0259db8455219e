"""Pluggable validation SPI (reference core/handlers/validation/api/
validation.go Plugin + plugin_validator.go dispatch semantics).

The port's counterpart of the JAX package's `validation/plugin_api`, with
the same classes and outcome mapping. A validation plugin decides, per
(transaction, written namespace), whether the endorsement is acceptable.
The reference loads Go shared objects (core/handlers/library/registry.go:134
plugin.Open) and calls `Validate(block, namespace, position, 0,
policyBytes...)`; here plugins are Python objects, loaded by
"module.path:Attribute" reference (dispatcher.PluginRegistry.load), and
`validate(ValidationContext)` is called.

Outcome mapping (plugin_validator.go:100-118):
- return normally            -> the namespace validates
- raise EndorsementInvalid   -> tx marked ENDORSEMENT_POLICY_FAILURE
  (the reference's *commonerrors.VSCCEndorsementPolicyError)
- raise anything else        -> ValidationError halts the whole block
  (the reference's VSCCExecutionFailureError: a retriable infrastructure
  fault, never a silently invalidated tx)

Unlike the reference, where each plugin verifies endorsement signatures
itself, signature verification has already run in the block's batch (K2 on
the card) by the time a plugin is consulted: the context carries the
per-endorser verdicts (`signers`) and a `default_check()` that runs the
builtin policy circuit, so a plugin builds on the batch instead of paying
per-tx host crypto.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple


class EndorsementInvalid(Exception):
    """The tx's endorsement does not satisfy the plugin's rules."""


class PluginExecutionError(Exception):
    """Infrastructure failure inside a plugin — halts block processing."""


@dataclass
class SignerInfo:
    """One endorsement signature, post device batch."""

    msp_id: str
    identity_bytes: bytes
    sig_valid: bool


@dataclass
class ValidationContext:
    """Everything a validation plugin may consult for one (tx, ns)."""

    channel_id: str
    block_num: int
    tx_index: int
    namespace: str
    tx_id: str
    envelope_bytes: bytes
    # the namespace's endorsement policy (policy.ast envelope), as the
    # reference passes serialized policy bytes to plugin.Validate
    policy: object
    # post-device-batch endorsement verdicts for this tx
    signers: List[SignerInfo]
    # runs the builtin policy circuit for this tx against `policy`
    # (plugins that only ADD rules on top of the default check call this
    # first, like the reference builtin wrapped by custom plugins)
    default_check: Callable[[], bool]
    # committed state metadata probe: (ns, coll, key) -> bytes | None
    get_state_metadata: Callable[[str, str, object], Optional[bytes]] = (
        lambda ns, coll, key: None
    )
    # (namespace, writes?) pairs of the tx's rwset, rwset order
    ns_entries: Tuple = ()


class ValidationPlugin:
    """Base class for custom validation plugins. Subclasses override
    `validate`; `init` receives nothing today but reserves the
    reference's dependency-injection slot (validation.go Init)."""

    def init(self, **deps) -> None:
        pass

    def validate(self, ctx: ValidationContext) -> None:
        raise NotImplementedError
