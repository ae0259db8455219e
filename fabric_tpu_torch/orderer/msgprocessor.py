"""Orderer-side message validation rules (reference
orderer/common/msgprocessor/*.go: classification, SigFilter, size filter,
expiration, StandardChannel/SystemChannel processors).

ProcessNormalMsg runs the filter chain (expiration -> size -> sig) and
returns the current config sequence; ProcessConfigUpdateMsg additionally
drives the configtx Validator to produce the CONFIG envelope the
consenter will order (reference standardchannel.go:147-201).

The port's counterpart of the JAX package's `orderer/msgprocessor.py`:
envelopes are message dicts, the expiration filter reads the signer's
`not_after` through the port's own X.509 reader (`common/x509`) and takes
its clock from the caller (`clock`, UTC now by default), and SigFilter
turns only a failed policy (`PolicyError`) into PermissionDenied: a
provider that fails (a lost device) raises through it, never reading as a
denial.
"""

from __future__ import annotations

import datetime
from typing import Callable, Optional, Tuple

from fabric_tpu_torch.channelconfig.bundle import Bundle
from fabric_tpu_torch.channelconfig.configtx import Validator
from fabric_tpu_torch.common import x509
from fabric_tpu_torch.policy.manager import CHANNEL_WRITERS, PolicyError, SignedData
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire

Clock = Callable[[], datetime.datetime]


def utc_now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


class MsgProcessorError(Exception):
    pass


class PermissionDenied(MsgProcessorError):
    pass


class MsgTooLarge(MsgProcessorError):
    pass


# -- classification (reference broadcast.go + msgprocessor interfaces) ------


def classify(chdr: dict) -> str:
    """CONFIG_UPDATE messages take the config path; everything else is a
    normal message (reference standardchannel.go ClassifyMsg)."""
    kind = chdr.get("type", 0)
    if kind == fabric.CONFIG_UPDATE:
        return "config_update"
    if kind in (fabric.CONFIG, fabric.ORDERER_TRANSACTION):
        return "config"
    return "normal"


def _signature_header(env: dict) -> Tuple[dict, bytes]:
    """(the envelope's payload, its signature header's bytes)."""
    payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
    return payload, payload.get("header", {}).get("signature_header", b"")


# -- filters ----------------------------------------------------------------


class SizeFilter:
    """Reject messages above absolute_max_bytes (sizefilter.go)."""

    def __init__(self, bundle: Bundle):
        self._max = (
            bundle.orderer.batch_size_absolute_max_bytes
            if bundle.orderer
            else 10 * 1024 * 1024
        )

    def apply(self, env: dict) -> None:
        size = len(wire.encode(fabric.ENVELOPE, env))
        if size > self._max:
            raise MsgTooLarge(
                f"message payload is {size} bytes and exceeds maximum "
                f"allowed {self._max} bytes"
            )


class SigFilter:
    """Evaluate the channel Writers policy over the envelope signature
    (sigfilter.go:41-77). In maintenance mode the orderers policy is used
    instead ('/Channel/Orderer/Writers')."""

    def __init__(
        self,
        bundle: Bundle,
        normal_policy: str = CHANNEL_WRITERS,
        maintenance_policy: str = "/Channel/Orderer/Writers",
    ):
        self._bundle = bundle
        self._normal = normal_policy
        self._maintenance = maintenance_policy

    def apply(self, env: dict) -> None:
        _, raw_shdr = _signature_header(env)
        if not raw_shdr:
            raise MsgProcessorError("missing signature header")
        shdr = protoutil.unmarshal(fabric.SIGNATURE_HEADER, raw_shdr)
        name = self._normal
        orderer = self._bundle.orderer
        if orderer is not None and orderer.consensus_state == cfgpb.STATE_MAINTENANCE:
            name = self._maintenance
        policy, ok = self._bundle.policy_manager.get_policy(name)
        if not ok:
            raise MsgProcessorError(f"could not find policy {name}")
        sd = SignedData(env.get("payload", b""), shdr.get("creator", b""),
                        env.get("signature", b""))
        try:
            policy.evaluate_signed_data([sd])
        except PolicyError as e:
            raise PermissionDenied(f"implicit policy evaluation failed: {e}") from e


def identity_expiration(creator: bytes) -> Optional[datetime.datetime]:
    """The notAfter of a serialized X.509 identity, or None when the
    creator is no X.509 identity (reference crypto/expiration.go)."""
    try:
        sid = protoutil.unmarshal(fabric.SERIALIZED_IDENTITY, creator)
        return x509.load_pem_certificate(sid.get("id_bytes", b"")).not_after
    except ValueError:
        return None


class ExpirationFilter:
    """Reject envelopes whose signer cert is expired (expiration.go);
    gated on orderer V1_1 capabilities in the reference — always on here."""

    def __init__(self, clock: Optional[Clock] = None):
        self._clock = clock or utc_now

    def apply(self, env: dict) -> None:
        _, raw_shdr = _signature_header(env)
        if not raw_shdr:
            return
        creator = protoutil.unmarshal(fabric.SIGNATURE_HEADER, raw_shdr).get("creator", b"")
        if not creator:
            return
        not_after = identity_expiration(creator)
        if not_after is None:
            return  # not an x509 identity; the sig filter will judge it
        if not_after < self._clock():
            raise MsgProcessorError("identity expired")


class StandardChannelProcessor:
    """Per-channel msgprocessor (reference standardchannel.go)."""

    def __init__(self, channel_id: str, bundle: Bundle, validator: Validator,
                 clock: Optional[Clock] = None):
        self.channel_id = channel_id
        self.validator = validator
        self._clock = clock
        self.update_bundle(bundle)

    def update_bundle(self, bundle: Bundle) -> None:
        """Swap in the post-config-block bundle: filters AND the configtx
        validator's authorization tree must both follow the new config."""
        self.bundle = bundle
        self._filters = [ExpirationFilter(self._clock), SizeFilter(bundle), SigFilter(bundle)]
        self.validator.policy_manager = bundle.policy_manager

    def apply_filters(self, env: dict, include_sig: bool = True) -> None:
        """Run the ingress filter chain alone. include_sig=False is the
        system channel's channel-creation path (systemchannel.go): the
        client envelope is authorized by the consortium's
        ChannelCreationPolicy, not the system channel's Writers."""
        for f in self._filters:
            if not include_sig and isinstance(f, SigFilter):
                continue
            f.apply(env)

    def process_normal_msg(self, env: dict) -> int:
        """Returns the config sequence the message was validated against."""
        self.apply_filters(env)
        return self.validator.sequence

    def process_config_update_msg(self, env: dict, signer=None) -> Tuple[dict, int]:
        """CONFIG_UPDATE -> (CONFIG envelope ready to order, sequence)
        (reference standardchannel.go ProcessConfigUpdateMsg)."""
        self.apply_filters(env)
        config_env = self.validator.propose_config_update(env)

        chdr = protoutil.make_channel_header(fabric.CONFIG, self.channel_id)
        shdr = (protoutil.make_signature_header(signer.serialize(), signer.new_nonce())
                if signer is not None else {})
        payload = {"header": {"channel_header": wire.encode(fabric.CHANNEL_HEADER, chdr),
                              "signature_header": wire.encode(fabric.SIGNATURE_HEADER, shdr)},
                   "data": wire.encode(cfgpb.CONFIG_ENVELOPE, config_env)}
        out = {"payload": wire.encode(fabric.PAYLOAD, payload)}
        if signer is not None:
            out["signature"] = signer.sign(out["payload"])
        return out, self.validator.sequence

    def process_config_msg(self, env: dict, signer=None) -> Tuple[dict, int]:
        """Re-validate a CONFIG envelope by re-running its embedded update
        (reference standardchannel.go ProcessConfigMsg)."""
        payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
        cenv = protoutil.unmarshal(cfgpb.CONFIG_ENVELOPE, payload.get("data", b""))
        if "last_update" not in cenv:
            raise MsgProcessorError("config envelope has no last_update")
        return self.process_config_update_msg(cenv["last_update"], signer=signer)
