"""Broadcast ingest handler (reference orderer/common/broadcast/
broadcast.go: classify -> msgprocessor -> WaitReady -> Order/Configure).

Returns a BroadcastResponse-style (status, info) pair per envelope instead
of streaming; a transport layer adapts this to the AtomicBroadcast service.

The port's counterpart of the JAX package's `orderer/broadcast.py`:
envelopes are message dicts, and each envelope gets the JAX handler's status
and info string. `cluster_client` is any object with
`forward_submit(channel_id, env, leader_id) -> (status, info)` (the
follower-to-leader Submit of the cluster service; in process, another
orderer's handler called with `forwarded=True`). Only the wire codec's
errors (and a creation policy that does not convert) read as a malformed
request; an error that is no verdict (a provider that fails, even with a
ValueError) raises out of `process_message`.
"""

from __future__ import annotations

from typing import Tuple

from fabric_tpu_torch.orderer.msgprocessor import (
    MsgProcessorError,
    MsgTooLarge,
    PermissionDenied,
    classify,
)
from fabric_tpu_torch.orderer.multichannel import Registrar, RegistrarError
from fabric_tpu_torch.orderer.raft_chain import NotLeaderError
from fabric_tpu_torch.policy.proto_convert import PolicyConversionError
from fabric_tpu_torch.protos import fabric, protoutil, wire

# what a malformed envelope raises past the header parse: the codec's own
# error, and a ChannelCreationPolicy that is no SignaturePolicyEnvelope
_MALFORMED = (wire.WireError, PolicyConversionError)


class BroadcastHandler:
    def __init__(self, registrar: Registrar, signer=None, cluster_client=None):
        self.registrar = registrar
        self.signer = signer
        # follower -> leader Submit forwarding (orderer/common/cluster
        # comm.go Submit path); None on a solo/single orderer
        self.cluster_client = cluster_client

    def process_message(self, env: dict, forwarded: bool = False) -> Tuple[int, str]:
        """One Broadcast message -> (common.Status, info). `forwarded`
        marks a Submit that already hopped orderer-to-orderer once: it
        must not be re-forwarded (redirect loop) even if leadership moved
        again."""
        try:
            payload = protoutil.unmarshal_as(fabric.PAYLOAD, env.get("payload", b""),
                                             "common.Payload")
            raw_chdr = payload.get("header", {}).get("channel_header", b"")
            if not raw_chdr:
                raise ValueError("missing channel header")
            chdr = protoutil.unmarshal_as(fabric.CHANNEL_HEADER, raw_chdr,
                                          "common.ChannelHeader")
        except ValueError as e:
            return fabric.BAD_REQUEST, str(e)

        channel_id = chdr.get("channel_id", "")
        kind = classify(chdr)
        support = self.registrar.get_chain(channel_id)

        try:
            if kind == "normal":
                if support is None:
                    return fabric.NOT_FOUND, f"channel {channel_id} not found"
                support.processor.process_normal_msg(env)
                support.chain.order(env)
            elif kind == "config_update":
                if support is None:
                    # channel creation through the system channel
                    self.registrar.new_channel_from_update(env)
                    return fabric.SUCCESS, ""
                config_env, _seq = support.processor.process_config_update_msg(
                    env, signer=self.signer)
                support.chain.configure(config_env)
            else:  # a full CONFIG envelope resubmitted for re-validation
                if support is None:
                    return fabric.NOT_FOUND, f"channel {channel_id} not found"
                config_env, _seq = support.processor.process_config_msg(env, signer=self.signer)
                support.chain.configure(config_env)
        except MsgTooLarge as e:
            return fabric.REQUEST_ENTITY_TOO_LARGE, str(e)
        except PermissionDenied as e:
            return fabric.FORBIDDEN, str(e)
        except (MsgProcessorError, RegistrarError) as e:
            return fabric.BAD_REQUEST, str(e)
        except NotLeaderError as e:
            if not forwarded and self.cluster_client is not None and e.leader_id:
                return self.cluster_client.forward_submit(channel_id, env, e.leader_id)
            return fabric.SERVICE_UNAVAILABLE, str(e)
        except _MALFORMED as e:
            return fabric.BAD_REQUEST, str(e)
        return fabric.SUCCESS, ""
