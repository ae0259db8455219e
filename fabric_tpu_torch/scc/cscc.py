"""cscc — configuration system chaincode (reference core/scc/cscc/
configure.go).

Functions: JoinChain (bootstrap a channel from its genesis block),
JoinChainBySnapshot (build the channel from an exported ledger snapshot,
configure.go joinChainBySnapshot), GetChannels (ChannelQueryResponse),
GetConfigBlock (latest config block bytes), GetChannelConfig (the
current channel Config proto). The peer node wires `join_chain` /
`join_by_snapshot` to its channel-creation routines (core/peer
createChannel / CreateChannelFromSnapshot).

The port's counterpart of the JAX package's `scc/cscc.py`: blocks are
message dicts (`protos/fabric.py`), and the payloads are the JAX SCC's bytes.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from fabric_tpu_torch.chaincode.shim import ChaincodeStub, Response, error_response, success
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire

JOIN_CHAIN = "JoinChain"
JOIN_CHAIN_BY_SNAPSHOT = "JoinChainBySnapshot"
GET_CHANNELS = "GetChannels"
GET_CONFIG_BLOCK = "GetConfigBlock"
GET_CHANNEL_CONFIG = "GetChannelConfig"


class CSCC:
    def __init__(
        self,
        join_chain: Callable[[dict], None],
        channel_list: Callable[[], List[str]],
        get_config_block: Callable[[str], Optional[dict]],
        join_by_snapshot: Optional[Callable[[str], str]] = None,
    ):
        self._join_chain = join_chain
        self._channel_list = channel_list
        self._get_config_block = get_config_block
        self._join_by_snapshot = join_by_snapshot

    def init(self, stub: ChaincodeStub) -> Response:
        return success()

    def invoke(self, stub: ChaincodeStub) -> Response:
        args = stub.get_args()
        if not args:
            return error_response("Incorrect number of arguments, 0")
        fname = args[0].decode()
        if fname == JOIN_CHAIN:
            if len(args) < 2:
                return error_response("missing genesis block")
            try:
                block = protoutil.unmarshal_as(fabric.BLOCK, args[1], "common.Block")
                self._join_chain(block)
            except Exception as e:  # noqa: BLE001 - report any join failure
                return error_response(f'"JoinChain" request failed: {e}')
            return success()
        if fname == GET_CHANNELS:
            resp = {"channels": [{"channel_id": cid} for cid in self._channel_list()]}
            return success(wire.encode(fabric.CHANNEL_QUERY_RESPONSE, resp))
        if fname == GET_CONFIG_BLOCK:
            if len(args) < 2:
                return error_response("missing channel ID")
            block = self._get_config_block(args[1].decode())
            if block is None:
                return error_response(f"Unknown chain ID, {args[1].decode()}")
            return success(wire.encode(fabric.BLOCK, block))
        if fname == GET_CHANNEL_CONFIG:
            # the current channel Config proto (configure.go
            # getChannelConfig), extracted from the latest config block
            if len(args) < 2:
                return error_response("missing channel ID")
            block = self._get_config_block(args[1].decode())
            if block is None:
                return error_response(f"Unknown chain ID, {args[1].decode()}")
            try:
                env = protoutil.get_envelope_from_block_data(block["data"]["data"][0])
                payload = protoutil.unmarshal_as(fabric.PAYLOAD, env.get("payload", b""),
                                                 "common.Payload")
                cenv = protoutil.unmarshal_as(cfgpb.CONFIG_ENVELOPE, payload.get("data", b""),
                                              "common.ConfigEnvelope")
                return success(wire.encode(cfgpb.CONFIG, cenv.get("config", {})))
            except Exception as e:  # noqa: BLE001 - malformed config block
                return error_response(f"failed to extract config: {e}")
        if fname == JOIN_CHAIN_BY_SNAPSHOT:
            if self._join_by_snapshot is None:
                return error_response("JoinChainBySnapshot is not enabled on this peer")
            if len(args) < 2 or not args[1]:
                return error_response("missing snapshot directory")
            try:
                channel_id = self._join_by_snapshot(args[1].decode())
            except Exception as e:  # noqa: BLE001 - report join failure
                return error_response(f'"JoinChainBySnapshot" request failed: {e}')
            return success(channel_id.encode())
        return error_response(f"Requested function {fname} not found.")
