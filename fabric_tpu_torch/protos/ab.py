"""Schemas of the atomic-broadcast and deliver messages for the wire codec.

The port's counterpart of the JAX package's `ab_pb2` (`protos/src/ab.proto`:
fabric-protos orderer/ab.proto and the filtered and private-data blocks of
peer/events.proto). `DeliverResponse.Type` is a oneof: a status (common.Status,
written even when 0), a block, a filtered block or a block with its private
data; `BlockAndPrivateData.private_data_map` is a map keyed by the uint64
transaction index. `FilteredTransaction.transaction_actions` and its chaincode
events are the fabric-protos fields the JAX subset leaves out: nothing on the
port's paths writes them, and a reader keeps them.
"""

from __future__ import annotations

from fabric_tpu_torch.protos import fabric
from fabric_tpu_torch.protos.wire import TX_PVT_RWSET, Field, Schema, _map, _msg

BROADCAST_RESPONSE: Schema = {1: Field("status", "enum"), 2: Field("info", "string")}

SEEK_NEWEST: Schema = {}
SEEK_OLDEST: Schema = {}
SEEK_NEXT_COMMIT: Schema = {}
SEEK_SPECIFIED: Schema = {1: Field("number", "uint64")}
SEEK_POSITION: Schema = {
    1: _msg("newest", SEEK_NEWEST, oneof="Type"),
    2: _msg("oldest", SEEK_OLDEST, oneof="Type"),
    3: _msg("specified", SEEK_SPECIFIED, oneof="Type"),
    4: _msg("next_commit", SEEK_NEXT_COMMIT, oneof="Type"),
}
BLOCK_UNTIL_READY, FAIL_IF_NOT_READY = 0, 1  # SeekInfo.SeekBehavior
STRICT, BEST_EFFORT = 0, 1  # SeekInfo.SeekErrorResponse
SEEK_INFO: Schema = {
    1: _msg("start", SEEK_POSITION),
    2: _msg("stop", SEEK_POSITION),
    3: Field("behavior", "enum"),
    4: Field("error_response", "enum"),
}
# the "max" stop of a seek that delivers forever
SEEK_MAX = 2**64 - 1

FILTERED_CHAINCODE_ACTION: Schema = {1: _msg("chaincode_event", fabric.CHAINCODE_EVENT)}
FILTERED_TRANSACTION_ACTIONS: Schema = {
    1: _msg("chaincode_actions", FILTERED_CHAINCODE_ACTION, repeated=True),
}
FILTERED_TRANSACTION: Schema = {
    1: Field("txid", "string"),
    2: Field("type", "enum"),
    3: Field("tx_validation_code", "int32"),
    4: _msg("transaction_actions", FILTERED_TRANSACTION_ACTIONS, oneof="Data"),
}
FILTERED_BLOCK: Schema = {
    1: Field("channel_id", "string"),
    2: Field("number", "uint64"),
    4: _msg("filtered_transactions", FILTERED_TRANSACTION, repeated=True),
}
BLOCK_AND_PRIVATE_DATA: Schema = {
    1: _msg("block", fabric.BLOCK),
    2: _map("private_data_map", "uint64", _msg("", TX_PVT_RWSET)),
}
DELIVER_RESPONSE: Schema = {
    1: Field("status", "enum", oneof="Type"),
    2: _msg("block", fabric.BLOCK, oneof="Type"),
    3: _msg("filtered_block", FILTERED_BLOCK, oneof="Type"),
    4: _msg("block_and_private_data", BLOCK_AND_PRIVATE_DATA, oneof="Type"),
}


def response_type(resp: dict):
    """The member of DeliverResponse.Type that `resp` holds (protobuf's
    WhichOneof("Type")), or None."""
    for name in ("status", "block", "filtered_block", "block_and_private_data"):
        if name in resp:
            return name
    return None
