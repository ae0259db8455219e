"""Schemas of the chaincode shim stream for the wire codec.

The port's counterpart of the shim messages of the JAX package's `peer_pb2`
(`protos/src/peer.proto`: fabric-protos peer/chaincode_shim.proto):
`ChaincodeMessage` and its `Type` values, and the payloads the peer and the
chaincode exchange on the stream (state access, range and rich queries with
their pagination metadata, state metadata).
"""

from __future__ import annotations

from fabric_tpu_torch.protos import fabric
from fabric_tpu_torch.protos.wire import Field, Schema, _msg

# ChaincodeMessage.Type
UNDEFINED = 0
REGISTER = 1
REGISTERED = 2
INIT = 3
READY = 4
TRANSACTION = 5
COMPLETED = 6
ERROR = 7
GET_STATE = 8
PUT_STATE = 9
DEL_STATE = 10
INVOKE_CHAINCODE = 11
RESPONSE = 13
GET_STATE_BY_RANGE = 14
GET_QUERY_RESULT = 15
QUERY_STATE_NEXT = 16
QUERY_STATE_CLOSE = 17
KEEPALIVE = 18
GET_HISTORY_FOR_KEY = 19
GET_STATE_METADATA = 20
PUT_STATE_METADATA = 21
GET_PRIVATE_DATA_HASH = 22

CHAINCODE_MESSAGE: Schema = {
    1: Field("type", "enum"),
    2: _msg("timestamp", fabric.TIMESTAMP),
    3: Field("payload", "bytes"),
    4: Field("txid", "string"),
    5: _msg("proposal", fabric.SIGNED_PROPOSAL),
    6: _msg("chaincode_event", fabric.CHAINCODE_EVENT),
    7: Field("channel_id", "string"),
}
GET_STATE_MSG: Schema = {1: Field("key", "string"), 2: Field("collection", "string")}
GET_STATE_METADATA_MSG: Schema = {1: Field("key", "string"), 2: Field("collection", "string")}
PUT_STATE_MSG: Schema = {
    1: Field("key", "string"),
    2: Field("value", "bytes"),
    3: Field("collection", "string"),
}
DEL_STATE_MSG: Schema = {1: Field("key", "string"), 2: Field("collection", "string")}
GET_STATE_BY_RANGE_MSG: Schema = {
    1: Field("startKey", "string"),
    2: Field("endKey", "string"),
    3: Field("collection", "string"),
    4: Field("metadata", "bytes"),
}
GET_QUERY_RESULT_MSG: Schema = {
    1: Field("query", "string"),
    2: Field("collection", "string"),
    3: Field("metadata", "bytes"),
}
QUERY_RESULT_BYTES: Schema = {1: Field("resultBytes", "bytes")}
QUERY_RESPONSE: Schema = {
    1: _msg("results", QUERY_RESULT_BYTES, repeated=True),
    2: Field("has_more", "bool"),
    3: Field("id", "string"),
    4: Field("metadata", "bytes"),
}
SHIM_STATE_METADATA: Schema = {1: Field("metakey", "string"), 2: Field("value", "bytes")}
STATE_METADATA_RESULT: Schema = {1: _msg("entries", SHIM_STATE_METADATA, repeated=True)}
PUT_STATE_METADATA_MSG: Schema = {
    1: Field("key", "string"),
    3: Field("collection", "string"),
    4: _msg("metadata", SHIM_STATE_METADATA),
}
QUERY_METADATA: Schema = {1: Field("pageSize", "int32"), 2: Field("bookmark", "string")}
QUERY_RESPONSE_METADATA: Schema = {
    1: Field("fetched_records_count", "int32"),
    2: Field("bookmark", "string"),
}
