"""Schemas of the gossip messages for the wire codec.

The port's counterpart of the JAX package's `gossip_pb2` (`protos/src/
gossip.proto`: the subset of fabric-protos gossip/message.proto that
membership, state transfer, the pull rounds, the stream handshake and private
data use). `GossipMessage.content` is a oneof of thirteen messages;
`content(msg)` names the member a message holds, as protobuf's
`WhichOneof("content")` does. A block rides as the bytes of a `common.Block`
(`DataMessage.block`, `RemoteStateResponse.blocks`), a pulled item as the
bytes of a whole GossipMessage (`DataUpdate.data`).
"""

from __future__ import annotations

from typing import Optional

from fabric_tpu_torch.protos.wire import Field, Schema, _msg

CONN_ESTABLISH: Schema = {
    1: Field("pki_id", "bytes"),
    2: Field("identity", "bytes"),
    3: Field("tls_cert_hash", "bytes"),
    4: Field("signature", "bytes"),
}
MEMBER: Schema = {
    1: Field("endpoint", "string"),
    2: Field("pki_id", "bytes"),
    3: Field("ledger_height", "uint64"),
}
ALIVE_MESSAGE: Schema = {
    1: _msg("membership", MEMBER),
    2: Field("seq_num", "uint64"),
    3: Field("inc_num", "uint64"),
    4: Field("signature", "bytes"),
}
DATA_MESSAGE: Schema = {1: Field("seq_num", "uint64"), 2: Field("block", "bytes")}
REMOTE_STATE_REQUEST: Schema = {
    1: Field("start_seq_num", "uint64"),
    2: Field("end_seq_num", "uint64"),
}
REMOTE_STATE_RESPONSE: Schema = {1: Field("blocks", "bytes", repeated=True)}
GOSSIP_HELLO: Schema = {1: Field("nonce", "uint64"), 2: Field("msg_type", "int32")}
DATA_DIGEST: Schema = {
    1: Field("nonce", "uint64"),
    2: Field("digests", "bytes", repeated=True),
    3: Field("msg_type", "int32"),
}
DATA_REQUEST: Schema = DATA_DIGEST
DATA_UPDATE: Schema = {
    1: Field("nonce", "uint64"),
    2: Field("data", "bytes", repeated=True),
    3: Field("msg_type", "int32"),
}
PEER_IDENTITY: Schema = {1: Field("pki_id", "bytes"), 2: Field("cert", "bytes")}
PRIVATE_PAYLOAD: Schema = {
    1: Field("collection_name", "string"),
    2: Field("namespace", "string"),
    3: Field("tx_id", "string"),
    4: Field("private_rwset", "bytes"),
    5: Field("block_seq", "uint64"),
    6: Field("seq_in_block", "uint64"),
}
PRIVATE_DATA_MESSAGE: Schema = {1: _msg("payload", PRIVATE_PAYLOAD)}
PVT_DATA_DIGEST: Schema = {
    1: Field("tx_id", "string"),
    2: Field("namespace", "string"),
    3: Field("collection", "string"),
    4: Field("block_seq", "uint64"),
    5: Field("seq_in_block", "uint64"),
}
REMOTE_PVT_DATA_REQUEST: Schema = {
    1: _msg("digests", PVT_DATA_DIGEST, repeated=True),
    2: Field("pki_id", "bytes"),
    3: Field("signature", "bytes"),
    4: Field("nonce", "bytes"),
}
PVT_DATA_ELEMENT: Schema = {1: _msg("digest", PVT_DATA_DIGEST), 2: Field("payload", "bytes")}
REMOTE_PVT_DATA_RESPONSE: Schema = {1: _msg("elements", PVT_DATA_ELEMENT, repeated=True)}

GOSSIP_MESSAGE: Schema = {
    1: Field("nonce", "uint64"),
    2: Field("channel", "string"),
    5: _msg("alive_msg", ALIVE_MESSAGE, oneof="content"),
    6: _msg("data_msg", DATA_MESSAGE, oneof="content"),
    7: _msg("state_request", REMOTE_STATE_REQUEST, oneof="content"),
    8: _msg("state_response", REMOTE_STATE_RESPONSE, oneof="content"),
    9: _msg("hello", GOSSIP_HELLO, oneof="content"),
    10: _msg("data_dig", DATA_DIGEST, oneof="content"),
    11: _msg("data_req", DATA_REQUEST, oneof="content"),
    12: _msg("data_update", DATA_UPDATE, oneof="content"),
    13: _msg("peer_identity", PEER_IDENTITY, oneof="content"),
    14: _msg("private_data", PRIVATE_DATA_MESSAGE, oneof="content"),
    15: _msg("private_req", REMOTE_PVT_DATA_REQUEST, oneof="content"),
    16: _msg("private_res", REMOTE_PVT_DATA_RESPONSE, oneof="content"),
    17: _msg("conn", CONN_ESTABLISH, oneof="content"),
}

CONTENT = tuple(f.name for f in GOSSIP_MESSAGE.values() if f.oneof == "content")


def content(msg: dict) -> Optional[str]:
    """The member of GossipMessage.content that `msg` holds (protobuf's
    WhichOneof("content")), or None."""
    for name in CONTENT:
        if name in msg:
            return name
    return None
