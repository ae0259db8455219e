"""Schemas of the orderer-to-orderer cluster messages for the wire codec.

The port's counterpart of the JAX package's `cluster_pb2`
(`protos/src/cluster.proto`: the Step service's Submit path, a forwarded
transaction and the leader's Broadcast status, and its Consensus path, a
framed raft message of `orderer/raft.message_to_bytes`).
`ClusterStepRequest.payload` is a oneof of the two.
"""

from __future__ import annotations

from fabric_tpu_torch.protos import fabric
from fabric_tpu_torch.protos.wire import Field, Schema, _msg

CLUSTER_SUBMIT_REQUEST: Schema = {
    1: Field("channel", "string"),
    2: _msg("payload", fabric.ENVELOPE),
}
CLUSTER_SUBMIT_RESPONSE: Schema = {
    1: Field("channel", "string"),
    2: Field("status", "enum"),
    3: Field("info", "string"),
}
CLUSTER_CONSENSUS_REQUEST: Schema = {
    1: Field("channel", "string"),
    2: Field("payload", "bytes"),
    3: Field("from_node", "uint64"),
}
CLUSTER_STEP_REQUEST: Schema = {
    1: _msg("submit_request", CLUSTER_SUBMIT_REQUEST, oneof="payload"),
    2: _msg("consensus_request", CLUSTER_CONSENSUS_REQUEST, oneof="payload"),
}
CLUSTER_STEP_RESPONSE: Schema = {1: _msg("submit_res", CLUSTER_SUBMIT_RESPONSE)}
