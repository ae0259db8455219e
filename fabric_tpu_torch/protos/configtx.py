"""Schemas of the channel configuration messages for the wire codec.

The port's counterpart of the JAX package's `configtx_pb2`,
`configuration_pb2`, `msp_config_pb2` and the `Policy` and
`ImplicitMetaPolicy` messages of `policies_pb2`, as the channel
configuration layer uses them (`protos/src/{configtx,configuration,
msp_config,policies}.proto`, which follow `fabric-protos-go`). Every
`ConfigGroup` is three maps (`wire._map`); `wire.encode` writes them in key
order, the bytes of protobuf's `SerializeToString(deterministic=True)`.
"""

from __future__ import annotations

from fabric_tpu_torch.protos import fabric
from fabric_tpu_torch.protos.wire import Field, Schema, _map, _msg

# policies.proto
UNKNOWN, SIGNATURE, MSP, IMPLICIT_META = 0, 1, 2, 3  # Policy.PolicyType
POLICY: Schema = {1: Field("type", "int32"), 2: Field("value", "bytes")}
ANY, ALL, MAJORITY = 0, 1, 2  # ImplicitMetaPolicy.Rule
IMPLICIT_META_POLICY: Schema = {1: Field("sub_policy", "string"), 2: Field("rule", "enum")}

# configtx.proto; ConfigGroup holds itself
CONFIG_VALUE: Schema = {
    1: Field("version", "uint64"),
    2: Field("value", "bytes"),
    3: Field("mod_policy", "string"),
}
CONFIG_POLICY: Schema = {
    1: Field("version", "uint64"),
    2: _msg("policy", POLICY),
    3: Field("mod_policy", "string"),
}
CONFIG_GROUP: Schema = {}
CONFIG_GROUP.update({
    1: Field("version", "uint64"),
    2: _map("groups", "string", _msg("", CONFIG_GROUP)),
    3: _map("values", "string", _msg("", CONFIG_VALUE)),
    4: _map("policies", "string", _msg("", CONFIG_POLICY)),
    5: Field("mod_policy", "string"),
})
CONFIG: Schema = {1: Field("sequence", "uint64"), 2: _msg("channel_group", CONFIG_GROUP)}
CONFIG_ENVELOPE: Schema = {1: _msg("config", CONFIG), 2: _msg("last_update", fabric.ENVELOPE)}
CONFIG_SIGNATURE: Schema = {1: Field("signature_header", "bytes"), 2: Field("signature", "bytes")}
CONFIG_UPDATE_ENVELOPE: Schema = {
    1: Field("config_update", "bytes"),
    2: _msg("signatures", CONFIG_SIGNATURE, repeated=True),
}
CONFIG_UPDATE: Schema = {
    1: Field("channel_id", "string"),
    2: _msg("read_set", CONFIG_GROUP),
    3: _msg("write_set", CONFIG_GROUP),
    5: _map("isolated_data", "string", Field("", "bytes")),
}

# common/configuration.proto
HASHING_ALGORITHM: Schema = {1: Field("name", "string")}
BLOCK_DATA_HASHING_STRUCTURE: Schema = {1: Field("width", "uint32")}
ORDERER_ADDRESSES: Schema = {1: Field("addresses", "string", repeated=True)}
CONSORTIUM: Schema = {1: Field("name", "string")}
CAPABILITY: Schema = {}
CAPABILITIES: Schema = {1: _map("capabilities", "string", _msg("", CAPABILITY))}

# orderer/configuration.proto
STATE_NORMAL, STATE_MAINTENANCE = 0, 1  # ConsensusType.State
CONSENSUS_TYPE: Schema = {
    1: Field("type", "string"),
    2: Field("metadata", "bytes"),
    3: Field("state", "enum"),
}
BATCH_SIZE: Schema = {
    1: Field("max_message_count", "uint32"),
    2: Field("absolute_max_bytes", "uint32"),
    3: Field("preferred_max_bytes", "uint32"),
}
BATCH_TIMEOUT: Schema = {1: Field("timeout", "string")}
CHANNEL_RESTRICTIONS: Schema = {1: Field("max_count", "uint64")}

# orderer/etcdraft/configuration.proto (ConfigMetadata, Consenter, Options)
RAFT_CONSENTER: Schema = {
    1: Field("host", "string"),
    2: Field("port", "uint32"),
    3: Field("client_tls_cert", "bytes"),
    4: Field("server_tls_cert", "bytes"),
}
RAFT_OPTIONS: Schema = {
    1: Field("tick_interval", "string"),
    2: Field("election_tick", "uint32"),
    3: Field("heartbeat_tick", "uint32"),
    4: Field("max_inflight_blocks", "uint32"),
    5: Field("snapshot_interval_size", "uint32"),
}
RAFT_CONFIG_METADATA: Schema = {
    1: _msg("consenters", RAFT_CONSENTER, repeated=True),
    2: _msg("options", RAFT_OPTIONS),
}
# the consenter -> raft id mapping in a block's ORDERER metadata slot
# (the JAX package's configuration.proto RaftBlockMetadata); the ids are
# a packed repeated uint64
RAFT_BLOCK_METADATA: Schema = {
    1: Field("consenter_addresses", "string", repeated=True),
    2: Field("consenter_ids", "uint64", repeated=True),
    3: Field("next_consenter_id", "uint64"),
}

# peer/configuration.proto
ANCHOR_PEER: Schema = {1: Field("host", "string"), 2: Field("port", "int32")}
ANCHOR_PEERS: Schema = {1: _msg("anchor_peers", ANCHOR_PEER, repeated=True)}
API_RESOURCE: Schema = {1: Field("policy_ref", "string")}
ACLS: Schema = {1: _map("acls", "string", _msg("", API_RESOURCE))}

# msp/msp_config.proto
MSP_CONFIG: Schema = {1: Field("type", "int32"), 2: Field("config", "bytes")}
FABRIC_OU_IDENTIFIER: Schema = {
    1: Field("certificate", "bytes"),
    2: Field("organizational_unit_identifier", "string"),
}
FABRIC_NODE_OUS: Schema = {
    1: Field("enable", "bool"),
    2: _msg("client_ou_identifier", FABRIC_OU_IDENTIFIER),
    3: _msg("peer_ou_identifier", FABRIC_OU_IDENTIFIER),
    4: _msg("admin_ou_identifier", FABRIC_OU_IDENTIFIER),
    5: _msg("orderer_ou_identifier", FABRIC_OU_IDENTIFIER),
}
FABRIC_CRYPTO_CONFIG: Schema = {
    1: Field("signature_hash_family", "string"),
    2: Field("identity_identifier_hash_function", "string"),
}
KEY_INFO: Schema = {1: Field("key_identifier", "string"), 2: Field("key_material", "bytes")}
SIGNING_IDENTITY_INFO: Schema = {
    1: Field("public_signer", "bytes"),
    2: _msg("private_signer", KEY_INFO),
}
FABRIC_MSP_CONFIG: Schema = {
    1: Field("name", "string"),
    2: Field("root_certs", "bytes", repeated=True),
    3: Field("intermediate_certs", "bytes", repeated=True),
    4: Field("admins", "bytes", repeated=True),
    5: Field("revocation_list", "bytes", repeated=True),
    6: _msg("signing_identity", SIGNING_IDENTITY_INFO),
    7: _msg("organizational_unit_identifiers", FABRIC_OU_IDENTIFIER, repeated=True),
    8: _msg("crypto_config", FABRIC_CRYPTO_CONFIG),
    9: Field("tls_root_certs", "bytes", repeated=True),
    10: Field("tls_intermediate_certs", "bytes", repeated=True),
    11: _msg("fabric_node_ous", FABRIC_NODE_OUS),
}
