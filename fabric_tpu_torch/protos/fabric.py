"""Schemas of the block, transaction, MSP and policy messages for the wire codec.

The port's counterpart of the JAX package's `common_pb2`, `peer_pb2`,
`identities_pb2`, `msp_principal_pb2`, `msp_config_pb2` (the Idemix MSP's
two messages), `policies_pb2`, `collection_pb2` and `lifecycle_pb2`, as far
as the block validator, the transaction builder, the policy conversion, the
collections, `_lifecycle`, the legacy validation, the Idemix MSP, the
endorser, the system chaincodes, the orderer and the snapshot service use them
(`protos/src/{common,peer,identities,msp_principal,msp_config,policies,
collection,lifecycle}.proto`). Messages
are dicts in `wire.decode`'s form; `wire.encode` writes them byte for byte as
protobuf's `SerializeToString` does. `ChaincodeProposalPayload.TransientMap`
is a map field (`wire._map`): a dict {key: bytes}, written in upb's key
order. `ChaincodeInput.decorations` is left out: nothing on the port's paths
writes it, and the reader skips it as an unknown field.
"""

from __future__ import annotations

from fabric_tpu_torch.protos.wire import Field, Schema, _map, _msg

# common.HeaderType
MESSAGE, CONFIG, CONFIG_UPDATE, ENDORSER_TRANSACTION = 0, 1, 2, 3
ORDERER_TRANSACTION, DELIVER_SEEK_INFO, CHAINCODE_PACKAGE = 4, 5, 6
# common.Status
SUCCESS, BAD_REQUEST, FORBIDDEN, NOT_FOUND = 200, 400, 403, 404
REQUEST_ENTITY_TOO_LARGE, INTERNAL_SERVER_ERROR = 413, 500
NOT_IMPLEMENTED, SERVICE_UNAVAILABLE = 501, 503
# common.BlockMetadataIndex: SIGNATURES, LAST_CONFIG, TRANSACTIONS_FILTER, ORDERER, COMMIT_HASH
SIGNATURES = 0
TRANSACTIONS_FILTER = 2
ORDERER_METADATA = 3  # BlockMetadataIndex.ORDERER: the etcdraft consenter ids (configtx.RAFT_BLOCK_METADATA)
COMMIT_HASH = 4
BLOCK_METADATA_SLOTS = 5

# google.protobuf.Timestamp
TIMESTAMP: Schema = {1: Field("seconds", "int64"), 2: Field("nanos", "int32")}

# common.proto
BLOCK_HEADER: Schema = {
    1: Field("number", "uint64"),
    2: Field("previous_hash", "bytes"),
    3: Field("data_hash", "bytes"),
}
BLOCK_DATA: Schema = {1: Field("data", "bytes", repeated=True)}
BLOCK_METADATA: Schema = {1: Field("metadata", "bytes", repeated=True)}
BLOCK: Schema = {
    1: _msg("header", BLOCK_HEADER),
    2: _msg("data", BLOCK_DATA),
    3: _msg("metadata", BLOCK_METADATA),
}
METADATA_SIGNATURE: Schema = {
    1: Field("signature_header", "bytes"),
    2: Field("signature", "bytes"),
    3: Field("identifier_header", "bytes"),
}
# a block metadata slot's message; the COMMIT_HASH slot holds the hash in `value`
METADATA: Schema = {
    1: Field("value", "bytes"),
    2: _msg("signatures", METADATA_SIGNATURE, repeated=True),
}
ENVELOPE: Schema = {1: Field("payload", "bytes"), 2: Field("signature", "bytes")}
HEADER: Schema = {1: Field("channel_header", "bytes"), 2: Field("signature_header", "bytes")}
PAYLOAD: Schema = {1: _msg("header", HEADER), 2: Field("data", "bytes")}
CHANNEL_HEADER: Schema = {
    1: Field("type", "int32"),
    2: Field("version", "int32"),
    3: _msg("timestamp", TIMESTAMP),
    4: Field("channel_id", "string"),
    5: Field("tx_id", "string"),
    6: Field("epoch", "uint64"),
    7: Field("extension", "bytes"),
    8: Field("tls_cert_hash", "bytes"),
}
SIGNATURE_HEADER: Schema = {1: Field("creator", "bytes"), 2: Field("nonce", "bytes")}
LAST_CONFIG: Schema = {1: Field("index", "uint64")}
BLOCKCHAIN_INFO: Schema = {
    1: Field("height", "uint64"),
    2: Field("currentBlockHash", "bytes"),
    3: Field("previousBlockHash", "bytes"),
}

# peer.proto
CHAINCODE_ID: Schema = {
    1: Field("path", "string"),
    2: Field("name", "string"),
    3: Field("version", "string"),
}
CHAINCODE_INPUT: Schema = {1: Field("args", "bytes", repeated=True), 3: Field("is_init", "bool")}
CHAINCODE_SPEC: Schema = {
    1: Field("type", "enum"),
    2: _msg("chaincode_id", CHAINCODE_ID),
    3: _msg("input", CHAINCODE_INPUT),
    4: Field("timeout", "int32"),
}
GOLANG = 1  # ChaincodeSpec.Type
CHAINCODE_INVOCATION_SPEC: Schema = {1: _msg("chaincode_spec", CHAINCODE_SPEC)}
CHAINCODE_HEADER_EXTENSION: Schema = {2: _msg("chaincode_id", CHAINCODE_ID)}
CHAINCODE_DEPLOYMENT_SPEC: Schema = {
    1: _msg("chaincode_spec", CHAINCODE_SPEC),
    3: Field("code_package", "bytes"),
}
SIGNED_PROPOSAL: Schema = {1: Field("proposal_bytes", "bytes"), 2: Field("signature", "bytes")}
PROPOSAL: Schema = {
    1: Field("header", "bytes"),
    2: Field("payload", "bytes"),
    3: Field("extension", "bytes"),
}
CHAINCODE_PROPOSAL_PAYLOAD: Schema = {
    1: Field("input", "bytes"),
    2: _map("TransientMap", "string", Field("value", "bytes")),
}
RESPONSE: Schema = {
    1: Field("status", "int32"),
    2: Field("message", "string"),
    3: Field("payload", "bytes"),
}
CHAINCODE_ACTION: Schema = {
    1: Field("results", "bytes"),
    2: Field("events", "bytes"),
    3: _msg("response", RESPONSE),
    4: _msg("chaincode_id", CHAINCODE_ID),
}
PROPOSAL_RESPONSE_PAYLOAD: Schema = {1: Field("proposal_hash", "bytes"), 2: Field("extension", "bytes")}
ENDORSEMENT: Schema = {1: Field("endorser", "bytes"), 2: Field("signature", "bytes")}
PROPOSAL_RESPONSE: Schema = {
    1: Field("version", "int32"),
    2: _msg("timestamp", TIMESTAMP),
    4: _msg("response", RESPONSE),
    5: Field("payload", "bytes"),
    6: _msg("endorsement", ENDORSEMENT),
}
CHAINCODE_ENDORSED_ACTION: Schema = {
    1: Field("proposal_response_payload", "bytes"),
    2: _msg("endorsements", ENDORSEMENT, repeated=True),
}
CHAINCODE_ACTION_PAYLOAD: Schema = {
    1: Field("chaincode_proposal_payload", "bytes"),
    2: _msg("action", CHAINCODE_ENDORSED_ACTION),
}
TRANSACTION_ACTION: Schema = {1: Field("header", "bytes"), 2: Field("payload", "bytes")}
TRANSACTION: Schema = {1: _msg("actions", TRANSACTION_ACTION, repeated=True)}
PROCESSED_TRANSACTION: Schema = {
    1: _msg("transactionEnvelope", ENVELOPE),
    2: Field("validationCode", "int32"),
}
CHAINCODE_EVENT: Schema = {
    1: Field("chaincode_id", "string"),
    2: Field("tx_id", "string"),
    3: Field("event_name", "string"),
    4: Field("payload", "bytes"),
}
CHANNEL_INFO: Schema = {1: Field("channel_id", "string")}
CHANNEL_QUERY_RESPONSE: Schema = {1: _msg("channels", CHANNEL_INFO, repeated=True)}
CHAINCODE_INFO: Schema = {
    1: Field("name", "string"),
    2: Field("version", "string"),
    3: Field("path", "string"),
    4: Field("input", "string"),
    5: Field("escc", "string"),
    6: Field("vscc", "string"),
    7: Field("id", "bytes"),
}
CHAINCODE_QUERY_RESPONSE: Schema = {1: _msg("chaincodes", CHAINCODE_INFO, repeated=True)}
# the peer's Snapshot service (peer.proto; google.protobuf.Empty as EMPTY)
SNAPSHOT_QUERY: Schema = {1: Field("signature_header", "bytes"), 2: Field("channel_id", "string")}
SNAPSHOT_REQUEST: Schema = {
    1: Field("signature_header", "bytes"),
    2: Field("channel_id", "string"),
    3: Field("block_number", "uint64"),
}
SIGNED_SNAPSHOT_REQUEST: Schema = {1: Field("request", "bytes"), 2: Field("signature", "bytes")}
QUERY_PENDING_SNAPSHOTS_RESPONSE: Schema = {1: Field("block_numbers", "uint64", repeated=True)}
EMPTY: Schema = {}

# identities.proto, msp_principal.proto
SERIALIZED_IDENTITY: Schema = {1: Field("mspid", "string"), 2: Field("id_bytes", "bytes")}
SERIALIZED_IDEMIX_IDENTITY: Schema = {
    1: Field("nym_x", "bytes"),
    2: Field("nym_y", "bytes"),
    3: Field("ou", "bytes"),
    4: Field("role", "bytes"),
    5: Field("proof", "bytes"),
}
MSP_PRINCIPAL: Schema = {
    1: Field("principal_classification", "enum"),
    2: Field("principal", "bytes"),
}
ROLE, ORGANIZATION_UNIT, IDENTITY = 0, 1, 2  # MSPPrincipal.Classification
MSP_ROLE: Schema = {1: Field("msp_identifier", "string"), 2: Field("role", "enum")}
MEMBER, ADMIN, CLIENT, PEER, ORDERER = 0, 1, 2, 3, 4  # MSPRole.MSPRoleType
ORGANIZATION_UNIT_MSG: Schema = {
    1: Field("msp_identifier", "string"),
    2: Field("organizational_unit_identifier", "string"),
    3: Field("certifiers_identifier", "bytes"),
}

# msp_config.proto: the Idemix MSP's configuration
IDEMIX_MSP_SIGNER_CONFIG: Schema = {
    1: Field("cred", "bytes"),
    2: Field("sk", "bytes"),
    3: Field("organizational_unit_identifier", "string"),
    4: Field("role", "int32"),
    5: Field("enrollment_id", "string"),
    6: Field("credential_revocation_information", "bytes"),
}
IDEMIX_MSP_CONFIG: Schema = {
    1: Field("name", "string"),
    2: Field("ipk", "bytes"),
    3: _msg("signer", IDEMIX_MSP_SIGNER_CONFIG),
    4: Field("revocation_pk", "bytes"),
    5: Field("epoch", "int64"),
}

# policies.proto; SignaturePolicy and NOutOf refer to each other
SIGNATURE_POLICY: Schema = {}
N_OUT_OF: Schema = {
    1: Field("n", "int32"),
    2: _msg("rules", SIGNATURE_POLICY, repeated=True),
}
SIGNATURE_POLICY.update({
    1: Field("signed_by", "int32", oneof="Type"),
    2: _msg("n_out_of", N_OUT_OF, oneof="Type"),
})
SIGNATURE_POLICY_ENVELOPE: Schema = {
    1: Field("version", "int32"),
    2: _msg("rule", SIGNATURE_POLICY),
    3: _msg("identities", MSP_PRINCIPAL, repeated=True),
}
APPLICATION_POLICY: Schema = {
    1: _msg("signature_policy", SIGNATURE_POLICY_ENVELOPE, oneof="Type"),
    2: Field("channel_config_policy_reference", "string", oneof="Type"),
}

# collection.proto
COLLECTION_POLICY_CONFIG: Schema = {
    1: _msg("signature_policy", SIGNATURE_POLICY_ENVELOPE, oneof="payload"),
}
STATIC_COLLECTION_CONFIG: Schema = {
    1: Field("name", "string"),
    2: _msg("member_orgs_policy", COLLECTION_POLICY_CONFIG),
    3: Field("required_peer_count", "int32"),
    4: Field("maximum_peer_count", "int32"),
    5: Field("block_to_live", "uint64"),
    6: Field("member_only_read", "bool"),
    7: Field("member_only_write", "bool"),
    8: _msg("endorsement_policy", APPLICATION_POLICY),
}
COLLECTION_CONFIG: Schema = {
    1: _msg("static_collection_config", STATIC_COLLECTION_CONFIG, oneof="payload"),
}
COLLECTION_CONFIG_PACKAGE: Schema = {1: _msg("config", COLLECTION_CONFIG, repeated=True)}

# peer.proto: LSCC's record of a chaincode (pre-2.0 lifecycle)
CHAINCODE_DATA: Schema = {
    1: Field("name", "string"),
    2: Field("version", "string"),
    3: Field("escc", "string"),
    4: Field("vscc", "string"),
    5: Field("policy", "bytes"),
    6: Field("data", "bytes"),
    7: Field("id", "bytes"),
    8: Field("instantiation_policy", "bytes"),
}

# lifecycle.proto: the `_lifecycle` namespace's values
STATE_METADATA: Schema = {
    1: Field("datatype", "string"),
    2: Field("fields", "string", repeated=True),
}
STATE_DATA: Schema = {
    1: Field("Int64", "int64", oneof="Type"),
    2: Field("Bytes", "bytes", oneof="Type"),
    3: Field("String", "string", oneof="Type"),
}
