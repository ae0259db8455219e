"""Schemas of the discovery service's wire messages for the wire codec.

The port's counterpart of the JAX package's `discovery_pb2`
(`protos/src/discovery.proto`): a SignedRequest whose payload is a JSON
query document, and a QueryResponse whose result is a JSON document.
"""

from __future__ import annotations

from fabric_tpu_torch.protos.wire import Field, Schema

SIGNED_REQUEST: Schema = {1: Field("payload", "bytes"), 2: Field("signature", "bytes")}
QUERY_RESPONSE: Schema = {1: Field("status", "int32"), 2: Field("result", "bytes")}
