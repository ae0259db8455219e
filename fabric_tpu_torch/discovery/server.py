"""Discovery over gRPC + the client library (reference discovery/support
+ discovery/client: the SDK-facing service answering peers / config /
endorsers queries with a signed request).

Wire format: one `discovery.Discovery/Process` unary RPC carrying a
SignedRequest whose payload is a JSON query document signed by the
client identity — the reference's SignedRequest shape
(discovery/protocol.proto) with a JSON body standing in for the full
discovery proto tree:

  payload = {"channel": "...", "query": "peers|config|endorsers",
             "chaincode": "...", "identity": base64(SerializedIdentity)}

Access control is the channel's Readers policy evaluated over the signed
payload, exactly like service.go processQuery.

The port's counterpart of the JAX package's `discovery/server.py`, over the
port's `discovery/service.DiscoveryService` and the schemas of
`protos/discovery.py`: the same JSON documents, byte for byte. The service
answers a denial as a DiscoveryError (status 500, as in the JAX server); a
provider that fails raises out of the call (the port's service lets it
through, fail closed), which the client sees as a failed RPC.
"""

from __future__ import annotations

import base64
import json
from dataclasses import asdict
from typing import Optional

from fabric_tpu_torch.comm.server import UNARY, GRPCServer, channel_to, wire_codec
from fabric_tpu_torch.discovery.service import DiscoveryError, DiscoveryService
from fabric_tpu_torch.policy.manager import SignedData
from fabric_tpu_torch.protos import discovery as discovery_proto

SERVICE_NAME = "discovery.Discovery"

_SIGNED_REQUEST = wire_codec(discovery_proto.SIGNED_REQUEST)
_QUERY_RESPONSE = wire_codec(discovery_proto.QUERY_RESPONSE)


class DiscoveryServer:
    def __init__(self, service: DiscoveryService):
        self.service = service

    def process(self, request: dict, context) -> dict:
        payload = request.get("payload", b"")
        try:
            doc = json.loads(payload)
            client = SignedData(
                data=payload,
                identity=base64.b64decode(doc["identity"]),
                signature=request.get("signature", b""),
            )
            channel = doc.get("channel", "")
            query = doc.get("query")
            if query == "peers":
                result = [
                    asdict(p) for p in self.service.peers(channel, client)
                ]
            elif query == "config":
                result = self.service.config(channel, client)
            elif query == "endorsers":
                desc = self.service.endorsers(
                    channel, doc.get("chaincode", ""), client
                )
                result = {
                    "chaincode": desc.chaincode,
                    "endorsers_by_groups": {
                        g: [asdict(p) for p in peers]
                        for g, peers in desc.endorsers_by_groups.items()
                    },
                    "layouts": desc.layouts,
                }
            else:
                raise DiscoveryError(f"unknown query {query!r}")
            return {"status": 200, "result": json.dumps(result, sort_keys=True).encode()}
        except (DiscoveryError, ValueError, KeyError) as exc:
            return {"status": 500, "result": json.dumps({"error": str(exc)}).encode()}

    def register(self, server: GRPCServer) -> None:
        server.register(
            SERVICE_NAME,
            {
                "Process": (UNARY, self.process, _SIGNED_REQUEST[0], _QUERY_RESPONSE[1])
            },
        )


def query(
    addr: str,
    signer,
    channel: str,
    what: str,
    chaincode: str = "",
    root_ca: Optional[bytes] = None,
):
    """Client half (discovery/client): sign + send one query, return the
    decoded JSON result (raises DiscoveryError on a service error)."""
    doc = {
        "channel": channel,
        "query": what,
        "chaincode": chaincode,
        "identity": base64.b64encode(signer.serialize()).decode(),
    }
    payload = json.dumps(doc, sort_keys=True).encode()
    req = {"payload": payload, "signature": signer.sign(payload)}
    conn = channel_to(addr, root_ca)
    try:
        resp = conn.unary_unary(
            f"/{SERVICE_NAME}/Process",
            request_serializer=_SIGNED_REQUEST[1],
            response_deserializer=_QUERY_RESPONSE[0],
        )(req, timeout=10.0)
    finally:
        conn.close()
    body = json.loads(resp.get("result", b""))
    if resp.get("status", 0) != 200:
        raise DiscoveryError(body.get("error", "discovery failed"))
    return body
