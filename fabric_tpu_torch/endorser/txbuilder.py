"""Proposal/transaction assembly (reference protoutil/txutils.go:
CreateChaincodeProposal, GetSignedProposal, CreateProposalResponse/
GetProposalHash1, CreateSignedTx; the endorsement signature of
plugin_endorser.go).

The port's counterpart of the JAX package's `endorser/txbuilder.py`, over
the wire codec: the same messages, byte for byte, for the same identities
and nonces. Messages are dicts in `wire.decode`'s form. A proposal may carry
a transient map: it rides in the signed proposal's payload only, and the
proposal hash and the transaction carry the sanitized payload without it
(`cc_proposal_payload_tx`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from fabric_tpu_torch.msp.signer import SigningIdentity
from fabric_tpu_torch.protos import fabric, protoutil, wire


@dataclass
class ProposalBundle:
    """A proposal plus the pieces later steps need."""

    channel_id: str
    tx_id: str
    channel_header: bytes
    signature_header: bytes
    cc_proposal_payload: bytes  # with the transient map (the endorser's input)
    cc_proposal_payload_tx: bytes  # sanitized: no transient map (goes in the tx)
    chaincode_name: str


def create_proposal(
    signer: SigningIdentity,
    channel_id: str,
    chaincode_name: str,
    args: Sequence[bytes],
    transient: Optional[Dict[str, bytes]] = None,
) -> ProposalBundle:
    nonce = signer.new_nonce()
    creator = signer.serialize()
    tx_id = protoutil.compute_tx_id(nonce, creator)
    ext = wire.encode(fabric.CHAINCODE_HEADER_EXTENSION, {"chaincode_id": {"name": chaincode_name}})
    chdr = protoutil.make_channel_header(
        fabric.ENDORSER_TRANSACTION, channel_id, tx_id=tx_id, extension=ext)
    cis = {"chaincode_spec": {
        "type": fabric.GOLANG,
        "chaincode_id": {"name": chaincode_name},
        "input": {"args": list(args)},
    }}
    ccpp_tx = {"input": wire.encode(fabric.CHAINCODE_INVOCATION_SPEC, cis)}
    ccpp = dict(ccpp_tx)
    if transient:
        ccpp["TransientMap"] = dict(transient)
    return ProposalBundle(
        channel_id=channel_id,
        tx_id=tx_id,
        channel_header=wire.encode(fabric.CHANNEL_HEADER, chdr),
        signature_header=wire.encode(
            fabric.SIGNATURE_HEADER, protoutil.make_signature_header(creator, nonce)),
        cc_proposal_payload=wire.encode(fabric.CHAINCODE_PROPOSAL_PAYLOAD, ccpp),
        cc_proposal_payload_tx=wire.encode(fabric.CHAINCODE_PROPOSAL_PAYLOAD, ccpp_tx),
        chaincode_name=chaincode_name,
    )


def create_signed_proposal(bundle: ProposalBundle, signer: SigningIdentity) -> dict:
    """protoutil.GetSignedProposal: Proposal{header, payload with the
    transient map} signed by the client over the serialized proposal
    bytes; returns a SignedProposal message."""
    header = wire.encode(fabric.HEADER, {"channel_header": bundle.channel_header,
                                         "signature_header": bundle.signature_header})
    proposal_bytes = wire.encode(fabric.PROPOSAL, {"header": header,
                                                   "payload": bundle.cc_proposal_payload})
    return {"proposal_bytes": proposal_bytes, "signature": signer.sign(proposal_bytes)}


def proposal_hash(bundle: ProposalBundle) -> bytes:
    """GetProposalHash1: sha256 over channel header || signature header ||
    sanitized chaincode proposal payload."""
    h = hashlib.sha256()
    h.update(bundle.channel_header)
    h.update(bundle.signature_header)
    h.update(bundle.cc_proposal_payload_tx)
    return h.digest()


def endorse_proposal(bundle: ProposalBundle, endorser: SigningIdentity, results: bytes,
                     response_payload: bytes = b"", events: bytes = b"") -> dict:
    """Simulate-free endorsement: wrap the given simulation `results`
    (serialized TxReadWriteSet) and sign prp || endorser identity; returns
    a ProposalResponse message."""
    action = {
        "results": results,
        "events": events,
        "response": {"status": 200, "payload": response_payload},
        "chaincode_id": {"name": bundle.chaincode_name},
    }
    prp_bytes = wire.encode(fabric.PROPOSAL_RESPONSE_PAYLOAD, {
        "proposal_hash": proposal_hash(bundle),
        "extension": wire.encode(fabric.CHAINCODE_ACTION, action),
    })
    endorser_bytes = endorser.serialize()
    return {
        "version": 1,
        "response": {"status": 200},
        "payload": prp_bytes,
        "endorsement": {
            "endorser": endorser_bytes,
            "signature": endorser.sign(prp_bytes + endorser_bytes),
        },
    }


def create_signed_tx(
    bundle: ProposalBundle, signer: SigningIdentity, responses: Sequence[dict]
) -> dict:
    """Assemble the final envelope (protoutil.CreateSignedTx): every
    endorsement must be a success and agree on the response payload."""
    if not responses:
        raise ValueError("at least one proposal response is required")
    for r in responses:
        status = r.get("response", {}).get("status", 0)
        if not 200 <= status < 400:
            message = r.get("response", {}).get("message", "")
            raise ValueError(
                f"proposal response was not successful, error code {status}, msg {message}")
    payload_bytes = responses[0].get("payload", b"")
    if any(r.get("payload", b"") != payload_bytes for r in responses[1:]):
        raise ValueError("ProposalResponsePayloads do not match")
    cap = {
        "chaincode_proposal_payload": bundle.cc_proposal_payload_tx,
        "action": {
            "proposal_response_payload": payload_bytes,
            "endorsements": [dict(r["endorsement"]) for r in responses],
        },
    }
    tx = {"actions": [{
        "header": bundle.signature_header,
        "payload": wire.encode(fabric.CHAINCODE_ACTION_PAYLOAD, cap),
    }]}
    payload = wire.encode(fabric.PAYLOAD, {
        "header": {"channel_header": bundle.channel_header,
                   "signature_header": bundle.signature_header},
        "data": wire.encode(fabric.TRANSACTION, tx),
    })
    return {"payload": payload, "signature": signer.sign(payload)}
