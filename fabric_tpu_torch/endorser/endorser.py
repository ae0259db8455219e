"""Endorser service — ProcessProposal (reference core/endorser/
endorser.go:296 + preProcess :250-294 + SimulateProposal :178).

Pipeline per proposal:
1. unpack SignedProposal -> Proposal -> headers (UnpackProposal);
2. validate: channel header type, TxID recompute, creator deserialize +
   certificate validation + client signature over proposal_bytes
   (validateProcessProposal -> checkSignatureFromCreator analog);
3. ACL check (aclmgmt hook);
4. duplicate TxID check against the ledger;
5. simulate: TxSimulator over committed state + ChaincodeSupport.Execute;
6. endorse: ProposalResponsePayload{proposal_hash, ChaincodeAction} signed
   as sig(prp || endorser_identity) — the default endorsement plugin
   (plugin_endorser.go / builtin ESCC).

The port's counterpart of the JAX package's `endorser/endorser.py`, over the
wire codec: a SignedProposal and a ProposalResponse are message dicts
(`protos/fabric.py`), and a response's status, message and payload bytes
are the JAX endorser's for the same input. The creator's signature goes to
the provider of the MSP that deserializes the creator (`Identity.verify`:
on `CUDAProvider`, one K2 launch of one lane). A `LaunchError` (a chaincode
that is neither registered nor resolvable) is not caught here, as in the
reference package.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from fabric_tpu_torch.chaincode.support import ChaincodeSupport, TxParams
from fabric_tpu_torch.ledger.simulator import TxSimulator, collection_kvrwset_bytes
from fabric_tpu_torch.ledger.statedb import VersionedDB
from fabric_tpu_torch.msp.identity import MSPError, MSPManager
from fabric_tpu_torch.msp.signer import SigningIdentity
from fabric_tpu_torch.protos import fabric, protoutil, wire


class ProposalError(Exception):
    """Rejected before/while simulation; maps to a 500 ProposalResponse."""


@dataclass
class UnpackedProposal:
    signed_proposal: dict
    proposal: dict
    channel_header: dict
    signature_header: dict
    chaincode_name: str
    input: dict  # ChaincodeInput
    transient: Dict[str, bytes]


def unpack_proposal(signed: dict) -> UnpackedProposal:
    """protoutil.UnpackProposal + header checks (endorser.go:250-270)."""
    unmarshal = protoutil.unmarshal_as
    prop = unmarshal(fabric.PROPOSAL, signed.get("proposal_bytes", b""), "protos.Proposal")
    header = unmarshal(fabric.HEADER, prop.get("header", b""), "common.Header")
    chdr = unmarshal(fabric.CHANNEL_HEADER, header.get("channel_header", b""),
                     "common.ChannelHeader")
    shdr = unmarshal(fabric.SIGNATURE_HEADER, header.get("signature_header", b""),
                     "common.SignatureHeader")
    if chdr.get("type", 0) != fabric.ENDORSER_TRANSACTION:
        raise ProposalError(
            f"invalid header type {chdr.get('type', 0)}, expected ENDORSER_TRANSACTION"
        )
    ext = unmarshal(fabric.CHAINCODE_HEADER_EXTENSION, chdr.get("extension", b""),
                    "protos.ChaincodeHeaderExtension")
    name = ext.get("chaincode_id", {}).get("name", "")
    if not name:
        raise ProposalError("ChaincodeHeaderExtension.ChaincodeId.Name is empty")
    ccpp = unmarshal(fabric.CHAINCODE_PROPOSAL_PAYLOAD, prop.get("payload", b""),
                     "protos.ChaincodeProposalPayload")
    cis = unmarshal(fabric.CHAINCODE_INVOCATION_SPEC, ccpp.get("input", b""),
                    "protos.ChaincodeInvocationSpec")
    return UnpackedProposal(
        signed_proposal=signed,
        proposal=prop,
        channel_header=chdr,
        signature_header=shdr,
        chaincode_name=name,
        input=cis.get("chaincode_spec", {}).get("input", {}),
        transient=dict(ccpp.get("TransientMap", {})),
    )


def _response(status: int, message: str, payload: bytes = b"") -> dict:
    return {"status": status, "message": message, "payload": payload}


class Endorser:
    def __init__(
        self,
        local_signer: SigningIdentity,
        msp_manager: MSPManager,
        support: ChaincodeSupport,
        get_ledger: Callable[[str], Optional[object]],
        acl_check: Optional[Callable[[UnpackedProposal], None]] = None,
        on_pvt_results=None,  # (channel, tx_id, [(ns, coll, kvrwset)])
    ):
        self.signer = local_signer
        self.msp_manager = msp_manager
        self.support = support
        self.get_ledger = get_ledger
        self.acl_check = acl_check
        self.on_pvt_results = on_pvt_results

    # -- the gRPC entry point --
    def process_proposal(self, signed: dict) -> dict:
        """A SignedProposal message in, a ProposalResponse message out."""
        try:
            unpacked = unpack_proposal(signed)
            self._validate(unpacked)
            return self._simulate_and_endorse(unpacked)
        except (ProposalError, ValueError) as err:
            return {"response": {"status": 500, "message": str(err)}}

    # -- preProcess (endorser.go:250-294) --
    def _validate(self, up: UnpackedProposal) -> None:
        shdr = up.signature_header
        nonce, creator = shdr.get("nonce", b""), shdr.get("creator", b"")
        if not nonce:
            raise ProposalError("nonce is empty")
        if not creator:
            raise ProposalError("creator is empty")
        expected = protoutil.compute_tx_id(nonce, creator)
        tx_id = up.channel_header.get("tx_id", "")
        if tx_id != expected:
            raise ProposalError(f"incorrect txid; expected {expected}, got {tx_id}")
        try:
            identity, msp = self.msp_manager.deserialize_identity(creator)
            msp.validate(identity)
            identity.verify(up.signed_proposal.get("proposal_bytes", b""),
                            up.signed_proposal.get("signature", b""))
        except MSPError as err:
            raise ProposalError(f"access denied: {err}") from err
        if self.acl_check is not None:
            self.acl_check(up)

    # -- SimulateProposal + endorsement --
    def _simulate_and_endorse(self, up: UnpackedProposal) -> dict:
        channel_id = up.channel_header.get("channel_id", "")
        tx_id = up.channel_header.get("tx_id", "")
        if channel_id:
            ledger = self.get_ledger(channel_id)
            if ledger is None:
                raise ProposalError(f"channel {channel_id} not found")
            if ledger.tx_exists(tx_id):
                raise ProposalError(f"duplicate transaction found [{tx_id}]")
            sim = TxSimulator(ledger.state_db, tx_id=tx_id)
        else:
            # channel-less proposal (lifecycle install, cscc JoinChain):
            # no ledger, a throwaway simulator whose rwset is discarded
            # (endorser.go: acquire a tx simulator only if chainID != "")
            sim = TxSimulator(VersionedDB(), tx_id=tx_id)
        resp, event = self.support.execute(
            TxParams(
                channel_id=channel_id,
                tx_id=tx_id,
                simulator=sim,
                creator=up.signature_header.get("creator", b""),
                transient=up.transient,
            ),
            up.chaincode_name,
            list(up.input.get("args", ())),
        )
        if resp.status >= 400:
            # Chaincode errors return the response unsigned
            # (endorser.go:347-352: no endorsement on failure).
            return {"response": _response(resp.status, resp.message, resp.payload)}

        results = sim.get_tx_simulation_results()
        action = {
            "results": results.public_bytes,
            "response": _response(resp.status, resp.message, resp.payload),
            "chaincode_id": {"name": up.chaincode_name},
        }
        if event is not None:
            action["events"] = wire.encode(fabric.CHAINCODE_EVENT, event)
        prp_bytes = wire.encode(fabric.PROPOSAL_RESPONSE_PAYLOAD, {
            "proposal_hash": self._proposal_hash(up),
            "extension": wire.encode(fabric.CHAINCODE_ACTION, action),
        })
        endorser_bytes = self.signer.serialize()
        out = {
            "version": 1,
            "response": _response(resp.status, resp.message, resp.payload),
            "payload": prp_bytes,
            "endorsement": {
                "endorser": endorser_bytes,
                "signature": self.signer.sign(prp_bytes + endorser_bytes),
            },
        }
        # Private write-sets never ride in the block; they go to the local
        # transient store and out to eligible peers NOW (endorser.go
        # distributePrivateData -> gossip/privdata pull.go push).
        self.last_pvt_results = results
        if results.pvt_writes and self.on_pvt_results is not None:
            pvt_writes = [
                (ns, coll, collection_kvrwset_bytes(writes))
                for (ns, coll), writes in sorted(results.pvt_writes.items())
            ]
            self.on_pvt_results(channel_id, tx_id, pvt_writes)
        return out

    def _proposal_hash(self, up: UnpackedProposal) -> bytes:
        """GetProposalHash1: headers + sanitized payload (no transient)."""
        ccpp = protoutil.unmarshal_as(fabric.CHAINCODE_PROPOSAL_PAYLOAD,
                                      up.proposal.get("payload", b""),
                                      "protos.ChaincodeProposalPayload")
        sanitized = wire.encode(fabric.CHAINCODE_PROPOSAL_PAYLOAD,
                                {"input": ccpp.get("input", b"")})
        header = protoutil.unmarshal_as(fabric.HEADER, up.proposal.get("header", b""),
                                        "common.Header")
        h = hashlib.sha256()
        h.update(header.get("channel_header", b""))
        h.update(header.get("signature_header", b""))
        h.update(sanitized)
        return h.digest()
