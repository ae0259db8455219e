"""The port's Endorser (fabric_tpu_torch.endorser.endorser) against the JAX
package's, with no tolerance: the same SignedProposal bytes go to both
endorsers (the JAX one over SoftwareProvider, the port's over the port's
P-256 oracle behind the provider SPI) and the ProposalResponses' statuses,
messages, payload bytes and endorser identities are equal; each
endorsement signature verifies under the other package's verifier.
tests/test_endorser.py's cases (the happy path, a bad signature, a wrong
txid, an unknown channel, a chaincode error returned unsigned, malformed
bytes, a missing chaincode name), then the header checks, a duplicate txid,
an ACL hook, a channel-less proposal, a transient map (the proposal hash
leaves it out; private write-sets go to `on_pvt_results`), a high-S and a
malformed signature (`VerifyError`'s text in both), the pinned `LaunchError`
for an unknown chaincode and an off-curve creator key. Then the port's
txbuilder and the wire schemas of the slice against protobuf, and
`Identity.verify`: no provider raises, `CUDAProvider(device="cpu")` is one
K2 call (its plain version)."""

import random

import pytest
import torch

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from fabric_tpu.chaincode import support as jsup
from fabric_tpu.crypto.bccsp import ECDSAPublicKey as JKey
from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.endorser import endorser as jend
from fabric_tpu.endorser import txbuilder as jtb
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.ledger import statedb as jdb
from fabric_tpu.msp import identity as jid
from fabric_tpu.msp.cryptogen import generate_org
from fabric_tpu.msp.signer import SigningIdentity as JSigner
from fabric_tpu.protos import common_pb2, peer_pb2
from fabric_tpu_torch.chaincode import support as tsup
from fabric_tpu_torch.common import p256
from fabric_tpu_torch.common import x509 as tx509
from fabric_tpu_torch.crypto import bccsp as tbccsp
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.endorser import endorser as tend
from fabric_tpu_torch.endorser import txbuilder as ttb
from fabric_tpu_torch.ledger import rwset as trw
from fabric_tpu_torch.ledger import statedb as tdb
from fabric_tpu_torch.msp import identity as tid
from fabric_tpu_torch.msp.cryptogen import NodeIdentity
from fabric_tpu_torch.msp.signer import SigningIdentity as TSigner
from fabric_tpu_torch.ops import p256_kernel
from fabric_tpu_torch.protos import fabric, protoutil as tpu, wire
from test_torch_chaincode import make_cc
from torch_untraced import untraced  # noqa: F401

SW = SoftwareProvider()
CHANNEL = "ch"


class OracleProvider(tbccsp.Provider):
    """The port's P-256 oracle behind the provider SPI (test material)."""

    def verify(self, key, signature, digest):
        r, s = tbccsp.parse_and_precheck(signature)
        return p256.verify_digest(key.point, digest, r, s)


ORACLE = OracleProvider()


def port_signer(node, seed):
    return TSigner(NodeIdentity(node.name, node.cert_pem, node.priv_scalar, node.msp_id),
                   random.Random(seed))


@pytest.fixture(scope="module")
def net():
    orgs = [generate_org(f"org{i}.example.com", f"Org{i}MSP") for i in (1, 2)]
    cfgs = [o.msp_config() for o in orgs]
    return {
        "orgs": orgs,
        "jmgr": jid.MSPManager([jid.MSP(c, provider=SW) for c in cfgs]),
        "tmgr": tid.MSPManager([tid.MSP(tid.msp_config_from_pems(
            c.msp_id, c.root_certs, admins=c.admins, node_ous=tid.NodeOUs(enable=True)),
            provider=ORACLE) for c in cfgs]),
        "client": port_signer(orgs[0].users[0], 1),
        "jpeer": JSigner(orgs[0].peers[0], SW),
        "tpeer": port_signer(orgs[0].peers[0], 2),
    }


class Ledger:
    """What the endorser reads of a ledger: its state DB and tx_exists."""

    def __init__(self, state_db, txids=()):
        self.state_db = state_db
        self.txids = set(txids)

    def tx_exists(self, txid):
        return txid in self.txids


def seeded(db_mod, rw_mod):
    db = db_mod.VersionedDB()
    batch = db_mod.UpdateBatch()
    batch.put("mycc", "a", b"100", rw_mod.Version(1, 0))
    batch.put("othercc", "a", b"other-a", rw_mod.Version(1, 1))
    db.apply_updates(batch)
    return db


def endorsers(net, txids=(), acl=None, pvt_sink=None):
    out = {}
    for pkg, sup, end, db_mod, rw_mod, signer, mgr, shim in (
            ("jax", jsup, jend, jdb, jrw, net["jpeer"], net["jmgr"], "fabric_tpu.chaincode.shim"),
            ("port", tsup, tend, tdb, trw, net["tpeer"], net["tmgr"],
             "fabric_tpu_torch.chaincode.shim")):
        import importlib

        shim_mod = importlib.import_module(shim)
        support = sup.ChaincodeSupport()
        support.register("mycc", make_cc(shim_mod))
        support.register("othercc", make_cc(shim_mod))
        ledger = Ledger(seeded(db_mod, rw_mod), txids)
        out[pkg] = end.Endorser(
            signer, mgr, support, get_ledger=lambda ch, lg=ledger: lg if ch == CHANNEL else None,
            acl_check=(lambda up, p=pkg: acl(p, up)) if acl else None,
            on_pvt_results=(lambda *a, p=pkg: pvt_sink.setdefault(p, []).append(a))
            if pvt_sink is not None else None)
    return out


def signed_proposal(net, args, channel=CHANNEL, cc="mycc", transient=None, change=None,
                    signer=None):
    """A SignedProposal dict made by the port's txbuilder; `change` edits
    the decoded Proposal (header dicts) before it is signed."""
    signer = signer or net["client"]
    bundle = ttb.create_proposal(signer, channel, cc, args, transient)
    signed = ttb.create_signed_proposal(bundle, signer)
    if change is not None:
        prop = wire.decode(fabric.PROPOSAL, signed["proposal_bytes"])
        header = wire.decode(fabric.HEADER, prop["header"])
        change(header, prop)
        prop["header"] = wire.encode(fabric.HEADER, header)
        raw = wire.encode(fabric.PROPOSAL, prop)
        signed = {"proposal_bytes": raw, "signature": signer.sign(raw)}
    return bundle, signed


def both(eps, signed):
    """Both endorsers' responses to the same SignedProposal bytes, as
    (status, message, payload, response payload, endorser) each, plus the
    raw responses."""
    raw = wire.encode(fabric.SIGNED_PROPOSAL, signed)
    jresp = eps["jax"].process_proposal(peer_pb2.SignedProposal.FromString(raw))
    tresp = eps["port"].process_proposal(wire.decode(fabric.SIGNED_PROPOSAL, raw))
    jview = (jresp.response.status, jresp.response.message, jresp.response.payload,
             jresp.payload, jresp.endorsement.endorser, jresp.version)
    r = tresp.get("response", {})
    tview = (r.get("status", 0), r.get("message", ""), r.get("payload", b""),
             tresp.get("payload", b""), tresp.get("endorsement", {}).get("endorser", b""),
             tresp.get("version", 0))
    assert tview == jview
    # the port's response, signature aside, is protobuf's message byte for byte
    jcopy = peer_pb2.ProposalResponse()
    jcopy.CopyFrom(jresp)
    if "endorsement" in tresp:
        jcopy.endorsement.signature = tresp["endorsement"]["signature"]
    assert wire.encode(fabric.PROPOSAL_RESPONSE, tresp) == jcopy.SerializeToString()
    return jview, jresp, tresp


def cross_verify(net, jresp, tresp):
    """Each endorsement signature verifies under the other package."""
    for resp_sig, prp, endorser in (
            (jresp.endorsement.signature, jresp.payload, jresp.endorsement.endorser),
            (tresp["endorsement"]["signature"], tresp["payload"],
             tresp["endorsement"]["endorser"])):
        ident, _ = net["tmgr"].deserialize_identity(endorser)
        ident.verify(prp + endorser, resp_sig)  # the port's verifier
        jident, _ = net["jmgr"].deserialize_identity(endorser)
        jident.verify(prp + endorser, resp_sig)  # the JAX verifier


def test_happy_path_equal_and_signatures_cross(net):
    bundle, signed = signed_proposal(net, [b"put", b"k1", b"v1"])
    view, jresp, tresp = both(endorsers(net), signed)
    assert view[0] == 200 and tresp["endorsement"]["signature"]
    cross_verify(net, jresp, tresp)
    prp = wire.decode(fabric.PROPOSAL_RESPONSE_PAYLOAD, tresp["payload"])
    assert prp["proposal_hash"] == ttb.proposal_hash(bundle)
    action = wire.decode(fabric.CHAINCODE_ACTION, prp["extension"])
    event = wire.decode(fabric.CHAINCODE_EVENT, action["events"])
    assert event == {"chaincode_id": "mycc", "tx_id": bundle.tx_id, "event_name": "put",
                     "payload": b"k1"}
    # the client assembles one envelope from either response; both verify
    env = ttb.create_signed_tx(bundle, net["client"], [tresp])
    jenv = jtb.create_signed_tx(_jax_bundle(bundle), JSigner(net["orgs"][0].users[0], SW), [
        peer_pb2.ProposalResponse.FromString(wire.encode(fabric.PROPOSAL_RESPONSE, tresp))])
    assert env["payload"] == jenv.payload


def _jax_bundle(bundle):
    return jtb.ProposalBundle(bundle.channel_id, bundle.tx_id, bundle.channel_header,
                              bundle.signature_header, bundle.cc_proposal_payload,
                              bundle.cc_proposal_payload_tx, bundle.chaincode_name)


def _flip(signed):
    sig = signed["signature"]
    return {**signed, "signature": sig[:-1] + bytes([sig[-1] ^ 1])}


def _set_chdr(**fields):
    def change(header, prop):
        chdr = wire.decode(fabric.CHANNEL_HEADER, header["channel_header"])
        chdr.update(fields)
        header["channel_header"] = wire.encode(fabric.CHANNEL_HEADER, chdr)
    return change


def _set_shdr(**fields):
    def change(header, prop):
        shdr = wire.decode(fabric.SIGNATURE_HEADER, header["signature_header"])
        shdr.update(fields)
        header["signature_header"] = wire.encode(fabric.SIGNATURE_HEADER, shdr)
    return change


def _high_s(signed):
    r, s = tbccsp.parse_and_precheck(signed["signature"])
    from fabric_tpu_torch.common import der

    return {**signed, "signature": der.marshal_signature(r, p256.N - s)}


CASES = {
    "bad-signature": lambda net: _flip(signed_proposal(net, [b"get", b"a"])[1]),
    "wrong-txid": lambda net: signed_proposal(net, [b"get", b"a"],
                                              change=_set_chdr(tx_id="beef"))[1],
    "unknown-channel": lambda net: signed_proposal(net, [b"get", b"a"], channel="nochannel")[1],
    "chaincode-error": lambda net: signed_proposal(net, [b"nope"])[1],
    "chaincode-panic": lambda net: signed_proposal(net, [b"boom"])[1],
    "malformed-bytes": lambda net: {"proposal_bytes": b"\xff\xff\xff garbage"},
    "malformed-header": lambda net: {"proposal_bytes": wire.encode(
        fabric.PROPOSAL, {"header": b"\x0a\x05ab"})},
    "malformed-input": lambda net: {"proposal_bytes": wire.encode(fabric.PROPOSAL, {
        "header": wire.encode(fabric.HEADER, {"channel_header": wire.encode(
            fabric.CHANNEL_HEADER, {"type": fabric.ENDORSER_TRANSACTION, "extension": wire.encode(
                fabric.CHAINCODE_HEADER_EXTENSION, {"chaincode_id": {"name": "mycc"}})})}),
        "payload": b"\x0a\x03\x0a\x05a"})},
    "missing-chaincode-name": lambda net: signed_proposal(net, [b"x"], change=_set_chdr(
        extension=wire.encode(fabric.CHAINCODE_HEADER_EXTENSION, {})))[1],
    "config-header-type": lambda net: signed_proposal(net, [b"x"],
                                                      change=_set_chdr(type=fabric.CONFIG))[1],
    "empty-nonce": lambda net: signed_proposal(net, [b"x"], change=_set_shdr(nonce=b""))[1],
    "empty-creator": lambda net: signed_proposal(net, [b"x"], change=_set_shdr(creator=b""))[1],
    "unknown-msp": lambda net: signed_proposal(net, [b"x"], change=lambda h, p: _retx(
        h, wire.encode(fabric.SERIALIZED_IDENTITY, {"mspid": "Org9MSP", "id_bytes": b"x"})))[1],
    "high-s": lambda net: _high_s(signed_proposal(net, [b"get", b"a"])[1]),
    "malformed-signature": lambda net: {**signed_proposal(net, [b"get", b"a"])[1],
                                        "signature": b"\x30\x03\x02\x01"},
    "get": lambda net: signed_proposal(net, [b"get", b"a"])[1],
    "cc2cc": lambda net: signed_proposal(net, [b"call", b"othercc", b"a"])[1],
    "scan": lambda net: signed_proposal(net, [b"scan", b"", b""])[1],
}


def _retx(header, creator):
    """Replace the creator and recompute the txid, so the check that
    fails is the creator's."""
    shdr = wire.decode(fabric.SIGNATURE_HEADER, header["signature_header"])
    shdr["creator"] = creator
    header["signature_header"] = wire.encode(fabric.SIGNATURE_HEADER, shdr)
    chdr = wire.decode(fabric.CHANNEL_HEADER, header["channel_header"])
    chdr["tx_id"] = tpu.compute_tx_id(shdr["nonce"], creator)
    header["channel_header"] = wire.encode(fabric.CHANNEL_HEADER, chdr)


EXPECT = {  # the status and a piece of the message, as tests/test_endorser.py pins them
    "bad-signature": (500, "access denied: The signature is invalid"),
    "wrong-txid": (500, "incorrect txid"),
    "unknown-channel": (500, "channel nochannel not found"),
    "chaincode-error": (500, "unknown function nope"),
    "chaincode-panic": (500, "chaincode mycc failed: chaincode panic"),
    "malformed-bytes": (500, "error unmarshalling Proposal: Error parsing message with type "
                             "'protos.Proposal'"),
    "malformed-header": (500, "error unmarshalling Header"),
    "malformed-input": (500, "error unmarshalling ChaincodeInvocationSpec"),
    "missing-chaincode-name": (500, "ChaincodeHeaderExtension.ChaincodeId.Name is empty"),
    "config-header-type": (500, "invalid header type 1, expected ENDORSER_TRANSACTION"),
    "empty-nonce": (500, "nonce is empty"),
    "empty-creator": (500, "creator is empty"),
    "unknown-msp": (500, "access denied: MSP Org9MSP is unknown"),
    "high-s": (500, "access denied: could not determine the validity of the signature: "
                    "invalid S, must be smaller than half the order"),
    "malformed-signature": (500, "access denied: could not determine the validity of the "
                                 "signature: failed unmarshalling signature"),
    "get": (200, ""),
    "cc2cc": (200, ""),
    "scan": (200, ""),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_responses_equal_jax(net, case):
    view, jresp, tresp = both(endorsers(net), CASES[case](net))
    status, fragment = EXPECT[case]
    assert view[0] == status and fragment in view[1]
    if status != 200:
        # errors carry no endorsement and no payload
        assert "endorsement" not in tresp and "payload" not in tresp
    else:
        cross_verify(net, jresp, tresp)


def test_unpack_rejects_missing_chaincode_in_both(net):
    _, signed = signed_proposal(net, [b"x"], change=_set_chdr(
        extension=wire.encode(fabric.CHAINCODE_HEADER_EXTENSION, {})))
    with pytest.raises(tend.ProposalError, match="Name is empty"):
        tend.unpack_proposal(signed)
    raw = wire.encode(fabric.SIGNED_PROPOSAL, signed)
    with pytest.raises(jend.ProposalError, match="Name is empty"):
        jend.unpack_proposal(peer_pb2.SignedProposal.FromString(raw))


def test_duplicate_txid_and_acl_hook(net):
    bundle, signed = signed_proposal(net, [b"get", b"a"])
    view, _, _ = both(endorsers(net, txids={bundle.tx_id}), signed)
    assert view[:2] == (500, f"duplicate transaction found [{bundle.tx_id}]")
    seen = []

    def acl(pkg, up):
        seen.append((pkg, up.chaincode_name, up.channel_header.tx_id if pkg == "jax"
                     else up.channel_header["tx_id"]))
        raise (jend if pkg == "jax" else tend).ProposalError("access denied: peer/Propose")

    view, _, _ = both(endorsers(net, acl=acl), signed)
    assert view[:2] == (500, "access denied: peer/Propose")
    assert seen == [("jax", "mycc", bundle.tx_id), ("port", "mycc", bundle.tx_id)]


def test_channel_less_proposal(net):
    """No ledger: a throwaway simulator whose rwset is discarded."""
    _, signed = signed_proposal(net, [b"get", b"a"], channel="")
    view, jresp, tresp = both(endorsers(net), signed)
    assert view[:3] == (200, "", b"")
    cross_verify(net, jresp, tresp)


def test_transient_map_private_data(net):
    """The transient map rides in the signed proposal only: the proposal
    hash covers the sanitized payload, and the private write-set goes to
    on_pvt_results with the same bytes in both packages."""
    transient = {"v": b"secret-v", "": b"empty key", "ab": b"", "a": b"x"}
    bundle, signed = signed_proposal(net, [b"pvt", b"k1"], transient=transient)
    sink = {}
    view, jresp, tresp = both(endorsers(net, pvt_sink=sink), signed)
    assert view[0] == 200
    assert sink["port"] == sink["jax"] and sink["port"][0][0] == CHANNEL
    prp = wire.decode(fabric.PROPOSAL_RESPONSE_PAYLOAD, tresp["payload"])
    assert prp["proposal_hash"] == ttb.proposal_hash(bundle)
    assert bundle.cc_proposal_payload != bundle.cc_proposal_payload_tx
    cross_verify(net, jresp, tresp)


def test_unknown_chaincode_raises_launch_error_in_both(net):
    """Pinned: a chaincode neither registered nor resolvable raises
    LaunchError out of process_proposal in both packages (the reference
    catches only ProposalError and ValueError; Fabric answers 500)."""
    _, signed = signed_proposal(net, [b"get", b"a"], cc="ghostcc")
    raw = wire.encode(fabric.SIGNED_PROPOSAL, signed)
    eps = endorsers(net)
    with pytest.raises(jsup.LaunchError, match="ghostcc is not installed/launched"):
        eps["jax"].process_proposal(peer_pb2.SignedProposal.FromString(raw))
    with pytest.raises(tsup.LaunchError, match="ghostcc is not installed/launched"):
        eps["port"].process_proposal(wire.decode(fabric.SIGNED_PROPOSAL, raw))


def test_off_curve_creator_key(net):
    """Pinned: a creator certificate whose key is not on P-256. Both answer
    500 without an endorsement. The JAX MSP fails in `cryptography`'s key
    load (a ValueError, whose text is cryptography's); the port's MSP
    refuses the identity (MSPError), so its message is "access denied: ..."."""
    jcert = jid.x509.load_pem_x509_certificate(net["orgs"][0].users[0].cert_pem)
    der = bytearray(jcert.public_bytes(jid.serialization.Encoding.DER))
    der[der.index(bytes.fromhex("03420004")) + 40] ^= 1  # inside the key's BIT STRING
    creator = tpu.serialize_identity("Org1MSP", tx509.pem_encode("CERTIFICATE", bytes(der)))
    _, signed = signed_proposal(net, [b"get", b"a"], change=lambda h, p: _retx(h, creator))
    raw = wire.encode(fabric.SIGNED_PROPOSAL, signed)
    eps = endorsers(net)
    jresp = eps["jax"].process_proposal(peer_pb2.SignedProposal.FromString(raw))
    tresp = eps["port"].process_proposal(wire.decode(fabric.SIGNED_PROPOSAL, raw))
    assert jresp.response.status == tresp["response"]["status"] == 500
    assert not jresp.endorsement.signature and "endorsement" not in tresp
    assert not jresp.response.message.startswith("access denied")
    assert tresp["response"]["message"] == (
        "access denied: could not decode PEM certificate: point not on P-256")


# ---------------------------------------------------------------------------
# txbuilder and the slice's wire schemas against protobuf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transient", [None, {}, {"k": b"v"}, {"ab": b"1", "a": b"2", "": b"",
                                                            "b": b"\x00" * 40}])
def test_txbuilder_equals_jax(net, transient):
    """create_proposal, create_signed_proposal, proposal_hash and the
    transient map's bytes against the JAX txbuilder and protobuf."""
    bundle = ttb.create_proposal(net["client"], CHANNEL, "mycc", [b"put", b"k", b"v"], transient)
    ccpp = peer_pb2.ChaincodeProposalPayload()
    ccpp.input = wire.decode(fabric.CHAINCODE_PROPOSAL_PAYLOAD, bundle.cc_proposal_payload_tx)[
        "input"]
    ccpp_tx = ccpp.SerializeToString()
    for k, v in (transient or {}).items():
        ccpp.TransientMap[k] = v
    assert bundle.cc_proposal_payload == ccpp.SerializeToString(deterministic=True)
    assert bundle.cc_proposal_payload_tx == ccpp_tx
    assert wire.decode(fabric.CHAINCODE_PROPOSAL_PAYLOAD, ccpp.SerializeToString()).get(
        "TransientMap", {}) == dict(transient or {})
    jb = _jax_bundle(bundle)
    assert ttb.proposal_hash(bundle) == jtb.proposal_hash(jb)
    signed = ttb.create_signed_proposal(bundle, net["client"])
    jsigned = jtb.create_signed_proposal(jb, JSigner(net["orgs"][0].users[0], SW))
    assert signed["proposal_bytes"] == jsigned.proposal_bytes
    assert SW.verify(_jkey(net["client"]), signed["signature"], SW.hash(signed["proposal_bytes"]))
    # endorse_proposal's payload with a response payload and events
    endorsed = ttb.endorse_proposal(bundle, net["tpeer"], b"results", b"resp", b"events")
    jendorsed = jtb.endorse_proposal(jb, net["jpeer"], b"results", b"resp", b"events")
    assert endorsed["payload"] == jendorsed.payload


def _jkey(signer):
    """The JAX package's key for a port signer's certificate."""
    return JKey(*tx509.load_pem_certificate(signer.node.cert_pem).public_key)


def test_slice_schemas_equal_protobuf():
    """Each new schema writes protobuf's bytes and reads them back."""
    cases = [
        (fabric.SIGNED_PROPOSAL, peer_pb2.SignedProposal,
         {"proposal_bytes": b"p", "signature": b"s"}),
        (fabric.PROPOSAL, peer_pb2.Proposal, {"header": b"h", "payload": b"p", "extension": b"e"}),
        (fabric.CHAINCODE_EVENT, peer_pb2.ChaincodeEvent,
         {"chaincode_id": "cc", "tx_id": "t", "event_name": "n", "payload": b"\x00"}),
        (fabric.LAST_CONFIG, common_pb2.LastConfig, {"index": 2 ** 40 + 3}),
        (fabric.BLOCKCHAIN_INFO, common_pb2.BlockchainInfo,
         {"height": 9, "currentBlockHash": b"c" * 32, "previousBlockHash": b"p" * 32}),
        (fabric.PROCESSED_TRANSACTION, peer_pb2.ProcessedTransaction,
         {"transactionEnvelope": {"payload": b"p", "signature": b"s"}, "validationCode": 11}),
        (fabric.PROCESSED_TRANSACTION, peer_pb2.ProcessedTransaction,
         {"transactionEnvelope": {}}),
        (fabric.CHAINCODE_DEPLOYMENT_SPEC, peer_pb2.ChaincodeDeploymentSpec,
         {"chaincode_spec": {"type": 1, "chaincode_id": {"name": "cc", "version": "1.0"},
                             "input": {"args": [b"init"]}}, "code_package": b"tgz"}),
        (fabric.CHAINCODE_QUERY_RESPONSE, peer_pb2.ChaincodeQueryResponse,
         {"chaincodes": [{"name": "a", "version": "1", "path": "p", "input": "i", "escc": "e",
                          "vscc": "v", "id": b"\x01"}, {"name": "b"}]}),
        (fabric.CHAINCODE_INFO, peer_pb2.ChaincodeInfo, {"name": "a", "version": "2"}),
        (fabric.CHANNEL_QUERY_RESPONSE, peer_pb2.ChannelQueryResponse,
         {"channels": [{"channel_id": "ch"}, {"channel_id": "ch2"}]}),
    ]
    for schema, cls, msg in cases:
        raw = wire.encode(schema, msg)
        pb = cls.FromString(raw)
        assert pb.SerializeToString() == raw, cls.__name__
        assert wire.encode(schema, wire.decode(schema, raw)) == raw


# ---------------------------------------------------------------------------
# Identity.verify
# ---------------------------------------------------------------------------


def test_identity_verify_without_provider_raises(net):
    cfg = net["orgs"][0].msp_config()
    msp = tid.MSP(tid.msp_config_from_pems(cfg.msp_id, cfg.root_certs))
    ident = msp.deserialize_identity(net["client"].serialize())
    with pytest.raises(tid.MSPError, match="no provider"):
        ident.verify(b"m", net["client"].sign(b"m"))


def test_identity_verify_on_cuda_provider_is_one_k2_call(net, monkeypatch):
    """`Identity.verify` through `CUDAProvider(device="cpu")`: one call of
    K2's wrapper (its plain version here), one lane; a flipped signature is
    refused by it, a malformed one raises before any call."""
    torch.set_num_threads(1)
    calls = []
    real = p256_kernel.verify_batch_bytes

    def counted(*args, **kw):
        calls.append(int(args[0].shape[0]))
        return real(*args, **kw)

    monkeypatch.setattr(p256_kernel, "verify_batch_bytes", counted)
    cfg = net["orgs"][0].msp_config()
    msp = tid.MSP(tid.msp_config_from_pems(cfg.msp_id, cfg.root_certs),
                  provider=CUDAProvider(device="cpu"))
    ident = msp.deserialize_identity(net["client"].serialize())
    sig = net["client"].sign(b"message")
    ident.verify(b"message", sig)
    assert len(calls) == 1
    with pytest.raises(tid.MSPError, match="The signature is invalid"):
        ident.verify(b"other message", sig)
    assert len(calls) == 2
    with pytest.raises(tid.MSPError, match="could not determine the validity"):
        ident.verify(b"message", b"\x30\x00")
    assert len(calls) == 2
