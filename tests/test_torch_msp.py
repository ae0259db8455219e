"""The port's X.509 reader and writer, MSP and wire schemas against the JAX
package and `cryptography`: certificates and CRLs from the JAX package's
`generate_org` read as `cryptography` reads them; the port's `cryptogen`
material loading in `cryptography` and accepted by the JAX MSP; chain,
expiry, CRL and principal verdicts equal to the JAX MSP's; and the block,
transaction, MSP and policy schemas byte for byte against protobuf, both
ways. Every comparison is exact."""

import datetime
import random

import pytest

pytest.importorskip("cryptography", reason="the reference MSP needs the cryptography package")

from cryptography import x509 as cx509
from cryptography.hazmat.primitives import serialization

from fabric_tpu.crypto.bccsp import SoftwareProvider
from fabric_tpu.msp import cryptogen as jgen
from fabric_tpu.msp import identity as jid
from fabric_tpu.protos import (
    common_pb2,
    identities_pb2,
    msp_principal_pb2,
    peer_pb2,
    policies_pb2,
    protoutil as jpu,
)
from fabric_tpu_torch.common import p256, x509
from fabric_tpu_torch.msp import cryptogen as tgen
from fabric_tpu_torch.msp import identity as tid
from fabric_tpu_torch.protos import fabric, protoutil as tpu, wire

SW = SoftwareProvider()
UTC = datetime.timezone.utc


@pytest.fixture(scope="module")
def jorg():
    org = jgen.generate_org("org1.example.com", "Org1MSP", num_peers=2)
    org.ca.revoke(org.peers[1])
    return org


@pytest.fixture(scope="module")
def torg():
    org = tgen.generate_org("org2.example.com", "Org2MSP", num_peers=2,
                            rng=random.Random(2026))
    org.ca.revoke(org.peers[1])
    return org


def _pems(org):
    return [org.ca.cert_pem, org.admin.cert_pem, *(p.cert_pem for p in org.peers),
            *(u.cert_pem for u in org.users)]


def assert_reads_like_cryptography(pem: bytes):
    c = cx509.load_pem_x509_certificate(pem)
    t = x509.load_pem_certificate(pem)
    assert t.der == c.public_bytes(serialization.Encoding.DER)
    assert t.pem() == c.public_bytes(serialization.Encoding.PEM)
    assert t.tbs == c.tbs_certificate_bytes
    assert t.issuer == c.issuer.public_bytes() and t.subject == c.subject.public_bytes()
    assert t.serial == c.serial_number
    assert t.not_before == c.not_valid_before_utc and t.not_after == c.not_valid_after_utc
    nums = c.public_key().public_numbers()
    assert t.public_key == (nums.x, nums.y)
    assert t.signature == c.signature
    assert t.signature_algorithm == bytes.fromhex("2a8648ce3d040302")
    assert c.signature_algorithm_oid.dotted_string == "1.2.840.10045.4.3.2"
    assert list(t.ou_values) == [a.value for a in c.subject.get_attributes_for_oid(
        cx509.NameOID.ORGANIZATIONAL_UNIT_NAME)]
    return c, t


def test_reader_matches_cryptography_on_jax_material(jorg):
    ca = x509.load_pem_certificate(jorg.ca.cert_pem)
    for pem in _pems(jorg):
        c, t = assert_reads_like_cryptography(pem)
        assert x509.verify_issued_by(t, ca)
    crl = jorg.ca.crl_pem()
    assert x509.load_pem_crl(crl) == [r.serial_number for r in cx509.load_pem_x509_crl(crl)]
    assert x509.load_pem_crl(jgen.generate_org("x.org").ca.crl_pem()) == []


def test_port_material_loads_in_cryptography(torg):
    ca = cx509.load_pem_x509_certificate(torg.ca.cert_pem)
    assert ca.extensions.get_extension_for_class(cx509.BasicConstraints).value.ca
    ku = ca.extensions.get_extension_for_class(cx509.KeyUsage).value
    assert ku.key_cert_sign and ku.crl_sign and ku.digital_signature
    for pem in _pems(torg):
        c, _ = assert_reads_like_cryptography(pem)
        c.verify_directly_issued_by(ca)
    leaf = cx509.load_pem_x509_certificate(torg.peers[0].cert_pem)
    assert leaf.not_valid_after_utc - leaf.not_valid_before_utc == datetime.timedelta(days=366)
    assert ca.not_valid_after_utc - ca.not_valid_before_utc == datetime.timedelta(days=3651)
    crl = cx509.load_pem_x509_crl(torg.ca.crl_pem())
    assert crl.is_signature_valid(ca.public_key())
    assert [r.serial_number for r in crl] == [
        cx509.load_pem_x509_certificate(torg.peers[1].cert_pem).serial_number]
    # the key in the cert is the signer's
    d = torg.peers[0].priv_scalar
    assert x509.load_pem_certificate(torg.peers[0].cert_pem).public_key == p256.scalar_mult(
        d, p256.GENERATOR)


def test_generalized_time_and_point_forms():
    """Validity past 2049 is written and read as GeneralizedTime; the
    reader takes compressed points as cryptography does."""
    rng = random.Random(5)
    ca = tgen.OrgCA("late.org", "LateMSP", rng, now=datetime.datetime(2050, 6, 1, tzinfo=UTC))
    c, t = assert_reads_like_cryptography(ca.cert_pem)
    assert t.not_after.year == 2060 and b"\x18\x0f2060" in t.der
    x, y = t.public_key
    assert x509.decode_point(bytes([2 + (y & 1)]) + x.to_bytes(32, "big")) == (x, y)
    with pytest.raises(x509.X509Error):
        x509.decode_point(b"\x04" + x.to_bytes(32, "big") + ((y + 1) % p256.P).to_bytes(32, "big"))
    with pytest.raises(x509.X509Error):
        x509.Certificate.from_der(t.der + b"\x00")


# ---------------------------------------------------------------------------
# Chain, expiry, CRL and principals against the JAX MSP
# ---------------------------------------------------------------------------


def _intermediate_chain(rng):
    """root -> intermediate -> leaf, built with the port's writer."""
    root = tgen.OrgCA("chain.org", "ChainMSP", rng)
    inter_key, inter_pub = tgen.new_key(rng)
    inter_name = x509.encode_name("ica.chain.org", "chain.org")
    now = datetime.datetime.now(UTC).replace(microsecond=0)
    inter_der = x509.build_certificate(
        7, root.subject, inter_name, now - datetime.timedelta(days=1),
        now + datetime.timedelta(days=30), inter_pub,
        [x509.basic_constraints(True), x509.ca_key_usage()], root._sign)
    _, leaf_pub = tgen.new_key(rng)

    def leaf(ou, serial, sign=None, issuer=inter_name):
        der = x509.build_certificate(
            serial, issuer, x509.encode_name(f"{ou}.chain.org", "chain.org", ou=ou),
            now - datetime.timedelta(days=1), now + datetime.timedelta(days=30), leaf_pub,
            [x509.basic_constraints(False)],
            sign or (lambda tbs: tgen.sign_der(inter_key, p256.sha256(tbs), rng)))
        return x509.pem_encode("CERTIFICATE", der)

    return root, x509.pem_encode("CERTIFICATE", inter_der), leaf


@pytest.fixture(scope="module")
def msp_world(jorg, torg):
    """Both MSP implementations over the same PEMs, and identities whose
    verdicts differ: member, admin, client, peer, revoked, expired, not yet
    valid, another org's, chained through an intermediate, a bad chain
    signature."""
    rng = random.Random(99)
    past = datetime.datetime.now(UTC).replace(microsecond=0) - datetime.timedelta(days=400)
    future = datetime.datetime.now(UTC).replace(microsecond=0) + datetime.timedelta(days=3)
    root, inter_pem, leaf = _intermediate_chain(rng)
    chain_cfg = dict(root_certs=[root.cert_pem], intermediate_certs=[inter_pem],
                     admins=[], revocation_list=[])
    configs = {
        "Org1MSP": dict(root_certs=[jorg.ca.cert_pem], admins=[jorg.admin.cert_pem],
                        revocation_list=[jorg.ca.crl_pem()]),
        "Org2MSP": dict(root_certs=[torg.ca.cert_pem], admins=[torg.admin.cert_pem],
                        revocation_list=[torg.ca.crl_pem()]),
        "ChainMSP": chain_cfg,
    }
    jmsps, tmsps = {}, {}
    for msp_id, cfg in configs.items():
        ous = dict(enable=msp_id != "ChainMSP")
        jmsps[msp_id] = jid.MSP(jid.MSPConfig(msp_id, node_ous=jid.NodeOUs(**ous), **cfg),
                                provider=SW)
        tmsps[msp_id] = tid.MSP(tid.msp_config_from_pems(msp_id, node_ous=tid.NodeOUs(**ous),
                                                         **cfg))
    idents = {
        "j.admin": ("Org1MSP", jorg.admin.cert_pem),
        "j.peer": ("Org1MSP", jorg.peers[0].cert_pem),
        "j.revoked": ("Org1MSP", jorg.peers[1].cert_pem),
        "j.user": ("Org1MSP", jorg.users[0].cert_pem),
        "t.admin": ("Org2MSP", torg.admin.cert_pem),
        "t.peer": ("Org2MSP", torg.peers[0].cert_pem),
        "t.revoked": ("Org2MSP", torg.peers[1].cert_pem),
        "t.user": ("Org2MSP", torg.users[0].cert_pem),
        "t.expired": ("Org2MSP", torg.ca.enroll("old.org2", "peer", now=past).cert_pem),
        "t.not_yet": ("Org2MSP", torg.ca.enroll("new.org2", "client", now=future).cert_pem),
        "t.orderer": ("Org2MSP", torg.ca.enroll("o.org2", "orderer").cert_pem),
        "t.foreign": ("Org2MSP", jorg.peers[0].cert_pem),
        "c.peer": ("ChainMSP", leaf("peer", 11)),
        "c.bad_sig": ("ChainMSP", leaf("peer", 12, sign=lambda tbs: tgen.sign_der(
            5, p256.sha256(tbs), rng))),
        "c.no_issuer": ("ChainMSP", leaf("peer", 13, issuer=x509.encode_name("x", "y"))),
    }
    return jmsps, tmsps, idents


def _verdict(fn):
    try:
        fn()
        return "ok"
    except (jid.MSPError, tid.MSPError) as exc:
        return type(exc).__name__


def test_validate_verdicts_match(msp_world):
    jmsps, tmsps, idents = msp_world
    got, want = {}, {}
    for name, (msp_id, pem) in idents.items():
        sid = jpu.serialize_identity(msp_id, pem)
        assert tpu.serialize_identity(msp_id, pem) == sid
        jm, tm = jmsps[msp_id], tmsps[msp_id]
        ji, ti = jm.deserialize_identity(sid), tm.deserialize_identity(sid)
        assert ti.serialize() == ji.serialize() and ti.fingerprint() == ji.fingerprint()
        assert ti.ou_values == ji.ou_values
        assert (ti.public_key.x, ti.public_key.y) == (ji.public_key.x, ji.public_key.y)
        want[name] = _verdict(lambda: jm.validate(ji))
        got[name] = _verdict(lambda: tm.validate(ti))
        # success is memoized, failure is not
        assert _verdict(lambda: tm.validate(ti)) == got[name]
        assert (ti._validation_err is None) == (got[name] == "ok")
    assert got == want
    assert [k for k, v in got.items() if v != "ok"] == [
        "j.revoked", "t.revoked", "t.expired", "t.not_yet", "t.foreign", "c.bad_sig",
        "c.no_issuer"]


def _principals(msp_ids, idents):
    out = []
    for msp_id in msp_ids:
        for role in range(5):
            r = msp_principal_pb2.MSPRole(msp_identifier=msp_id, role=role)
            out.append(msp_principal_pb2.MSPPrincipal(
                principal_classification=msp_principal_pb2.MSPPrincipal.ROLE,
                principal=r.SerializeToString()))
        for ou in ("peer", "client", "admin", "nope"):
            u = msp_principal_pb2.OrganizationUnit(
                msp_identifier=msp_id, organizational_unit_identifier=ou)
            out.append(msp_principal_pb2.MSPPrincipal(
                principal_classification=msp_principal_pb2.MSPPrincipal.ORGANIZATION_UNIT,
                principal=u.SerializeToString()))
    for msp_id, pem in list(idents.values())[:3]:
        out.append(msp_principal_pb2.MSPPrincipal(
            principal_classification=msp_principal_pb2.MSPPrincipal.IDENTITY,
            principal=jpu.serialize_identity(msp_id, pem)))
    out.append(msp_principal_pb2.MSPPrincipal(principal_classification=3))
    return out


def test_satisfies_principal_matches(msp_world):
    jmsps, tmsps, idents = msp_world
    principals = _principals(["Org1MSP", "Org2MSP", "ChainMSP"], idents)
    mismatches, outcomes = [], set()
    for name, (msp_id, pem) in idents.items():
        sid = jpu.serialize_identity(msp_id, pem)
        jm, tm = jmsps[msp_id], tmsps[msp_id]
        ji, ti = jm.deserialize_identity(sid), tm.deserialize_identity(sid)
        for k, pr in enumerate(principals):
            tpr = wire.decode(fabric.MSP_PRINCIPAL, pr.SerializeToString())
            want = _verdict(lambda: jm.satisfies_principal(ji, pr))
            got = _verdict(lambda: tm.satisfies_principal(ti, tpr))
            outcomes.add(want)
            if got != want:
                mismatches.append((name, k, want, got))
    assert mismatches == []
    assert outcomes == {"ok", "MSPError"}


def test_jax_msp_accepts_port_material(torg):
    """The port's cryptogen certs pass the JAX MSP's chain, CRL and NodeOU
    checks, and the port's MSP gives the same verdicts."""
    cfg = torg.msp_config(with_crl=True)
    jm = jid.MSP(jid.MSPConfig(cfg.msp_id, cfg.root_certs, admins=cfg.admins,
                               revocation_list=cfg.revocation_list,
                               node_ous=jid.NodeOUs(enable=True)), provider=SW)
    tm = torg.msp(with_crl=True)
    role = msp_principal_pb2.MSPRole(msp_identifier="Org2MSP", role=msp_principal_pb2.MSPRole.PEER)
    peer = msp_principal_pb2.MSPPrincipal(principal=role.SerializeToString())
    for node, ok in ((torg.peers[0], "ok"), (torg.peers[1], "MSPError"), (torg.users[0], "ok")):
        sid = jpu.serialize_identity("Org2MSP", node.cert_pem)
        ji = jm.deserialize_identity(sid)
        assert _verdict(lambda: jm.validate(ji)) == ok
        assert _verdict(lambda: tm.validate(tm.deserialize_identity(sid))) == ok
    sid = jpu.serialize_identity("Org2MSP", torg.peers[0].cert_pem)
    jm.satisfies_principal(jm.deserialize_identity(sid), peer)


def test_manager_refusals_match(msp_world):
    jmsps, tmsps, _ = msp_world
    jmgr, tmgr = jid.MSPManager(list(jmsps.values())), tid.MSPManager(list(tmsps.values()))
    for raw in (jpu.serialize_identity("NoMSP", b"x"), jpu.serialize_identity("Org1MSP", b"junk")):
        with pytest.raises(jid.MSPError):
            jmgr.deserialize_identity(raw)
        with pytest.raises(tid.MSPError):
            tmgr.deserialize_identity(raw)
    with pytest.raises(ValueError):
        jmgr.deserialize_identity(b"\x0a\x02\xff\xfe")  # mspid is not UTF-8
    with pytest.raises(ValueError):
        tmgr.deserialize_identity(b"\x0a\x02\xff\xfe")


# ---------------------------------------------------------------------------
# The wire schemas against protobuf, both ways
# ---------------------------------------------------------------------------


def _pb_messages():
    ts = common_pb2.ChannelHeader(type=-3, version=2, channel_id="ch", tx_id="t", epoch=7,
                                  extension=b"e", tls_cert_hash=b"h")
    ts.timestamp.seconds, ts.timestamp.nanos = -5, 9
    block = common_pb2.Block()
    block.header.number = 3
    block.header.previous_hash = b"p"
    block.data.data.extend([b"a", b"", b"c"])
    block.metadata.metadata.extend([b"", b"x", b"\x00\x0a", b"", b""])
    empty_block = common_pb2.Block()
    empty_block.data.SetInParent()
    payload = common_pb2.Payload(data=b"d")
    payload.header.SetInParent()
    cis = peer_pb2.ChaincodeInvocationSpec()
    cis.chaincode_spec.type = 1
    cis.chaincode_spec.chaincode_id.name = "cc"
    cis.chaincode_spec.input.args.extend([b"a", b""])
    cis.chaincode_spec.input.is_init = True
    cis.chaincode_spec.timeout = -1
    act = peer_pb2.ChaincodeAction(results=b"r", events=b"e")
    act.response.status = 200
    act.response.message = "ok"
    act.chaincode_id.SetInParent()
    cap = peer_pb2.ChaincodeActionPayload(chaincode_proposal_payload=b"c")
    cap.action.proposal_response_payload = b"prp"
    cap.action.endorsements.add(endorser=b"e1", signature=b"s1")
    cap.action.endorsements.add()
    pr = peer_pb2.ProposalResponse(version=1, payload=b"p")
    pr.response.status = 200
    pr.endorsement.endorser = b"e"
    tx = peer_pb2.Transaction()
    tx.actions.add(header=b"h", payload=b"p")
    tx.actions.add()
    spe = policies_pb2.SignaturePolicyEnvelope(version=-1)
    spe.rule.n_out_of.n = 2
    spe.rule.n_out_of.rules.add().signed_by = 0
    spe.rule.n_out_of.rules.add().n_out_of.n = 0
    spe.identities.add(principal_classification=2, principal=b"i")
    ap = policies_pb2.ApplicationPolicy(channel_config_policy_reference="")
    ext = peer_pb2.ChaincodeHeaderExtension()
    ext.chaincode_id.name = "cc"
    return [
        (fabric.CHANNEL_HEADER, ts), (fabric.BLOCK, block), (fabric.BLOCK, empty_block),
        (fabric.PAYLOAD, payload), (fabric.ENVELOPE, common_pb2.Envelope(payload=b"p")),
        (fabric.SIGNATURE_HEADER, common_pb2.SignatureHeader(creator=b"c", nonce=b"n")),
        (fabric.CHAINCODE_INVOCATION_SPEC, cis), (fabric.CHAINCODE_ACTION, act),
        (fabric.CHAINCODE_ACTION_PAYLOAD, cap), (fabric.PROPOSAL_RESPONSE, pr),
        (fabric.TRANSACTION, tx), (fabric.CHAINCODE_HEADER_EXTENSION, ext),
        (fabric.CHAINCODE_PROPOSAL_PAYLOAD, peer_pb2.ChaincodeProposalPayload(input=b"i")),
        (fabric.PROPOSAL_RESPONSE_PAYLOAD, peer_pb2.ProposalResponsePayload(proposal_hash=b"h")),
        (fabric.SERIALIZED_IDENTITY, identities_pb2.SerializedIdentity(mspid="M", id_bytes=b"x")),
        (fabric.MSP_ROLE, msp_principal_pb2.MSPRole(msp_identifier="M", role=4)),
        (fabric.ORGANIZATION_UNIT_MSG, msp_principal_pb2.OrganizationUnit(
            msp_identifier="M", organizational_unit_identifier="ou", certifiers_identifier=b"c")),
        (fabric.SIGNATURE_POLICY_ENVELOPE, spe), (fabric.APPLICATION_POLICY, ap),
    ]


@pytest.mark.parametrize("case", range(19))
def test_schemas_match_protobuf_both_ways(case):
    schema, msg = _pb_messages()[case]
    raw = msg.SerializeToString()
    decoded = wire.decode(schema, raw)
    assert wire.encode(schema, decoded) == raw
    back = type(msg)()
    back.ParseFromString(wire.encode(schema, decoded))
    assert back == msg


def test_oneof_scalar_members_replace_each_other():
    """signed_by = 0 is present and written; the last oneof member wins."""
    assert wire.encode(fabric.SIGNATURE_POLICY, {"signed_by": 0}) == b"\x08\x00"
    raw = b"\x12\x02\x08\x02\x08\x03"  # n_out_of then signed_by
    msg = policies_pb2.SignaturePolicy()
    msg.ParseFromString(raw)
    assert msg.WhichOneof("Type") == "signed_by"
    assert wire.decode(fabric.SIGNATURE_POLICY, raw) == {"signed_by": 3}
    raw = b"\x08\x03\x12\x02\x08\x02\x12\x02\x10\x00"
    msg.ParseFromString(raw)
    assert wire.decode(fabric.SIGNATURE_POLICY, raw) == {"n_out_of": {"n": 2}}
    assert msg.WhichOneof("Type") == "n_out_of" and msg.n_out_of.n == 2


def test_base_mult_matches_scalar_mult():
    """The signer's fixed-base multiply equals the oracle's double-and-add."""
    rng = random.Random(8)
    for k in [0, 1, 2, 3, p256.N - 1, p256.N, p256.N + 1, 2**255, 2**256 - 1] + [
            rng.randrange(p256.N) for _ in range(64)]:
        assert p256.base_mult(k) == p256.scalar_mult(k, p256.GENERATOR)
