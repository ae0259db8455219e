"""The rest of the port's Idemix against the JAX package: nym signatures,
`verify_credential`, weak Boneh-Boyen, the revocation authority's CRI
(`idemix/scheme.py`), the Idemix MSP (`msp/idemix_msp.py`) and idemixgen
(`cli/idemixgen.py`).

(a) Under the same `random.Random`, `new_nym_signature` and `wbb_sign` give
the JAX bytes and points; `verify_credential`, `verify_nym_signature`,
`wbb_verify` and `verify_epoch_pk` decide valid and tampered inputs as the
JAX functions do, with the same messages; a JAX-made CRI verifies in the
port and a port-made one in JAX (the revocation key from one scalar on both
sides: the port's P-384 and `cryptography`'s).

(b) For the same seeds the issuer key, the signer config and the serialized
identity equal the JAX ones in every byte but the CRI's P-384 signature
(`cryptography` draws its nonce from the OS): the identity's bytes are
compared with both sides handed the same CRI. Every `validate`, `verify`
and `satisfies_principal` outcome and message equals the JAX MSP's over
identities of both packages: a MEMBER and an ADMIN, a credential with the
CLIENT role mask (its proof fails in both: the identity discloses MEMBER's
mask), another issuer's identity, a flipped proof byte, a foreign MSP ID,
a bad pseudonym; and principals of every role, OU and classification.

(c) idemixgen directories written by one package are loaded and used by the
other, both ways (`tests/test_cli_network.py:399-437` for the JAX tool), a
signer config issued by each package's tool from the other's ca/, and the
`version` output equal.

A proof is verified on the host once per package and identity: the memo of
the `memo` fixture replays the verdict of `verify_signature` for a proof it
has already checked (both packages' MSPs call it for every `validate`).
"""

import copy
import hashlib
import random

import pytest
from torch_untraced import untraced  # noqa: F401

pytest.importorskip("cryptography", reason="the JAX revocation key is cryptography's")

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ec

from fabric_tpu import idemix as jidemix
from fabric_tpu.cli import idemixgen as jgen
from fabric_tpu.crypto import fp256bn as jbn
from fabric_tpu.msp import idemix_msp as jmsp
from fabric_tpu.protos import idemix_pb2, msp_config_pb2, msp_principal_pb2
from fabric_tpu_torch import idemix
from fabric_tpu_torch.cli import idemixgen as gen
from fabric_tpu_torch.common import fp256bn as bn
from fabric_tpu_torch.common import p384
from fabric_tpu_torch.msp import idemix_msp as msp
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.protos import idemix as ipb

SEED = 15
NAME = "IdemixOrg"
REV_D = random.Random(SEED).randrange(1, p384.N)  # one revocation scalar for both packages


def _jax_rev_key():
    return ec.derive_private_key(REV_D, ec.SECP384R1())


# ---------------------------------------------------------------------------
# (a) the scheme's remainder
# ---------------------------------------------------------------------------


def _credential(pkg, curve, attrs):
    rng = random.Random(SEED)
    ik = pkg.new_issuer_key(["OU", "Role", "EnrollmentId", "RevocationHandle"], rng)
    ipk = ik["ipk"] if isinstance(ik, dict) else ik.ipk
    sk = curve.rand_mod_order(rng)
    req = pkg.new_cred_request(sk, curve.big_to_bytes(curve.rand_mod_order(rng)), ipk, rng)
    return ipk, sk, pkg.new_credential(ik, req, attrs, rng), rng


@pytest.fixture(scope="module")
def creds():
    attrs = [11, 22, 33, 44]
    return _credential(jidemix, jbn, attrs), _credential(idemix, bn, attrs)


def _outcome(fn, *args):
    try:
        fn(*args)
        return "ok"
    except (jidemix.IdemixError, idemix.IdemixError, msp.IdemixMSPError,
            jmsp.IdemixMSPError) as exc:
        return f"{type(exc).__name__}: {exc}"


def test_nym_signatures_equal_jax_and_verify_alike(creds):
    (jipk, jsk, _, _), (ipk, sk, _, _) = creds
    outcomes = []
    for msg in (b"", b"tx payload"):
        jnym, jr = jidemix.make_nym(jsk, jipk, random.Random(msg))
        nym, r = idemix.make_nym(sk, ipk, random.Random(msg))
        assert (nym, r) == (jnym, jr)
        jsig = jidemix.new_nym_signature(jsk, jnym, jr, jipk, msg, random.Random(7))
        sig = idemix.new_nym_signature(sk, nym, r, ipk, msg, random.Random(7))
        assert ipb.encode(ipb.NYM_SIGNATURE, sig) == jsig.SerializeToString()
        other = bn.g1_mul(nym, 3)
        tampered = dict(sig, proof_s_sk=bn.big_to_bytes(bn.big_from_bytes(sig["proof_s_sk"]) + 1))
        jtampered = idemix_pb2.NymSignature.FromString(ipb.encode(ipb.NYM_SIGNATURE, tampered))
        for port_args, jax_args in (((sig, nym, ipk, msg), (jsig, jnym, jipk, msg)),
                                    ((sig, nym, ipk, msg + b"!"), (jsig, jnym, jipk, msg + b"!")),
                                    ((sig, other, ipk, msg), (jsig, other, jipk, msg)),
                                    ((tampered, nym, ipk, msg), (jtampered, jnym, jipk, msg))):
            got = _outcome(idemix.verify_nym_signature, *port_args)
            want = _outcome(jidemix.verify_nym_signature, *jax_args)
            assert got.split(": ", 1)[1:] == want.split(": ", 1)[1:]
            outcomes.append(got)
    assert outcomes[0] == "ok" and outcomes[1].endswith("zero-knowledge proof is invalid")
    assert sum(o == "ok" for o in outcomes) == 2


def test_verify_credential_as_jax(creds):
    (jipk, jsk, jcred, _), (ipk, sk, cred, _) = creds
    assert ipb.encode(ipb.CREDENTIAL, cred) == jcred.SerializeToString()
    tampered = copy.deepcopy(cred)
    tampered["attrs"][1] = bn.big_to_bytes(23)
    jtampered = idemix_pb2.Credential.FromString(ipb.encode(ipb.CREDENTIAL, tampered))
    bad_a = dict(cred, a=idemix.ecp_to_proto(bn.g1_mul(idemix.ecp_from_proto(cred["a"]), 2)))
    jbad_a = idemix_pb2.Credential.FromString(ipb.encode(ipb.CREDENTIAL, bad_a))
    got, want = [], []
    for (c, s), (jc, js) in (((cred, sk), (jcred, jsk)), ((cred, sk + 1), (jcred, jsk + 1)),
                             ((tampered, sk), (jtampered, jsk)), ((bad_a, sk), (jbad_a, jsk))):
        got.append(_outcome(idemix.verify_credential, c, s, ipk))
        want.append(_outcome(jidemix.verify_credential, jc, js, jipk))
    assert [g.split(": ", 1)[-1] for g in got] == [w.split(": ", 1)[-1] for w in want]
    assert got[0] == "ok"
    assert got[1].endswith("does not match the attribute values") and got[2] == got[1]
    assert got[3].endswith("credential is not cryptographically valid")


def test_weak_bb_as_jax():
    jsk, jpk = jidemix.wbb_keygen(random.Random(3))
    sk, pk = idemix.wbb_keygen(random.Random(3))
    assert (sk, pk) == (jsk, jpk)
    m = 0xC0FFEE
    sig = idemix.wbb_sign(sk, m)
    assert sig == jidemix.wbb_sign(jsk, m)
    cases = [(pk, sig, m), (pk, sig, m + 1), (None, sig, m), (pk, None, m)]
    got = [_outcome(idemix.wbb_verify, *c) for c in cases]
    want = [_outcome(jidemix.wbb_verify, *c) for c in cases]
    assert [g.split(": ", 1)[-1] for g in got] == [w.split(": ", 1)[-1] for w in want]
    assert got[0] == "ok" and got[1].endswith("Weak-BB signature is invalid")
    assert got[2].endswith("received nil input")


def _jax_cri_msg(raw: bytes):
    return idemix_pb2.CredentialRevocationInformation.FromString(raw)


@pytest.mark.parametrize("epoch", [0, 7])
def test_cri_verifies_across_packages(epoch):
    key = idemix.generate_long_term_revocation_key(random.Random(epoch))
    jkey = ec.derive_private_key(key.d, ec.SECP384R1())
    cri = idemix.create_cri(key, [5], epoch, idemix.ALG_NO_REVOCATION, random.Random(1))
    jcri = jidemix.create_cri(jkey, [5], epoch, jidemix.ALG_NO_REVOCATION, random.Random(1))
    raw, jraw = ipb.encode(ipb.CREDENTIAL_REVOCATION_INFORMATION, cri), jcri.SerializeToString()
    # equal but for the signature, whose nonce cryptography draws from the OS
    assert dict(cri, epoch_pk_sig=b"") == dict(ipb.decode(
        ipb.CREDENTIAL_REVOCATION_INFORMATION, jraw), epoch_pk_sig=b"")
    pk, jpk = key.public_key(), jkey.public_key()
    flipped = bytes([cri["epoch_pk_sig"][0]]) + bytes([cri["epoch_pk_sig"][1] ^ 4]) + \
        cri["epoch_pk_sig"][2:]
    for made, jmade in ((raw, _jax_cri_msg(raw)), (jraw, jcri)):
        port_view = ipb.decode(ipb.CREDENTIAL_REVOCATION_INFORMATION, made)
        for sig, ep in ((port_view["epoch_pk_sig"], epoch), (flipped, epoch),
                        (port_view["epoch_pk_sig"], epoch + 1), (b"", epoch)):
            got = _outcome(idemix.verify_epoch_pk, pk, port_view["epoch_pk"], sig, ep, 0)
            want = _outcome(jidemix.verify_epoch_pk, jpk, jmade.epoch_pk, sig, ep, 0)
            assert got.split(": ", 1)[-1] == want.split(": ", 1)[-1], (sig.hex(), ep)
    assert _outcome(idemix.verify_epoch_pk, pk, cri["epoch_pk"], cri["epoch_pk_sig"], epoch,
                    0) == "ok"
    with pytest.raises(idemix.IdemixError, match="EpochPKSig invalid"):
        idemix.verify_epoch_pk(pk, cri["epoch_pk"], flipped, epoch, 0)
    with pytest.raises(idemix.IdemixError, match="not supported"):
        idemix.create_cri(key, [5], epoch, 1, random.Random(1))


# ---------------------------------------------------------------------------
# (b) the MSP
# ---------------------------------------------------------------------------


def _jax_signer(raw: bytes):
    out = msp_config_pb2.IdemixMSPSignerConfig()
    out.ParseFromString(raw)
    return out


def _jax_config(name, ipk_raw):
    cfg = msp_config_pb2.IdemixMSPConfig()
    cfg.name = name
    cfg.ipk = ipk_raw
    return cfg


# (label, OU, role mask, enrollment id) of the identities issued by both
IDENTITIES = [("member", "OU1", msp.ROLE_MEMBER, "alice"), ("admin", "OU2", msp.ROLE_ADMIN, "bob"),
              ("client-mask", "OU1", msp.ROLE_CLIENT, "carol")]


@pytest.fixture(scope="module")
def world():
    """Both packages' issuer from one seed, each identity's signer config
    from one seed (the port's CRI on both sides) and its signing identity
    from one seed; a second issuer's identity."""
    jikey, _ = jmsp.generate_issuer(random.Random(SEED))
    ikey, rev_key = msp.generate_issuer(random.Random(SEED))
    ipk_raw = ipb.encode(ipb.ISSUER_PUBLIC_KEY, ikey["ipk"])
    assert ipb.encode(ipb.ISSUER_KEY, ikey) == jikey.SerializeToString()
    assert ipk_raw == jikey.ipk.SerializeToString()
    port_msp = msp.IdemixMSP({"name": NAME, "ipk": ipk_raw}, rev_key.public_key())
    jax_msp = jmsp.IdemixMSP(_jax_config(NAME, ipk_raw))
    out = {"ikey": ikey, "jikey": jikey, "rev_key": rev_key, "port_msp": port_msp,
           "jax_msp": jax_msp, "signers": {}, "idents": {}}
    for k, (label, ou, role, enrollment) in enumerate(IDENTITIES):
        sc = msp.generate_signer_config(ikey, rev_key, ou, role, enrollment, random.Random(k))
        jsc = jmsp.generate_signer_config(jikey, _jax_rev_key(), ou, role, enrollment,
                                          random.Random(k))
        out["signers"][label] = (sc, jsc)
        same = wire.encode(fabric.IDEMIX_MSP_SIGNER_CONFIG, sc)
        ident = msp.IdemixSigningIdentity(port_msp, sc, random.Random(100 + k))
        jident = jmsp.IdemixSigningIdentity(jax_msp, _jax_signer(same), random.Random(100 + k))
        out["idents"][label] = (ident, jident)
    other_ikey, other_rev = msp.generate_issuer(random.Random(SEED + 1))
    other_msp = msp.IdemixMSP({"name": NAME, "ipk": ipb.encode(
        ipb.ISSUER_PUBLIC_KEY, other_ikey["ipk"])})
    other_sc = msp.generate_signer_config(other_ikey, other_rev, "OU1", msp.ROLE_MEMBER, "eve",
                                          random.Random(9))
    out["other"] = msp.IdemixSigningIdentity(other_msp, other_sc, random.Random(9))
    return out


def test_signer_configs_equal_jax_but_the_cri_signature(world):
    for label, (sc, jsc) in world["signers"].items():
        raw = wire.encode(fabric.IDEMIX_MSP_SIGNER_CONFIG, sc)
        theirs = wire.decode(fabric.IDEMIX_MSP_SIGNER_CONFIG, jsc.SerializeToString())
        cri_key = "credential_revocation_information"
        ours_cri = ipb.decode(ipb.CREDENTIAL_REVOCATION_INFORMATION, sc[cri_key])
        their_cri = ipb.decode(ipb.CREDENTIAL_REVOCATION_INFORMATION, theirs[cri_key])
        assert dict(ours_cri, epoch_pk_sig=b"") == dict(their_cri, epoch_pk_sig=b""), label
        assert ours_cri["epoch_pk_sig"] != their_cri["epoch_pk_sig"]
        assert dict(sc, **{cri_key: b""}) == dict(theirs, **{cri_key: b""}), label
        # the same config bytes through protobuf
        assert _jax_signer(raw).SerializeToString() == raw
        # each CRI verifies under its authority's key in the other package
        pk = serialization.load_pem_public_key(world["rev_key"].public_key().public_bytes_pem())
        jidemix.verify_epoch_pk(pk, _jax_cri_msg(sc[cri_key]).epoch_pk, ours_cri["epoch_pk_sig"],
                                0, 0)
        idemix.verify_epoch_pk(p384.ECDSAP384PrivateKey(REV_D).public_key(),
                               their_cri["epoch_pk"], their_cri["epoch_pk_sig"], 0, 0)


def test_serialized_identities_and_signatures_equal_jax(world):
    for label, (ident, jident) in world["idents"].items():
        assert ident.serialize() == jident.serialize(), label
        assert ident.sign(b"hello idemix") == jident.sign(b"hello idemix"), label


def test_msp_config_round_trips_protobuf(world):
    cfg, rev = msp.generate_msp_config("Org9", rng=random.Random(5))
    raw = wire.encode(fabric.IDEMIX_MSP_CONFIG, cfg)
    jcfg = msp_config_pb2.IdemixMSPConfig.FromString(raw)
    assert jcfg.SerializeToString() == raw and jcfg.signer.role == msp.ROLE_MEMBER
    assert wire.decode(fabric.IDEMIX_MSP_CONFIG, raw) == cfg
    assert p384.load_pem_public_key(cfg["revocation_pk"]) == rev.public_key()
    assert serialization.load_pem_public_key(jcfg.revocation_pk) is not None
    inner = {"nym_x": b"\x01" * 32, "nym_y": b"\x02", "ou": b"o", "role": b"r", "proof": b"p"}
    from fabric_tpu.protos import identities_pb2
    assert wire.encode(fabric.SERIALIZED_IDEMIX_IDENTITY, inner) == \
        identities_pb2.SerializedIdemixIdentity(**inner).SerializeToString()


@pytest.fixture
def memo(monkeypatch):
    """`verify_signature` of both packages memoized on the proof's bytes and
    the checked values: a proof is checked on the host once per package."""
    for pkg, encode in ((jidemix, lambda s: s.SerializeToString()),
                        (idemix, lambda s: ipb.encode(ipb.SIGNATURE, s))):
        real, seen = pkg.verify_signature, {}

        def cached(sig, disclosure, ipk, m, values, rh, rev, epoch, real=real, seen=seen,
                   encode=encode):
            key = (encode(sig), tuple(disclosure), m, tuple(values), rh)
            if key not in seen:
                try:
                    real(sig, disclosure, ipk, m, values, rh, rev, epoch)
                    seen[key] = None
                except Exception as exc:  # replayed below
                    seen[key] = exc
            if seen[key] is not None:
                raise seen[key]

        monkeypatch.setattr(pkg, "verify_signature", cached)


def _principal(cls, body: dict, schema) -> dict:
    return {"principal_classification": cls, "principal": wire.encode(schema, body)}


def _role(role, mspid=NAME):
    return _principal(fabric.ROLE, {"msp_identifier": mspid, "role": role}, fabric.MSP_ROLE)


def _ou(ou, mspid=NAME):
    return _principal(fabric.ORGANIZATION_UNIT, {"msp_identifier": mspid,
                                                 "organizational_unit_identifier": ou},
                      fabric.ORGANIZATION_UNIT_MSG)


PRINCIPALS = [_role(fabric.MEMBER), _role(fabric.ADMIN), _role(fabric.CLIENT), _role(fabric.PEER),
              _role(fabric.ORDERER), _role(9), _role(fabric.MEMBER, "OtherMSP"), _ou("OU1"),
              _ou("OU2"), _ou("OU1", "OtherMSP"),
              _principal(fabric.IDENTITY, {"mspid": NAME}, fabric.SERIALIZED_IDENTITY)]


def _jax_principal(p: dict):
    return msp_principal_pb2.MSPPrincipal.FromString(wire.encode(fabric.MSP_PRINCIPAL, p))


def _flip_proof(raw: bytes, field: str = "") -> bytes:
    """The identity with one bit of its proof flipped: in the proof's field
    `field`, or (no field) byte 40 of the proof's bytes, inside a_prime's x."""
    sid = wire.decode(fabric.SERIALIZED_IDENTITY, raw)
    inner = wire.decode(fabric.SERIALIZED_IDEMIX_IDENTITY, sid["id_bytes"])
    if field:
        proof = ipb.decode(ipb.SIGNATURE, inner["proof"])
        proof[field] = bytes([proof[field][0] ^ 1]) + proof[field][1:]
        inner["proof"] = ipb.encode(ipb.SIGNATURE, proof)
    else:
        proof = bytearray(inner["proof"])
        proof[40] ^= 1
        inner["proof"] = bytes(proof)
    return wire.encode(fabric.SERIALIZED_IDENTITY, dict(
        sid, id_bytes=wire.encode(fabric.SERIALIZED_IDEMIX_IDENTITY, inner)))


def _with_inner(raw: bytes, **fields) -> bytes:
    sid = wire.decode(fabric.SERIALIZED_IDENTITY, raw)
    inner = dict(wire.decode(fabric.SERIALIZED_IDEMIX_IDENTITY, sid["id_bytes"]), **fields)
    return wire.encode(fabric.SERIALIZED_IDENTITY, dict(
        sid, id_bytes=wire.encode(fabric.SERIALIZED_IDEMIX_IDENTITY, inner)))


def test_msp_outcomes_and_messages_equal_jax(world, memo):
    pm, jm = world["port_msp"], world["jax_msp"]
    member = world["idents"]["member"][0].serialize()
    cases = {label: pair[0].serialize() for label, pair in world["idents"].items()}
    cases["jax-made-admin"] = world["idents"]["admin"][1].serialize()
    cases["other-issuer"] = world["other"].serialize()
    cases["flipped-proof"] = _flip_proof(member, "proof_c")
    cases["a-prime-off-curve"] = _flip_proof(member)
    cases["foreign-mspid"] = wire.encode(fabric.SERIALIZED_IDENTITY, dict(
        wire.decode(fabric.SERIALIZED_IDENTITY, member), mspid="OtherMSP"))
    cases["empty-nym"] = _with_inner(member, nym_x=b"")
    cases["nym-off-curve"] = _with_inner(member, nym_y=bn.big_to_bytes(5))
    table = {}
    for label, raw in cases.items():
        row = []
        try:
            ident = pm.deserialize_identity(raw)
            port_des = "ok"
        except msp.IdemixMSPError as exc:
            ident, port_des = None, f"error: {exc}"
        try:
            jident = jm.deserialize_identity(raw)
            jax_des = "ok"
        except jmsp.IdemixMSPError as exc:
            jident, jax_des = None, f"error: {exc}"
        assert port_des == jax_des, label
        row.append(port_des)
        if ident is None:
            table[label] = row
            continue
        assert ident.role_mask == jident.role_mask
        got = _outcome(pm.validate, ident)
        assert got.split(": ", 1)[-1] == _outcome(jm.validate, jident).split(": ", 1)[-1], label
        row.append(got)
        msg = b"a proposal"
        sig = world["idents"]["member"][0].sign(msg)
        for m in (msg, b"another"):
            got = _outcome(pm.verify, ident, m, sig)
            assert got.split(": ", 1)[-1] == _outcome(jm.verify, jident, m, sig).split(": ", 1)[-1]
            row.append(got)
        for p in PRINCIPALS:
            got = _outcome(pm.satisfies_principal, ident, p)
            want = _outcome(jm.satisfies_principal, jident, _jax_principal(p))
            assert got.split(": ", 1)[-1] == want.split(": ", 1)[-1], (label, p)
            row.append(got)
        table[label] = row
    ok = lambda label: table[label][1] == "ok"  # noqa: E731
    assert ok("member") and ok("admin") and ok("jax-made-admin")
    for label in ("client-mask", "flipped-proof"):
        assert table[label][1].endswith("identity proof invalid: signature invalid: "
                                        "zero-knowledge proof is invalid"), label
    assert table["other-issuer"][1].endswith("APrime and ABar don't have the expected structure")
    assert table["a-prime-off-curve"][1].endswith("identity proof invalid: G1 point not on curve")
    assert table["foreign-mspid"] == [f"error: expected MSP ID {NAME}, received OtherMSP"]
    assert table["empty-nym"] == ["error: pseudonym is invalid"]
    assert table["nym-off-curve"] == ["error: pseudonym is not on the curve"]
    member_row, admin_row = table["member"], table["admin"]
    assert member_row[2] == "ok" and member_row[3].endswith("zero-knowledge proof is invalid")
    # MEMBER, ADMIN, CLIENT, PEER, ORDERER, 9, other MSP, OU1, OU2, OU1@other, IDENTITY
    assert [r == "ok" for r in member_row[4:]] == [True, False, False, False, False, False, False,
                                                   True, False, False, False]
    assert [r == "ok" for r in admin_row[4:]] == [True, True, False, False, False, False, False,
                                                  False, True, False, False]
    assert admin_row[4 + 4].endswith("invalid MSP role type 4")
    assert member_row[-1].endswith("invalid principal type 2")


def test_identity_of_the_wrong_msp_object_is_refused(world, memo):
    ident = world["port_msp"].deserialize_identity(world["idents"]["member"][0].serialize())
    ident.msp_id = "OtherMSP"
    with pytest.raises(msp.IdemixMSPError, match="does not belong to this msp"):
        world["port_msp"].validate(ident)


def test_issuer_key_with_other_attributes_is_refused():
    ik = idemix.new_issuer_key(["OU", "Role", "EnrollmentID", "RevocationHandle"],
                               random.Random(1))
    cfg = {"name": NAME, "ipk": ipb.encode(ipb.ISSUER_PUBLIC_KEY, ik["ipk"])}
    with pytest.raises(msp.IdemixMSPError, match="must have attributes OU, Role"):
        msp.IdemixMSP(cfg)
    with pytest.raises(jmsp.IdemixMSPError, match="must have attributes OU, Role"):
        jmsp.IdemixMSP(_jax_config(NAME, cfg["ipk"]))


# ---------------------------------------------------------------------------
# (c) idemixgen both ways
# ---------------------------------------------------------------------------


def _use_with_port(out_dir, signer_raw: bytes):
    cfg = {"name": NAME, "ipk": (out_dir / "msp" / "IssuerPublicKey").read_bytes(),
           "revocation_pk": (out_dir / "msp" / "RevocationPublicKey").read_bytes()}
    rev_pk = p384.load_pem_public_key(cfg["revocation_pk"])
    port_msp = msp.IdemixMSP(cfg, rev_pk)
    sc = wire.decode(fabric.IDEMIX_MSP_SIGNER_CONFIG, signer_raw)
    ident = msp.IdemixSigningIdentity(port_msp, sc, random.Random(1))
    sig = ident.sign(b"hello idemix")
    parsed = port_msp.deserialize_identity(ident.serialize())
    port_msp.validate(parsed)
    port_msp.verify(parsed, b"hello idemix", sig)
    cri = ipb.decode(ipb.CREDENTIAL_REVOCATION_INFORMATION,
                     sc["credential_revocation_information"])
    idemix.verify_epoch_pk(rev_pk, cri["epoch_pk"], cri["epoch_pk_sig"], 0, 0)
    return parsed


def _use_with_jax(out_dir, signer_raw: bytes):
    cfg = _jax_config(NAME, (out_dir / "msp" / "IssuerPublicKey").read_bytes())
    cfg.revocation_pk = (out_dir / "msp" / "RevocationPublicKey").read_bytes()
    signer_cfg = _jax_signer(signer_raw)
    cfg.signer.CopyFrom(signer_cfg)
    jax_msp = jmsp.IdemixMSP(cfg)
    ident = jmsp.IdemixSigningIdentity(jax_msp, signer_cfg, random.Random(1))
    sig = ident.sign(b"hello idemix")
    parsed = jax_msp.deserialize_identity(ident.serialize())
    jax_msp.validate(parsed)
    jax_msp.verify(parsed, b"hello idemix", sig)
    cri = _jax_cri_msg(signer_cfg.credential_revocation_information)
    jidemix.verify_epoch_pk(serialization.load_pem_public_key(cfg.revocation_pk), cri.epoch_pk,
                            cri.epoch_pk_sig, cri.epoch, cri.revocation_alg)
    serialization.load_pem_private_key((out_dir / "ca" / "RevocationKey").read_bytes(), None)
    return parsed


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_idemixgen_directories_used_by_the_other_package(tmp_path, capsys, writer):
    tool, other = (gen, jgen) if writer == "port" else (jgen, gen)
    out_dir = tmp_path / "idemix"
    assert tool.main(["ca-keygen", "--output", str(out_dir)]) == 0
    for name in ("ca/IssuerSecretKey", "ca/RevocationKey", "msp/IssuerPublicKey",
                 "msp/RevocationPublicKey"):
        assert (out_dir / name).exists(), name
    assert tool.main(["signerconfig", "--output", str(out_dir), "-u", "org9", "-e", "alice",
                      "--admin"]) == 0
    signer_raw = (out_dir / "user" / "SignerConfig").read_bytes()
    port_ident = _use_with_port(out_dir, signer_raw)
    jax_ident = _use_with_jax(out_dir, signer_raw)
    assert port_ident.ou_identifier == jax_ident.ou.organizational_unit_identifier == "org9"
    assert port_ident.role_mask == jax_ident.role_mask == msp.ROLE_ADMIN
    # the other package's tool issues a signer from this ca/
    assert other.main(["signerconfig", "--output", str(out_dir), "-u", "org7", "-e",
                       "bob"]) == 0
    signer_raw = (out_dir / "user" / "SignerConfig").read_bytes()
    assert _use_with_port(out_dir, signer_raw).role_mask == msp.ROLE_MEMBER
    assert _use_with_jax(out_dir, signer_raw).role.role == msp_principal_pb2.MSPRole.MEMBER
    capsys.readouterr()


def test_signerconfig_without_ca_and_version(tmp_path, capsys):
    with pytest.raises(SystemExit, match="run ca-keygen first"):
        gen.main(["signerconfig", "--output", str(tmp_path / "none")])
    assert gen.main(["version"]) == 0
    ours = capsys.readouterr().out
    assert jgen.main(["version"]) == 0
    assert ours == capsys.readouterr().out
    assert ours.startswith("idemixgen:\n Version: ")


def test_seeded_tool_material_is_reproducible(tmp_path, capsys):
    for k in (1, 2):
        gen.ca_keygen(str(tmp_path / str(k)), random.Random(4))
        gen.signerconfig(str(tmp_path / str(k)), "OU3", "dave", False, random.Random(5))
    for name in ("ca/IssuerSecretKey", "ca/RevocationKey", "msp/IssuerPublicKey",
                 "msp/RevocationPublicKey", "user/SignerConfig"):
        assert (tmp_path / "1" / name).read_bytes() == (tmp_path / "2" / name).read_bytes()
    assert hashlib.sha256((tmp_path / "1" / "ca/IssuerSecretKey").read_bytes()).digest() == \
        hashlib.sha256(jmsp.generate_issuer(random.Random(4))[0].SerializeToString()).digest()
    capsys.readouterr()
