"""The port's Idemix messages, issuance and batch verification against the
JAX package.

(a) The wire schemas of `protos/idemix.py` against `idemix_pb2`: one seeded
message of each type, bytes equal both ways, negative int32 and int64
fields included. (b) The port's issuance with `random.Random(seed)`
reproduces the JAX package's issuer key, credential request, credential and
signatures byte for byte, `IssuerPublicKey.hash` included (an unsigned
ALG_NO_REVOCATION CRI on both sides, as bench.py's config #3 uses). (c)
`verify_signatures_batch(device="cpu")`, whose default route runs the plain
versions of K4 and K3, gives the JAX package's `scheme` and `hostbn` masks
lane by lane on the vectors of `tests/test_idemix_batch.py` plus a doubled
ABar, an identity ABar, an identity A' and a wrong count of s-values; so
do the port's `scheme` and `hostbn` routes. Five signatures are issued, once
per module on each side.
"""

import copy
import random

import pytest
import torch

from fabric_tpu import idemix as jidemix
from fabric_tpu.common import fp256bn as jbn
from fabric_tpu.idemix.batch import verify_signatures_batch as jax_batch
from fabric_tpu.protos import idemix_pb2
from fabric_tpu_torch import idemix
from fabric_tpu_torch.common import fp256bn as bn
from fabric_tpu_torch.idemix.batch import verify_signatures_batch
from fabric_tpu_torch.protos import idemix as pb
from torch_untraced import untraced  # noqa: F401

ATTR_NAMES = ["OU", "Role", "EnrollmentID", "RevocationHandle"]
ATTR_VALUES = [11, 22, 33, 44]
RH_INDEX = 3
SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small tensor ops; one intra-op thread
    keeps them from contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# (a) wire schemas
# ---------------------------------------------------------------------------

MESSAGES = {
    "ECP": (pb.ECP, idemix_pb2.ECP),
    "ECP2": (pb.ECP2, idemix_pb2.ECP2),
    "IssuerPublicKey": (pb.ISSUER_PUBLIC_KEY, idemix_pb2.IssuerPublicKey),
    "IssuerKey": (pb.ISSUER_KEY, idemix_pb2.IssuerKey),
    "Credential": (pb.CREDENTIAL, idemix_pb2.Credential),
    "CredRequest": (pb.CRED_REQUEST, idemix_pb2.CredRequest),
    "Signature": (pb.SIGNATURE, idemix_pb2.Signature),
    "NonRevocationProof": (pb.NON_REVOCATION_PROOF, idemix_pb2.NonRevocationProof),
    "NymSignature": (pb.NYM_SIGNATURE, idemix_pb2.NymSignature),
    "CredentialRevocationInformation": (
        pb.CREDENTIAL_REVOCATION_INFORMATION, idemix_pb2.CredentialRevocationInformation),
}


def _sample(schema, rng):
    """A message with every field set to a seeded non-default value;
    integers negative half the time."""
    out = {}
    for field in schema.values():
        def one():
            if field.kind == "message":
                return _sample(field.message, rng)
            if field.kind == "bytes":
                return rng.randbytes(rng.choice([1, 32, 65, 200]))
            if field.kind == "string":
                return "attr-%d-é" % rng.randrange(1000)
            bits = 63 if field.kind == "int64" else 31
            v = rng.randrange(1, 1 << bits)
            return -v if rng.random() < 0.5 else v
        out[field.name] = [one() for _ in range(2)] if field.repeated else one()
    return out


def _fill(msg, schema, d):
    """The dict's fields set on a protobuf message."""
    for field in schema.values():
        if field.name not in d:
            continue
        v = d[field.name]
        target = getattr(msg, field.name)
        if field.kind == "message" and field.repeated:
            for item in v:
                _fill(target.add(), field.message, item)
        elif field.kind == "message":
            target.SetInParent()
            _fill(target, field.message, v)
        elif field.repeated:
            target.extend(v)
        else:
            setattr(msg, field.name, v)


@pytest.mark.parametrize("name", list(MESSAGES))
def test_schema_bytes_equal_protobuf(name):
    schema, cls = MESSAGES[name]
    d = _sample(schema, random.Random(name))
    msg = cls()
    _fill(msg, schema, d)
    raw = msg.SerializeToString()
    assert pb.encode(schema, d) == raw
    assert pb.decode(schema, raw) == d
    assert cls.FromString(pb.encode(schema, d)) == msg


@pytest.mark.parametrize("epoch,alg", [(-1, -5), (-(1 << 63), -(1 << 31)), ((1 << 63) - 1, 7)])
def test_negative_ints_encode_as_protobuf(epoch, alg):
    sig = idemix_pb2.Signature()
    sig.epoch = epoch
    sig.non_revocation_proof.revocation_alg = alg
    d = {"epoch": epoch, "non_revocation_proof": {"revocation_alg": alg}}
    assert pb.encode(pb.SIGNATURE, d) == sig.SerializeToString()
    assert pb.decode(pb.SIGNATURE, sig.SerializeToString()) == d
    cri = idemix_pb2.CredentialRevocationInformation(epoch=epoch, revocation_alg=alg)
    d = {"epoch": epoch, "revocation_alg": alg}
    assert pb.encode(pb.CREDENTIAL_REVOCATION_INFORMATION, d) == cri.SerializeToString()
    # an int32 read from a 64-bit varint keeps its low 32 bits, as upb does
    wide = pb.encode(pb.SIGNATURE, {"epoch": (1 << 40) + alg})
    as_int32 = pb.decode(pb.NON_REVOCATION_PROOF, b"\x08" + wide[2:])
    assert as_int32 == {"revocation_alg": idemix_pb2.NonRevocationProof.FromString(
        b"\x08" + wide[2:]).revocation_alg}


# ---------------------------------------------------------------------------
# (b) issuance, byte for byte
# ---------------------------------------------------------------------------

# (disclosure, message) of the issued signatures, test_idemix_batch's order
ISSUED = [([0, 0, 0, 0], b"m0"), ([0, 1, 0, 0], b"m1"), ([0, 0, 0, 0], b"m2"),
          ([0, 0, 0, 0], b"m3"), ([0, 1, 0, 0], b"m4")]


def _issue(pkg, curve, cri):
    rng = random.Random(SEED)
    ik = pkg.new_issuer_key(ATTR_NAMES, rng)
    ipk = ik["ipk"] if isinstance(ik, dict) else ik.ipk
    sk = curve.rand_mod_order(rng)
    nonce = curve.big_to_bytes(curve.rand_mod_order(rng))
    req = pkg.new_cred_request(sk, nonce, ipk, rng)
    cred = pkg.new_credential(ik, req, ATTR_VALUES, rng)
    sigs = []
    for disclosure, msg in ISSUED:
        nym, r_nym = pkg.make_nym(sk, ipk, rng)
        sigs.append(pkg.new_signature(cred, sk, nym, r_nym, ipk, disclosure, msg, RH_INDEX,
                                      cri, rng))
    return {"ik": ik, "ipk": ipk, "req": req, "cred": cred, "sigs": sigs}


@pytest.fixture(scope="module")
def worlds():
    jcri = idemix_pb2.CredentialRevocationInformation()
    jcri.revocation_alg = jidemix.ALG_NO_REVOCATION
    return _issue(jidemix, jbn, jcri), _issue(idemix, bn, {"revocation_alg": 0})


ISSUANCE_SCHEMAS = {"ik": pb.ISSUER_KEY, "ipk": pb.ISSUER_PUBLIC_KEY, "req": pb.CRED_REQUEST,
                    "cred": pb.CREDENTIAL}


@pytest.mark.parametrize("item", list(ISSUANCE_SCHEMAS))
def test_issuance_bytes_equal_jax(worlds, item):
    jax_world, port = worlds
    schema = ISSUANCE_SCHEMAS[item]
    raw = jax_world[item].SerializeToString()
    assert pb.encode(schema, port[item]) == raw
    assert pb.decode(schema, raw) == port[item]


@pytest.mark.parametrize("index", range(len(ISSUED)))
def test_signature_bytes_equal_jax(worlds, index):
    jax_world, port = worlds
    raw = jax_world["sigs"][index].SerializeToString()
    assert pb.encode(pb.SIGNATURE, port["sigs"][index]) == raw
    assert pb.decode(pb.SIGNATURE, raw) == port["sigs"][index]


def test_issuer_key_hash_and_proof(worlds):
    jax_world, port = worlds
    ipk = copy.deepcopy(port["ipk"])
    want = ipk["hash"]
    assert want == jax_world["ipk"].hash and len(want) == 32
    ipk["hash"] = b"stale"
    idemix.check_issuer_public_key(ipk)
    assert ipk["hash"] == want
    ipk["proof_s"] = bn.big_to_bytes((bn.big_from_bytes(ipk["proof_s"]) + 1) % bn.R)
    with pytest.raises(idemix.IdemixError):
        idemix.check_issuer_public_key(ipk)


# ---------------------------------------------------------------------------
# (c) batch verification masks
# ---------------------------------------------------------------------------

LANES = ["valid", "valid-disclosed", "wrong-message", "proof-s-sk+1", "wrong-disclosed-value",
         "abar-doubled", "abar-identity", "aprime-identity", "wrong-s-value-count"]
EXPECTED = [True, True] + [False] * 7


def _batch(world, pkg):
    """(signatures, disclosures, msgs, values) of the lanes, built from the
    issued signatures in one package's message type."""
    is_pb = pkg is jidemix
    sigs = world["sigs"]

    def clone(sig):
        if is_pb:
            out = idemix_pb2.Signature()
            out.CopyFrom(sig)
            return out
        return copy.deepcopy(sig)

    def setf(sig, name, value):
        if name in ("a_bar", "a_prime"):
            value = pkg.ecp_to_proto(value)
            if is_pb:
                getattr(sig, name).CopyFrom(value)
                return sig
        if is_pb:
            setattr(sig, name, value)
        else:
            sig[name] = value
        return sig

    def get(sig, name):
        return getattr(sig, name) if is_pb else sig[name]

    def a_bar(sig):
        return pkg.ecp_from_proto(get(sig, "a_bar"))

    tampered = setf(clone(sigs[3]), "proof_s_sk", bn.big_to_bytes(
        (bn.big_from_bytes(get(sigs[3], "proof_s_sk")) + 1) % bn.R))
    short = clone(sigs[0])
    if is_pb:
        del short.proof_s_attrs[-1]
    else:
        short["proof_s_attrs"] = short["proof_s_attrs"][:-1]
    lanes = [
        (sigs[0], ISSUED[0][0], b"m0", [None] * 4),
        (sigs[1], ISSUED[1][0], b"m1", [None, ATTR_VALUES[1], None, None]),
        (sigs[2], ISSUED[2][0], b"WRONG", [None] * 4),
        (tampered, ISSUED[3][0], b"m3", [None] * 4),
        (sigs[4], ISSUED[4][0], b"m4", [None, 999, None, None]),
        (setf(clone(sigs[0]), "a_bar", bn.g1_mul(a_bar(sigs[0]), 2)), ISSUED[0][0], b"m0",
         [None] * 4),
        (setf(clone(sigs[0]), "a_bar", None), ISSUED[0][0], b"m0", [None] * 4),
        (setf(clone(sigs[0]), "a_prime", None), ISSUED[0][0], b"m0", [None] * 4),
        (short, ISSUED[0][0], b"m0", [None] * 4),
    ]
    return tuple(list(c) for c in zip(*lanes))


@pytest.fixture(scope="module")
def masks(worlds):
    jax_world, port = worlds
    jsigs, disclosures, msgs, values = _batch(jax_world, jidemix)
    psigs, pdisclosures, pmsgs, pvalues = _batch(port, idemix)
    assert [pb.encode(pb.SIGNATURE, s) for s in psigs] == [s.SerializeToString() for s in jsigs]
    args = (disclosures, port["ipk"], msgs, values, RH_INDEX)
    jargs = (disclosures, jax_world["ipk"], msgs, values, RH_INDEX)
    split = {}
    return {
        "port-device": verify_signatures_batch(psigs, *args, device="cpu", split_ms=split),
        "port-split": split,
        "port-scheme": verify_signatures_batch(psigs, *args, backend="scheme"),
        "port-hostbn": verify_signatures_batch(psigs, *args, backend="hostbn"),
        "jax-scheme": jax_batch(jsigs, *jargs, backend="scheme"),
        "jax-hostbn": jax_batch(jsigs, *jargs, backend="hostbn"),
    }


@pytest.mark.parametrize("lane", LANES)
def test_batch_mask_matches_jax(masks, lane):
    i = LANES.index(lane)
    assert (masks["port-device"][i] == masks["port-scheme"][i] == masks["port-hostbn"][i]
            == masks["jax-scheme"][i] == masks["jax-hostbn"][i] == EXPECTED[i])


def test_device_route_reports_its_split(masks):
    split = masks["port-split"]
    assert sorted(split) == ["challenge", "msm", "msm_kernel", "msm_pack", "msm_unpack",
                             "pairing", "parse"]
    assert all(v >= 0 for v in split.values())
    assert split["msm_pack"] + split["msm_kernel"] + split["msm_unpack"] <= split["msm"]


@pytest.mark.parametrize("backend", ["hostbn", "msm"])
def test_batch_rejects_unknown_backend_and_empty(worlds, backend):
    """The port has the device, hostbn and scheme routes: the JAX
    package's host-pairing "msm" route is not ported and raises; the
    hostbn rung (tests/test_torch_hostbn.py) takes the empty batch."""
    port = worlds[1]
    if backend == "msm":
        with pytest.raises(ValueError):
            verify_signatures_batch([], [], port["ipk"], [], [], RH_INDEX, backend=backend,
                                    device="cpu")
    else:
        assert verify_signatures_batch([], [], port["ipk"], [], [], RH_INDEX,
                                       backend=backend) == []
    assert verify_signatures_batch([], [], port["ipk"], [], [], RH_INDEX, device="cpu") == []


# ---------------------------------------------------------------------------
# (e) an issuer key of 13 attributes: t2's MSM lane has 17 bases
# ---------------------------------------------------------------------------

WIDE_NAMES = [f"attr{i}" for i in range(13)]
WIDE_VALUES = [11 * (i + 1) for i in range(13)]


def _issue_wide(pkg, curve, cri):
    """One signature on b"m" under a 13-attribute key, every attribute
    hidden, from random.Random(1234)."""
    rng = random.Random(1234)
    ik = pkg.new_issuer_key(WIDE_NAMES, rng)
    ipk = ik["ipk"] if isinstance(ik, dict) else ik.ipk
    sk = curve.rand_mod_order(rng)
    nonce = curve.big_to_bytes(curve.rand_mod_order(rng))
    req = pkg.new_cred_request(sk, nonce, ipk, rng)
    cred = pkg.new_credential(ik, req, WIDE_VALUES, rng)
    nym, r_nym = pkg.make_nym(sk, ipk, rng)
    sig = pkg.new_signature(cred, sk, nym, r_nym, ipk, [0] * 13, b"m", RH_INDEX, cri, rng)
    return ipk, sig


def test_thirteen_attribute_key_verifies_as_jax():
    """The port's device route on the CPU runs the 17-base t2 lane as one
    lane of one launch; its verdict equals its own scheme route and the JAX
    package's scheme route on the same issuance."""
    jcri = idemix_pb2.CredentialRevocationInformation()
    jcri.revocation_alg = jidemix.ALG_NO_REVOCATION
    jipk, jsig = _issue_wide(jidemix, jbn, jcri)
    ipk, sig = _issue_wide(idemix, bn, {"revocation_alg": 0})
    assert pb.encode(pb.SIGNATURE, sig) == jsig.SerializeToString()
    args = ([[0] * 13], ipk, [b"m"], [[None] * 13], RH_INDEX)
    split = {}
    assert verify_signatures_batch([sig], *args, device="cpu", split_ms=split) == [True]
    assert split["msm_kernel"] > 0
    assert verify_signatures_batch([sig], *args, backend="scheme") == [True]
    assert jax_batch([jsig], [[0] * 13], jipk, [b"m"], [[None] * 13], RH_INDEX,
                     backend="scheme") == [True]
