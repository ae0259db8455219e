"""Idemix credential scheme on FP256BN (reference idemix/*.go), over the
port's dict messages.

The port's copy of the JAX package's `idemix/scheme.py`: issuer keys and
their proof (issuerkey.go), credential requests (credrequest.go),
credential issuance and verification, a BBS+ signature (credential.go),
pseudonyms (util.go MakeNym), the signature of knowledge over a credential
(signature.go NewSignature / Ver), pseudonym signatures (nymsignature.go),
weak Boneh-Boyen signatures (weak-bb.go) and the revocation authority's
long-term ECDSA P-384 key and CRI (revocation_authority.go), with the same
Fiat-Shamir transcripts. Given the same `random.Random` state it issues the
same keys, credentials and signatures, byte for byte.

A message is a dict in the form of `protos/wire.py` (schemas in
`protos/idemix.py`): a field that is absent reads as protobuf's default.

Only ALG_NO_REVOCATION exists, as in the reference. The revocation key is
the port's own P-384 (`common/p384.py`; the card's machine has no
`cryptography`), and its ECDSA nonce comes from the caller's generator
where the JAX package's comes from the OS, so a CRI's signature differs
between the packages while each verifies under the other.
"""

from __future__ import annotations

import copy
import functools
import hashlib
from typing import List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fp256bn as bn
from fabric_tpu_torch.common import p384
from fabric_tpu_torch.protos import idemix as pb

SIGN_LABEL = b"sign"
CRED_REQUEST_LABEL = b"credRequest"

ALG_NO_REVOCATION = 0


class IdemixError(Exception):
    pass


# --------------------------------------------------------------------------
# proto converters (util.go EcpToProto & co.)
# --------------------------------------------------------------------------


def ecp_to_proto(pt: bn.G1Point) -> dict:
    return {"x": bn.big_to_bytes(pt[0] if pt else 0), "y": bn.big_to_bytes(pt[1] if pt else 0)}


def ecp_from_proto(msg: Optional[dict]) -> bn.G1Point:
    msg = msg or {}
    pt = (bn.big_from_bytes(msg.get("x", b"")), bn.big_from_bytes(msg.get("y", b"")))
    if pt == (0, 0):
        return None
    if not bn.g1_is_on_curve(pt):
        raise IdemixError("G1 point not on curve")
    return pt


def ecp2_to_proto(pt: bn.G2Point) -> dict:
    (xa, xb), (ya, yb) = pt if pt else ((0, 0), (0, 0))
    return {
        "xa": bn.big_to_bytes(xa),
        "xb": bn.big_to_bytes(xb),
        "ya": bn.big_to_bytes(ya),
        "yb": bn.big_to_bytes(yb),
    }


def ecp2_from_proto(msg: Optional[dict]) -> bn.G2Point:
    msg = msg or {}
    big = [bn.big_from_bytes(msg.get(k, b"")) for k in ("xa", "xb", "ya", "yb")]
    pt = ((big[0], big[1]), (big[2], big[3]))
    if pt == ((0, 0), (0, 0)):
        return None
    if not bn.g2_is_on_curve(pt):
        raise IdemixError("G2 point not on twist")
    return pt


def _append_g1(buf: bytearray, pt: bn.G1Point) -> None:
    buf += bn.g1_to_bytes(pt)


def _append_g2(buf: bytearray, pt: bn.G2Point) -> None:
    buf += bn.g2_to_bytes(pt)


def _append_big(buf: bytearray, v: int) -> None:
    buf += bn.big_to_bytes(v)


def _hidden_indices(disclosure: Sequence[int]) -> List[int]:
    return [i for i, d in enumerate(disclosure) if d == 0]


def _mod(a: int) -> int:
    return a % bn.R


def _big(msg: dict, name: str) -> int:
    return bn.big_from_bytes(msg.get(name, b""))


def ipk_hash(ipk: dict) -> bytes:
    """The key's `hash` field: HashModOrder of the key serialized without
    it (SetHash)."""
    bare = {k: v for k, v in ipk.items() if k != "hash"}
    return bn.big_to_bytes(bn.hash_mod_order(pb.encode(pb.ISSUER_PUBLIC_KEY, bare)))


# --------------------------------------------------------------------------
# Issuer key (issuerkey.go)
# --------------------------------------------------------------------------


def new_issuer_key(attribute_names: Sequence[str], rng) -> dict:
    if len(set(attribute_names)) != len(attribute_names):
        raise IdemixError("attribute list contains duplicates")

    isk = bn.rand_mod_order(rng)
    ipk: dict = {"attribute_names": list(attribute_names)}
    w = bn.g2_mul(bn.G2_GEN, isk)
    ipk["w"] = ecp2_to_proto(w)
    ipk["h_attrs"] = [
        ecp_to_proto(bn.g1_mul(bn.G1_GEN, bn.rand_mod_order(rng))) for _ in attribute_names
    ]
    ipk["h_sk"] = ecp_to_proto(bn.g1_mul(bn.G1_GEN, bn.rand_mod_order(rng)))
    ipk["h_rand"] = ecp_to_proto(bn.g1_mul(bn.G1_GEN, bn.rand_mod_order(rng)))
    bar_g1 = bn.g1_mul(bn.G1_GEN, bn.rand_mod_order(rng))
    ipk["bar_g1"] = ecp_to_proto(bar_g1)
    bar_g2 = bn.g1_mul(bar_g1, isk)
    ipk["bar_g2"] = ecp_to_proto(bar_g2)

    # ZK PoK of isk in W and BarG2 (issuerkey.go:76-100)
    r = bn.rand_mod_order(rng)
    t1 = bn.g2_mul(bn.G2_GEN, r)
    t2 = bn.g1_mul(bar_g1, r)
    buf = bytearray()
    _append_g2(buf, t1)
    _append_g1(buf, t2)
    _append_g2(buf, bn.G2_GEN)
    _append_g1(buf, bar_g1)
    _append_g2(buf, w)
    _append_g1(buf, bar_g2)
    proof_c = bn.hash_mod_order(bytes(buf))
    ipk["proof_c"] = bn.big_to_bytes(proof_c)
    ipk["proof_s"] = bn.big_to_bytes(_mod(proof_c * isk + r))
    ipk["hash"] = ipk_hash(ipk)
    return {"isk": bn.big_to_bytes(isk), "ipk": ipk}


def check_issuer_public_key(ipk: dict) -> None:
    """IssuerPublicKey.Check: well-formedness and the proof; recomputes the
    embedded hash (SetHash)."""
    if len(ipk.get("h_attrs", [])) < len(ipk.get("attribute_names", [])):
        raise IdemixError("some part of the public key is undefined")
    h_sk = ecp_from_proto(ipk.get("h_sk"))
    h_rand = ecp_from_proto(ipk.get("h_rand"))
    bar_g1 = ecp_from_proto(ipk.get("bar_g1"))
    bar_g2 = ecp_from_proto(ipk.get("bar_g2"))
    w = ecp2_from_proto(ipk.get("w"))
    if h_sk is None or h_rand is None or bar_g1 is None:
        raise IdemixError("some part of the public key is undefined")
    proof_c = _big(ipk, "proof_c")
    proof_s = _big(ipk, "proof_s")

    neg_c = _mod(-proof_c)
    t1 = bn.g2_add(bn.g2_mul(bn.G2_GEN, proof_s), bn.g2_mul(w, neg_c))
    t2 = bn.g1_add(bn.g1_mul(bar_g1, proof_s), bn.g1_mul(bar_g2, neg_c))
    buf = bytearray()
    _append_g2(buf, t1)
    _append_g1(buf, t2)
    _append_g2(buf, bn.G2_GEN)
    _append_g1(buf, bar_g1)
    _append_g2(buf, w)
    _append_g1(buf, bar_g2)
    if proof_c != bn.hash_mod_order(bytes(buf)):
        raise IdemixError("zero knowledge proof in public key invalid")
    ipk["hash"] = ipk_hash(ipk)


# --------------------------------------------------------------------------
# Credential request (credrequest.go)
# --------------------------------------------------------------------------


def _cred_request_challenge(t, h_sk, nym, issuer_nonce: bytes, ipk: dict) -> int:
    buf = bytearray()
    buf += CRED_REQUEST_LABEL
    _append_g1(buf, t)
    _append_g1(buf, h_sk)
    _append_g1(buf, nym)
    buf += issuer_nonce
    buf += ipk.get("hash", b"")
    return bn.hash_mod_order(bytes(buf))


def new_cred_request(sk: int, issuer_nonce: bytes, ipk: dict, rng) -> dict:
    h_sk = ecp_from_proto(ipk.get("h_sk"))
    nym = bn.g1_mul(h_sk, sk)
    r_sk = bn.rand_mod_order(rng)
    t = bn.g1_mul(h_sk, r_sk)
    proof_c = _cred_request_challenge(t, h_sk, nym, issuer_nonce, ipk)
    return {
        "nym": ecp_to_proto(nym),
        "issuer_nonce": issuer_nonce,
        "proof_c": bn.big_to_bytes(proof_c),
        "proof_s": bn.big_to_bytes(_mod(proof_c * sk + r_sk)),
    }


def verify_cred_request(req: dict, ipk: dict) -> None:
    nym = ecp_from_proto(req.get("nym"))
    proof_c = _big(req, "proof_c")
    proof_s = _big(req, "proof_s")
    h_sk = ecp_from_proto(ipk.get("h_sk"))
    t = bn.g1_add(bn.g1_mul(h_sk, proof_s), bn.g1_neg(bn.g1_mul(nym, proof_c)))
    if proof_c != _cred_request_challenge(t, h_sk, nym, req.get("issuer_nonce", b""), ipk):
        raise IdemixError("zero knowledge proof is invalid")


# --------------------------------------------------------------------------
# Credential = BBS+ signature (credential.go)
# --------------------------------------------------------------------------


def _attr_bases_product(ipk: dict, indices: Sequence[int], scalars: Sequence[int]) -> bn.G1Point:
    """prod_i HAttrs[indices[i]]^scalars[i]."""
    acc: bn.G1Point = None
    for idx, s in zip(indices, scalars):
        acc = bn.g1_add(acc, bn.g1_mul(ecp_from_proto(ipk["h_attrs"][idx]), s))
    return acc


def new_credential(key: dict, req: dict, attrs: Sequence[int], rng) -> dict:
    ipk = key["ipk"]
    verify_cred_request(req, ipk)
    if len(attrs) != len(ipk.get("attribute_names", [])):
        raise IdemixError("incorrect number of attribute values passed")

    e = bn.rand_mod_order(rng)
    s = bn.rand_mod_order(rng)

    b = bn.G1_GEN
    b = bn.g1_add(b, ecp_from_proto(req.get("nym")))
    b = bn.g1_add(b, bn.g1_mul(ecp_from_proto(ipk.get("h_rand")), s))
    b = bn.g1_add(b, _attr_bases_product(ipk, range(len(attrs)), attrs))

    isk = _big(key, "isk")
    exp = pow(_mod(isk + e), bn.R - 2, bn.R)  # 1/(e + isk) mod r
    a = bn.g1_mul(b, exp)
    return {
        "a": ecp_to_proto(a),
        "b": ecp_to_proto(b),
        "e": bn.big_to_bytes(e),
        "s": bn.big_to_bytes(s),
        "attrs": [bn.big_to_bytes(v) for v in attrs],
    }


def verify_credential(cred: dict, sk: int, ipk: dict) -> None:
    """Credential.Ver (credential.go): the b-value from the attributes, then
    e(w * g2^e, A) == e(g2, B) on the host."""
    a = ecp_from_proto(cred.get("a"))
    b = ecp_from_proto(cred.get("b"))
    e = _big(cred, "e")
    s = _big(cred, "s")
    attrs = [bn.big_from_bytes(v) for v in cred.get("attrs", [])]

    b_prime = bn.G1_GEN
    b_prime = bn.g1_add(b_prime, bn.g1_mul2(ecp_from_proto(ipk.get("h_sk")), sk,
                                            ecp_from_proto(ipk.get("h_rand")), s))
    # zip's truncation, as the JAX package's product over (h_attrs, attrs)
    b_prime = bn.g1_add(b_prime, _attr_bases_product(
        ipk, range(len(ipk.get("h_attrs", []))), attrs))
    if b != b_prime:
        raise IdemixError("b-value from credential does not match the attribute values")

    lhs_g2 = bn.g2_add(bn.g2_mul(bn.G2_GEN, e), ecp2_from_proto(ipk.get("w")))
    if bn.pairing(lhs_g2, a) != bn.pairing(bn.G2_GEN, b):
        raise IdemixError("credential is not cryptographically valid")


# --------------------------------------------------------------------------
# Pseudonyms (util.go MakeNym)
# --------------------------------------------------------------------------


def make_nym(sk: int, ipk: dict, rng) -> Tuple[bn.G1Point, int]:
    rand_nym = bn.rand_mod_order(rng)
    nym = bn.g1_mul2(ecp_from_proto(ipk.get("h_sk")), sk, ecp_from_proto(ipk.get("h_rand")),
                     rand_nym)
    return nym, rand_nym


# --------------------------------------------------------------------------
# Signature of knowledge (signature.go)
# --------------------------------------------------------------------------


def new_signature(cred: dict, sk: int, nym: bn.G1Point, r_nym: int, ipk: dict,
                  disclosure: Sequence[int], msg: bytes, rh_index: int, cri: dict, rng) -> dict:
    names = ipk.get("attribute_names", [])
    if rh_index < 0 or rh_index >= len(names) or len(disclosure) != len(names):
        raise IdemixError("cannot create idemix signature: invalid input")
    alg = cri.get("revocation_alg", 0)
    if alg != ALG_NO_REVOCATION and disclosure[rh_index] == 1:
        raise IdemixError("revocation handle attribute must remain hidden")
    if alg != ALG_NO_REVOCATION:
        raise IdemixError(f"unknown revocation algorithm {alg}")

    hidden = _hidden_indices(disclosure)

    r1 = bn.rand_mod_order(rng)
    r2 = bn.rand_mod_order(rng)
    r3 = pow(r1, bn.R - 2, bn.R)
    nonce = bn.rand_mod_order(rng)

    a = ecp_from_proto(cred.get("a"))
    b = ecp_from_proto(cred.get("b"))
    e = _big(cred, "e")
    s = _big(cred, "s")

    a_prime = bn.g1_mul(a, r1)
    a_bar = bn.g1_add(bn.g1_mul(b, r1), bn.g1_neg(bn.g1_mul(a_prime, e)))
    h_rand = ecp_from_proto(ipk.get("h_rand"))
    h_sk = ecp_from_proto(ipk.get("h_sk"))
    b_prime = bn.g1_add(bn.g1_mul(b, r1), bn.g1_neg(bn.g1_mul(h_rand, r2)))

    s_prime = _mod(s - r2 * r3)

    r_sk = bn.rand_mod_order(rng)
    r_e = bn.rand_mod_order(rng)
    r_r2 = bn.rand_mod_order(rng)
    r_r3 = bn.rand_mod_order(rng)
    r_s_prime = bn.rand_mod_order(rng)
    r_r_nym = bn.rand_mod_order(rng)
    r_attrs = [bn.rand_mod_order(rng) for _ in hidden]

    # t-values (signature.go:136-159)
    t1 = bn.g1_mul2(a_prime, r_e, h_rand, r_r2)
    t2 = bn.g1_add(bn.g1_mul(h_rand, r_s_prime), bn.g1_mul2(b_prime, r_r3, h_sk, r_sk))
    t2 = bn.g1_add(t2, _attr_bases_product(ipk, hidden, r_attrs))
    t3 = bn.g1_mul2(h_sk, r_sk, h_rand, r_r_nym)

    # non-revocation contribution: empty for ALG_NO_REVOCATION
    c = _signature_challenge(t1, t2, t3, a_prime, a_bar, b_prime, nym, b"",
                             ipk.get("hash", b""), disclosure, msg)
    proof_c = _second_challenge(c, nonce)

    attrs = cred.get("attrs", [])
    sig = {
        "a_prime": ecp_to_proto(a_prime),
        "a_bar": ecp_to_proto(a_bar),
        "b_prime": ecp_to_proto(b_prime),
        "proof_c": bn.big_to_bytes(proof_c),
        "proof_s_sk": bn.big_to_bytes(_mod(r_sk + proof_c * sk)),
        "proof_s_e": bn.big_to_bytes(_mod(r_e - proof_c * e)),
        "proof_s_r2": bn.big_to_bytes(_mod(r_r2 + proof_c * r2)),
        "proof_s_r3": bn.big_to_bytes(_mod(r_r3 - proof_c * r3)),
        "proof_s_s_prime": bn.big_to_bytes(_mod(r_s_prime + proof_c * s_prime)),
        "proof_s_attrs": [
            bn.big_to_bytes(_mod(r_attrs[i] + proof_c * bn.big_from_bytes(attrs[j])))
            for i, j in enumerate(hidden)
        ],
        "nonce": bn.big_to_bytes(nonce),
        "nym": ecp_to_proto(nym),
        "proof_s_r_nym": bn.big_to_bytes(_mod(r_r_nym + proof_c * r_nym)),
        # present even when the CRI carries no key, as CopyFrom makes it
        "revocation_epoch_pk": copy.deepcopy(cri.get("epoch_pk", {})),
        # present, with revocation_alg ALG_NO_REVOCATION, the default
        "non_revocation_proof": {},
    }
    for name, src in (("revocation_pk_sig", "epoch_pk_sig"), ("epoch", "epoch")):
        if cri.get(src):
            sig[name] = cri[src]
    return sig


def _signature_challenge(t1, t2, t3, a_prime, a_bar, b_prime, nym, non_revoked_bytes: bytes,
                         ipk_hash_bytes: bytes, disclosure: Sequence[int], msg: bytes) -> int:
    """First Fiat-Shamir hash over the fixed transcript layout
    (signature.go:161-187)."""
    buf = bytearray()
    buf += SIGN_LABEL
    for pt in (t1, t2, t3, a_prime, a_bar, b_prime, nym):
        _append_g1(buf, pt)
    buf += non_revoked_bytes
    buf += ipk_hash_bytes
    buf += bytes(disclosure)
    buf += msg
    return bn.hash_mod_order(bytes(buf))


def _second_challenge(c: int, nonce: int) -> int:
    """signature.go:189-194: ProofC = H(c || nonce)."""
    buf = bytearray()
    _append_big(buf, c)
    _append_big(buf, nonce)
    return bn.hash_mod_order(bytes(buf))


def verify_signature(sig: dict, disclosure: Sequence[int], ipk: dict, msg: bytes,
                     attribute_values: Sequence[Optional[int]], rh_index: int, rev_pk,
                     epoch: int) -> None:
    """Signature.Ver (signature.go:243-405): raises IdemixError unless the
    signature holds. attribute_values[i] is checked for each disclosed
    attribute i. rev_pk, the revocation authority's key, is not read: with
    ALG_NO_REVOCATION the reference's msp layer skips the epoch key check."""
    names = ipk.get("attribute_names", [])
    if rh_index < 0 or rh_index >= len(names) or len(disclosure) != len(names):
        raise IdemixError("cannot verify idemix signature: invalid input")
    alg = (sig.get("non_revocation_proof") or {}).get("revocation_alg", 0)
    if alg != ALG_NO_REVOCATION:
        raise IdemixError(f"unknown revocation algorithm {alg}")

    hidden = _hidden_indices(disclosure)

    a_prime = ecp_from_proto(sig.get("a_prime"))
    a_bar = ecp_from_proto(sig.get("a_bar"))
    b_prime = ecp_from_proto(sig.get("b_prime"))
    nym = ecp_from_proto(sig.get("nym"))
    proof_c = _big(sig, "proof_c")
    proof_s_sk = _big(sig, "proof_s_sk")
    proof_s_e = _big(sig, "proof_s_e")
    proof_s_r2 = _big(sig, "proof_s_r2")
    proof_s_r3 = _big(sig, "proof_s_r3")
    proof_s_s_prime = _big(sig, "proof_s_s_prime")
    proof_s_r_nym = _big(sig, "proof_s_r_nym")
    s_attrs = sig.get("proof_s_attrs", [])
    if len(s_attrs) != len(hidden):
        raise IdemixError(
            "signature invalid: incorrect amount of s-values for AttributeProofSpec")
    proof_s_attrs = [bn.big_from_bytes(v) for v in s_attrs]
    nonce = _big(sig, "nonce")

    w = ecp2_from_proto(ipk.get("w"))
    h_rand = ecp_from_proto(ipk.get("h_rand"))
    h_sk = ecp_from_proto(ipk.get("h_sk"))

    if a_prime is None:
        raise IdemixError("signature invalid: APrime = 1")

    # pairing check: e(W, A') * e(g2, ABar)^-1 == 1 (Ate output is not
    # unitary, so a true Fp12 inverse is needed, not the conjugate)
    t = bn.fp12_mul(bn.ate(w, a_prime), bn.fp12_inv(bn.ate(bn.G2_GEN, a_bar)))
    if not bn.gt_is_unity(bn.fexp(t)):
        raise IdemixError(
            "signature invalid: APrime and ABar don't have the expected structure")

    # recompute t1
    t1 = bn.g1_mul2(a_prime, proof_s_e, h_rand, proof_s_r2)
    temp = bn.g1_add(a_bar, bn.g1_neg(b_prime))
    t1 = bn.g1_add(t1, bn.g1_neg(bn.g1_mul(temp, proof_c)))

    # recompute t2
    t2 = bn.g1_add(bn.g1_mul(h_rand, proof_s_s_prime),
                   bn.g1_mul2(b_prime, proof_s_r3, h_sk, proof_s_sk))
    t2 = bn.g1_add(t2, _attr_bases_product(ipk, hidden, proof_s_attrs))
    temp = bn.G1_GEN
    for index, disclose in enumerate(disclosure):
        if disclose != 0:
            temp = bn.g1_add(temp, bn.g1_mul(ecp_from_proto(ipk["h_attrs"][index]),
                                             attribute_values[index]))
    t2 = bn.g1_add(t2, bn.g1_mul(temp, proof_c))

    # recompute t3
    t3 = bn.g1_mul2(h_sk, proof_s_sk, h_rand, proof_s_r_nym)
    t3 = bn.g1_add(t3, bn.g1_neg(bn.g1_mul(nym, proof_c)))

    c = _signature_challenge(t1, t2, t3, a_prime, a_bar, b_prime, nym, b"",
                             ipk.get("hash", b""), disclosure, msg)
    if proof_c != _second_challenge(c, nonce):
        raise IdemixError("signature invalid: zero-knowledge proof is invalid")


# --------------------------------------------------------------------------
# Nym signatures (nymsignature.go)
# --------------------------------------------------------------------------


def new_nym_signature(sk: int, nym: bn.G1Point, r_nym: int, ipk: dict, msg: bytes,
                      rng) -> dict:
    nonce = bn.rand_mod_order(rng)
    h_rand = ecp_from_proto(ipk.get("h_rand"))
    h_sk = ecp_from_proto(ipk.get("h_sk"))

    r_sk = bn.rand_mod_order(rng)
    r_r_nym = bn.rand_mod_order(rng)
    t = bn.g1_mul2(h_sk, r_sk, h_rand, r_r_nym)

    c = _nym_challenge(t, nym, ipk.get("hash", b""), msg)
    proof_c = _second_challenge(c, nonce)
    return {
        "proof_c": bn.big_to_bytes(proof_c),
        "proof_s_sk": bn.big_to_bytes(_mod(r_sk + proof_c * sk)),
        "proof_s_r_nym": bn.big_to_bytes(_mod(r_r_nym + proof_c * r_nym)),
        "nonce": bn.big_to_bytes(nonce),
    }


def _nym_challenge(t, nym, ipk_hash_bytes: bytes, msg: bytes) -> int:
    buf = bytearray()
    buf += SIGN_LABEL
    _append_g1(buf, t)
    _append_g1(buf, nym)
    buf += ipk_hash_bytes
    buf += msg
    return bn.hash_mod_order(bytes(buf))


def verify_nym_signature(sig: dict, nym: bn.G1Point, ipk: dict, msg: bytes) -> None:
    proof_c = _big(sig, "proof_c")
    proof_s_sk = _big(sig, "proof_s_sk")
    proof_s_r_nym = _big(sig, "proof_s_r_nym")
    nonce = _big(sig, "nonce")
    h_rand = ecp_from_proto(ipk.get("h_rand"))
    h_sk = ecp_from_proto(ipk.get("h_sk"))

    t = bn.g1_mul2(h_sk, proof_s_sk, h_rand, proof_s_r_nym)
    t = bn.g1_add(t, bn.g1_neg(bn.g1_mul(nym, proof_c)))

    c = _nym_challenge(t, nym, ipk.get("hash", b""), msg)
    if proof_c != _second_challenge(c, nonce):
        raise IdemixError("pseudonym signature invalid: zero-knowledge proof is invalid")


# --------------------------------------------------------------------------
# Weak Boneh-Boyen signatures (weak-bb.go)
# --------------------------------------------------------------------------


def wbb_keygen(rng) -> Tuple[int, bn.G2Point]:
    sk = bn.rand_mod_order(rng)
    return sk, bn.g2_mul(bn.G2_GEN, sk)


def wbb_sign(sk: int, m: int) -> bn.G1Point:
    exp = pow(_mod(sk + m), bn.R - 2, bn.R)
    return bn.g1_mul(bn.G1_GEN, exp)


@functools.lru_cache(maxsize=1)
def _gen_gt() -> bn.Fp12:
    return bn.pairing(bn.G2_GEN, bn.G1_GEN)


def wbb_verify(pk: bn.G2Point, sig: bn.G1Point, m: int) -> None:
    if pk is None or sig is None:
        raise IdemixError("Weak-BB signature invalid: received nil input")
    p = bn.g2_add(pk, bn.g2_mul(bn.G2_GEN, m))
    if bn.pairing(p, sig) != _gen_gt():
        raise IdemixError("Weak-BB signature is invalid")


# --------------------------------------------------------------------------
# Revocation authority (revocation_authority.go)
# --------------------------------------------------------------------------


def generate_long_term_revocation_key(rng) -> p384.ECDSAP384PrivateKey:
    """Long-term revocation key: ECDSA on P-384 like the reference, its
    scalar drawn from `rng`."""
    return p384.ECDSAP384PrivateKey.generate(rng)


def _cri_prefix_digest(alg: int, epoch_pk: dict, epoch: int) -> bytes:
    """SHA-256 of the CRI serialized with its revocation_alg, epoch_pk and
    epoch only: the bytes the authority signs."""
    prefix = {"epoch": epoch, "epoch_pk": epoch_pk, "revocation_alg": alg}
    return hashlib.sha256(pb.encode(pb.CREDENTIAL_REVOCATION_INFORMATION, prefix)).digest()


def create_cri(key: p384.ECDSAP384PrivateKey, unrevoked_handles: Sequence[int], epoch: int,
               alg: int, rng) -> dict:
    """The epoch's CRI, its prefix signed with `key` (the nonce from
    `rng`)."""
    if alg != ALG_NO_REVOCATION:
        raise IdemixError("the specified revocation algorithm is not supported.")
    epoch_pk = ecp2_to_proto(bn.G2_GEN)  # dummy PK
    cri: dict = {"epoch_pk": epoch_pk}
    if epoch:
        cri["epoch"] = epoch
    if alg:
        cri["revocation_alg"] = alg
    cri["epoch_pk_sig"] = key.sign(_cri_prefix_digest(alg, epoch_pk, epoch), rng)
    return cri


def verify_epoch_pk(pk: p384.ECDSAP384PublicKey, epoch_pk: dict, epoch_pk_sig: bytes, epoch: int,
                    alg: int) -> None:
    """VerifyEpochPK: the revocation authority's signature over the (alg,
    epoch_pk, epoch) CRI prefix."""
    try:
        pk.verify(epoch_pk_sig, _cri_prefix_digest(alg, epoch_pk, epoch))
    except p384.SignatureError as exc:
        raise IdemixError("EpochPKSig invalid") from exc
