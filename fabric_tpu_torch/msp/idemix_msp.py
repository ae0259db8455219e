"""Idemix MSP: anonymous credentials as a membership service provider.

The port's counterpart of the JAX package's `msp/idemix_msp.py` (reference
msp/idemixmsp.go, msp/idemix_roles.go and the bccsp idemix bridge's
attribute encoding, bccsp/idemix/bridge/credential.go:50-60: bytes
attributes enter the credential as HashModOrder(bytes), int attributes as
the integer itself), over the port's dict messages (`protos/fabric.py`,
`protos/idemix.py`).

The credential carries 4 attributes (msp/idemixmsp.go:25-35):
  0: OU   (disclosed)   - organizational unit identifier
  1: Role (disclosed)   - idemix role bitmask (MEMBER=1, ADMIN=2, ...)
  2: EnrollmentId (hidden)
  3: RevocationHandle (hidden, rhIndex=3)

An identity serializes as SerializedIdentity{mspid,
SerializedIdemixIdentity{nym_x, nym_y, ou, role, proof}} where `proof` is
an idemix signature over the EMPTY message disclosing OU and Role: the
association between the pseudonym and the issuer. `IdemixMSP.validate`
checks it on the host through `scheme.verify_signature`, one identity at a
time, as the JAX MSP does; a caller with many identities batches their
proofs through `idemix/batch.verify_signatures_batch`. Message signatures
(`verify`) are pseudonym signatures.

As in the reference, a signer's identity carries the MSP role ADMIN when its
credential's role mask has the ADMIN bit and MEMBER otherwise, and its proof
discloses that role's mask: a credential issued with the CLIENT or PEER mask
alone makes an identity whose proof does not verify.

The revocation key is the port's P-384 (`common/p384.py`): its scalar and
each CRI's ECDSA nonce come from the caller's generator, where the JAX
package's come from the OS. So `generate_issuer` and `generate_signer_config`
give the JAX bytes for the same seed but for the CRI's signature, and a
generator shared across a revocation key or a CRI draws differently after it.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Tuple

from fabric_tpu_torch import idemix
from fabric_tpu_torch.common import fp256bn as bn
from fabric_tpu_torch.common import p384
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.protos import idemix as ipb

# idemix role bitmask (msp/idemix_roles.go:16-22)
ROLE_MEMBER = 1
ROLE_ADMIN = 2
ROLE_CLIENT = 4
ROLE_PEER = 8

ATTR_OU = 0
ATTR_ROLE = 1
ATTR_ENROLLMENT_ID = 2
ATTR_REVOCATION_HANDLE = 3
RH_INDEX = ATTR_REVOCATION_HANDLE

ATTRIBUTE_NAMES = ["OU", "Role", "EnrollmentId", "RevocationHandle"]

PROOF_DISCLOSURE = [1, 1, 0, 0]  # disclose OU + Role
_EMPTY_MSG = b""


class IdemixMSPError(Exception):
    pass


def _msp_role_to_idemix(role_type: int) -> int:
    """msp/idemix_roles.go getIdemixRoleFromMSPRoleValue."""
    if role_type == fabric.ADMIN:
        return ROLE_ADMIN
    if role_type == fabric.CLIENT:
        return ROLE_CLIENT
    if role_type == fabric.PEER:
        return ROLE_PEER
    return ROLE_MEMBER


def _attr_bytes(value: bytes) -> int:
    return bn.hash_mod_order(value)


@dataclass
class IdemixIdentity:
    """A deserialized anonymous identity; `ou`, `role` and `proof` are the
    OrganizationUnit, MSPRole and Signature messages as dicts."""

    msp_id: str
    nym: bn.G1Point
    ou: dict
    role: dict
    proof: dict
    raw: bytes  # the SerializedIdentity bytes

    def serialize(self) -> bytes:
        return self.raw

    @property
    def role_mask(self) -> int:
        return _msp_role_to_idemix(self.role.get("role", fabric.MEMBER))

    @property
    def ou_identifier(self) -> str:
        return self.ou.get("organizational_unit_identifier", "")


class IdemixMSP:
    """Verification-side idemix MSP (reference idemixmsp.go Setup with no
    signer). `config` is an IdemixMSPConfig dict; `rev_pk` the revocation
    authority's `p384.ECDSAP384PublicKey` or None."""

    def __init__(self, config: dict, rev_pk: Optional[p384.ECDSAP384PublicKey] = None):
        self.name = config.get("name", "")
        self.epoch = config.get("epoch", 0)
        self.ipk = ipb.decode(ipb.ISSUER_PUBLIC_KEY, config.get("ipk", b""))
        idemix.check_issuer_public_key(self.ipk)
        if self.ipk.get("attribute_names", []) != ATTRIBUTE_NAMES:
            raise IdemixMSPError(
                "issuer public key must have attributes OU, Role, "
                "EnrollmentId, and RevocationHandle")
        self.rev_pk = rev_pk

    # -- identity plane (msp.MSP surface) -----------------------------------

    def deserialize_identity(self, serialized: bytes) -> IdemixIdentity:
        sid = wire.decode(fabric.SERIALIZED_IDENTITY, serialized)
        mspid = sid.get("mspid", "")
        if mspid != self.name:
            raise IdemixMSPError(f"expected MSP ID {self.name}, received {mspid}")
        inner = wire.decode(fabric.SERIALIZED_IDEMIX_IDENTITY, sid.get("id_bytes", b""))
        if not inner.get("nym_x") or not inner.get("nym_y"):
            raise IdemixMSPError("pseudonym is invalid")
        nym = (bn.big_from_bytes(inner["nym_x"]), bn.big_from_bytes(inner["nym_y"]))
        if not bn.g1_is_on_curve(nym):
            raise IdemixMSPError("pseudonym is not on the curve")
        ou = wire.decode(fabric.ORGANIZATION_UNIT_MSG, inner.get("ou", b""))
        role = wire.decode(fabric.MSP_ROLE, inner.get("role", b""))
        proof = ipb.decode(ipb.SIGNATURE, inner.get("proof", b""))
        return IdemixIdentity(self.name, nym, ou, role, proof, serialized)

    def proof_attribute_values(self, ident: IdemixIdentity) -> list:
        """The attribute values the association proof is checked against:
        the OU's hash and the role's mask disclosed, the rest hidden."""
        return [_attr_bytes(ident.ou_identifier.encode()), ident.role_mask, None, None]

    def validate(self, ident: IdemixIdentity) -> None:
        """Verify the association proof (idemixmsp.go verifyProof):
        disclosure = [OU, Role, hidden, hidden] over the empty message."""
        if ident.msp_id != self.name:
            raise IdemixMSPError("the supplied identity does not belong to this msp")
        try:
            idemix.verify_signature(ident.proof, PROOF_DISCLOSURE, self.ipk, _EMPTY_MSG,
                                    self.proof_attribute_values(ident), RH_INDEX, self.rev_pk,
                                    self.epoch)
        except idemix.IdemixError as e:
            raise IdemixMSPError(f"identity proof invalid: {e}") from e

    def verify(self, ident: IdemixIdentity, msg: bytes, sig: bytes) -> None:
        """Identity.Verify: pseudonym signature over msg."""
        nym_sig = ipb.decode(ipb.NYM_SIGNATURE, sig)
        try:
            idemix.verify_nym_signature(nym_sig, ident.nym, self.ipk, msg)
        except idemix.IdemixError as e:
            raise IdemixMSPError(f"signature invalid: {e}") from e

    def satisfies_principal(self, ident: IdemixIdentity, principal: dict) -> None:
        """idemixmsp.go SatisfiesPrincipal: validate, then match role/OU.
        `principal` is an MSPPrincipal dict."""
        self.validate(ident)
        cls = principal.get("principal_classification", fabric.ROLE)
        if cls == fabric.ROLE:
            role = wire.decode(fabric.MSP_ROLE, principal.get("principal", b""))
            msp_identifier = role.get("msp_identifier", "")
            if msp_identifier != self.name:
                raise IdemixMSPError(
                    f"the identity is a member of a different MSP ({msp_identifier})")
            want = role.get("role", fabric.MEMBER)
            if want == fabric.MEMBER:
                return
            if want == fabric.ADMIN:
                if ident.role_mask & ROLE_ADMIN:
                    return
                raise IdemixMSPError("user is not an admin")
            if want in (fabric.CLIENT, fabric.PEER):
                if ident.role_mask & _msp_role_to_idemix(want):
                    return
                raise IdemixMSPError("user does not have the required role")
            raise IdemixMSPError(f"invalid MSP role type {want}")
        if cls == fabric.ORGANIZATION_UNIT:
            ou = wire.decode(fabric.ORGANIZATION_UNIT_MSG, principal.get("principal", b""))
            if ou.get("msp_identifier", "") != self.name:
                raise IdemixMSPError("the identity is a member of a different MSP")
            if ou.get("organizational_unit_identifier", "") != ident.ou_identifier:
                raise IdemixMSPError("OU identifier does not match")
            return
        raise IdemixMSPError(f"invalid principal type {cls}")


class IdemixSigningIdentity:
    """Signer side: a fresh pseudonym and the proof binding it to the
    issuer's credential (idemixSigningIdentity). `signer_config` is an
    IdemixMSPSignerConfig dict."""

    def __init__(self, msp: IdemixMSP, signer_config: dict,
                 rng: Optional[random.Random] = None):
        self.msp = msp
        self.rng = rng or random.SystemRandom()
        self.sk = bn.big_from_bytes(signer_config.get("sk", b""))
        self.cred = ipb.decode(ipb.CREDENTIAL, signer_config.get("cred", b""))
        self.ou_id = signer_config.get("organizational_unit_identifier", "")
        self.enrollment_id = signer_config.get("enrollment_id", "")
        self.role_mask = signer_config.get("role", 0)
        self.cri = ipb.decode(ipb.CREDENTIAL_REVOCATION_INFORMATION,
                              signer_config.get("credential_revocation_information", b""))

        idemix.verify_credential(self.cred, self.sk, msp.ipk)
        self.nym, self.r_nym = idemix.make_nym(self.sk, msp.ipk, self.rng)

        role = {"msp_identifier": msp.name,
                "role": fabric.ADMIN if self.role_mask & ROLE_ADMIN else fabric.MEMBER}
        ou = {"msp_identifier": msp.name, "organizational_unit_identifier": self.ou_id}
        proof = idemix.new_signature(self.cred, self.sk, self.nym, self.r_nym, msp.ipk,
                                     PROOF_DISCLOSURE, _EMPTY_MSG, RH_INDEX, self.cri, self.rng)
        inner = {
            "nym_x": bn.big_to_bytes(self.nym[0]),
            "nym_y": bn.big_to_bytes(self.nym[1]),
            "ou": wire.encode(fabric.ORGANIZATION_UNIT_MSG, ou),
            "role": wire.encode(fabric.MSP_ROLE, role),
            "proof": ipb.encode(ipb.SIGNATURE, proof),
        }
        self._serialized = wire.encode(fabric.SERIALIZED_IDENTITY, {
            "mspid": msp.name,
            "id_bytes": wire.encode(fabric.SERIALIZED_IDEMIX_IDENTITY, inner),
        })

    def serialize(self) -> bytes:
        return self._serialized

    def sign(self, msg: bytes) -> bytes:
        """Pseudonym signature (idemixSigningIdentity.Sign)."""
        return ipb.encode(ipb.NYM_SIGNATURE, idemix.new_nym_signature(
            self.sk, self.nym, self.r_nym, self.msp.ipk, msg, self.rng))


# --------------------------------------------------------------------------
# idemixgen analog (cmd/idemixgen): issuer + default signer config
# --------------------------------------------------------------------------


def generate_issuer(rng: Optional[random.Random] = None):
    """idemixgen ca-keygen: the issuer key (a dict) with the 4 fixed
    attributes, then the long-term revocation key, both from `rng`."""
    rng = rng or random.SystemRandom()
    ikey = idemix.new_issuer_key(ATTRIBUTE_NAMES, rng)
    rev_key = idemix.generate_long_term_revocation_key(rng)
    return ikey, rev_key


def generate_signer_config(ikey: dict, rev_key: p384.ECDSAP384PrivateKey, ou_id: str,
                           role_mask: int, enrollment_id: str,
                           rng: Optional[random.Random] = None) -> dict:
    """idemixgen signerconfig: run the issuance protocol locally; returns an
    IdemixMSPSignerConfig dict."""
    rng = rng or random.SystemRandom()
    sk = bn.rand_mod_order(rng)
    issuer_nonce = bn.big_to_bytes(bn.rand_mod_order(rng))
    req = idemix.new_cred_request(sk, issuer_nonce, ikey["ipk"], rng)
    rh = bn.rand_mod_order(rng)
    attrs = [_attr_bytes(ou_id.encode()), role_mask, _attr_bytes(enrollment_id.encode()), rh]
    cred = idemix.new_credential(ikey, req, attrs, rng)
    cri = idemix.create_cri(rev_key, [rh], 0, idemix.ALG_NO_REVOCATION, rng)
    return {
        "cred": ipb.encode(ipb.CREDENTIAL, cred),
        "sk": bn.big_to_bytes(sk),
        "organizational_unit_identifier": ou_id,
        "role": role_mask,
        "enrollment_id": enrollment_id,
        "credential_revocation_information": ipb.encode(
            ipb.CREDENTIAL_REVOCATION_INFORMATION, cri),
    }


def generate_msp_config(name: str, ou_id: str = "OU1", role_mask: int = ROLE_MEMBER,
                        enrollment_id: str = "user1",
                        rng: Optional[random.Random] = None
                        ) -> Tuple[dict, p384.ECDSAP384PrivateKey]:
    """Full idemix MSP config (verification + default signer). Returns
    (the IdemixMSPConfig dict, the revocation private key)."""
    rng = rng or random.SystemRandom()
    ikey, rev_key = generate_issuer(rng)
    signer = generate_signer_config(ikey, rev_key, ou_id, role_mask, enrollment_id, rng)
    cfg = {
        "name": name,
        "ipk": ipb.encode(ipb.ISSUER_PUBLIC_KEY, ikey["ipk"]),
        "revocation_pk": rev_key.public_key().public_bytes_pem(),
        "signer": signer,
    }
    return cfg, rev_key
