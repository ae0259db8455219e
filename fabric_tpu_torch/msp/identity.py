"""X.509 MSP (reference msp/ package): identities, chain validation, CRLs and
principal matching.

The port's counterpart of the JAX package's `msp/identity.py`, over the
port's own X.509 reader (`common/x509.py`) in place of `cryptography`, which
the card's machine does not have. Each hop of a chain is checked with the
port's P-256 oracle over the hash of the TBS bytes. The signature checks of
transactions do not pass through here: the validator batches them to the
provider. `Identity.verify` (one signature, the endorser's creator check)
goes to the provider the MSP was given; an MSP without one raises there, as
there is no host check to fall back to.
"""

from __future__ import annotations

import datetime
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import x509
from fabric_tpu_torch.crypto.bccsp import ECDSAPublicKey
from fabric_tpu_torch.protos import fabric, protoutil


class MSPError(Exception):
    pass


# sentinel: "chain validation not yet succeeded" (None means validated OK;
# failures are never cached, they may be time-dependent)
_UNVALIDATED = object()


@dataclass(frozen=True)
class NodeOUs:
    """NodeOU classification (reference msp/mspimplsetup.go): OU strings
    that classify a cert as client/peer/admin/orderer."""

    enable: bool = False
    client_ou: str = "client"
    peer_ou: str = "peer"
    admin_ou: str = "admin"
    orderer_ou: str = "orderer"


@dataclass
class MSPConfig:
    """The field lists of the JAX package's `MSPConfig`: PEM bytes each."""

    msp_id: str
    root_certs: List[bytes]
    intermediate_certs: List[bytes] = field(default_factory=list)
    admins: List[bytes] = field(default_factory=list)
    revocation_list: List[bytes] = field(default_factory=list)  # PEM CRLs
    node_ous: NodeOUs = field(default_factory=NodeOUs)


def msp_config_from_pems(
    msp_id: str,
    root_certs: Sequence[bytes],
    intermediate_certs: Sequence[bytes] = (),
    admins: Sequence[bytes] = (),
    revocation_list: Sequence[bytes] = (),
    node_ous: Optional[NodeOUs] = None,
) -> MSPConfig:
    """An MSPConfig from the PEMs another MSP (the JAX package's, say) was
    configured with."""
    return MSPConfig(msp_id, list(root_certs), list(intermediate_certs), list(admins),
                     list(revocation_list), node_ous or NodeOUs())


class Identity:
    """A deserialized (MSPID, X.509 cert) pair."""

    def __init__(self, msp_id: str, cert: x509.Certificate, provider=None):
        if cert.public_key is None:
            raise MSPError("only ECDSA P-256 identities supported")
        self.msp_id = msp_id
        self.cert = cert
        self._provider = provider
        self.public_key = ECDSAPublicKey(*cert.public_key)
        # memoized derived forms: an identity is deserialized once per
        # distinct cert but consulted per signature job
        self._serialized: Optional[bytes] = None
        self._fingerprint: Optional[bytes] = None
        self._validation_err: object = _UNVALIDATED

    @property
    def ou_values(self) -> List[str]:
        return list(self.cert.ou_values)

    def serialize(self) -> bytes:
        if self._serialized is None:
            self._serialized = protoutil.serialize_identity(self.msp_id, self.cert.pem())
        return self._serialized

    def fingerprint(self) -> bytes:
        """SHA-256 of the serialized identity (cache keys in the validator)."""
        if self._fingerprint is None:
            self._fingerprint = hashlib.sha256(self.serialize()).digest()
        return self._fingerprint

    def verify(self, msg: bytes, sig: bytes) -> None:
        """Raises MSPError unless `sig` is this identity's signature over
        `msg` (msp/identities.go Verify: SHA-256, then the provider's
        verify); on `CUDAProvider` one K2 launch of one lane."""
        if self._provider is None:
            raise MSPError("identity has no provider to verify with")
        digest = self._provider.hash(msg)
        try:
            ok = self._provider.verify(self.public_key, sig, digest)
        except Exception as e:
            raise MSPError(f"could not determine the validity of the signature: {e}")
        if not ok:
            raise MSPError("The signature is invalid")


def _load_cert(pem: bytes) -> x509.Certificate:
    try:
        return x509.load_pem_certificate(pem)
    except x509.X509Error as e:
        raise MSPError(f"could not decode PEM certificate: {e}") from e


class MSP:
    """bccspmsp analog: one organization's verification context."""

    def __init__(self, config: MSPConfig, provider=None):
        self.config = config
        self.msp_id = config.msp_id
        self._provider = provider
        self._roots = [_load_cert(c) for c in config.root_certs]
        self._intermediates = [_load_cert(c) for c in config.intermediate_certs]
        self._admin_serialized = {
            protoutil.serialize_identity(config.msp_id, _load_cert(pem).pem())
            for pem in config.admins
        }
        self._revoked_serials = set()
        for crl_pem in config.revocation_list:
            try:
                self._revoked_serials.update(x509.load_pem_crl(crl_pem))
            except x509.X509Error as e:
                raise MSPError(f"could not decode CRL: {e}") from e
        self._deser_cache: Dict[bytes, Identity] = {}

    # -- deserialization (msp/mspimpl.go DeserializeIdentity + msp/cache) --
    def deserialize_identity(self, serialized: bytes) -> Identity:
        cached = self._deser_cache.get(serialized)
        if cached is not None:
            return cached
        sid = protoutil.unmarshal(fabric.SERIALIZED_IDENTITY, serialized)
        mspid = sid.get("mspid", "")
        if mspid != self.msp_id:
            raise MSPError(f"expected MSP ID {self.msp_id}, received {mspid}")
        ident = Identity(mspid, _load_cert(sid.get("id_bytes", b"")), self._provider)
        if len(self._deser_cache) > 16384:
            self._deser_cache.clear()
        self._deser_cache[serialized] = ident
        return ident

    # -- validation (msp/mspimplvalidate.go) -------------------------------
    def validate(self, identity: Identity) -> None:
        """Chain walk + expiry + CRL. Success is memoized on the identity;
        failures are not ('not yet valid' and expiry are time-dependent)."""
        if identity._validation_err is None:
            return
        self._validate_uncached(identity)
        identity._validation_err = None

    def _validate_uncached(self, identity: Identity) -> None:
        cert = identity.cert
        chain = self._build_chain(cert)
        now = datetime.datetime.now(datetime.timezone.utc)
        for c in [cert] + chain:
            if not (c.not_before <= now <= c.not_after):
                raise MSPError("certificate expired or not yet valid")
        if cert.serial in self._revoked_serials:
            raise MSPError("The certificate has been revoked")

    def _build_chain(self, cert: x509.Certificate) -> List[x509.Certificate]:
        """Walk issuers through intermediates to a trusted root, checking
        each signature (Go x509 Verify analog, sans path constraints)."""
        chain: List[x509.Certificate] = []
        current = cert
        pool = self._intermediates + self._roots
        for _ in range(8):  # max depth
            issuer = next((c for c in pool if x509.verify_issued_by(current, c)), None)
            if issuer is None:
                raise MSPError("could not obtain certification chain")
            chain.append(issuer)
            if any(issuer is r for r in self._roots):
                return chain
            current = issuer
        raise MSPError("certification chain too deep")

    # -- principal matching (msp/mspimpl.go SatisfiesPrincipal) ------------
    def satisfies_principal(self, identity: Identity, principal: dict) -> None:
        """`principal` is a decoded MSPPrincipal; raises MSPError unless the
        identity satisfies it."""
        cls = principal.get("principal_classification", fabric.ROLE)
        if cls == fabric.ROLE:
            role = protoutil.unmarshal(fabric.MSP_ROLE, principal.get("principal", b""))
            msp_identifier = role.get("msp_identifier", "")
            if msp_identifier != self.msp_id:
                raise MSPError(
                    f"the identity is a member of a different MSP "
                    f"(expected {msp_identifier}, got {self.msp_id})"
                )
            kind = role.get("role", fabric.MEMBER)
            ous = self.config.node_ous
            if kind == fabric.MEMBER:
                self.validate(identity)
                return
            if kind == fabric.ADMIN:
                if identity.serialize() in self._admin_serialized:
                    return
                if ous.enable and ous.admin_ou in identity.ou_values:
                    self.validate(identity)
                    return
                raise MSPError("This identity is not an admin")
            if kind in (fabric.CLIENT, fabric.PEER, fabric.ORDERER):
                if not ous.enable:
                    raise MSPError("NodeOUs not activated, cannot tell apart identities.")
                ou_name = {fabric.CLIENT: ous.client_ou, fabric.PEER: ous.peer_ou,
                           fabric.ORDERER: ous.orderer_ou}[kind]
                self.validate(identity)
                if ou_name not in identity.ou_values:
                    raise MSPError(f"The identity is not a {ou_name} under this MSP")
                return
            raise MSPError(f"invalid MSP role type {kind}")
        if cls == fabric.IDENTITY:
            if identity.serialize() != principal.get("principal", b""):
                raise MSPError("The identities do not match")
            return
        if cls == fabric.ORGANIZATION_UNIT:
            ou = protoutil.unmarshal(fabric.ORGANIZATION_UNIT_MSG, principal.get("principal", b""))
            if ou.get("msp_identifier", "") != self.msp_id:
                raise MSPError("the identity is a member of a different MSP")
            self.validate(identity)
            if ou.get("organizational_unit_identifier", "") not in identity.ou_values:
                raise MSPError("The identities do not match")
            return
        raise MSPError(f"principal type {cls} is not supported")


class MSPManager:
    """Per-channel MSP registry (reference msp/mspmgrimpl.go)."""

    def __init__(self, msps: Sequence[MSP]):
        self._by_id = {m.msp_id: m for m in msps}

    def get_msp(self, msp_id: str) -> MSP:
        msp = self._by_id.get(msp_id)
        if msp is None:
            raise MSPError(f"MSP {msp_id} is unknown")
        return msp

    def deserialize_identity(self, serialized: bytes) -> Tuple[Identity, MSP]:
        sid = protoutil.unmarshal(fabric.SERIALIZED_IDENTITY, serialized)
        msp = self.get_msp(sid.get("mspid", ""))
        return msp.deserialize_identity(serialized), msp

    def msps(self) -> List[MSP]:
        return list(self._by_id.values())
