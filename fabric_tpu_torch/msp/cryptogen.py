"""Test crypto-material generator (reference cmd/cryptogen): per-org ECDSA
P-256 root CA, node and user certs with NodeOU subject entries, MSP configs.

The port's counterpart of the JAX package's `msp/cryptogen.py`, written over
the port's X.509 writer (`common/x509.py`) and P-256 oracle: the card's
machine has no `cryptography`. The certificates carry what the JAX package's
do (C=US, O=org, OU, CN; BasicConstraints; the CA's KeyUsage; the same
validity windows; ecdsa-with-SHA256), and load in `cryptography`.

Keys, serials and ECDSA nonces come from the `random.Random` the caller
passes. This is material for tests and the chip smoke, never a production
CA or signer: a seeded generator is not a source of secret nonces.
"""

from __future__ import annotations

import datetime
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from fabric_tpu_torch.common import der, p256, x509
from fabric_tpu_torch.msp.identity import MSP, MSPConfig, NodeOUs


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)


def new_key(rng: random.Random) -> Tuple[int, Tuple[int, int]]:
    """(private scalar, public point) drawn from `rng`."""
    d = rng.randrange(1, p256.N)
    return d, p256.base_mult(d)


def sign_der(priv: int, digest: bytes, rng: random.Random) -> bytes:
    """Low-S ECDSA over `digest`, DER-encoded, with a nonce from `rng`."""
    r, s = p256.sign_digest(priv, digest, k=rng.randrange(1, p256.N))
    return der.marshal_signature(r, s)


@dataclass
class NodeIdentity:
    name: str
    cert_pem: bytes
    priv_scalar: int
    msp_id: str


class OrgCA:
    """A self-signed org root CA that can enroll node/user identities."""

    def __init__(self, org_name: str, msp_id: str, rng: random.Random,
                 now: Optional[datetime.datetime] = None):
        self.org_name = org_name
        self.msp_id = msp_id
        self.rng = rng
        self.key, public = new_key(rng)
        self.subject = x509.encode_name(f"ca.{org_name}", org_name)
        now = now or _now()
        self.cert_pem = self._issue(
            self.subject, public, now - datetime.timedelta(days=1),
            now + datetime.timedelta(days=3650),
            [x509.basic_constraints(True), x509.ca_key_usage()],
        )
        self._revoked: List[int] = []

    def _sign(self, tbs: bytes) -> bytes:
        return sign_der(self.key, p256.sha256(tbs), self.rng)

    def _issue(self, subject, public, not_before, not_after, extensions) -> bytes:
        serial = self.rng.getrandbits(159) | 1
        cert = x509.build_certificate(serial, self.subject, subject, not_before, not_after,
                                      public, extensions, self._sign)
        return x509.pem_encode("CERTIFICATE", cert)

    def enroll(self, name: str, ou: str = "peer",
               now: Optional[datetime.datetime] = None) -> NodeIdentity:
        """A cert valid from a day before `now` (default: the clock) for 365 days."""
        d, public = new_key(self.rng)
        now = now or _now()
        pem = self._issue(
            x509.encode_name(name, self.org_name, ou=ou), public,
            now - datetime.timedelta(days=1), now + datetime.timedelta(days=365),
            [x509.basic_constraints(False)],
        )
        return NodeIdentity(name, pem, d, self.msp_id)

    def revoke(self, identity: NodeIdentity) -> None:
        self._revoked.append(x509.load_pem_certificate(identity.cert_pem).serial)

    def crl_pem(self) -> bytes:
        now = _now()
        crl = x509.build_crl(
            self.subject, now - datetime.timedelta(hours=1), now + datetime.timedelta(days=365),
            [(serial, now - datetime.timedelta(minutes=5)) for serial in self._revoked],
            self._sign,
        )
        return x509.pem_encode("X509 CRL", crl)


@dataclass
class Org:
    """One generated organization: CA + standard identities."""

    ca: OrgCA
    admin: NodeIdentity
    peers: List[NodeIdentity]
    users: List[NodeIdentity]

    @property
    def msp_id(self) -> str:
        return self.ca.msp_id

    def msp_config(self, with_crl: bool = False) -> MSPConfig:
        return MSPConfig(
            msp_id=self.ca.msp_id,
            root_certs=[self.ca.cert_pem],
            admins=[self.admin.cert_pem],
            revocation_list=[self.ca.crl_pem()] if with_crl else [],
            node_ous=NodeOUs(enable=True),
        )

    def msp(self, with_crl: bool = False) -> MSP:
        return MSP(self.msp_config(with_crl=with_crl))


def generate_org(
    org_name: str,
    msp_id: Optional[str] = None,
    num_peers: int = 1,
    num_users: int = 1,
    *,
    rng: random.Random,
) -> Org:
    """An org with keys, serials and nonces drawn from `rng`."""
    ca = OrgCA(org_name, msp_id or f"{org_name}MSP", rng)
    admin = ca.enroll(f"Admin@{org_name}", ou="admin")
    peers = [ca.enroll(f"peer{i}.{org_name}", ou="peer") for i in range(num_peers)]
    users = [ca.enroll(f"User{i}@{org_name}", ou="client") for i in range(num_users)]
    return Org(ca, admin, peers, users)
