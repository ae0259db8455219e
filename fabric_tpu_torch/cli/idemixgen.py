"""idemixgen: Idemix crypto-material generator (reference cmd/idemixgen:
ca-keygen and signerconfig, directory layout per the idemixmsp docs).

  python -m fabric_tpu_torch.cli.idemixgen ca-keygen [--output idemix-dir]
  python -m fabric_tpu_torch.cli.idemixgen signerconfig [--output idemix-dir] \
      [-u OU] [-e enrollmentId] [--admin]
  python -m fabric_tpu_torch.cli.idemixgen version

Layout written (matching the reference tool and the JAX package's
`cli/idemixgen.py`, so either package reads the other's directory):

  <output>/ca/IssuerSecretKey            full issuer key (proto)
  <output>/ca/RevocationKey              long-term revocation key (PKCS#8 PEM)
  <output>/msp/IssuerPublicKey           issuer public key (proto)
  <output>/msp/RevocationPublicKey       revocation public key (PEM)
  <output>/user/SignerConfig             IdemixMSPSignerConfig (proto)

The command line draws its randomness from the OS (`random.SystemRandom`);
`ca_keygen` and `signerconfig` take a generator for seeded material.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import Optional

from fabric_tpu_torch.cli import version_cmd
from fabric_tpu_torch.common import p384
from fabric_tpu_torch.msp.idemix_msp import (
    ROLE_ADMIN,
    ROLE_MEMBER,
    generate_issuer,
    generate_signer_config,
)
from fabric_tpu_torch.protos import fabric, wire
from fabric_tpu_torch.protos import idemix as ipb


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def ca_keygen(output: str, rng: Optional[random.Random] = None) -> None:
    ikey, rev_key = generate_issuer(rng)
    _write(os.path.join(output, "ca", "IssuerSecretKey"), ipb.encode(ipb.ISSUER_KEY, ikey))
    _write(os.path.join(output, "ca", "RevocationKey"), rev_key.private_bytes_pem())
    _write(os.path.join(output, "msp", "IssuerPublicKey"),
           ipb.encode(ipb.ISSUER_PUBLIC_KEY, ikey["ipk"]))
    _write(os.path.join(output, "msp", "RevocationPublicKey"),
           rev_key.public_key().public_bytes_pem())
    print(f"wrote issuer key material under {output}/")


def signerconfig(output: str, ou: str, enrollment: str, admin: bool,
                 rng: Optional[random.Random] = None) -> None:
    ikey_path = os.path.join(output, "ca", "IssuerSecretKey")
    rev_path = os.path.join(output, "ca", "RevocationKey")
    if not (os.path.exists(ikey_path) and os.path.exists(rev_path)):
        raise SystemExit(f"run ca-keygen first (no issuer key under {output}/ca)")
    with open(ikey_path, "rb") as f:
        ikey = ipb.decode(ipb.ISSUER_KEY, f.read())
    with open(rev_path, "rb") as f:
        rev_key = p384.load_pem_private_key(f.read())

    signer = generate_signer_config(ikey, rev_key, ou, ROLE_ADMIN if admin else ROLE_MEMBER,
                                    enrollment, rng)
    _write(os.path.join(output, "user", "SignerConfig"),
           wire.encode(fabric.IDEMIX_MSP_SIGNER_CONFIG, signer))
    print(f"wrote {output}/user/SignerConfig")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="idemixgen")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("version")
    ca = sub.add_parser("ca-keygen")
    ca.add_argument("--output", default="idemix-config")
    sc = sub.add_parser("signerconfig")
    sc.add_argument("--output", default="idemix-config")
    sc.add_argument("-u", "--org-unit", default="OU1")
    sc.add_argument("-e", "--enrollment-id", default="user1")
    sc.add_argument("--admin", action="store_true")
    args = parser.parse_args(argv)
    if args.cmd == "version":
        return version_cmd("idemixgen")
    if args.cmd == "ca-keygen":
        ca_keygen(args.output)
    else:
        signerconfig(args.output, args.org_unit, args.enrollment_id, args.admin)
    return 0


if __name__ == "__main__":
    sys.exit(main())
