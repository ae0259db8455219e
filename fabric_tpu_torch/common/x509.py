"""X.509 certificates and CRLs in DER and PEM, without the cryptography package.

The port's counterpart of what the JAX package's MSP takes from
`cryptography` (`msp/identity.py:18-38`, `msp/cryptogen.py`): the card's
machine has no `cryptography`, so the MSP reads certificates and CRLs here
and `msp/cryptogen` writes them here.

Reading (`Certificate.from_der`, `load_pem_certificate`, `load_pem_crl`):
the TBS bytes, the raw DER of the issuer and subject Names, the subject's
organizational-unit values in certificate order, the serial, the validity
(UTCTime and GeneralizedTime), a P-256 subject public key (uncompressed or
compressed), the signature algorithm and value, and a CRL's revoked serials.
The DER must be strict: definite, minimal lengths, one-byte tags, nothing
after the outer SEQUENCE; anything else raises `X509Error`.

`Certificate.pem()` re-encodes the certificate as `cryptography`'s
`public_bytes(Encoding.PEM)` does (base64 of the DER in 64-character lines
between the BEGIN and END lines, each line ending in a newline): the MSP
serializes an identity from it, and the validator dedupes signers by the
hash of that serialization.

`verify_issued_by` checks a certificate's signature against its issuer's
P-256 key with the port's oracle (`common/p256.verify_digest` over the hash
of the TBS bytes), as `cryptography`'s `verify_directly_issued_by` does with
OpenSSL: the issuer's Name must equal the certificate's issuer Name, the
signature must be DER that re-encodes to itself, and r, s must lie in
[1, n); high S is accepted. Names are compared as DER bytes, as Go's x509
does; `cryptography` compares parsed Names, which can differ for two
encodings of one value (a PrintableString against a UTF8String), never for
the certificates `msp/cryptogen` writes.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import hashlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from fabric_tpu_torch.common import der, p256


class X509Error(ValueError):
    """Malformed or unsupported certificate or CRL."""


_SEQUENCE, _SET, _INTEGER, _BIT_STRING, _OCTET_STRING, _OID, _BOOLEAN = (
    0x30, 0x31, 0x02, 0x03, 0x04, 0x06, 0x01)
_UTC_TIME, _GENERALIZED_TIME = 0x17, 0x18
_UTF8, _PRINTABLE, _TELETEX, _IA5, _UNIVERSAL, _BMP = 0x0C, 0x13, 0x14, 0x16, 0x1C, 0x1E

# OIDs as DER content bytes
OID_EC_PUBLIC_KEY = bytes.fromhex("2a8648ce3d0201")  # 1.2.840.10045.2.1
OID_PRIME256V1 = bytes.fromhex("2a8648ce3d030107")  # 1.2.840.10045.3.1.7
OID_ECDSA_SHA256 = bytes.fromhex("2a8648ce3d040302")  # 1.2.840.10045.4.3.2
_ECDSA_HASHES = {
    OID_ECDSA_SHA256: hashlib.sha256,
    bytes.fromhex("2a8648ce3d040303"): hashlib.sha384,
    bytes.fromhex("2a8648ce3d040304"): hashlib.sha512,
}
OID_COUNTRY = bytes.fromhex("550406")
OID_ORGANIZATION = bytes.fromhex("55040a")
OID_ORGANIZATIONAL_UNIT = bytes.fromhex("55040b")
OID_COMMON_NAME = bytes.fromhex("550403")
OID_BASIC_CONSTRAINTS = bytes.fromhex("551d13")
OID_KEY_USAGE = bytes.fromhex("551d0f")

_UTC = datetime.timezone.utc


# ---------------------------------------------------------------------------
# DER reader
# ---------------------------------------------------------------------------


def _tlv(buf: bytes, off: int, end: int) -> Tuple[int, int, int]:
    """(tag, content start, content end) of the element at `off`."""
    if off + 2 > end:
        raise X509Error("truncated element")
    tag = buf[off]
    if tag & 0x1F == 0x1F:
        raise X509Error("multi-byte tags are not supported")
    n = buf[off + 1]
    pos = off + 2
    if n >= 0x80:
        count = n & 0x7F
        if count == 0 or count > 4 or pos + count > end:
            raise X509Error("bad length")
        n = int.from_bytes(buf[pos:pos + count], "big")
        if buf[pos] == 0 or n < 0x80:
            raise X509Error("non-minimal length")
        pos += count
    if pos + n > end:
        raise X509Error("element runs past its container")
    return tag, pos, pos + n


def _children(buf: bytes, start: int, end: int) -> List[Tuple[int, int, int, int]]:
    """(tag, element start, content start, content end) of each child."""
    out = []
    off = start
    while off < end:
        tag, s, e = _tlv(buf, off, end)
        out.append((tag, off, s, e))
        off = e
    return out


def _expect(child, tag: int, what: str):
    if child[0] != tag:
        raise X509Error(f"{what}: expected tag {tag:#x}, got {child[0]:#x}")
    return child


def _integer(buf: bytes, s: int, e: int) -> int:
    content = buf[s:e]
    if not content:
        raise X509Error("empty INTEGER")
    if len(content) > 1 and (
        (content[0] == 0 and content[1] < 0x80) or (content[0] == 0xFF and content[1] >= 0x80)
    ):
        raise X509Error("INTEGER not minimally encoded")
    return int.from_bytes(content, "big", signed=True)


def _time(buf: bytes, child) -> datetime.datetime:
    tag, _, s, e = child
    text = buf[s:e].decode("ascii", "replace")
    if tag == _UTC_TIME and len(text) == 13 and text.endswith("Z") and text[:12].isdigit():
        year = int(text[:2])
        year += 1900 if year >= 50 else 2000
        rest = text[2:12]
    elif tag == _GENERALIZED_TIME and len(text) == 15 and text.endswith("Z") and text[:14].isdigit():
        year = int(text[:4])
        rest = text[4:14]
    else:
        raise X509Error(f"bad time {text!r}")
    mo, d, h, mi, sec = (int(rest[i:i + 2]) for i in range(0, 10, 2))
    try:
        return datetime.datetime(year, mo, d, h, mi, sec, tzinfo=_UTC)
    except ValueError as exc:
        raise X509Error(f"bad time {text!r}") from exc


def _string(buf: bytes, tag: int, s: int, e: int) -> str:
    raw = buf[s:e]
    codec = {_UTF8: "utf-8", _PRINTABLE: "ascii", _IA5: "ascii", _TELETEX: "latin-1",
             _BMP: "utf-16-be", _UNIVERSAL: "utf-32-be"}.get(tag)
    if codec is None:
        raise X509Error(f"unsupported string type {tag:#x}")
    try:
        return raw.decode(codec)
    except UnicodeDecodeError as exc:
        raise X509Error("bad string value") from exc


def _name_values(buf: bytes, s: int, e: int, oid: bytes) -> List[str]:
    """The values of attribute `oid` in a Name, in certificate order."""
    out = []
    for rdn in _children(buf, s, e):
        _expect(rdn, _SET, "RelativeDistinguishedName")
        for atv in _children(buf, rdn[2], rdn[3]):
            _expect(atv, _SEQUENCE, "AttributeTypeAndValue")
            parts = _children(buf, atv[2], atv[3])
            if len(parts) != 2:
                raise X509Error("AttributeTypeAndValue needs a type and a value")
            _expect(parts[0], _OID, "attribute type")
            if buf[parts[0][2]:parts[0][3]] == oid:
                out.append(_string(buf, parts[1][0], parts[1][2], parts[1][3]))
    return out


def _algorithm(buf: bytes, child) -> bytes:
    parts = _children(buf, child[2], child[3])
    if not parts:
        raise X509Error("empty AlgorithmIdentifier")
    return buf[_expect(parts[0], _OID, "algorithm")[2]:parts[0][3]]


def _bit_string(buf: bytes, child) -> bytes:
    _, _, s, e = _expect(child, _BIT_STRING, "BIT STRING")
    if s == e or buf[s] != 0:
        raise X509Error("BIT STRING with unused bits")
    return buf[s + 1:e]


def decode_point(raw: bytes) -> Tuple[int, int]:
    """A SEC1 P-256 point, uncompressed or compressed, checked on the curve."""
    if len(raw) == 65 and raw[0] == 4:
        pt = (int.from_bytes(raw[1:33], "big"), int.from_bytes(raw[33:], "big"))
    elif len(raw) == 33 and raw[0] in (2, 3):
        x = int.from_bytes(raw[1:], "big")
        if x >= p256.P:
            raise X509Error("point not on P-256")
        y = pow((x * x * x + p256.A * x + p256.B) % p256.P, (p256.P + 1) // 4, p256.P)
        if y & 1 != raw[0] & 1:
            y = p256.P - y
        pt = (x, y)
    else:
        raise X509Error("unsupported point encoding")
    if not p256.is_on_curve(pt):
        raise X509Error("point not on P-256")
    return pt


def _outer(data: bytes, what: str):
    tag, s, e = _tlv(data, 0, len(data))
    if tag != _SEQUENCE or e != len(data):
        raise X509Error(f"{what}: not one DER SEQUENCE")
    parts = _children(data, s, e)
    if len(parts) != 3:
        raise X509Error(f"{what}: expected TBS, algorithm and signature")
    return parts


@dataclass(frozen=True, eq=False)
class Certificate:
    der: bytes
    tbs: bytes
    serial: int
    signature_algorithm: bytes  # OID content bytes
    signature: bytes
    issuer: bytes  # the Name's DER
    subject: bytes
    not_before: datetime.datetime
    not_after: datetime.datetime
    public_key: Optional[Tuple[int, int]]  # None: not a P-256 key
    ou_values: Tuple[str, ...]

    @classmethod
    def from_der(cls, data: bytes) -> "Certificate":
        data = bytes(data)
        tbs_el, alg_el, sig_el = _outer(data, "Certificate")
        _expect(tbs_el, _SEQUENCE, "TBSCertificate")
        fields = _children(data, tbs_el[2], tbs_el[3])
        if fields and fields[0][0] == 0xA0:
            fields = fields[1:]
        if len(fields) < 6:
            raise X509Error("TBSCertificate is missing fields")
        serial_el, _alg, issuer_el, validity_el, subject_el, spki_el = fields[:6]
        serial = _integer(data, *_expect(serial_el, _INTEGER, "serial")[2:])
        _expect(issuer_el, _SEQUENCE, "issuer")
        _expect(subject_el, _SEQUENCE, "subject")
        validity = _children(data, *_expect(validity_el, _SEQUENCE, "validity")[2:])
        if len(validity) != 2:
            raise X509Error("validity needs two times")
        spki = _children(data, *_expect(spki_el, _SEQUENCE, "subjectPublicKeyInfo")[2:])
        if len(spki) != 2:
            raise X509Error("bad subjectPublicKeyInfo")
        alg = _children(data, *_expect(spki[0], _SEQUENCE, "key algorithm")[2:])
        key = None
        if (len(alg) == 2 and alg[0][0] == _OID and alg[1][0] == _OID
                and data[alg[0][2]:alg[0][3]] == OID_EC_PUBLIC_KEY
                and data[alg[1][2]:alg[1][3]] == OID_PRIME256V1):
            key = decode_point(_bit_string(data, spki[1]))
        return cls(
            der=data,
            tbs=data[tbs_el[1]:tbs_el[3]],
            serial=serial,
            signature_algorithm=_algorithm(data, _expect(alg_el, _SEQUENCE, "algorithm")),
            signature=_bit_string(data, sig_el),
            issuer=data[issuer_el[1]:issuer_el[3]],
            subject=data[subject_el[1]:subject_el[3]],
            not_before=_time(data, validity[0]),
            not_after=_time(data, validity[1]),
            public_key=key,
            ou_values=tuple(_name_values(data, subject_el[2], subject_el[3],
                                         OID_ORGANIZATIONAL_UNIT)),
        )

    def pem(self) -> bytes:
        return pem_encode("CERTIFICATE", self.der)


def verify_issued_by(cert: Certificate, issuer: Certificate) -> bool:
    """True iff `issuer`'s Name and P-256 key issued `cert` (see the module
    docstring for the rules)."""
    hash_fn = _ECDSA_HASHES.get(cert.signature_algorithm)
    if cert.issuer != issuer.subject or hash_fn is None or issuer.public_key is None:
        return False
    try:
        r, s = der.unmarshal_signature(cert.signature)
    except der.DerError:
        return False
    if der.marshal_signature(r, s) != cert.signature:
        return False
    return p256.verify_digest(issuer.public_key, hash_fn(cert.tbs).digest(), r, s)


def crl_revoked_serials(data: bytes) -> List[int]:
    """The serials a DER CertificateList revokes (its signature is not
    checked, as the JAX package's MSP does not check it)."""
    data = bytes(data)
    tbs_el, _alg, _sig = _outer(data, "CertificateList")
    fields = _children(data, *_expect(tbs_el, _SEQUENCE, "TBSCertList")[2:])
    if fields and fields[0][0] == _INTEGER:
        fields = fields[1:]
    if len(fields) < 3:
        raise X509Error("TBSCertList is missing fields")
    _expect(fields[0], _SEQUENCE, "signature")
    _expect(fields[1], _SEQUENCE, "issuer")
    _time(data, fields[2])
    rest = fields[3:]
    if rest and rest[0][0] in (_UTC_TIME, _GENERALIZED_TIME):
        _time(data, rest[0])
        rest = rest[1:]
    serials = []
    if rest and rest[0][0] == _SEQUENCE:
        for entry in _children(data, rest[0][2], rest[0][3]):
            parts = _children(data, *_expect(entry, _SEQUENCE, "revoked entry")[2:])
            if len(parts) < 2:
                raise X509Error("revoked entry needs a serial and a date")
            serials.append(_integer(data, *_expect(parts[0], _INTEGER, "serial")[2:]))
            _time(data, parts[1])
    return serials


# ---------------------------------------------------------------------------
# PEM
# ---------------------------------------------------------------------------


def pem_encode(label: str, data: bytes) -> bytes:
    body = base64.b64encode(data)
    lines = [body[i:i + 64] for i in range(0, len(body), 64)]
    return (f"-----BEGIN {label}-----\n".encode() + b"".join(ln + b"\n" for ln in lines)
            + f"-----END {label}-----\n".encode())


def pem_decode(label: str, data: bytes) -> bytes:
    """The DER of the first `label` block in `data`."""
    begin = f"-----BEGIN {label}-----".encode()
    end = f"-----END {label}-----".encode()
    start = bytes(data).find(begin)
    if start < 0:
        raise X509Error(f"no {label} PEM block")
    stop = data.find(end, start)
    if stop < 0:
        raise X509Error(f"unterminated {label} PEM block")
    body = b"".join(data[start + len(begin):stop].split())
    try:
        return base64.b64decode(body, validate=True)
    except binascii.Error as exc:
        raise X509Error("bad base64 in PEM block") from exc


def load_pem_certificate(data: bytes) -> Certificate:
    return Certificate.from_der(pem_decode("CERTIFICATE", data))


def load_pem_crl(data: bytes) -> List[int]:
    return crl_revoked_serials(pem_decode("X509 CRL", data))


# ---------------------------------------------------------------------------
# DER writer (msp/cryptogen's certificates and CRLs)
# ---------------------------------------------------------------------------


def _enc(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        head = bytes([n])
    else:
        body = n.to_bytes((n.bit_length() + 7) // 8, "big")
        head = bytes([0x80 | len(body)]) + body
    return bytes([tag]) + head + content


def _enc_seq(*items: bytes) -> bytes:
    return _enc(_SEQUENCE, b"".join(items))


def _enc_int(v: int) -> bytes:
    return _enc(_INTEGER, v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big", signed=True))


def _enc_time(t: datetime.datetime) -> bytes:
    t = t.astimezone(_UTC)
    if t.year < 2050:  # RFC 5280 4.1.2.5: UTCTime through 2049
        return _enc(_UTC_TIME, t.strftime("%y%m%d%H%M%SZ").encode())
    return _enc(_GENERALIZED_TIME, t.strftime("%Y%m%d%H%M%SZ").encode())


def encode_name(common_name: str, org: str, ou: Optional[str] = None) -> bytes:
    """C=US, O=org[, OU=ou], CN=common_name: the Name `msp/cryptogen` writes,
    with the string types `cryptography` gives these attributes."""
    attrs = [(OID_COUNTRY, _enc(_PRINTABLE, b"US")),
             (OID_ORGANIZATION, _enc(_UTF8, org.encode()))]
    if ou:
        attrs.append((OID_ORGANIZATIONAL_UNIT, _enc(_UTF8, ou.encode())))
    attrs.append((OID_COMMON_NAME, _enc(_UTF8, common_name.encode())))
    return _enc_seq(*(_enc(_SET, _enc_seq(_enc(_OID, oid), value)) for oid, value in attrs))


def basic_constraints(ca: bool) -> Tuple[bytes, bool, bytes]:
    return OID_BASIC_CONSTRAINTS, True, _enc_seq(_enc(_BOOLEAN, b"\xff") if ca else b"")


def ca_key_usage() -> Tuple[bytes, bool, bytes]:
    """KeyUsage: digitalSignature, keyCertSign, cRLSign, critical."""
    return OID_KEY_USAGE, True, _enc(_BIT_STRING, b"\x01\x86")


Signer = Callable[[bytes], bytes]  # TBS bytes -> DER ECDSA signature


def _signed(tbs: bytes, sign: Signer) -> bytes:
    alg = _enc_seq(_enc(_OID, OID_ECDSA_SHA256))
    return _enc_seq(tbs, alg, _enc(_BIT_STRING, b"\x00" + sign(tbs)))


def build_certificate(
    serial: int,
    issuer: bytes,
    subject: bytes,
    not_before: datetime.datetime,
    not_after: datetime.datetime,
    public_key: Tuple[int, int],
    extensions: Sequence[Tuple[bytes, bool, bytes]],
    sign: Signer,
) -> bytes:
    """A v3 certificate signed with ecdsa-with-SHA256; returns its DER."""
    spki = _enc_seq(
        _enc_seq(_enc(_OID, OID_EC_PUBLIC_KEY), _enc(_OID, OID_PRIME256V1)),
        _enc(_BIT_STRING, b"\x00" + p256.pubkey_to_bytes(public_key)),
    )
    exts = b"".join(
        _enc_seq(_enc(_OID, oid), _enc(_BOOLEAN, b"\xff") if critical else b"",
                 _enc(_OCTET_STRING, value))
        for oid, critical, value in extensions
    )
    tbs = _enc_seq(
        _enc(0xA0, _enc_int(2)),
        _enc_int(serial),
        _enc_seq(_enc(_OID, OID_ECDSA_SHA256)),
        issuer,
        _enc_seq(_enc_time(not_before), _enc_time(not_after)),
        subject,
        spki,
        _enc(0xA3, _enc_seq(exts)) if extensions else b"",
    )
    return _signed(tbs, sign)


def build_crl(
    issuer: bytes,
    last_update: datetime.datetime,
    next_update: datetime.datetime,
    revoked: Sequence[Tuple[int, datetime.datetime]],
    sign: Signer,
) -> bytes:
    """A v2 CRL signed with ecdsa-with-SHA256; returns its DER."""
    entries = b"".join(_enc_seq(_enc_int(serial), _enc_time(when)) for serial, when in revoked)
    tbs = _enc_seq(
        _enc_int(1),
        _enc_seq(_enc(_OID, OID_ECDSA_SHA256)),
        issuer,
        _enc_time(last_update),
        _enc_time(next_update),
        _enc_seq(entries) if revoked else b"",
    )
    return _signed(tbs, sign)
