"""ECDSA signature DER codec with Go encoding/asn1 parse semantics.

The reference unmarshals signatures with Go's asn1.Unmarshal into
struct{R, S *big.Int} and then requires R > 0 and S > 0
(bccsp/utils/ecdsa.go UnmarshalECDSASignature). To be bit-exact on the
accept/reject decision we replicate Go's quirks precisely:

- definite lengths only; long-form lengths must be minimal, and short
  lengths must use the short form ("non-minimal length" errors);
- INTEGER contents must be minimally encoded two's complement
  ("integer not minimally-encoded");
- negative integers parse fine at the ASN.1 layer but are rejected by the
  R.Sign()/S.Sign() checks;
- extra bytes at the end of the SEQUENCE are ALLOWED (Go tolerates them
  for compatibility with old x509 implementations);
- trailing bytes after the SEQUENCE are ignored (Unmarshal returns `rest`
  and the reference drops it).
"""

from __future__ import annotations

from typing import Tuple


class DerError(ValueError):
    """Raised when a signature fails to parse the way Go's asn1 would fail."""


def _parse_length(data: bytes, off: int) -> Tuple[int, int]:
    """Parse a BER/DER length at data[off]; returns (length, new_offset)."""
    if off >= len(data):
        raise DerError("truncated length")
    b = data[off]
    off += 1
    if b & 0x80 == 0:
        return b, off
    num = b & 0x7F
    if num == 0:
        raise DerError("indefinite length found (not DER)")
    length = 0
    for _ in range(num):
        if off >= len(data):
            raise DerError("truncated length")
        if length >= 1 << 23:
            raise DerError("length too large")
        length = (length << 8) | data[off]
        if length == 0:
            raise DerError("superfluous leading zeros in length")
        off += 1
    if length < 0x80:
        raise DerError("non-minimal length")
    return length, off


def _parse_int(data: bytes, off: int, end: int) -> Tuple[int, int]:
    """Parse one ASN.1 INTEGER element; returns (value, new_offset)."""
    if off >= end:
        raise DerError("truncated element")
    if data[off] != 0x02:  # universal, primitive, INTEGER
        raise DerError("expected INTEGER tag")
    length, off = _parse_length(data, off + 1)
    if off + length > end:
        raise DerError("integer overruns sequence")
    content = data[off : off + length]
    if len(content) == 0:
        raise DerError("empty integer")
    if len(content) > 1 and (
        (content[0] == 0x00 and content[1] & 0x80 == 0)
        or (content[0] == 0xFF and content[1] & 0x80 == 0x80)
    ):
        raise DerError("integer not minimally-encoded")
    value = int.from_bytes(content, "big", signed=True)
    return value, off + length


def unmarshal_signature(raw: bytes) -> Tuple[int, int]:
    """Parse (r, s) with reference semantics; raises DerError on reject.

    Mirrors bccsp/utils/ecdsa.go UnmarshalECDSASignature: after ASN.1
    parsing, R and S must be strictly positive.
    """
    if len(raw) == 0:
        raise DerError("empty signature")
    if raw[0] != 0x30:  # universal, constructed, SEQUENCE
        raise DerError("expected SEQUENCE tag")
    seq_len, off = _parse_length(raw, 1)
    end = off + seq_len
    if end > len(raw):
        raise DerError("sequence overruns input")
    r, off = _parse_int(raw, off, end)
    s, off = _parse_int(raw, off, end)
    # Extra bytes inside the SEQUENCE and after it are tolerated (Go quirk).
    if r <= 0:
        raise DerError("invalid signature, R must be larger than zero")
    if s <= 0:
        raise DerError("invalid signature, S must be larger than zero")
    return r, s


def _encode_int(v: int) -> bytes:
    if v == 0:
        return b"\x02\x01\x00"
    nbytes = (v.bit_length() + 8) // 8  # room for sign bit
    content = v.to_bytes(nbytes, "big")
    if len(content) > 1 and content[0] == 0 and content[1] & 0x80 == 0:
        content = content[1:]
    return b"\x02" + _encode_len(len(content)) + content


def _encode_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def marshal_signature(r: int, s: int) -> bytes:
    """DER-encode (r, s) the way Go asn1.Marshal does for positive ints."""
    if r < 0 or s < 0:
        raise ValueError("r and s must be non-negative")
    body = _encode_int(r) + _encode_int(s)
    return b"\x30" + _encode_len(len(body)) + body
