"""Proto3 wire format for the port's messages, without protobuf.

The port's paths run where no protobuf runtime is installed, so the few
messages they read and write are described as tables (field number ->
`Field`) and one reader and one writer walk them. The tables here follow the
JAX package's `protos/src/{kv_rwset,rwset,txmgr_updates}.proto`; those of
`idemix.proto` are in `protos/idemix.py`, and those of the block, transaction,
MSP and policy messages in `protos/fabric.py`.

A decoded message is a dict that holds only the fields present on the wire:
a scalar or string under its name (read it with `.get(name, default)`), a
repeated field as a list, an embedded message as a dict. The key of an
embedded message is present whenever the message was on the wire, even
empty, which keeps proto's `HasField`.

Decoding follows the protobuf runtime (upb), which the CPU tests hold it to:

- unknown fields are skipped, groups included, and so is a known field that
  arrives with another wire type than its own;
- an int32 or int64 field is two's complement: a negative value arrives as
  a 10-byte varint, and an int32 keeps the low 32 bits of what it reads;
- a singular scalar, string or bytes field keeps its last value; a repeated
  field appends; a singular message that appears twice is merged, field by
  field; a member of a oneof, scalar or message, replaces the other members,
  and a message member merges only with itself;
- truncated input, a varint longer than 10 bytes, a tag longer than 5 bytes
  or above 2^32 - 1, field number 0, wire types 6 and 7, an unmatched group
  end, messages and groups nested more than 100 deep, and a string field
  that is not UTF-8 raise `WireError`.

`decode(..., keep_unknown=True)` keeps what it skips, in arrival order, as
bytes under the key `UNKNOWN` of the message's dict (and of every embedded
message's), as protobuf keeps unknown fields; `encode` writes them after the
known fields, where `SerializeToString` writes them, so a message that is
parsed and serialized again comes out as protobuf's does.

A repeated field of a varint kind (`uint64`, `int32`, `bool`, `enum`, ...)
is written packed, as proto3 writes it: one length-delimited record of the
varints, left out when the list is empty. The reader takes both forms, packed
records and single varints, in any mix, as protobuf does.

A `map<K, V>` field (`_map`) is a repeated entry message with the key as
field 1 and the value as field 2. It decodes to a dict {key: value}; a key
that arrives twice keeps its last value, as upb keeps it (a message value is
replaced, not merged), and an entry that lacks its key or value takes the
default (0, empty string or bytes, an empty message).

Encoding writes what protobuf's `SerializeToString(deterministic=True)`
writes for the same message: fields in field-number order, a map's entries
in upb's order of their keys (`_map_key_order`: a string key by its UTF-8
bytes, a key that is a prefix of another after it; an integer key from the
largest down), each entry with its key
and its value written even where they are the default, as upb writes them
(an empty string key as `0a 00`, an empty message value as `12 00`), proto3
defaults (0, false, empty string or bytes) left out of singular fields but
not out of a oneof's member that is present, a negative int32 or int64 as
the 10-byte varint of its two's complement, embedded messages whenever
present (an empty dict writes an empty but present message), every element
of a repeated field.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1

# the key of a decoded message's unknown fields (decode's keep_unknown)
UNKNOWN = "__unknown__"

_VARINT_KINDS = frozenset(("uint64", "uint32", "int64", "int32", "bool", "enum"))
# protobuf's nesting limit: embedded messages and groups together
_MAX_DEPTH = 100


class WireError(ValueError):
    """Malformed proto wire bytes (protobuf's DecodeError)."""


class Field(NamedTuple):
    name: str
    kind: str  # uint64, uint32, int64, int32, bool, enum, string, bytes, message or map
    repeated: bool = False
    message: Optional[Dict[int, "Field"]] = None
    oneof: Optional[str] = None

    @property
    def wire_type(self) -> int:
        return _VARINT if self.kind in _VARINT_KINDS else _LEN


Schema = Dict[int, Field]


def _msg(name: str, schema: Schema, repeated: bool = False, oneof: Optional[str] = None) -> Field:
    return Field(name, "message", repeated, schema, oneof)


def _map(name: str, key_kind: str, value: Field) -> Field:
    """A `map<key_kind, value>` field; `value` is the entry's field 2 (its
    name is not used), a scalar kind or a message."""
    return Field(name, "map", False, {1: Field("key", key_kind), 2: value._replace(name="value")})


_DEFAULTS = {"string": "", "bytes": b"", "bool": False}


def _default(field: Field):
    if field.kind == "message":
        return {}
    return _DEFAULTS.get(field.kind, 0)


# kvrwset (kv_rwset.proto)
VERSION: Schema = {1: Field("block_num", "uint64"), 2: Field("tx_num", "uint64")}
KV_READ: Schema = {1: Field("key", "string"), 2: _msg("version", VERSION)}
KV_WRITE: Schema = {
    1: Field("key", "string"),
    2: Field("is_delete", "bool"),
    3: Field("value", "bytes"),
}
KV_METADATA_ENTRY: Schema = {1: Field("name", "string"), 2: Field("value", "bytes")}
KV_METADATA_WRITE: Schema = {
    1: Field("key", "string"),
    2: _msg("entries", KV_METADATA_ENTRY, repeated=True),
}
QUERY_READS: Schema = {1: _msg("kv_reads", KV_READ, repeated=True)}
QUERY_READS_MERKLE_SUMMARY: Schema = {
    1: Field("max_degree", "uint32"),
    2: Field("max_level", "uint32"),
    3: Field("max_level_hashes", "bytes", repeated=True),
}
RANGE_QUERY_INFO: Schema = {
    1: Field("start_key", "string"),
    2: Field("end_key", "string"),
    3: Field("itr_exhausted", "bool"),
    4: _msg("raw_reads", QUERY_READS, oneof="reads_info"),
    5: _msg("reads_merkle_hashes", QUERY_READS_MERKLE_SUMMARY, oneof="reads_info"),
}
KV_RWSET: Schema = {
    1: _msg("reads", KV_READ, repeated=True),
    2: _msg("range_queries_info", RANGE_QUERY_INFO, repeated=True),
    3: _msg("writes", KV_WRITE, repeated=True),
    4: _msg("metadata_writes", KV_METADATA_WRITE, repeated=True),
}
KV_READ_HASH: Schema = {1: Field("key_hash", "bytes"), 2: _msg("version", VERSION)}
KV_WRITE_HASH: Schema = {
    1: Field("key_hash", "bytes"),
    2: Field("is_delete", "bool"),
    3: Field("value_hash", "bytes"),
}
KV_METADATA_WRITE_HASH: Schema = {
    1: Field("key_hash", "bytes"),
    2: _msg("entries", KV_METADATA_ENTRY, repeated=True),
}
HASHED_RWSET: Schema = {
    1: _msg("hashed_reads", KV_READ_HASH, repeated=True),
    2: _msg("hashed_writes", KV_WRITE_HASH, repeated=True),
    3: _msg("metadata_writes", KV_METADATA_WRITE_HASH, repeated=True),
}

# rwset (rwset.proto)
COLLECTION_HASHED_RWSET: Schema = {
    1: Field("collection_name", "string"),
    2: Field("hashed_rwset", "bytes"),
    3: Field("pvt_rwset_hash", "bytes"),
}
NS_RWSET: Schema = {
    1: Field("namespace", "string"),
    2: Field("rwset", "bytes"),
    3: _msg("collection_hashed_rwset", COLLECTION_HASHED_RWSET, repeated=True),
}
TX_RWSET: Schema = {
    1: Field("data_model", "enum"),
    2: _msg("ns_rwset", NS_RWSET, repeated=True),
}
COLLECTION_PVT_RWSET: Schema = {1: Field("collection_name", "string"), 2: Field("rwset", "bytes")}
NS_PVT_RWSET: Schema = {
    1: Field("namespace", "string"),
    2: _msg("collection_pvt_rwset", COLLECTION_PVT_RWSET, repeated=True),
}
TX_PVT_RWSET: Schema = {
    1: Field("data_model", "enum"),
    2: _msg("ns_pvt_rwset", NS_PVT_RWSET, repeated=True),
}

# txmgr (txmgr_updates.proto): the commit hash's update bytes
TXMGR_KV_WRITE: Schema = {
    1: Field("namespace", "bytes"),
    2: Field("collection", "bytes"),
    3: Field("key", "bytes"),
    4: Field("isDelete", "bool"),
    5: Field("value", "bytes"),
    6: Field("version_bytes", "bytes"),
}
UPDATES: Schema = {1: _msg("kvwrites", TXMGR_KV_WRITE, repeated=True)}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def _varint(buf: bytes, pos: int, end: int):
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise WireError("varint longer than 10 bytes")


def _tag(buf: bytes, pos: int, end: int):
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise WireError("truncated tag")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
        if shift >= 35:
            raise WireError("tag longer than 5 bytes")
    if result > _MASK32:
        raise WireError("tag above 2^32 - 1")
    number, wire_type = result >> 3, result & 7
    if number == 0:
        raise WireError("field number 0")
    return number, wire_type, pos


def _length(buf: bytes, pos: int, end: int):
    n, pos = _varint(buf, pos, end)
    if n > end - pos:
        raise WireError("length-delimited field runs past its message")
    return pos + n, pos


def _skip(buf: bytes, pos: int, end: int, number: int, wire_type: int, depth: int) -> int:
    """Skip one field whose tag was just read; returns the position after it."""
    if wire_type == _VARINT:
        return _varint(buf, pos, end)[1]
    if wire_type == _I64 or wire_type == _I32:
        pos += 8 if wire_type == _I64 else 4
        if pos > end:
            raise WireError("truncated fixed-width field")
        return pos
    if wire_type == _LEN:
        return _length(buf, pos, end)[0]
    if wire_type == _SGROUP:
        if depth >= _MAX_DEPTH:
            raise WireError("groups nested too deep")
        while True:
            inner, inner_type, pos = _tag(buf, pos, end)
            if inner_type == _EGROUP:
                if inner != number:
                    raise WireError("group end does not match its start")
                return pos
            pos = _skip(buf, pos, end, inner, inner_type, depth + 1)
    if wire_type == _EGROUP:
        raise WireError("group end without a start")
    raise WireError(f"invalid wire type {wire_type}")


def _varint_value(kind: str, value: int):
    """A decoded varint as the value of a field of `kind`."""
    if kind == "bool":
        return value != 0
    if kind == "int64":
        return value - ((value >> 63) << 64)
    if kind == "int32":
        value &= _MASK32
        return value - ((value >> 31) << 32)
    if kind != "uint64":
        return value & _MASK32
    return value


def _decode_into(schema: Schema, buf: bytes, pos: int, end: int, out: dict, depth: int,
                 keep: bool = False) -> None:
    while pos < end:
        start = pos
        number, wire_type, pos = _tag(buf, pos, end)
        field = schema.get(number)
        if (field is not None and field.repeated and wire_type == _LEN
                and field.kind in _VARINT_KINDS):
            stop, pos = _length(buf, pos, end)
            values = out.setdefault(field.name, [])
            while pos < stop:
                value, pos = _varint(buf, pos, stop)
                values.append(_varint_value(field.kind, value))
            continue
        if field is None or wire_type != field.wire_type:
            pos = _skip(buf, pos, end, number, wire_type, depth)
            if keep:
                out[UNKNOWN] = out.get(UNKNOWN, b"") + buf[start:pos]
            continue
        kind = field.kind
        if wire_type == _VARINT:
            value, pos = _varint(buf, pos, end)
            value = _varint_value(kind, value)
        else:
            stop, pos = _length(buf, pos, end)
            if kind == "map":
                if depth >= _MAX_DEPTH:
                    raise WireError("messages nested too deep")
                entry: dict = {}
                _decode_into(field.message, buf, pos, stop, entry, depth + 1, keep)
                pos = stop
                key_f, value_f = field.message[1], field.message[2]
                key = entry.get("key", _default(key_f))
                out.setdefault(field.name, {})[key] = entry.get("value", _default(value_f))
                continue
            if kind == "message":
                if field.repeated:
                    value = {}
                else:
                    value = out.get(field.name)
                    if value is None:
                        if field.oneof is not None:
                            for other in schema.values():
                                if other.oneof == field.oneof:
                                    out.pop(other.name, None)
                        value = {}
                        out[field.name] = value
                if depth >= _MAX_DEPTH:
                    raise WireError("messages nested too deep")
                _decode_into(field.message, buf, pos, stop, value, depth + 1, keep)
                pos = stop
                if field.repeated:
                    out.setdefault(field.name, []).append(value)
                continue
            value = buf[pos:stop]
            pos = stop
            if kind == "string":
                try:
                    value = value.decode("utf-8")
                except UnicodeDecodeError as exc:
                    raise WireError(f"field {field.name} is not UTF-8") from exc
        if field.repeated:
            out.setdefault(field.name, []).append(value)
        else:
            if field.oneof is not None:
                for other in schema.values():
                    if other.oneof == field.oneof:
                        out.pop(other.name, None)
            out[field.name] = value


def decode(schema: Schema, data: bytes, keep_unknown: bool = False) -> dict:
    """Parse `data` as the message `schema` describes, or raise WireError;
    with `keep_unknown`, each message keeps its unknown fields' bytes under
    `UNKNOWN`."""
    buf = bytes(data)
    out: dict = {}
    _decode_into(schema, buf, 0, len(buf), out, 0, keep_unknown)
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _put_varint(out: bytearray, n: int) -> None:
    n &= _MASK64
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _put_field(out: bytearray, number: int, field: Field, v) -> None:
    """One occurrence of `field`, written even where `v` is the default."""
    if field.kind == "message":
        body = bytearray()
        _encode_into(field.message, v, body)
        _put_varint(out, number << 3 | _LEN)
        _put_varint(out, len(body))
        out += body
    elif field.wire_type == _VARINT:
        _put_varint(out, number << 3 | _VARINT)
        _put_varint(out, int(v))
    else:
        raw = v.encode("utf-8") if field.kind == "string" else bytes(v)
        _put_varint(out, number << 3 | _LEN)
        _put_varint(out, len(raw))
        out += raw


def _map_key_order(item):
    """upb's order of map keys: a string key by its UTF-8 bytes, except that
    a key that is a prefix of another comes after it (upb compares the
    common prefix, then puts the longer key first: "ab", "a", then ""), and
    an integer key in descending order."""
    key = item[0]
    if isinstance(key, str):
        return (*key.encode("utf-8"), 256)
    return -key  # an integer key: upb writes the largest first


def _encode_into(schema: Schema, msg: dict, out: bytearray) -> None:
    for number in sorted(schema):
        field = schema[number]
        value = msg.get(field.name)
        if value is None:
            continue
        if field.kind == "map":
            key_f, value_f = field.message[1], field.message[2]
            for key, v in sorted(value.items(), key=_map_key_order):
                body = bytearray()
                _put_field(body, 1, key_f, key)
                _put_field(body, 2, value_f, v)
                _put_varint(out, number << 3 | _LEN)
                _put_varint(out, len(body))
                out += body
            continue
        if field.repeated and field.kind in _VARINT_KINDS:
            if value:
                body = bytearray()
                for v in value:
                    _put_varint(body, int(v))
                _put_varint(out, number << 3 | _LEN)
                _put_varint(out, len(body))
                out += body
            continue
        values: List = value if field.repeated else [value]
        for v in values:
            if (field.kind != "message" and not v and not field.repeated
                    and field.oneof is None):
                continue  # a proto3 default of a singular scalar field
            _put_field(out, number, field, v)
    out += msg.get(UNKNOWN, b"")


def encode(schema: Schema, msg: dict) -> bytes:
    """Serialize `msg` (a dict in `decode`'s form) byte for byte as protobuf would."""
    out = bytearray()
    _encode_into(schema, msg, out)
    return bytes(out)
