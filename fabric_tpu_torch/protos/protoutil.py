"""Proto helpers of the reference's protoutil package, over the wire codec.

The port's counterpart of the JAX package's `protos/protoutil.py`. Messages
are dicts in `wire.decode`'s form (`protos/fabric.py` has their schemas); a
block is `{"header": {...}, "data": {"data": [...]}, "metadata":
{"metadata": [...]}}`, and `marshal(fabric.BLOCK, block)` gives the bytes
protobuf's `Block.SerializeToString()` gives for the same block.

- TxID = hex(SHA-256(nonce || creator))                  (proputils.go:357)
- BlockHeaderHash = SHA-256(ASN.1-DER(SEQUENCE{number INTEGER,
  previous_hash OCTET STRING, data_hash OCTET STRING})) (blockutils.go:60)
- BlockDataHash = SHA-256(concat(data...))               (blockutils.go:65)
"""

from __future__ import annotations

import hashlib

from fabric_tpu_torch.protos import fabric, wire


def compute_tx_id(nonce: bytes, creator: bytes) -> str:
    return hashlib.sha256(nonce + creator).hexdigest()


def check_tx_id(tx_id: str, nonce: bytes, creator: bytes) -> bool:
    """reference protoutil.CheckTxID (proputils.go:368)."""
    return tx_id == compute_tx_id(nonce, creator)


# --- minimal DER encoder for the block-header triple -----------------------


def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _der_integer(v: int) -> bytes:
    # two's-complement minimal encoding, matching Go asn1.Marshal of *big.Int
    if v == 0:
        content = b"\x00"
    elif v > 0:
        content = v.to_bytes((v.bit_length() + 8) // 8, "big")
        if len(content) > 1 and content[0] == 0 and content[1] & 0x80 == 0:
            content = content[1:]
    else:
        raise ValueError("negative block numbers do not occur")
    return b"\x02" + _der_len(len(content)) + content


def _der_octet_string(b: bytes) -> bytes:
    return b"\x04" + _der_len(len(b)) + b


def block_header_bytes(header: dict) -> bytes:
    """The DER of a block header dict (absent fields are proto3 defaults)."""
    body = (
        _der_integer(header.get("number", 0))
        + _der_octet_string(header.get("previous_hash", b""))
        + _der_octet_string(header.get("data_hash", b""))
    )
    return b"\x30" + _der_len(len(body)) + body


def block_header_hash(header: dict) -> bytes:
    return hashlib.sha256(block_header_bytes(header)).digest()


def block_data_hash(data: dict) -> bytes:
    return hashlib.sha256(b"".join(data.get("data", ()))).digest()


# --- block assembly --------------------------------------------------------


def new_block(number: int, previous_hash: bytes) -> dict:
    block = {
        "header": {"number": number, "previous_hash": previous_hash},
        "data": {"data": []},
    }
    init_block_metadata(block)
    return block


def init_block_metadata(block: dict) -> None:
    """Ensure the metadata array covers all BlockMetadataIndex slots
    (reference protoutil.InitBlockMetadata)."""
    slots = block.setdefault("metadata", {}).setdefault("metadata", [])
    while len(slots) < fabric.BLOCK_METADATA_SLOTS:
        slots.append(b"")


def seal_block(block: dict) -> dict:
    block["header"]["data_hash"] = block_data_hash(block["data"])
    return block


def make_signature_header(creator: bytes, nonce: bytes) -> dict:
    return {"creator": creator, "nonce": nonce}


def make_channel_header(header_type: int, channel_id: str, tx_id: str = "",
                        extension: bytes = b"") -> dict:
    return {"type": header_type, "channel_id": channel_id, "tx_id": tx_id, "extension": extension}


def serialize_identity(mspid: str, cert_pem: bytes) -> bytes:
    return wire.encode(fabric.SERIALIZED_IDENTITY, {"mspid": mspid, "id_bytes": cert_pem})


def get_envelope_from_block_data(data: bytes) -> dict:
    return wire.decode(fabric.ENVELOPE, data)


def unmarshal(schema: wire.Schema, raw: bytes) -> dict:
    """Parse or raise `wire.WireError`, a ValueError (the Go-style
    unmarshal-with-error wrapper)."""
    return wire.decode(schema, raw)


def unmarshal_as(schema: wire.Schema, raw: bytes, full_name: str) -> dict:
    """`unmarshal`, raising ValueError with the text the JAX package's
    `protoutil.unmarshal` gives for the same bytes: "error unmarshalling
    <Name>: Error parsing message with type '<full_name>'" (protobuf's
    parse error names the message's full name, e.g. "common.Block")."""
    try:
        return wire.decode(schema, raw)
    except wire.WireError as e:
        short = full_name.rsplit(".", 1)[-1]
        raise ValueError(f"error unmarshalling {short}: Error parsing message with type "
                         f"'{full_name}'") from e
