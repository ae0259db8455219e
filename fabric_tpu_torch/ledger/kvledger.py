"""The state half of the ledger's commit path, and the commit hash.

The port's counterpart of the JAX package's `ledger/kvledger`:
`encode_order_preserving_varuint64`, `version_to_bytes`, `_proto_varint`
and `deterministic_update_bytes` (over the port's wire codec, byte for byte
protobuf's), and `commit_block_state`, which does for one block what
`KVLedger.commit` and `_commit_state` (non-persistent branch) do to the
state: MVCC validate-and-prepare through the given validator, the codes
merged into the TRANSACTIONS_FILTER flags, the commit hash chained
(kv_ledger.go addBlockCommitHash)

    commit_hash = SHA-256(varint(len(filter)) || filter || update bytes || previous hash)

then the history entries and the state DB apply. The block store, private
data, collection-config history, fault points and the state mirror are not
ported yet.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from fabric_tpu_torch.common.txflags import TxValidationCode, ValidationFlags
from fabric_tpu_torch.ledger.rwset import Version
from fabric_tpu_torch.ledger.statedb import HashedUpdateBatch, UpdateBatch
from fabric_tpu_torch.ledger.txparse import parse_tx_rwset
from fabric_tpu_torch.protos import wire


def encode_order_preserving_varuint64(n: int) -> bytes:
    """reference common/ledger/util EncodeOrderPreservingVarUint64:
    [num-significant-bytes][big-endian significant bytes]."""
    be = n.to_bytes(8, "big")
    stripped = be.lstrip(b"\x00")
    return bytes([len(stripped)]) + stripped


def version_to_bytes(v: Version) -> bytes:
    return encode_order_preserving_varuint64(v.block_num) + encode_order_preserving_varuint64(
        v.tx_num
    )


def _proto_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def deterministic_update_bytes(updates: UpdateBatch, hashed: HashedUpdateBatch) -> bytes:
    """txmgr deterministicBytesForPubAndHashUpdates: namespaces sorted,
    public writes then collections (sorted), keys sorted; namespace/
    collection fields set only on the first entry of each group; the empty
    namespace (channel config) is skipped. Metadata is not part of the
    commit hash (reference update_batch_bytes.go serializes value writes
    only)."""
    pub_by_ns: Dict[str, Dict[str, Tuple[Optional[bytes], Version]]] = {}
    for (ns, key), entry in updates.items():
        pub_by_ns.setdefault(ns, {})[key] = (entry.value, entry.version)
    hashed_by_ns: Dict[str, Dict[str, Dict[bytes, Tuple[Optional[bytes], Version]]]] = {}
    for (ns, coll, key_hash), entry in hashed.items():
        hashed_by_ns.setdefault(ns, {}).setdefault(coll, {})[key_hash] = (
            entry.value,
            entry.version,
        )

    kvwrites: List[dict] = []
    for ns in sorted(set(pub_by_ns) | set(hashed_by_ns)):
        if ns == "":
            continue
        group: List[dict] = []

        def add(key: bytes, value: Optional[bytes], version: Version, coll: str = ""):
            # `coll` is set only on the first entry of a collection group
            group.append({
                "collection": coll.encode(),
                "key": key,
                "isDelete": value is None,
                "value": value,
                "version_bytes": version_to_bytes(version),
            })

        for key in sorted(pub_by_ns.get(ns, {})):
            value, version = pub_by_ns[ns][key]
            add(key.encode(), value, version)
        for coll in sorted(hashed_by_ns.get(ns, {})):
            for j, key_hash in enumerate(sorted(hashed_by_ns[ns][coll])):
                vh, version = hashed_by_ns[ns][coll][key_hash]
                add(key_hash, vh, version, coll=coll if j == 0 else "")
        if group:
            group[0]["namespace"] = ns.encode()
        kvwrites += group
    return wire.encode(wire.UPDATES, {"kvwrites": kvwrites})


class CommittedBlock(NamedTuple):
    flags: ValidationFlags
    updates: UpdateBatch
    hashed: HashedUpdateBatch
    commit_hash: bytes


def commit_block_state(
    validator,
    block_num: int,
    rwset_bytes: Sequence[Optional[bytes]],
    incoming_codes: Sequence[TxValidationCode],
    previous_commit_hash: bytes,
    history: Optional[Dict[Tuple[str, str], List[Version]]] = None,
) -> CommittedBlock:
    """Validate, hash and apply one block's state updates.

    `validator` is an `mvcc.Validator`, `mvcc_device.DeviceValidator` or
    `ResidentDeviceValidator` over the state DB it applies to.
    `rwset_bytes[i]` is tx i's TxReadWriteSet bytes, or None for a tx
    without one. Bytes that do not parse make an arriving-VALID tx
    BAD_RWSET, as the JAX package's transaction parse does
    (txparse.py:375-378). `history`, when given, gets each committed
    public write's version appended, as the non-persistent ledger's
    history does."""
    incoming = [TxValidationCode(int(c)) for c in incoming_codes]
    if len(incoming) != len(rwset_bytes):
        raise ValueError("one incoming code per transaction is required")
    rwsets = []
    for i, raw in enumerate(rwset_bytes):
        if raw is None:
            rwsets.append(None)
            continue
        try:
            rwsets.append(parse_tx_rwset(raw))
        except ValueError:
            rwsets.append(None)
            if incoming[i] == TxValidationCode.VALID:
                incoming[i] = TxValidationCode.BAD_RWSET
    codes, updates, hashed = validator.validate_and_prepare_batch(block_num, rwsets, incoming)
    flags = ValidationFlags(len(codes))
    for i, code in enumerate(codes):
        flags.set_flag(i, code)
    filter_bytes = flags.tobytes()
    commit_hash = hashlib.sha256(
        _proto_varint(len(filter_bytes))
        + filter_bytes
        + deterministic_update_bytes(updates, hashed)
        + previous_commit_hash
    ).digest()
    if history is not None:
        for (ns, key), entry in updates.items():
            history.setdefault((ns, key), []).append(entry.version)
    validator.db.apply_updates(updates, hashed)
    return CommittedBlock(flags, updates, hashed, commit_hash)
