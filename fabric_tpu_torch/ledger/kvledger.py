"""Per-channel ledger: commit orchestration (reference
core/ledger/kvledger/kv_ledger.go:596-680 + lockbased_txmgr.go).

The port's counterpart of the JAX package's `ledger/kvledger`. Commit path
per block (`KVLedger.commit`):

1. MVCC validate-and-prepare against committed state and in-block writes,
   through `mvcc.Validator` or, with `device_mvcc`, through
   `mvcc_device.DeviceValidator` (K5 on the card), built per block as the
   JAX ledger builds its own;
2. the private-data batch, hash-checked against the on-block hashed writes;
3. the commit hash chained (kv_ledger.go addBlockCommitHash)

       commit_hash = SHA-256(varint(len(filter)) || filter || update bytes || previous hash)

   and stored as a `Metadata` message in the block's COMMIT_HASH slot;
4. the private-data store, then the block store (`ledger/blockstore`), then
   state, history, savepoint and commit hash in one SQLite transaction
   (`ledger/persistent`), with the JAX package's fault points between them.

State and history are derived caches: on open, blocks present in the store
but missing from state are replayed (recoverDBs analog). The files a ledger
writes (`.chain`, `.pvtdata`, `.state.db`) hold what the JAX ledger's hold
for the same blocks.

`commit_block_state` is the state half alone for one block over any state DB
and validator (the resident K6 validator included), sharing the commit-hash
code.

`state_mirror` (a `ledger/statecouch.CouchStateAdapter`) receives each
block's public updates after the embedded commit, on a best-effort basis: a
mirror that fails is logged and never fails the commit, as in the JAX
ledger (kvledger.py:550-560). A ledger with `device_mvcc`
runs K5 on `device` (the card unless "cpu" is asked for), on a CUDA stream
of its own, so a commit on one thread never waits on kernels another thread
queued on the default stream.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from fabric_tpu_torch.common import fabobs, flogging
from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.txflags import TxValidationCode, ValidationFlags
from fabric_tpu_torch.ledger.blockstore import BlockStore, refuse_corrupt
from fabric_tpu_torch.ledger.confighistory import ConfigHistoryMgr
from fabric_tpu_torch.ledger.mvcc import Validator
from fabric_tpu_torch.ledger.pvtdatastore import MissingEntry, PvtDataStore, PvtEntry
from fabric_tpu_torch.ledger.rwset import TxRwSet, Version
from fabric_tpu_torch.ledger.statedb import (
    HashedUpdateBatch,
    PvtUpdateBatch,
    UpdateBatch,
    VersionedDB,
)
from fabric_tpu_torch.ledger.txparse import parse_transaction, parse_tx_rwset
from fabric_tpu_torch.protos import fabric, protoutil, wire

logger = flogging.must_get_logger("kvledger")


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


def chain_commit_hash(
    filter_bytes: bytes,
    updates: UpdateBatch,
    hashed: HashedUpdateBatch,
    previous_commit_hash: bytes,
) -> bytes:
    """kv_ledger.go addBlockCommitHash: SHA-256(varint(len(filter)) ||
    filter || deterministic update bytes || previous commit hash)."""
    return hashlib.sha256(
        _proto_varint(len(filter_bytes))
        + filter_bytes
        + deterministic_update_bytes(updates, hashed)
        + previous_commit_hash
    ).digest()


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
    commit_hash = chain_commit_hash(flags.tobytes(), updates, hashed, previous_commit_hash)
    if history is not None:
        for (ns, key), entry in updates.items():
            history.setdefault((ns, key), []).append(entry.version)
    validator.db.apply_updates(updates, hashed)
    return CommittedBlock(flags, updates, hashed, commit_hash)


def _number(block: dict) -> int:
    return block.get("header", {}).get("number", 0)


def _datas(block: dict) -> List[bytes]:
    return block.get("data", {}).get("data", [])


def _pvt_expected(
    rwset: Optional[TxRwSet], ns: str, coll: str
) -> Dict[bytes, Tuple[bool, bytes]]:
    """The tx's on-block hashed writes of (ns, coll): key hash ->
    (is_delete, value hash)."""
    expected: Dict[bytes, Tuple[bool, bytes]] = {}
    if rwset is not None:
        for ns_rw in rwset.ns_rw_sets:
            if ns_rw.namespace != ns:
                continue
            for c in ns_rw.coll_hashed:
                if c.collection_name == coll:
                    for hw in c.hashed_writes:
                        expected[hw.key_hash] = (hw.is_delete, hw.value_hash)
    return expected


def _kv_writes(raw: bytes) -> List[dict]:
    """The writes of a serialized cleartext KVRWSet; raises WireError (a
    ValueError) on bytes that do not parse."""
    return wire.decode(wire.KV_RWSET, raw).get("writes", [])


def pvt_data_matches_hashes(
    rwset: Optional[TxRwSet], ns: str, coll: str, raw: bytes
) -> bool:
    """Does a cleartext KVRWSet match the tx's on-block hashed writes for
    (ns, coll)? Used to screen untrusted (gossip-fetched) private data
    before commit — a mismatch is treated as missing, never an error
    (reference gossip/privdata purge of invalid fetched data)."""
    expected = _pvt_expected(rwset, ns, coll)
    try:
        writes = _kv_writes(raw)
    except ValueError:  # malformed pvt payload = explicit False
        return False
    for w in writes:
        exp = expected.get(hashlib.sha256(w.get("key", "").encode()).digest())
        if exp is None:
            return False
        is_del, vh = exp
        if w.get("is_delete", False) != is_del:
            return False
        if not w.get("is_delete", False) and hashlib.sha256(w.get("value", b"")).digest() != vh:
            return False
    return True


class KVLedger:
    """One channel's ledger (block store + state + history).

    `persistent=True` (the default) keeps state + history in SQLite
    (`ledger/persistent`) with a per-block savepoint, so reopening a tall
    ledger replays only the blocks committed after the last durable state
    write instead of the whole chain (kv_ledger.go recoverDBs). In-memory
    mode remains for tests and rebuilds everything by replay.

    `device_mvcc` runs MVCC through `DeviceValidator` on `device`, resolved
    at construction by `cudalib.resolve_device` (the card unless "cpu" is
    given; without a card the construction raises). `last_mvcc_path` says
    which route the last commit's MVCC took ("device" or "host"),
    `last_commit_timings` its split in seconds, and `recovered_blocks` how
    many blocks the last recovery replayed."""

    def __init__(
        self,
        ledger_dir: str,
        channel_id: str,
        btl_policy=None,
        persistent: bool = True,
        device_mvcc: bool = False,
        state_mirror=None,
        device=None,
    ):
        self.state_mirror = state_mirror
        self.channel_id = channel_id
        self.persistent = persistent
        self.device_mvcc = device_mvcc
        self.device = None
        self._stream = None
        if device_mvcc or device is not None:
            from fabric_tpu_torch.ops import cudalib

            self.device = cudalib.resolve_device(device, "MVCC")
        self.history: Dict[Tuple[str, str], List[Version]] = {}
        self.commit_hash = b""
        self.last_mvcc_path: Optional[str] = None
        self.last_commit_timings: Dict[str, float] = {}
        self._closed = False
        try:
            self.block_store = BlockStore(os.path.join(ledger_dir, f"{channel_id}.chain"))
            self.pvt_store = PvtDataStore(
                os.path.join(ledger_dir, f"{channel_id}.pvtdata"), btl_policy=btl_policy
            )
            if persistent:
                from fabric_tpu_torch.ledger.persistent import SqliteVersionedDB

                self.state_db = SqliteVersionedDB(
                    os.path.join(ledger_dir, f"{channel_id}.state.db")
                )
            else:
                self.state_db = VersionedDB()
            self.config_history = ConfigHistoryMgr(self.state_db if persistent else None)
            self._recover()
        except BaseException:
            # a refused recovery must not leak the file handles already
            # open: the operator reopens (possibly with RECOVERY_STRICT=0)
            self.close()
            raise

    # -- recovery: replay the block store into derived state ---------------
    def _recover(self) -> None:
        """Replay blocks the store has but the derived caches lack
        (kv_ledger.go recoverDBs), hardened for the kill windows:

        * block store AHEAD of the state db (crash after append, before
          the sqlite transaction committed): replay the gap idempotently
          into state + history + pvt (INSERT OR REPLACE semantics);
        * pvt store BEHIND a stored block (its torn tail was truncated):
          record missing-data markers so the reconciler re-fetches — the
          hashed writes are on-block and already replayed;
        * state db AHEAD of the block store (chain truncated behind our
          back): nothing can be repaired forward — refuse to serve
          (strict, the default) or rebuild the derived caches from the
          chain (FABRIC_TPU_RECOVERY_STRICT=0 salvage)."""
        height = self.block_store.height
        start = 0
        if self.persistent:
            savepoint = self.state_db.savepoint()
            if savepoint is not None and savepoint >= height:
                refuse_corrupt(
                    logger,
                    f"[{self.channel_id}] state db",
                    f"savepoint {savepoint} is AHEAD of block store "
                    f"height {height}: the chain lost committed "
                    f"blocks behind our back",
                    "statedb-ahead",
                    "rebuild derived state from the surviving chain",
                )
                self.state_db.clear()
                savepoint = None
            if savepoint is not None:
                start = savepoint + 1
                self.commit_hash = self.state_db.commit_hash()
        # pvt torn-tail repair for blocks the state db already covers; the
        # replay loop below repairs its own blocks' pvt gaps
        for bn in range(
            max(self.pvt_store.last_committed_block + 1, self.block_store.base_height),
            min(start, height),
        ):
            block = self.block_store.get_block_by_number(bn)
            self._repair_pvt_gap(block, self._extract_rwsets(block), self._codes(block))
        recovered = 0
        for block in self.block_store.iter_blocks(start):
            self._apply_committed_block(block)
            recovered += 1
        self.recovered_blocks = recovered
        if recovered and self.persistent:
            logger.warning(
                "[%s] recovery replayed %d block(s) above state savepoint "
                "into state/pvt", self.channel_id, recovered,
            )
            fabobs.obs_count("fabric_ledger_recovered_blocks_total", recovered)

    def _apply_committed_block(self, block: dict) -> None:
        number = _number(block)
        flags = self._extract_flags(block)
        rwsets = self._extract_rwsets(block)
        # restore the COMMIT_HASH chain so post-restart commits keep
        # chaining from the last stored hash
        metas = block.get("metadata", {}).get("metadata", [])
        if len(metas) > fabric.COMMIT_HASH and metas[fabric.COMMIT_HASH]:
            meta = protoutil.unmarshal(fabric.METADATA, metas[fabric.COMMIT_HASH])
            self.commit_hash = meta.get("value", b"")
        codes = [TxValidationCode(c) for c in flags.tobytes()]
        validator = Validator(self.state_db)
        # the stored filter already holds the MVCC verdicts: apply the
        # writes of the VALID txs without re-deciding
        updates = UpdateBatch()
        hashed = HashedUpdateBatch()
        for tx_num, (rwset, code) in enumerate(zip(rwsets, codes)):
            if code == TxValidationCode.VALID and rwset is not None:
                validator._apply_write_set(rwset, Version(number, tx_num), updates, hashed)
        # pvt cleartext state is derived from the pvt store on replay
        if self.pvt_store.last_committed_block < number:
            self._repair_pvt_gap(block, rwsets, codes)
        pvt_batch = self._pvt_batch(
            number, self.pvt_store.get_pvt_data_by_block(number), codes, rwsets,
            verify_hashes=False,
        )
        self._commit_state(block, updates, hashed, pvt_batch)

    def _codes(self, block: dict) -> List[TxValidationCode]:
        return [TxValidationCode(c) for c in self._extract_flags(block).tobytes()]

    def _repair_pvt_gap(self, block: dict, rwsets, codes) -> None:
        """The pvt record for an already-stored block is gone (its torn
        tail was truncated by recovery). Record missing markers for every
        collection the block's VALID txs wrote, so the pvt store is never
        behind the chain and the reconciler re-fetches."""
        missing = [
            MissingEntry(tx_num, ns_rw.namespace, coll.collection_name)
            for tx_num, (rwset, code) in enumerate(zip(rwsets, codes))
            if code == TxValidationCode.VALID and rwset is not None
            for ns_rw in rwset.ns_rw_sets
            for coll in ns_rw.coll_hashed
            if coll.hashed_writes
        ]
        logger.warning(
            "[%s] pvt store behind stored block %d on recovery: "
            "recording %d missing-data marker(s) for the reconciler",
            self.channel_id, _number(block), len(missing),
        )
        self.pvt_store.commit(_number(block), [], missing)

    def _extract_flags(self, block: dict) -> ValidationFlags:
        metas = block.get("metadata", {}).get("metadata", [])
        raw = metas[fabric.TRANSACTIONS_FILTER] if len(metas) > fabric.TRANSACTIONS_FILTER else b""
        return (
            ValidationFlags.from_bytes(raw)
            if raw
            else ValidationFlags(len(_datas(block)), TxValidationCode.VALID)
        )

    def _extract_rwsets(self, block: dict) -> List[Optional[TxRwSet]]:
        return [parse_transaction(i, data).rwset for i, data in enumerate(_datas(block))]

    # -- the commit path ---------------------------------------------------
    def _mvcc_stream(self):
        """The stream this ledger's kernels run on: a CUDA stream of its own
        on the card, nothing on the CPU."""
        if self.device is None or self.device.type != "cuda":
            return contextlib.nullcontext()
        import torch

        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream)

    def commit(
        self,
        block: dict,
        rwsets: Optional[List[Optional[TxRwSet]]] = None,
        pvt_data: Optional[Dict[Tuple[int, str, str], bytes]] = None,
        missing_pvt: Optional[List[MissingEntry]] = None,
    ) -> ValidationFlags:
        """ValidateAndPrepare + commit (kv_ledger.go commit): assumes the
        block already carries the txvalidator's TRANSACTIONS_FILTER; MVCC
        verdicts are merged in here and the final filter is what gets
        stored. `rwsets` lets the caller share the validator's parse pass;
        when absent the block is re-decoded.

        `pvt_data` maps (tx_num, ns, collection) -> serialized cleartext
        KVRWSet; its writes are hash-checked against the tx's on-block
        hashed rwset before being applied."""
        t0 = time.perf_counter()
        number = _number(block)
        flags = self._extract_flags(block)
        if rwsets is None:
            rwsets = self._extract_rwsets(block)
        incoming = [TxValidationCode(c) for c in flags.tobytes()]
        if self.device_mvcc:
            from fabric_tpu_torch.ledger.mvcc_device import DeviceValidator

            validator = DeviceValidator(self.state_db, device=self.device)
        else:
            validator = Validator(self.state_db)
        with self._mvcc_stream():
            codes, updates, hashed = validator.validate_and_prepare_batch(number, rwsets, incoming)
        self.last_mvcc_path = getattr(validator, "last_path", "host")
        # assemble + hash-check private data FIRST: anything that can
        # raise must run before commit_hash is chained or any store is
        # touched
        entries = [
            PvtEntry(tx_num, ns, coll, raw)
            for (tx_num, ns, coll), raw in sorted((pvt_data or {}).items())
            if tx_num < len(codes) and codes[tx_num] == TxValidationCode.VALID
        ]
        pvt_batch = self._pvt_batch(number, entries, codes, rwsets, verify_hashes=True)
        # a tx that ended up invalid needs no private data: a missing
        # marker for it would feed the reconciler forever
        missing = [
            m for m in (missing_pvt or [])
            if m.tx_num < len(codes) and codes[m.tx_num] == TxValidationCode.VALID
        ]

        for i, code in enumerate(codes):
            flags.set_flag(i, code)
        protoutil.init_block_metadata(block)
        filter_bytes = flags.tobytes()
        metas = block["metadata"]["metadata"]
        metas[fabric.TRANSACTIONS_FILTER] = filter_bytes
        self.commit_hash = chain_commit_hash(filter_bytes, updates, hashed, self.commit_hash)
        metas[fabric.COMMIT_HASH] = wire.encode(fabric.METADATA, {"value": self.commit_hash})

        # the pvt store commit precedes the block append (store.go
        # Commit); if a crash hit between the two, the pvt record for
        # this block is already durable: skip it, so redelivery completes
        # the interrupted commit
        t1 = time.perf_counter()
        # kill window: nothing of this block is durable yet
        fault_point("kvledger.commit.pre_pvt", key=int(number))
        if self.pvt_store.last_committed_block < number:
            self.pvt_store.commit(number, entries, missing)
        self.block_store.add_block(block)
        # kill window: pvt + block durable, state db not — recovery
        # replays this block into state/pvt idempotently
        fault_point("kvledger.commit.post_block", key=int(number))
        t2 = time.perf_counter()
        self._commit_state(block, updates, hashed, pvt_batch)
        t3 = time.perf_counter()
        # kv_ledger.go:663-672 state_validation / block_and_pvtdata_commit
        # / state_commit
        self.last_commit_timings = {
            "state_validation": t1 - t0,
            "block_and_pvtdata_commit": t2 - t1,
            "state_commit": t3 - t2,
        }
        return flags

    def _pvt_batch(
        self,
        block_num: int,
        entries: List[PvtEntry],
        codes: List[TxValidationCode],
        rwsets: List[Optional[TxRwSet]],
        verify_hashes: bool,
    ) -> PvtUpdateBatch:
        """Cleartext private writes -> state batch, checked against the
        tx's hashed rwset (the on-block source of truth)."""
        batch = PvtUpdateBatch()
        for e in entries:
            if e.tx_num >= len(codes) or codes[e.tx_num] != TxValidationCode.VALID:
                continue
            rwset = rwsets[e.tx_num] if e.tx_num < len(rwsets) else None
            expected = _pvt_expected(rwset, e.namespace, e.collection)
            for w in _kv_writes(e.rwset):
                key = w.get("key", "")
                is_delete = w.get("is_delete", False)
                value = w.get("value", b"")
                if verify_hashes:
                    exp = expected.get(hashlib.sha256(key.encode()).digest())
                    if exp is None:
                        raise ValueError(
                            f"pvt write {e.namespace}/{e.collection}/{key} "
                            "not present in the hashed rwset"
                        )
                    is_del, vh = exp
                    if is_delete != is_del or (
                        not is_delete and hashlib.sha256(value).digest() != vh
                    ):
                        raise ValueError(
                            f"pvt value hash mismatch for {e.namespace}/{e.collection}/{key}"
                        )
                batch.put(
                    e.namespace, e.collection, key, None if is_delete else value,
                    Version(block_num, e.tx_num),
                )
        return batch

    def _commit_state(
        self,
        block: dict,
        updates: UpdateBatch,
        hashed: HashedUpdateBatch,
        pvt: Optional[PvtUpdateBatch] = None,
    ) -> None:
        number = _number(block)
        if self.persistent:
            # state + history + savepoint + commit hash, one transaction
            self.state_db.commit_block(
                updates, hashed, pvt, savepoint=number, commit_hash=self.commit_hash
            )
        else:
            for (ns, key), entry in updates.items():
                self.history.setdefault((ns, key), []).append(entry.version)
            self.state_db.apply_updates(updates, hashed, pvt)
        # collection-config history (confighistory/mgr.go commit hook)
        self.config_history.record_from_updates(number, updates)
        if self.state_mirror is not None and len(updates):
            # the operational mirror (statecouch): best effort, after the
            # commit; the embedded store is authoritative
            try:
                self.state_mirror.apply_updates(updates)
            except Exception as exc:  # noqa: BLE001 - a mirror outage never fails the commit
                logger.warning(
                    "[%s] state mirror update failed at block %d: %s",
                    self.channel_id, number, exc,
                )

    def commit_reconciled_pvt(self, items) -> int:
        """Reconciler write-back (reference reconcile.go ->
        CommitPvtDataOfOldBlocks): late-arriving private data for already
        committed blocks, hash-checked against the on-block hashed rwset;
        entries that fail verification are dropped, good ones land in the
        pvt store AND the cleartext pvt state. `items` is
        [(block_num, tx_num, ns, coll, kvrwset_bytes)]; returns how many
        entries were accepted."""
        by_block: Dict[int, List[PvtEntry]] = {}
        for block_num, tx_num, ns, coll, raw in items:
            by_block.setdefault(block_num, []).append(PvtEntry(tx_num, ns, coll, raw))
        accepted = 0
        for block_num in sorted(by_block):
            block = self.block_store.get_block_by_number(block_num)
            if block is None:
                continue
            rwsets = self._extract_rwsets(block)
            codes = self._codes(block)
            good: List[PvtEntry] = []
            batch = PvtUpdateBatch()
            for entry in by_block[block_num]:
                try:
                    if not self._pvt_entry_complete(entry, rwsets):
                        continue  # subset/empty payload: must not clear the marker
                    one = self._pvt_batch(block_num, [entry], codes, rwsets, verify_hashes=True)
                except ValueError:
                    # one forged/mismatched/garbled entry must not abort
                    # the rest of the batch
                    continue
                for (ns, coll, key), e in one.items():
                    # never regress pvt state a LATER block already wrote
                    current = self.state_db.get_private_data(ns, coll, key)
                    if current is not None and not (
                        current.version.block_num < e.version.block_num
                        or (
                            current.version.block_num == e.version.block_num
                            and current.version.tx_num <= e.version.tx_num
                        )
                    ):
                        continue
                    batch.put(ns, coll, key, e.value, e.version)
                good.append(entry)
            if not good:
                continue
            self.pvt_store.commit_pvt_data_of_old_blocks(block_num, good)
            self.state_db.apply_updates(UpdateBatch(), None, batch)
            accepted += len(good)
        return accepted

    def _pvt_entry_complete(self, entry: PvtEntry, rwsets) -> bool:
        """The payload must cover EVERY key hash the tx's on-block hashed
        rwset lists for this collection — partial data must not clear the
        missing marker."""
        rwset = rwsets[entry.tx_num] if entry.tx_num < len(rwsets) else None
        if rwset is None:
            return False
        expected = set(_pvt_expected(rwset, entry.namespace, entry.collection))
        if not expected:
            return False
        provided = {hashlib.sha256(w.get("key", "").encode()).digest()
                    for w in _kv_writes(entry.rwset)}
        return provided == expected

    # -- admin ops (reference kvledger reset.go / rollback.go /
    #    rebuild_dbs.go: state & history are derived caches over the
    #    block store, so both ops are truncate-then-replay) -------------
    def rebuild_dbs(self) -> None:
        """Drop the derived state/history caches and replay the block
        store (peer node rebuild-dbs / reset)."""
        if self.block_store.base_height > 0:
            raise ValueError(
                "cannot rebuild a snapshot-bootstrapped ledger: state "
                f"below block {self.block_store.base_height} is not in "
                "the block store"
            )
        if self.persistent:
            self.state_db.clear()
        else:
            # carry the generation stamp forward (+1): a resident MVCC
            # table bound to the old db must see the rebuild as an
            # out-of-band mutation, not a fresh generation-0 twin
            old_generation = self.state_db.state_generation
            self.state_db = VersionedDB()
            self.state_db.state_generation = old_generation + 1
        self.config_history = ConfigHistoryMgr(self.state_db if self.persistent else None)
        self.history = {}
        self.commit_hash = b""
        self._recover()

    def rollback(self, target_block: int) -> None:
        """Roll the channel back so target_block is the last block."""
        if self.block_store.base_height > 0:
            raise ValueError("cannot roll back a snapshot-bootstrapped ledger")
        self.block_store.truncate_to(target_block + 1)
        # the pvt store must rewind too, or re-committed blocks skip pvt
        # persistence (last_committed guard) and replay stale records
        self.pvt_store.rollback_to(target_block + 1)
        self.rebuild_dbs()

    def close(self) -> None:
        """Release file handles and the SQLite connection: required before
        another process opens the same ledger directory. Idempotent and
        safe on a partially-constructed ledger."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        for store in (
            getattr(self, "block_store", None),
            getattr(self, "pvt_store", None),
            getattr(self, "state_db", None) if self.persistent else None,
        ):
            if store is not None:
                store.close()

    # -- queries (qscc analog) --------------------------------------------
    @property
    def height(self) -> int:
        return self.block_store.height

    def get_state(self, ns: str, key: str) -> Optional[bytes]:
        vv = self.state_db.get_state(ns, key)
        return vv.value if vv else None

    def get_private_data(self, ns: str, coll: str, key: str) -> Optional[bytes]:
        vv = self.state_db.get_private_data(ns, coll, key)
        return vv.value if vv else None

    def get_history_for_key(self, ns: str, key: str) -> List[Version]:
        if self.persistent:
            return self.state_db.get_history(ns, key)
        return list(self.history.get((ns, key), []))

    def execute_query(self, ns: str, query) -> List[Tuple[str, bytes]]:
        """Rich selector query over committed state (statecouchdb.go:695)."""
        return self.state_db.execute_query(ns, query)

    def tx_exists(self, txid: str) -> bool:
        return self.block_store.tx_exists(txid)
