"""Ledger snapshots (reference core/ledger/kvledger/snapshot.go:
generateSnapshot :94, CreateFromSnapshot :221).

The port's counterpart of the JAX package's `ledger/snapshot`: the files it
writes hold the JAX package's bytes for the same ledger. Export writes a
deterministic directory:
  public_state.data          (ns, key, value, version, metadata) sorted
  private_state_hashes.data  (ns, coll, key_hash, value_hash, version)
  txids.data                 sorted committed TxIDs
  _snapshot_signable_metadata.json
      channel name, height, last/prev block hash, per-file SHA-256: the
      cross-peer comparable fingerprint (the reference signs this).

Import (join-by-snapshot) builds a fresh ledger whose block store starts
at the snapshot height with no block prefix; state and the txid
dedup index come from the snapshot files; history before the snapshot is
unavailable, exactly like the reference. The snapshot carries no commit
hash: a joined ledger's commit-hash chain starts again from the empty hash,
as the JAX package's does (Fabric carries `LastBlockCommitHashInHex` in the
snapshot's additional metadata).

The export reads the ledger's height, its state table and its hashed table
one after the other, each under the state database's lock but not under one
lock together; `SnapshotRequestManager.on_block_committed(wait=False)` runs
it on a thread beside the committer, as the JAX package does.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
from typing import Dict, List

from fabric_tpu_torch.ledger.rwset import Version
from fabric_tpu_torch.protos import protoutil

SIGNABLE_METADATA = "_snapshot_signable_metadata.json"
PUBLIC_STATE = "public_state.data"
PVT_HASHES = "private_state_hashes.data"
TXIDS = "txids.data"


def _w(out, b: bytes) -> None:
    out.write(struct.pack("<I", len(b)))
    out.write(b)


def _r(f) -> bytes:
    hdr = f.read(4)
    if len(hdr) < 4:
        raise EOFError
    (ln,) = struct.unpack("<I", hdr)
    # the files are checked against the metadata's digests before a byte is
    # parsed, and read() stops at the end of the file
    return f.read(ln)


def _version_bytes(v: Version) -> bytes:
    return struct.pack("<QQ", v.block_num, v.tx_num)


def _version_from(b: bytes) -> Version:
    bn, tn = struct.unpack("<QQ", b)
    return Version(bn, tn)


def generate_snapshot(ledger, out_dir: str) -> Dict[str, str]:
    """Export the ledger at its current height. Returns the signable
    metadata dict (also written to disk)."""
    os.makedirs(out_dir, exist_ok=True)
    if ledger.height == 0:
        raise ValueError("cannot snapshot an empty ledger")

    with open(os.path.join(out_dir, PUBLIC_STATE), "wb") as f:
        for ns, key, vv in ledger.state_db.iter_all_state():
            _w(f, ns.encode())
            _w(f, key.encode())
            _w(f, vv.value)
            _w(f, _version_bytes(vv.version))
            _w(f, vv.metadata or b"")

    with open(os.path.join(out_dir, PVT_HASHES), "wb") as f:
        for ns, coll, kh, vv in ledger.state_db.iter_all_hashed():
            _w(f, ns.encode())
            _w(f, coll.encode())
            _w(f, kh)
            _w(f, vv.value)
            _w(f, _version_bytes(vv.version))

    with open(os.path.join(out_dir, TXIDS), "wb") as f:
        for txid in sorted(ledger.block_store._by_txid):
            _w(f, txid.encode())

    files = {}
    for name in (PUBLIC_STATE, PVT_HASHES, TXIDS):
        with open(os.path.join(out_dir, name), "rb") as f:
            files[name] = hashlib.sha256(f.read()).hexdigest()
    last = ledger.block_store.get_block_by_number(ledger.height - 1)
    meta = {
        "channel_name": ledger.channel_id,
        "last_block_number": ledger.height - 1,
        "last_block_hash": protoutil.block_header_hash(last["header"]).hex(),
        "previous_block_hash": last["header"].get("previous_hash", b"").hex(),
        "snapshot_files_raw_hashes": files,
        "state_db_type": "embedded",
    }
    with open(os.path.join(out_dir, SIGNABLE_METADATA), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return meta


def verify_snapshot(snap_dir: str) -> dict:
    """Check per-file hashes against the signable metadata; returns the
    metadata (import-side integrity check)."""
    with open(os.path.join(snap_dir, SIGNABLE_METADATA)) as f:
        meta = json.load(f)
    for name, want in meta["snapshot_files_raw_hashes"].items():
        with open(os.path.join(snap_dir, name), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise ValueError(f"snapshot file {name} hash mismatch")
    return meta


def create_from_snapshot(snap_dir: str, ledger_dir: str):
    """Join-by-snapshot: build a KVLedger for the snapshot's channel at
    height last_block_number+1 (kvledger CreateFromSnapshot), with the
    ledger's defaults (host MVCC); a peer closes it and reopens the
    directory through its Channel."""
    from fabric_tpu_torch.ledger.blockstore import BlockStore
    from fabric_tpu_torch.ledger.kvledger import KVLedger
    from fabric_tpu_torch.ledger.statedb import HashedUpdateBatch, UpdateBatch

    meta = verify_snapshot(snap_dir)
    channel_id = meta["channel_name"]
    height = meta["last_block_number"] + 1
    last_hash = bytes.fromhex(meta["last_block_hash"])

    txids: List[str] = []
    with open(os.path.join(snap_dir, TXIDS), "rb") as f:
        while True:
            try:
                txids.append(_r(f).decode())
            except EOFError:
                break

    # bootstrap the block store before the ledger opens it; pre-snapshot
    # txids persist in a sidecar so dedup survives restarts
    chain_path = os.path.join(ledger_dir, f"{channel_id}.chain")
    BlockStore.bootstrap_from_snapshot(
        chain_path, height, last_hash, pre_snapshot_txids=txids
    ).close()

    ledger = KVLedger(ledger_dir, channel_id)

    updates = UpdateBatch()
    with open(os.path.join(snap_dir, PUBLIC_STATE), "rb") as f:
        while True:
            try:
                ns = _r(f).decode()
            except EOFError:
                break
            key = _r(f).decode()
            value = _r(f)
            version = _version_from(_r(f))
            md = _r(f)
            updates.put(ns, key, value, version, md or None)
    hashed = HashedUpdateBatch()
    with open(os.path.join(snap_dir, PVT_HASHES), "rb") as f:
        while True:
            try:
                ns = _r(f).decode()
            except EOFError:
                break
            coll = _r(f).decode()
            kh = _r(f)
            vh = _r(f)
            version = _version_from(_r(f))
            hashed.put(ns, coll, kh, vh, version)
    ledger.state_db.apply_updates(updates, hashed)

    return ledger


class SnapshotRequestManager:
    """Pending snapshot requests for one channel (reference
    core/ledger/kvledger/snapshot_mgr.go: SubmitSnapshotRequest :60,
    CancelSnapshotRequest :78, PendingSnapshotRequests :91).

    Height 0 means "the next committed block". When the committer
    reaches a requested height (on_block_committed), the snapshot is
    generated into  <snapshots_root>/<channel>/<height>/  and the request
    retires. Requests below the current height are rejected, as the
    reference does."""

    def __init__(self, ledger, snapshots_root: str):
        self._ledger = ledger
        self._root = snapshots_root
        self._pending: set = set()
        self._lock = threading.Lock()
        self.generated: Dict[int, str] = {}

    def submit(self, height: int = 0) -> int:
        with self._lock:
            current = self._ledger.height
            if height == 0:
                height = current  # the next block to commit has this number
            elif height < current:
                raise ValueError(
                    f"requested snapshot height {height} cannot be less "
                    f"than the current height {current}"
                )
            if height in self._pending:
                raise ValueError(f"duplicate snapshot request for height {height}")
            self._pending.add(height)
            return height

    def cancel(self, height: int) -> None:
        with self._lock:
            if height not in self._pending:
                raise ValueError(f"no snapshot request exists for height {height}")
            self._pending.discard(height)

    def pending(self) -> List[int]:
        with self._lock:
            return sorted(self._pending)

    def on_block_committed(self, wait: bool = False) -> None:
        """Commit hook: ledger.height-1 is the block just committed.

        Generation runs on a worker thread so a large state export never
        stalls the commit path (the reference generates snapshots after
        commit, outside the critical section). ``wait=True`` blocks until
        the export finishes."""
        committed = self._ledger.height - 1
        with self._lock:
            if committed not in self._pending:
                return
            self._pending.discard(committed)
        out_dir = os.path.join(self._root, self._ledger.channel_id, str(committed))

        def work():
            generate_snapshot(self._ledger, out_dir)
            with self._lock:
                self.generated[committed] = out_dir

        if wait:
            work()
        else:
            # one-shot export whose completion is published in generated[]
            threading.Thread(target=work, name=f"snapshot-{committed}", daemon=True).start()
