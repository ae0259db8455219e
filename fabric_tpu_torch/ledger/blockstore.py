"""Append-only block store with indexes (reference common/ledger/blkstorage).

The port's counterpart of the JAX package's `ledger/blockstore`, with the
same file format: a block is the port's dict (`protos/fabric.BLOCK`) and
its payload is `wire.encode(fabric.BLOCK, block)`, the bytes protobuf's
`Block.SerializeToString()` writes, so the `.chain` file of a channel is
byte for byte the JAX package's for the same blocks.

Format: one file per channel of doubly-checksummed frames —
``u32 len || u32 crc32(len) || payload || u32 crc32(payload)`` of
serialized Block messages (the reference's blockfile format,
blockfile_mgr.go, with both the length prefix AND the payload covered
by checksums).  Indexes (number -> offset, hash -> number, txid ->
(number, txNum)) are rebuilt by scanning on open — the block file is
the source of truth, everything else is a derived cache (the
reference's crash-consistency model, SURVEY.md §5).

Crash-consistency contract: a crash can only ever
leave a PREFIX of one in-flight frame at the tail.  Recovery therefore
repairs exactly that — a truncated header, a frame shorter than its
(header-checksum-validated) length prefix, or a payload-checksum
mismatch that reaches EOF — by truncating to the last whole frame
(loud log + ``fabric_ledger_torn_tail_total``).  Damage a single
interrupted append cannot explain (a full header whose own checksum
fails, a bad frame with valid bytes AFTER it, a checksum-valid frame
that does not parse or is out of order) is corruption, and the store
fails closed: it refuses to open (:class:`LedgerCorruptionError`)
rather than silently drop committed blocks.  The header checksum is
what makes the torn/corrupt split SOUND: without it, a flipped bit
inflating a mid-file length prefix would masquerade as a torn tail and
silently truncate every later committed block.
``FABRIC_TPU_RECOVERY_STRICT=0`` downgrades the refusal to an
operator-forced salvage (truncate to the last good frame) for
forensics and manual repair.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from fabric_tpu_torch.common import fabobs
from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.common.flogging import must_get_logger
from fabric_tpu_torch.protos import fabric, protoutil, wire

logger = must_get_logger("blockstore")


class LedgerCorruptionError(ValueError):
    """The on-disk store is inconsistent in a way recovery cannot repair
    forward (damage beyond one interrupted append).  Raised instead of
    serving: a peer must fail closed and loud, never serve a chain it
    cannot prove whole.  Subclasses ValueError so callers treating
    store errors generically keep working."""


def recovery_strict() -> bool:
    """Live read of the FABRIC_TPU_RECOVERY_STRICT toggle (default
    strict).  ``0`` switches refusals into salvage-and-log: the store
    truncates to the last provably-whole record instead of refusing to
    open — an operator forensics mode, never a default."""
    return os.environ.get("FABRIC_TPU_RECOVERY_STRICT", "1") != "0"


def refuse_corrupt(log, subject: str, why: str, reason: str, salvage: str) -> None:
    """The ONE refusal contract every store shares: count the refusal,
    log CRITICAL, and raise :class:`LedgerCorruptionError` (strict, the
    default) or log the operator-forced salvage and return
    (FABRIC_TPU_RECOVERY_STRICT=0).  ``salvage`` names what salvage
    mode will do — it doubles as the hint in the strict message."""
    fabobs.obs_count(
        "fabric_ledger_recovery_refusals_total", reason=reason
    )
    if recovery_strict():
        log.critical(
            "%s is corrupt (%s): refusing to serve; set "
            "FABRIC_TPU_RECOVERY_STRICT=0 to %s for forensics",
            subject, why, salvage,
        )
        raise LedgerCorruptionError(f"{subject}: {why}")
    log.critical(
        "%s is corrupt (%s): SALVAGING — %s "
        "(FABRIC_TPU_RECOVERY_STRICT=0)",
        subject, why, salvage,
    )


#: frame header: u32 payload length + u32 crc32 of those length bytes.
#: A torn append leaves a PREFIX of a valid frame, so any full 8-byte
#: header at a frame boundary either validates or proves corruption —
#: which is what lets recovery trust the length when classifying a
#: short frame as a torn tail.
_HEADER = struct.Struct("<II")


def frame_header(payload_len: int) -> bytes:
    len_bytes = struct.pack("<I", payload_len)
    return len_bytes + struct.pack("<I", zlib.crc32(len_bytes))


def read_frame_header(raw8: bytes) -> Optional[int]:
    """Payload length from a full 8-byte header, or None when the
    header's own checksum fails (corruption, never a torn write)."""
    ln, hcrc = _HEADER.unpack(raw8)
    if zlib.crc32(raw8[:4]) != hcrc:
        return None
    return ln


def fsync_dir(path: str) -> None:
    """fsync the directory containing ``path``: on some filesystems a
    file-only fsync persists the data but not the metadata (size /
    directory entry) that makes it reachable after a crash."""
    dirname = os.path.dirname(path) or "."
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return  # O_RDONLY on a directory unsupported (exotic fs)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def extract_tx_ids(block: dict) -> List[str]:
    """Best-effort TxID extraction per tx (empty string when unparsable)."""
    out = []
    for data in block.get("data", {}).get("data", ()):
        txid = ""
        try:
            env = protoutil.unmarshal(fabric.ENVELOPE, data)
            payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
            chdr = protoutil.unmarshal(
                fabric.CHANNEL_HEADER,
                payload.get("header", {}).get("channel_header", b""),
            )
            txid = chdr.get("tx_id", "")
        except ValueError:
            pass
        out.append(txid)
    return out


class BlockStore:
    """One channel's chain on disk."""

    def __init__(self, path: str):
        self.path = path
        self._offsets: List[int] = []  # (number - base) -> file offset
        self._by_hash: Dict[bytes, int] = {}
        self._by_txid: Dict[str, Tuple[int, int]] = {}
        self._last_hash = b""
        # Snapshot bootstrap (reference bootstrapFromSnapshotInfo): a store
        # created from a snapshot starts at a nonzero height with no block
        # files for the prefix; base.meta records (base_height, last_hash).
        self._base = 0
        #: bytes dropped by the last torn-tail repair (0 = clean open);
        #: crash harness introspection, reset on every _rebuild_index
        self.torn_tail_bytes = 0
        # close() may race a node-shell teardown thread against the
        # owner: the flag flips under a leaf lock
        self._close_lock = threading.Lock()
        self._closed = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta_path = self.path + ".base"
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                raw = f.read().split(b"\n", 1)
            self._base = int(raw[0])
            self._last_hash = bytes.fromhex(raw[1].decode()) if len(raw) > 1 else b""
        self._load_pretxids()
        self._rebuild_index()
        self._f = open(self.path, "ab")

    def _load_pretxids(self) -> None:
        """Pre-snapshot TxIDs (duplicate-TxID protection for txs whose
        blocks are not stored) persist in a sidecar file, or a restart
        would forget them and re-admit replayed transactions."""
        pretx_path = self.path + ".pretxids"
        if os.path.exists(pretx_path):
            with open(pretx_path) as f:
                for line in f:
                    txid = line.strip()
                    if txid:
                        self._by_txid.setdefault(txid, (-1, -1))

    @classmethod
    def bootstrap_from_snapshot(
        cls,
        path: str,
        height: int,
        last_hash: bytes,
        pre_snapshot_txids: Optional[List[str]] = None,
    ) -> "BlockStore":
        """A new store at `height` with no block prefix (reference
        bootstrapFromSnapshotInfo): the `.base` sidecar holds the height and
        the last block's hash, the `.pretxids` sidecar the TxIDs committed
        before the snapshot."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            raise ValueError(f"block store already exists at {path}")
        with open(path + ".base", "wb") as f:
            f.write(str(height).encode() + b"\n" + last_hash.hex().encode())
        if pre_snapshot_txids:
            with open(path + ".pretxids", "w") as f:
                for txid in pre_snapshot_txids:
                    f.write(txid + "\n")
        return cls(path)

    # -- index ------------------------------------------------------------
    def _refuse(self, why: str) -> None:
        """Irreparable damage: fail closed (strict, the default) or let
        the caller salvage-truncate (FABRIC_TPU_RECOVERY_STRICT=0)."""
        refuse_corrupt(
            logger, f"block store {self.path}", why, "corrupt-chain",
            "truncate to the last whole block",
        )

    def _rebuild_index(self) -> None:
        self.torn_tail_bytes = 0
        if not os.path.exists(self.path):
            return
        size = os.path.getsize(self.path)
        refused = False  # salvage truncation, NOT a benign torn tail
        with open(self.path, "rb") as f:
            valid_end = 0
            while True:
                off = f.tell()
                header = f.read(_HEADER.size)
                if not header:
                    break  # clean EOF at a frame boundary
                if len(header) < _HEADER.size:
                    break  # torn header at the tail
                ln = read_frame_header(header)
                if ln is None:
                    # a torn append leaves a PREFIX of a valid frame, so
                    # a full header that fails its own checksum is
                    # corruption — and the length cannot be trusted to
                    # classify anything beyond it
                    self._refuse(f"frame header checksum failed at offset {off}")
                    refused = True
                    break
                raw = f.read(ln)
                crc = f.read(4)
                if len(raw) != ln or len(crc) != 4:
                    # header-validated length overshoots EOF: torn tail
                    break
                if zlib.crc32(raw) != struct.unpack("<I", crc)[0]:
                    # a torn write can only damage the LAST frame; a bad
                    # checksum with valid bytes after it is corruption
                    if f.tell() < size:
                        self._refuse(f"payload checksum mismatch at offset {off}")
                        refused = True
                    break
                try:
                    block = protoutil.unmarshal(fabric.BLOCK, raw)
                except ValueError:
                    # checksum-valid but unparseable: fully written
                    # garbage, not a torn append — never repairable
                    self._refuse(f"checksummed frame at offset {off} does not parse")
                    refused = True
                    break
                try:
                    # a parseable block with the wrong number is NOT a
                    # torn tail either: corruption, fail closed
                    self._index_block(block, off)
                except ValueError as exc:
                    self._refuse(str(exc))
                    refused = True
                    break
                valid_end = f.tell()
        if size != valid_end:
            dropped = size - valid_end
            if refused:
                # operator-forced salvage of refused corruption: the
                # refusal counter already fired — do NOT book this as a
                # benign torn-tail repair
                logger.critical(
                    "block store %s: salvage dropped %d bytes after "
                    "block %d (FABRIC_TPU_RECOVERY_STRICT=0)",
                    self.path, dropped, self.height - 1,
                )
            else:
                self.torn_tail_bytes = dropped
                logger.warning(
                    "block store %s: truncating %d-byte torn tail after "
                    "block %d (crash recovery)",
                    self.path, dropped, self.height - 1,
                )
                fabobs.obs_count(
                    "fabric_ledger_torn_tail_total", store="chain"
                )
            with open(self.path, "ab") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
            fsync_dir(self.path)

    def _index_block(self, block: dict, offset: int) -> None:
        num = block.get("header", {}).get("number", 0)
        if num != self._base + len(self._offsets):
            raise ValueError(f"out-of-order block {num}")
        self._offsets.append(offset)
        h = protoutil.block_header_hash(block.get("header", {}))
        self._by_hash[h] = num
        self._last_hash = h
        for tx_num, txid in enumerate(extract_tx_ids(block)):
            if txid and txid not in self._by_txid:
                self._by_txid[txid] = (num, tx_num)

    # -- writes -----------------------------------------------------------
    def add_block(self, block: dict) -> None:
        header = block.get("header", {})
        num = header.get("number", 0)
        if num != self.height:
            raise ValueError(
                f"block number should be {self.height} but is {num}"
            )
        if self.height > 0 and header.get("previous_hash", b"") != self._last_hash:
            raise ValueError("unexpected previous-block hash")
        off = self._f.tell()
        raw = wire.encode(fabric.BLOCK, block)
        try:
            # three writes on purpose: a large payload bypasses the
            # Python buffer while the trailing checksum stays buffered,
            # so a kill in the pre_fsync window leaves a genuinely torn
            # frame for recovery to repair (the kill-window tests
            # exercise exactly this)
            self._f.write(frame_header(len(raw)))
            self._f.write(raw)
            self._f.write(struct.pack("<I", zlib.crc32(raw)))
            # kill window: frame (partially) in Python/OS buffers,
            # nothing guaranteed durable yet
            fault_point("blockstore.append.pre_fsync", key=int(num))
            self._f.flush()
            os.fsync(self._f.fileno())
            # kill window: frame durable, directory metadata possibly not
            fault_point("blockstore.append.post_fsync", key=int(num))
            fsync_dir(self.path)
            # kill window: fully durable, in-memory index not yet updated
            fault_point("blockstore.append.pre_index", key=int(num))
        except Exception:
            # a failed append (injected raise, ENOSPC, fsync error) must
            # not leave a partial frame in place: an in-process
            # redelivery retry would stack a duplicate frame AFTER it,
            # which strict recovery then refuses as mid-file damage.
            # Roll the file back to the pre-append offset.  (A kill
            # never reaches here — os._exit skips unwinding — so the
            # torn tail stays for restart recovery, as intended.)
            try:
                # best effort: close() flushes the buffer and may itself
                # raise the same underlying error (ENOSPC) — the
                # truncate below must still run
                self._f.close()
            except OSError:
                pass
            with open(self.path, "ab") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
            self._f = open(self.path, "ab")
            raise
        self._index_block(block, off)

    # -- reads ------------------------------------------------------------
    @property
    def height(self) -> int:
        return self._base + len(self._offsets)

    @property
    def base_height(self) -> int:
        """First block number actually present (0 unless snapshot-bootstrapped)."""
        return self._base

    @property
    def last_block_hash(self) -> bytes:
        return self._last_hash

    def get_block_by_number(self, number: int) -> Optional[dict]:
        idx = number - self._base
        if idx < 0 or idx >= len(self._offsets):
            return None
        with open(self.path, "rb") as f:
            f.seek(self._offsets[idx])
            header = f.read(_HEADER.size)
            ln = (
                read_frame_header(header)
                if len(header) == _HEADER.size
                else None
            )
            raw = f.read(ln) if ln is not None else b""
            crc = f.read(4)
        if ln is None or len(raw) != ln or len(crc) != 4 or (
            zlib.crc32(raw) != struct.unpack("<I", crc)[0]
        ):
            # the frame checksummed clean at index-build time: this is
            # on-disk rot after open — never serve the damaged block
            raise LedgerCorruptionError(
                f"{self.path}: block {number} failed its checksum on read"
            )
        return protoutil.unmarshal(fabric.BLOCK, raw)

    def get_block_by_hash(self, block_hash: bytes) -> Optional[dict]:
        num = self._by_hash.get(block_hash)
        return None if num is None else self.get_block_by_number(num)

    def get_tx_loc(self, txid: str) -> Optional[Tuple[int, int]]:
        return self._by_txid.get(txid)

    def tx_exists(self, txid: str) -> bool:
        return txid in self._by_txid

    def iter_blocks(self, start: int = 0) -> Iterator[dict]:
        for n in range(max(start, self._base), self.height):
            yield self.get_block_by_number(n)

    def truncate_to(self, target_height: int) -> None:
        """Rollback support (reference blkstorage reset.go/rollback.go):
        drop every block with number >= target_height and rebuild the
        derived indexes."""
        if target_height < self._base:
            raise ValueError(
                f"cannot roll back below snapshot base {self._base}"
            )
        if target_height >= self.height:
            return
        keep = target_height - self._base
        self._f.close()
        cut = (
            self._offsets[keep]
            if keep < len(self._offsets)
            else os.path.getsize(self.path)
        )
        with open(self.path, "ab") as f:
            f.truncate(cut)
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(self.path)
        self._offsets = []
        self._by_hash = {}
        self._by_txid = {}
        self._last_hash = b""
        meta_path = self.path + ".base"
        if os.path.exists(meta_path) and self._base:
            with open(meta_path, "rb") as f:
                raw = f.read().split(b"\n", 1)
            self._last_hash = (
                bytes.fromhex(raw[1].decode()) if len(raw) > 1 else b""
            )
        self._load_pretxids()  # the sidecar survives rollbacks
        self._rebuild_index()
        self._f = open(self.path, "ab")
        with self._close_lock:
            self._closed = False

    def close(self) -> None:
        """Idempotent and safe on a partially-constructed store (recovery
        error paths close what exists)."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        f = getattr(self, "_f", None)
        if f is not None:
            f.close()
