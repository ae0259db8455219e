"""Raft consenter chain (reference orderer/consensus/etcdraft/chain.go):
ties the raft core to block cutting, block writing, WAL persistence and
snapshot-based catch-up for one channel.

Block creation happens only on the raft leader (chain.go run loop):
normal envelopes go through the blockcutter; each batch becomes a block
proposed as one raft entry (data = a flag byte, 0x01 for a config block,
then the serialized block). Every node writes committed blocks through its
BlockWriter; stale blocks re-proposed by a deposed leader are dropped by
block-number dedup (chain.go writeBlock checks block number ==
lastBlock+1).

The port's counterpart of the JAX package's `orderer/raft_chain.py` over the
port's BlockCutter, BlockWriter and BlockStore: envelopes and blocks are
message dicts, and a raft entry, the WAL and the snapshot file hold the
bytes the JAX chain writes for the same blocks.
"""

from __future__ import annotations

import copy
import os
import struct
import threading
from typing import Callable, List, Optional, Sequence

from fabric_tpu_torch.common.faults import fault_point
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.orderer.blockcutter import BatchConfig, BlockCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter
from fabric_tpu_torch.orderer.consenter_ids import (
    ConsenterIdTracker,
    consenters_from_config_block,
)
from fabric_tpu_torch.orderer.raft import (
    ENTRY_CONF,
    Entry,
    Message,
    RaftNode,
    SnapshotFile,
    WAL,
)
from fabric_tpu_torch.protos import fabric, protoutil, wire


def is_config_block(block: dict) -> bool:
    datas = block.get("data", {}).get("data", [])
    if len(datas) != 1:
        return False
    try:
        env = protoutil.get_envelope_from_block_data(datas[0])
        payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
        chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER,
                                   payload.get("header", {}).get("channel_header", b""))
    except ValueError:
        return False
    return chdr.get("type", 0) == fabric.CONFIG


def _last_config_index(block: Optional[dict]) -> int:
    """Recover LastConfig.index from a stored block's SIGNATURES metadata
    (blockwriter.go lastConfigBlockNumber on restart)."""
    if block is None:
        return 0
    metas = block.get("metadata", {}).get("metadata", [])
    if len(metas) > fabric.SIGNATURES and metas[fabric.SIGNATURES]:
        try:
            meta = protoutil.unmarshal(fabric.METADATA, metas[fabric.SIGNATURES])
            if meta.get("value"):
                return protoutil.unmarshal(fabric.LAST_CONFIG, meta["value"]).get("index", 0)
        except ValueError:
            pass
    return block["header"].get("number", 0) if is_config_block(block) else 0


class NotLeaderError(Exception):
    """Submit must be forwarded to the raft leader (cluster Step RPC)."""

    def __init__(self, leader_id: int):
        super().__init__(f"not leader; current leader is {leader_id}")
        self.leader_id = leader_id


class RaftChain:
    def __init__(
        self,
        channel_id: str,
        node_id: int,
        peers: Sequence[int],
        wal_dir: str,
        signer=None,
        batch_config: Optional[BatchConfig] = None,
        sink: Optional[Callable[[dict], None]] = None,
        genesis_block: Optional[dict] = None,
        snapshot_interval: int = 100,
        transport: Optional[Callable[[int, Message], None]] = None,
        on_config_block: Optional[Callable[[dict], None]] = None,
        initial_consenters: Optional[Sequence[str]] = None,
    ):
        self.channel_id = channel_id
        # One lock serializes everything that mutates raft/cutter/writer
        # state: broadcast threads (order/configure), the cluster Step
        # dispatcher (step), and the node's tick loop all race here (the
        # reference serializes the same way through the etcdraft chain's
        # single run() goroutine).
        self._lock = threading.RLock()
        self.cutter = BlockCutter(batch_config)
        self._sink = sink
        self._on_config_block = on_config_block
        self.snapshot_interval = snapshot_interval
        self.transport = transport or (lambda to, msg: None)
        self._applied_index = 0
        self._proposed_height: Optional[int] = None
        self._proposed_term = -1
        self._proposed_hash = b""

        base = os.path.join(wal_dir, channel_id)
        # The block ledger is persistent: a restart must resume from the
        # stored height or a snapshotted node silently resets to height 0
        # and re-mints already-used block numbers.
        self.block_store = BlockStore(os.path.join(base, "chain.blocks"))
        last_block = (
            self.block_store.get_block_by_number(self.block_store.height - 1)
            if self.block_store.height
            else None
        )
        # Stable consenter->raft-id mapping: the last stored block's
        # ORDERER metadata first (survives restarts and mid-life joins), a
        # fresh genesis falls back to the positional bootstrap rule.
        self.tracker = ConsenterIdTracker.from_block(
            last_block
        ) or ConsenterIdTracker.from_block(genesis_block)
        if self.tracker is None and initial_consenters:
            self.tracker = ConsenterIdTracker.bootstrap(initial_consenters)
        if self.tracker is not None and self.tracker.peer_ids():
            peers = self.tracker.peer_ids()
        self.node = RaftNode(node_id, peers)
        self.writer = BlockWriter(
            signer=signer,
            sink=self._store_block,
            last_block=last_block,
            last_config_index=_last_config_index(last_block),
        )
        self.wal = WAL(os.path.join(base, "wal.log"))
        self.snap = SnapshotFile(os.path.join(base, "snapshot"))
        self._persisted_snap_index = 0
        self._recover()
        self._persisted_snap_index = self.node.snap_index

        if genesis_block is not None and self.writer.height == 0:
            if (
                self.tracker is not None
                and ConsenterIdTracker.from_block(genesis_block) is None
            ):
                # stamp a COPY so followers joining later read the mapping
                # from block 0 — the caller's genesis stays byte-identical
                # to the configtx artifact
                genesis_block = copy.deepcopy(genesis_block)
                self.tracker.stamp(genesis_block)
            self.writer.append_bootstrap(genesis_block)

    # -- persistence --------------------------------------------------------
    def _recover(self) -> None:
        """Replay snapshot + WAL into the raft core (storage.go:175-)."""
        snap = self.snap.load()
        if snap is not None:
            index, term, data = snap
            self.node.snap_index = index
            self.node.snap_term = term
            self.node.snap_data = data
            self.node.commit_index = index
            self._applied_index = index
        hard, entries = self.wal.replay()
        self.node.term, self.node.voted_for = max(
            (self.node.term, self.node.voted_for), hard
        )
        for e in entries:
            if e.index > self.node.snap_index:
                self.node.log.append(e)

    def _store_block(self, block: dict) -> None:
        self.block_store.add_block(block)
        if self._sink is not None:
            self._sink(block)

    @property
    def height(self) -> int:
        return self.writer.height

    def get_block(self, number: int) -> Optional[dict]:
        return self.block_store.get_block_by_number(number)

    # -- consensus.Chain surface -------------------------------------------
    def order(self, env: dict) -> None:
        with self._lock:
            if self.node.role != "leader":
                raise NotLeaderError(self.node.leader_id)
            batches, _ = self.cutter.ordered(env)
            for batch in batches:
                self._propose_batch(batch)
            self._pump()

    def configure(self, env: dict) -> None:
        with self._lock:
            if self.node.role != "leader":
                raise NotLeaderError(self.node.leader_id)
            pending = self.cutter.cut()
            if pending:
                self._propose_batch(pending)
            self._propose_batch([env], is_config=True)
            self._pump()

    def flush(self) -> None:
        """Batch timeout expiry."""
        with self._lock:
            if self.node.role != "leader":
                return
            pending = self.cutter.cut()
            if pending:
                self._propose_batch(pending)
                self._pump()

    def _propose_batch(self, batch: List[dict], is_config: bool = False) -> None:
        block = self._next_proposed_block(batch)
        flag = b"\x01" if is_config else b"\x00"
        self.node.propose(flag + wire.encode(fabric.BLOCK, block))

    def _next_proposed_block(self, batch) -> dict:
        """Leader-side block numbering: continues from the last *proposed*
        block this term, not the last committed one, so multiple in-flight
        proposals chain correctly. Resets on (re-)election so a deposed
        leader's uncommitted proposals don't poison its numbering."""
        if (
            self._proposed_term != self.node.term
            or self._proposed_height is None
            or self._proposed_height < self.writer.height
        ):
            self._proposed_term = self.node.term
            self._proposed_height = self.writer.height
            self._proposed_hash = self.block_store.last_block_hash
        block = protoutil.new_block(self._proposed_height, self._proposed_hash)
        block["data"]["data"] = [wire.encode(fabric.ENVELOPE, env) for env in batch]
        protoutil.seal_block(block)
        self._proposed_height += 1
        self._proposed_hash = protoutil.block_header_hash(block["header"])
        return block

    # -- raft plumbing ------------------------------------------------------
    def tick(self) -> None:
        with self._lock:
            self.node.tick()
            self._pump()

    def step(self, msg: Message) -> None:
        # chaos seam: a 'drop' spec here is a lost consensus message —
        # raft's retransmission must absorb it without forking the
        # committed chain. Unkeyed on purpose: a heartbeat retransmits a
        # byte-identical append, so a content-keyed decision would drop
        # the same message forever.
        spec = fault_point("raft.step", interprets=("drop",))
        if spec is not None and spec.action == "drop":
            return
        with self._lock:
            self.node.step(msg)
            self._pump()

    def _pump(self) -> None:
        msgs, hard, new_entries = self.node.ready()
        self.wal.save(hard, new_entries)
        self._persist_received_snapshot()
        self._apply_committed()
        for m in msgs:
            self.transport(m.to, m)

    def _persist_received_snapshot(self) -> None:
        """A leader-installed snapshot (raft _on_snap) must hit disk like a
        self-taken one, or restart replays the WAL against snap_index=0
        with mis-based log offsets."""
        if (
            self.node.applied_snapshot is not None
            and self.node.snap_index > self._persisted_snap_index
        ):
            self.snap.save(self.node.snap_index, self.node.snap_term, self.node.snap_data)
            self._persisted_snap_index = self.node.snap_index
            self.wal.rotate((self.node.term, self.node.voted_for), self.node.log)

    def _apply_committed(self) -> None:
        while self._applied_index < self.node.commit_index:
            idx = self._applied_index + 1
            # idx <= snap_index covers idx == snap_index too: _term_at
            # answers with snap_term there, but the entry itself is NOT in
            # the log (log starts at snap_index+1)
            if idx <= self.node.snap_index or self.node._term_at(idx) is None:
                # below our log start: state arrives via snapshot instead
                self._applied_index = self.node.snap_index
                continue
            off = idx - self.node.snap_index - 1
            entry = self.node.log[off]
            self._apply_entry(entry)
            self._applied_index = idx
            if (
                self.snapshot_interval
                and self._applied_index - self.node.snap_index >= self.snapshot_interval
            ):
                self._take_snapshot()

    def _apply_entry(self, entry: Entry) -> None:
        if entry.type == ENTRY_CONF:
            new_peers = [int(p) for p in entry.data.decode().split(",") if p]
            removed = self.node.peers - set(new_peers)
            if self.node.role == "leader":
                # final append so removed nodes see the committed conf entry
                # and self-evict (reference etcdraft/eviction.go suspicion)
                for p in removed - {self.node.id}:
                    self.node._send_append(p)
            self.node.apply_conf_change(new_peers)
            return
        if not entry.data:
            return  # leader noop
        is_config = entry.data[0:1] == b"\x01"
        block = wire.decode(fabric.BLOCK, entry.data[1:])
        if block["header"].get("number", 0) != self.writer.height:
            return  # stale re-proposal from a deposed leader
        if self.tracker is not None:
            if is_config:
                # a consenter-set change takes effect in the mapping at the
                # config block that carries it (chain.go writeConfigBlock)
                addrs = consenters_from_config_block(block)
                if addrs is not None:
                    self.tracker.apply(addrs)
            self.tracker.stamp(block)
        self.writer.write_block(block, is_config=is_config)
        if is_config and self._on_config_block is not None:
            self._on_config_block(block)

    def _take_snapshot(self) -> None:
        data = struct.pack("<Q", self.writer.height)
        self.node.compact(self._applied_index, data)
        self.snap.save(self._applied_index, self.node.snap_term, data)
        self._persisted_snap_index = self._applied_index
        # rotate the WAL: replay only needs entries beyond the snapshot
        self.wal.rotate((self.node.term, self.node.voted_for), self.node.log)

    # -- membership ---------------------------------------------------------
    def propose_conf_change(self, new_peers: Sequence[int]) -> None:
        with self._lock:
            if self.node.role != "leader":
                raise NotLeaderError(self.node.leader_id)
            data = ",".join(str(p) for p in sorted(new_peers)).encode()
            self.node.propose(data, etype=ENTRY_CONF)
            self._pump()

    # -- catch-up (blockpuller.go analog) -----------------------------------
    def catch_up(self, blocks: Sequence[dict]) -> None:
        """Feed missing blocks pulled from another orderer after receiving
        a snapshot that outran our log. Config blocks are detected from the
        channel header so last-config tracking and the bundle stay fresh."""
        with self._lock:
            for b in sorted(blocks, key=lambda b: b["header"].get("number", 0)):
                if b["header"].get("number", 0) != self.writer.height:
                    continue
                is_config = is_config_block(b)
                # replicated blocks carry the cluster's authoritative
                # consenter-id mapping; adopt it (else derive + stamp)
                pulled = ConsenterIdTracker.from_block(b)
                if pulled is not None:
                    self.tracker = pulled
                elif self.tracker is not None:
                    if is_config:
                        addrs = consenters_from_config_block(b)
                        if addrs is not None:
                            self.tracker.apply(addrs)
                    self.tracker.stamp(b)
                self.writer.write_block(b, is_config=is_config)
                if is_config and self._on_config_block is not None:
                    self._on_config_block(b)

    @property
    def needs_catch_up(self) -> Optional[int]:
        """If a received snapshot implies blocks we don't have, the height
        we must reach; else None."""
        if self.node.applied_snapshot is None:
            return None
        _, data = self.node.applied_snapshot
        if len(data) >= 8:
            (target,) = struct.unpack_from("<Q", data, 0)
            if target > self.writer.height:
                return target
        return None
