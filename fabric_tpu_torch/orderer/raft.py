"""Raft CFT consensus core (reference orderer/consensus/etcdraft: one raft
group per channel, WAL + snapshots, leadership-aware block proposal).

Built tick-driven and message-passing like etcd/raft so tests can run a
whole cluster deterministically without wall-clock or sockets:

- RaftNode.tick() advances election/heartbeat timers;
- RaftNode.step(msg) consumes a peer message;
- both return nothing but queue outbound messages + ready state, drained
  via RaftNode.ready(): (messages, hard_state, committed_entries).

Persistence mirrors the reference's storage.go triple: a WAL of hard-state
changes and entries (CRC-framed, replayed on restart) and a snapshot file
that truncates the log prefix. The consenter layer (RaftChain) owns block
creation on the leader and block application everywhere (etcdraft/chain.go
writeBlock), including stale-leader deduplication by block number.

A copy of the JAX package's `orderer/raft.py`: the same node, the same
seeded election timeouts (`random.Random(node_id * 7919)` unless `rng` is
given), and the same message, WAL and snapshot bytes, so a cluster of each
package driven by the same ticks and deliveries runs in lockstep.
"""

from __future__ import annotations

import os
import random
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# -- log entries ------------------------------------------------------------

ENTRY_NORMAL = 0
ENTRY_CONF = 1  # data = comma-joined sorted node ids (membership change)


@dataclass(frozen=True)
class Entry:
    index: int
    term: int
    type: int
    data: bytes


@dataclass
class Message:
    kind: str  # vote_req | vote_resp | append | append_resp | snap
    term: int
    frm: int
    to: int
    # append
    prev_index: int = 0
    prev_term: int = 0
    entries: Tuple[Entry, ...] = ()
    commit: int = 0
    # vote_req
    last_index: int = 0
    last_term: int = 0
    # responses
    granted: bool = False
    success: bool = False
    match_index: int = 0
    # snap
    snap_index: int = 0
    snap_term: int = 0
    snap_data: bytes = b""


FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


# -- wire codec (cluster Step RPC payloads) ---------------------------------

_KINDS = ("vote_req", "vote_resp", "append", "append_resp", "snap")


def message_to_bytes(m: Message) -> bytes:
    """Frame a Message for the orderer-to-orderer Consensus stream
    (reference cluster ConsensusRequest.payload carries etcd raftpb bytes;
    here the same struct framing style as the WAL)."""
    head = struct.pack(
        "<BQQQQQQBBQQQQ",
        _KINDS.index(m.kind),
        m.term,
        m.frm,
        m.to,
        m.prev_index,
        m.prev_term,
        m.commit,
        1 if m.granted else 0,
        1 if m.success else 0,
        m.match_index,
        m.last_index,
        m.last_term,
        m.snap_index,
    )
    out = [head, struct.pack("<QI", m.snap_term, len(m.snap_data)), m.snap_data]
    out.append(struct.pack("<I", len(m.entries)))
    for e in m.entries:
        out.append(struct.pack("<QQBI", e.index, e.term, e.type, len(e.data)))
        out.append(e.data)
    return b"".join(out)


def message_from_bytes(raw: bytes) -> Message:
    head_fmt = "<BQQQQQQBBQQQQ"
    head_len = struct.calcsize(head_fmt)
    (
        kind_i,
        term,
        frm,
        to,
        prev_index,
        prev_term,
        commit,
        granted,
        success,
        match_index,
        last_index,
        last_term,
        snap_index,
    ) = struct.unpack_from(head_fmt, raw, 0)
    pos = head_len
    snap_term, snap_len = struct.unpack_from("<QI", raw, pos)
    pos += struct.calcsize("<QI")
    # Wire lengths are untrusted: a slice past the end of `raw` would
    # silently truncate (returning a short snapshot/entry as if it were
    # whole), so every decoded length is checked against the payload
    # before use and the frame is rejected loudly instead.
    if pos + snap_len > len(raw):
        raise ValueError(
            f"raft message snapshot length {snap_len} overruns the "
            f"{len(raw)}-byte payload"
        )
    snap_data = raw[pos : pos + snap_len]
    pos += snap_len
    (n_entries,) = struct.unpack_from("<I", raw, pos)
    pos += 4
    if n_entries > len(raw):
        raise ValueError(
            f"raft message entry count {n_entries} exceeds the "
            f"{len(raw)}-byte payload"
        )
    entries = []
    for _ in range(n_entries):
        index, eterm, etype, dlen = struct.unpack_from("<QQBI", raw, pos)
        pos += struct.calcsize("<QQBI")
        if pos + dlen > len(raw):
            raise ValueError(
                f"raft entry data length {dlen} overruns the "
                f"{len(raw)}-byte payload"
            )
        entries.append(Entry(index, eterm, etype, raw[pos : pos + dlen]))
        pos += dlen
    return Message(
        kind=_KINDS[kind_i],
        term=term,
        frm=frm,
        to=to,
        prev_index=prev_index,
        prev_term=prev_term,
        entries=tuple(entries),
        commit=commit,
        last_index=last_index,
        last_term=last_term,
        granted=bool(granted),
        success=bool(success),
        match_index=match_index,
        snap_index=snap_index,
        snap_term=snap_term,
        snap_data=snap_data,
    )


class RaftNode:
    """Single raft participant for one channel."""

    def __init__(
        self,
        node_id: int,
        peers: Sequence[int],
        election_tick: int = 10,
        heartbeat_tick: int = 1,
        rng: Optional[random.Random] = None,
    ):
        self.id = node_id
        self.peers = set(peers)
        assert node_id in self.peers
        self.term = 0
        self.voted_for = 0
        self.log: List[Entry] = []  # entries > snap_index
        self.snap_index = 0
        self.snap_term = 0
        self.snap_data = b""
        self.commit_index = 0
        self.role = FOLLOWER
        self.leader_id = 0
        self.election_tick = election_tick
        self.heartbeat_tick = heartbeat_tick
        self._rng = rng or random.Random(node_id * 7919)
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._votes: set = set()
        self._next: Dict[int, int] = {}
        self._match: Dict[int, int] = {}
        self._outbox: List[Message] = []
        self._hard_dirty = False
        self._new_entries: List[Entry] = []
        self.evicted = False
        self.applied_snapshot: Optional[Tuple[int, bytes]] = None

    # -- log helpers --------------------------------------------------------
    @property
    def last_index(self) -> int:
        return self.log[-1].index if self.log else self.snap_index

    def _term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self.snap_index:
            return self.snap_term
        off = index - self.snap_index - 1
        if 0 <= off < len(self.log):
            return self.log[off].term
        return None

    def _entries_from(self, index: int) -> List[Entry]:
        off = index - self.snap_index - 1
        return list(self.log[max(off, 0):])

    # -- timers -------------------------------------------------------------
    def _rand_timeout(self) -> int:
        return self.election_tick + self._rng.randrange(self.election_tick)

    def tick(self) -> None:
        if self.evicted:
            return
        self._elapsed += 1
        if self.role == LEADER:
            if self._elapsed >= self.heartbeat_tick:
                self._elapsed = 0
                self._broadcast_append()
        elif self._elapsed >= self._timeout:
            self.campaign()

    def campaign(self) -> None:
        if len(self.peers) == 1:
            self._become_leader_if_single()
            return
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self._hard_dirty = True
        self._votes = {self.id}
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        for p in self.peers - {self.id}:
            self._outbox.append(
                Message(
                    "vote_req",
                    self.term,
                    self.id,
                    p,
                    last_index=self.last_index,
                    last_term=self._term_at(self.last_index) or 0,
                )
            )

    def _become_leader_if_single(self) -> None:
        self.term += 1
        self.voted_for = self.id
        self._hard_dirty = True
        self._become_leader()

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_id = self.id
        self._elapsed = 0
        for p in self.peers:
            self._next[p] = self.last_index + 1
            self._match[p] = 0
        self._match[self.id] = self.last_index
        # noop entry to commit entries from prior terms (raft §5.4.2)
        self._append_local(ENTRY_NORMAL, b"")
        self._broadcast_append()

    def _become_follower(self, term: int, leader: int) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = 0
            self._hard_dirty = True
        self.role = FOLLOWER
        self.leader_id = leader
        self._elapsed = 0
        self._timeout = self._rand_timeout()

    # -- proposal -----------------------------------------------------------
    def propose(self, data: bytes, etype: int = ENTRY_NORMAL) -> bool:
        if self.role != LEADER or self.evicted:
            return False
        self._append_local(etype, data)
        self._broadcast_append()
        return True

    def _append_local(self, etype: int, data: bytes) -> None:
        e = Entry(self.last_index + 1, self.term, etype, data)
        self.log.append(e)
        self._new_entries.append(e)
        self._match[self.id] = self.last_index
        if len(self.peers) == 1:
            self._advance_commit()

    # -- replication --------------------------------------------------------
    def _broadcast_append(self) -> None:
        for p in self.peers - {self.id}:
            self._send_append(p)

    def _send_append(self, to: int) -> None:
        nxt = self._next.get(to, self.last_index + 1)
        if nxt <= self.snap_index:
            self._outbox.append(
                Message(
                    "snap",
                    self.term,
                    self.id,
                    to,
                    snap_index=self.snap_index,
                    snap_term=self.snap_term,
                    snap_data=self.snap_data,
                    commit=self.commit_index,
                )
            )
            return
        prev = nxt - 1
        prev_term = self._term_at(prev)
        entries = tuple(self._entries_from(nxt))
        self._outbox.append(
            Message(
                "append",
                self.term,
                self.id,
                to,
                prev_index=prev,
                prev_term=prev_term if prev_term is not None else 0,
                entries=entries,
                commit=self.commit_index,
            )
        )

    def step(self, m: Message) -> None:
        if self.evicted:
            return
        if m.term > self.term:
            self._become_follower(m.term, m.frm if m.kind == "append" else 0)
        if m.kind == "vote_req":
            self._on_vote_req(m)
        elif m.kind == "vote_resp":
            self._on_vote_resp(m)
        elif m.kind == "append":
            self._on_append(m)
        elif m.kind == "append_resp":
            self._on_append_resp(m)
        elif m.kind == "snap":
            self._on_snap(m)

    def _on_vote_req(self, m: Message) -> None:
        up_to_date = (m.last_term, m.last_index) >= (
            self._term_at(self.last_index) or 0,
            self.last_index,
        )
        grant = (
            m.term >= self.term
            and self.voted_for in (0, m.frm)
            and up_to_date
        )
        if grant:
            self.voted_for = m.frm
            self._hard_dirty = True
            self._elapsed = 0
        self._outbox.append(
            Message("vote_resp", self.term, self.id, m.frm, granted=grant)
        )

    def _on_vote_resp(self, m: Message) -> None:
        if self.role != CANDIDATE or m.term < self.term:
            return
        if m.granted:
            self._votes.add(m.frm)
            if len(self._votes) * 2 > len(self.peers):
                self._become_leader()

    def _on_append(self, m: Message) -> None:
        if m.term < self.term:
            self._outbox.append(
                Message("append_resp", self.term, self.id, m.frm, success=False)
            )
            return
        self._become_follower(m.term, m.frm)
        if m.prev_index < self.snap_index:
            # entries at/below our snapshot are already committed; the
            # leader's _next decayed past our compaction point. Tell it
            # where we really are instead of corrupting the log base.
            self._outbox.append(
                Message(
                    "append_resp",
                    self.term,
                    self.id,
                    m.frm,
                    success=False,
                    match_index=self.snap_index,
                )
            )
            return
        local_prev_term = self._term_at(m.prev_index)
        if local_prev_term is None or (
            m.prev_index > 0 and local_prev_term != m.prev_term
        ):
            self._outbox.append(
                Message(
                    "append_resp",
                    self.term,
                    self.id,
                    m.frm,
                    success=False,
                    match_index=min(self.last_index, m.prev_index - 1)
                    if m.prev_index > 0
                    else 0,
                )
            )
            return
        for e in m.entries:
            existing = self._term_at(e.index)
            if existing is None:
                self.log.append(e)
                self._new_entries.append(e)
            elif existing != e.term:
                # conflict: truncate from here, then append
                off = e.index - self.snap_index - 1
                del self.log[off:]
                self.log.append(e)
                self._new_entries.append(e)
        if m.commit > self.commit_index:
            self.commit_index = min(m.commit, self.last_index)
        self._outbox.append(
            Message(
                "append_resp",
                self.term,
                self.id,
                m.frm,
                success=True,
                match_index=self.last_index,
            )
        )

    def _on_append_resp(self, m: Message) -> None:
        if self.role != LEADER or m.term < self.term:
            return
        if m.success:
            self._match[m.frm] = max(self._match.get(m.frm, 0), m.match_index)
            self._next[m.frm] = self._match[m.frm] + 1
            self._advance_commit()
        else:
            hint = m.match_index
            self._next[m.frm] = max(1, hint + 1 if hint else self._next.get(m.frm, 2) - 1)
            self._send_append(m.frm)

    def _on_snap(self, m: Message) -> None:
        if m.term < self.term:
            return
        self._become_follower(m.term, m.frm)
        if m.snap_index <= self.commit_index:
            # already have this state; ack so the leader advances _next
            # instead of resending the snapshot forever
            self._outbox.append(
                Message(
                    "append_resp",
                    self.term,
                    self.id,
                    m.frm,
                    success=True,
                    match_index=self.commit_index,
                )
            )
            return
        self.snap_index = m.snap_index
        self.snap_term = m.snap_term
        self.snap_data = m.snap_data
        self.log = []
        self.commit_index = m.snap_index
        self.applied_snapshot = (m.snap_index, m.snap_data)
        self._outbox.append(
            Message(
                "append_resp",
                self.term,
                self.id,
                m.frm,
                success=True,
                match_index=m.snap_index,
            )
        )

    def _advance_commit(self) -> None:
        for idx in range(self.last_index, self.commit_index, -1):
            votes = sum(1 for p in self.peers if self._match.get(p, 0) >= idx)
            if votes * 2 > len(self.peers) and self._term_at(idx) == self.term:
                self.commit_index = idx
                break

    # -- membership ---------------------------------------------------------
    def apply_conf_change(self, new_peers: Sequence[int]) -> None:
        """Applied when an ENTRY_CONF commits; eviction detection
        (reference etcdraft/eviction.go): removed nodes halt."""
        self.peers = set(new_peers)
        if self.id not in self.peers:
            self.evicted = True
            self.role = FOLLOWER
        for p in list(self._next):
            if p not in self.peers:
                self._next.pop(p, None)
                self._match.pop(p, None)
        for p in self.peers:
            self._next.setdefault(p, self.last_index + 1)
            self._match.setdefault(p, 0)

    # -- compaction ---------------------------------------------------------
    def compact(self, index: int, data: bytes) -> None:
        """Truncate log entries <= index (applied state captured in data)."""
        if index <= self.snap_index:
            return
        term = self._term_at(index)
        assert term is not None, "cannot compact beyond the log"
        self.log = self._entries_from(index + 1)
        self.snap_index = index
        self.snap_term = term
        self.snap_data = data

    # -- ready --------------------------------------------------------------
    def ready(self) -> Tuple[List[Message], Optional[Tuple[int, int]], List[Entry]]:
        msgs, self._outbox = self._outbox, []
        hard = (self.term, self.voted_for) if self._hard_dirty else None
        self._hard_dirty = False
        entries, self._new_entries = self._new_entries, []
        return msgs, hard, entries


# -- WAL + snapshot persistence (reference etcdraft/storage.go) -------------

_REC_HARD = 1
_REC_ENTRY = 2


class WAL:
    """CRC-framed append-only log of hard-state changes + entries."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def _open(self):
        if self._f is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._f = open(self.path, "ab")
        return self._f

    def save(self, hard: Optional[Tuple[int, int]], entries: Sequence[Entry]) -> None:
        f = self._open()
        if hard is not None:
            body = struct.pack("<BQQ", _REC_HARD, hard[0], hard[1])
            f.write(struct.pack("<I", len(body)) + body + struct.pack("<I", zlib.crc32(body)))
        for e in entries:
            body = struct.pack("<BQQB", _REC_ENTRY, e.index, e.term, e.type) + e.data
            f.write(struct.pack("<I", len(body)) + body + struct.pack("<I", zlib.crc32(body)))
        f.flush()
        os.fsync(f.fileno())

    def replay(self) -> Tuple[Tuple[int, int], List[Entry]]:
        """Returns ((term, voted_for), entries) — truncated tails dropped."""
        hard = (0, 0)
        entries: List[Entry] = []
        if not os.path.exists(self.path):
            return hard, entries
        with open(self.path, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + 8 <= len(raw):
            (length,) = struct.unpack_from("<I", raw, pos)
            if pos + 4 + length + 4 > len(raw):
                break  # torn tail
            body = raw[pos + 4 : pos + 4 + length]
            (crc,) = struct.unpack_from("<I", raw, pos + 4 + length)
            if zlib.crc32(body) != crc:
                break
            pos += 8 + length
            kind = body[0]
            if kind == _REC_HARD:
                _, term, voted = struct.unpack("<BQQ", body)
                hard = (term, voted)
            elif kind == _REC_ENTRY:
                _, index, term, etype = struct.unpack_from("<BQQB", body)
                data = body[struct.calcsize("<BQQB"):]
                # conflicting rewrites: keep the latest copy of an index
                while entries and entries[-1].index >= index:
                    entries.pop()
                entries.append(Entry(index, term, etype, data))
        return hard, entries

    def rotate(self, hard: Tuple[int, int], entries: Sequence[Entry]) -> None:
        """Rewrite the WAL to just the current hard state + live entries
        (post-snapshot truncation; bounds file size and replay cost)."""
        self.close()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        self._f = open(tmp, "ab")
        self.save(hard, entries)
        self.close()
        os.replace(tmp, self.path)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class SnapshotFile:
    def __init__(self, path: str):
        self.path = path

    def save(self, index: int, term: int, data: bytes) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        body = struct.pack("<QQ", index, term) + data
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<I", zlib.crc32(body)) + body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load(self) -> Optional[Tuple[int, int, bytes]]:
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            raw = f.read()
        if len(raw) < 20:
            return None
        (crc,) = struct.unpack_from("<I", raw, 0)
        body = raw[4:]
        if zlib.crc32(body) != crc:
            return None
        index, term = struct.unpack_from("<QQ", body, 0)
        return index, term, body[16:]
