"""Gossip membership (reference gossip/discovery/discovery_impl.go):
alive/dead peer tracking from periodically-gossiped alive messages, with
sequence-number freshness and expiration sweeps, plus leader election
(reference gossip/election/election.go) built on the same view.

Deterministic, tick-driven (like the raft core): callers advance time via
tick() and inject messages via handle_alive(); the network layer carries
the message bytes.

The port's counterpart of the JAX package's `gossip/membership.py`, the same
code: it holds no message and no clock of its own (its time is the count of
`tick()` calls). Additions: `is_fresh`, which the gossip node asks before
it checks an alive's signature; and the incarnation. A departure: an alive's
freshness is the pair (incarnation, sequence) of the reference's PeerTime
{IncNum, SeqNum} (discovery_impl.go), where the JAX module judges by the
sequence alone and so ignores a restarted peer until its new sequence passes
the old one. `incarnation` is this node's (the gossip node gives its start
time in nanoseconds, as the reference does); an alive's is its "inc" (0 when
absent, so alives without one compare by sequence as in the JAX module).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set


@dataclass
class PeerState:
    endpoint: str
    seq: int
    last_seen_tick: int
    metadata: bytes = b""
    probed: bool = False  # direct probe sent this suspicion episode
    inc: int = 0  # the peer's incarnation

    def older_than(self, inc: int, seq: int) -> bool:
        return (self.inc, self.seq) < (inc, seq)


class Membership:
    """One node's view of the channel membership."""

    def __init__(
        self,
        self_id: str,
        endpoint: str = "",
        alive_expiration_ticks: int = 25,
        metadata: bytes = b"",
        suspect_ticks: Optional[int] = None,
        incarnation: int = 0,
    ):
        self.self_id = self_id
        self.incarnation = incarnation
        self.endpoint = endpoint
        self.metadata = metadata
        self._seq = 0
        self._now = 0
        self._alive: Dict[str, PeerState] = {}
        self._dead: Dict[str, PeerState] = {}
        self.expiration = alive_expiration_ticks
        # SWIM suspicion (reference discovery: a silent peer is PROBED
        # before it is declared dead — push loss must not kill a live
        # member): silent for > suspect_ticks -> suspect (probe it);
        # silent past expiration -> dead. A fresh alive refutes.
        self.suspect_ticks = (
            suspect_ticks
            if suspect_ticks is not None
            else max(alive_expiration_ticks // 2, 1)
        )
        self._suspected: Set[str] = set()
        # the WHOLE view (_seq, _now, _alive, _dead, _suspected) sees TWO
        # writers: the ticker thread (tick/_expire) and gRPC handler
        # threads (handle_alive answering probes / refuting suspicion).
        # An unsynchronized `_seq += 1` can duplicate a sequence number
        # (a receiver dedups the refutation as stale), and an _expire
        # sweep racing handle_alive can move a peer to _dead while a
        # fresh alive re-inserts it — losing the refutation entirely.
        # Every mutation holds _lock.
        self._lock = threading.Lock()

    # -- outgoing -----------------------------------------------------------
    def tick(self) -> dict:
        """Advance time; returns this node's alive message to broadcast
        (reference periodicalSendAlive)."""
        with self._lock:
            self._now += 1
        self._expire()
        return self.bump_seq()

    def bump_seq(self) -> dict:
        """A fresh alive WITHOUT advancing local time — membership-probe
        replies need a new sequence number (the prober dedups by seq) but
        must not accelerate this node's expiry clock. The single shared
        alive-dict shape for broadcasts AND probe replies."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        return {
            "id": self.self_id,
            "endpoint": self.endpoint,
            "seq": seq,
            "metadata": self.metadata,
        }

    # -- incoming -----------------------------------------------------------
    def handle_alive(self, msg: dict) -> bool:
        """Returns True if the message advanced our view (and should be
        forwarded — push gossip)."""
        pid = msg["id"]
        if pid == self.self_id:
            return False
        seq, inc = msg["seq"], msg.get("inc", 0)
        with self._lock:
            known = self._alive.get(pid) or self._dead.get(pid)
            if known is not None and not known.older_than(inc, seq):
                return False
            state = PeerState(
                endpoint=msg.get("endpoint", ""),
                seq=seq,
                last_seen_tick=self._now,
                metadata=msg.get("metadata", b""),
                inc=inc,
            )
            self._dead.pop(pid, None)
            self._suspected.discard(pid)  # fresh alive refutes suspicion
            self._alive[pid] = state
        return True

    def is_fresh(self, pid: str, seq: int, inc: int = 0) -> bool:
        """Whether an alive of `pid` at (`inc`, `seq`) would advance the
        view (a peer other than this node, with no known (incarnation,
        sequence) at or past it), so a caller can drop a stale one before
        checking its signature."""
        if pid == self.self_id:
            return False
        with self._lock:
            known = self._alive.get(pid) or self._dead.get(pid)
            return known is None or known.older_than(inc, seq)

    def _expire(self) -> None:
        with self._lock:
            for pid in list(self._alive):
                st = self._alive[pid]
                silent = self._now - st.last_seen_tick
                if silent > self.expiration:
                    self._suspected.discard(pid)
                    self._dead[pid] = self._alive.pop(pid)
                elif silent > self.suspect_ticks:
                    self._suspected.add(pid)

    def newly_suspect(self) -> List[str]:
        """Suspects not yet probed this suspicion episode — callers probe
        each ONCE per episode (a refuting alive clears the episode, so a
        peer that goes silent again gets probed again)."""
        out = []
        with self._lock:
            for pid in sorted(self._suspected):
                st = self._alive.get(pid)
                if st is not None and not st.probed:
                    st.probed = True
                    out.append(pid)
        return out

    # -- views --------------------------------------------------------------
    def alive_peers(self) -> List[str]:
        with self._lock:
            return sorted(self._alive)

    def suspect_peers(self) -> List[str]:
        with self._lock:
            return sorted(self._suspected)

    def dead_peers(self) -> List[str]:
        with self._lock:
            return sorted(self._dead)

    def endpoint_of(self, pid: str) -> Optional[str]:
        with self._lock:
            st = self._alive.get(pid)
            return st.endpoint if st else None

    def metadata_of(self, pid: str) -> Optional[bytes]:
        with self._lock:
            st = self._alive.get(pid)
            return st.metadata if st else None


class LeaderElection:
    """Per-channel leader election (reference gossip/election): the peer
    with the smallest id among alive candidates leads; peers declare
    themselves via the membership metadata. Deterministic and quiescent —
    no extra message type needed beyond the alive heartbeats."""

    def __init__(self, membership: Membership):
        self.membership = membership
        self.on_leadership_change: Optional[Callable[[bool], None]] = None
        self._is_leader = False
        # evaluate() runs from the ticker thread AND from gRPC handler
        # threads on membership change; an unguarded test-and-set can
        # fire the transition callback twice.  The
        # reentrant delivery lock spans compute + callback so two racing
        # transitions cannot deliver their callbacks in inverted order
        # (last callback must match final _is_leader); reentrant because
        # a callback that re-enters gossip may evaluate again.
        self._lock = threading.Lock()
        self._cb_lock = threading.RLock()

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    @property
    def leader(self) -> str:
        candidates = [self.membership.self_id] + self.membership.alive_peers()
        return min(candidates)

    def evaluate(self) -> bool:
        """Recompute leadership after membership changes; fires the
        callback on transitions (reference leaderElection beLeader /
        stopBeingLeader)."""
        with self._cb_lock:
            now_leader = self.leader == self.membership.self_id
            with self._lock:
                changed = now_leader != self._is_leader
                if changed:
                    self._is_leader = now_leader
            if changed and self.on_leadership_change is not None:
                self.on_leadership_change(now_leader)
        return now_leader
