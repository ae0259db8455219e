"""Per-class admission budgets for the shared sidecar (protocol rev 2).

The port's copy of the JAX package's `serve/qos`, less its environment
reader (``FABRIC_TPU_SERVE_QOS``): the channel -> class map comes from
the factory's ``SERVE`` block (``QoS``, ``Channel``) or a constructor
argument.

One global lane budget lets a zipf-skewed spam channel occupy every lane
and starve a paying channel behind the same ``ST_BUSY``.
:class:`ClassLedger` splits the budget into
weighted per-class quotas with **work-conserving borrowing**:

- a class may always use up to its reserved quota (``share * total``);
- beyond its quota it may borrow idle lanes, but ONLY while every
  *demanding* other class's unused reservation stays coverable — after
  an admission, the free-lane count must still cover
  ``sum(max(0, quota_o - used_o))`` over the other classes that have
  demand (lanes in flight, or a rejection not yet followed by an
  admission: the ``waiting`` latch);
- a class with no demand protects nothing — a single-tenant deployment
  uses the whole machine (fully work-conserving).

The invariant that buys the QoS guarantee: a burst of bulk traffic can
fill the whole machine while high-priority is idle, yet after at most
ONE rejection a high-priority channel's full quota is protected from
further borrowing until it is served — bulk drains, high admits, spam
never re-occupies the reservation.  Shedding stays protocol-explicit:
a rejected acquisition becomes an ``ST_BUSY`` with a per-class
``retry_after_ms``, never a silent drop.

The ledger is a leaf (one lock around counters, no I/O, no imports
upward) so the server can hold it on the request path and a test can
drive it deterministically.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.serve import protocol as proto

#: default lane shares per class (must sum to <= 1.0; the remainder is
#: borrowable-only headroom).  High-priority traffic owns half the
#: machine even under a 10:1 spam skew.
DEFAULT_SHARES: Dict[str, float] = {"high": 0.5, "normal": 0.35, "bulk": 0.15}


def parse_shares(text: str) -> Dict[str, float]:
    """``high=0.5,normal=0.35,bulk=0.15`` -> share map.  Malformed
    entries raise ValueError (the daemon's ``--qos-shares`` surfaces it)."""
    out: Dict[str, float] = {}
    for raw in text.replace(";", ",").split(","):
        entry = raw.strip()
        if not entry:
            continue
        name, sep, value = entry.partition("=")
        name = name.strip()
        if not sep or name not in proto.QOS_NAMES:
            raise ValueError(
                f"qos share entry {entry!r} is not class=fraction "
                f"(classes: {proto.QOS_NAMES})"
            )
        share = float(value)
        if not 0.0 <= share <= 1.0:
            raise ValueError(f"qos share {share!r} not in [0, 1]")
        out[name] = share
    if sum(out.values()) > 1.0 + 1e-9:
        raise ValueError(f"qos shares sum to {sum(out.values())} > 1")
    return out


class ClassLedger:
    """Per-class in-flight lane accounting with weighted quotas and
    work-conserving borrowing (module docstring has the invariant)."""

    def __init__(
        self,
        total_lanes: int,
        shares: Optional[Dict[str, float]] = None,
    ):
        self.total = max(1, int(total_lanes))
        share_map = dict(DEFAULT_SHARES)
        share_map.update(shares or {})
        self.quota: Tuple[int, ...] = tuple(
            int(self.total * share_map.get(name, 0.0))
            for name in proto.QOS_NAMES
        )
        self._lock = threading.Lock()
        self._used: List[int] = [0] * len(proto.QOS_NAMES)
        # the demand latch: set on a rejection, cleared by the class's
        # next admission — a rejected class's reservation is protected
        # from borrowing until it has been served (no clocks, so a
        # seeded sequence of requests replays its decisions exactly)
        self._waiting: List[bool] = [False] * len(proto.QOS_NAMES)
        # protocol-level accounting: every shed is an explicit ST_BUSY,
        # and these counters show that none was silent
        self.admitted: List[int] = [0] * len(proto.QOS_NAMES)
        self.rejected: List[int] = [0] * len(proto.QOS_NAMES)
        # lifetime lane flow: acquired must equal released + in-flight
        # at every instant — the proof that hedged or cancelled lanes
        # are neither leaked nor double-released (release() would
        # otherwise clamp a double-free invisibly at zero)
        self.lanes_acquired = 0
        self.lanes_released = 0

    def _clamped(self, qos_class: int) -> int:
        return qos_class if 0 <= qos_class < len(self._used) else proto.QOS_BULK

    def try_acquire(self, qos_class: int, lanes: int) -> bool:
        """Admit ``lanes`` for ``qos_class`` NOW or refuse (never
        blocks — the caller turns False into an ST_BUSY reply)."""
        c = self._clamped(qos_class)
        n = min(max(1, lanes), self.total)
        with self._lock:
            used_total = sum(self._used)
            if used_total + n > self.total:
                self.rejected[c] += 1
                self._waiting[c] = True
                return False
            if self._used[c] + n > self.quota[c]:
                # borrowing leg: admit only while every DEMANDING other
                # class's unused reservation stays coverable afterwards
                # (demand = lanes in flight or the waiting latch; an
                # idle class protects nothing — work-conserving)
                reserved_unused = sum(
                    max(0, self.quota[o] - self._used[o])
                    for o in range(len(self._used))
                    if o != c and (self._used[o] > 0 or self._waiting[o])
                )
                if self.total - used_total - n < reserved_unused:
                    self.rejected[c] += 1
                    self._waiting[c] = True
                    return False
            self._used[c] += n
            self._waiting[c] = False
            self.admitted[c] += 1
            self.lanes_acquired += n
            return True

    def release(self, qos_class: int, lanes: int) -> None:
        c = self._clamped(qos_class)
        n = min(max(1, lanes), self.total)
        with self._lock:
            self._used[c] = max(0, self._used[c] - n)
            self.lanes_released += n

    def balance(self) -> Dict[str, int]:
        """Lifetime lane-flow balance: ``leaked`` must be 0 at quiesce
        and can never go negative unless a release was double-fired —
        the hedge/cancel bookkeeping proof."""
        with self._lock:
            return {
                "acquired": self.lanes_acquired,
                "released": self.lanes_released,
                "in_flight": sum(self._used),
                "leaked": self.lanes_acquired - self.lanes_released
                - sum(self._used),
            }

    def fill(self, qos_class: Optional[int] = None) -> float:
        """Queue-fill fraction: the class's used/quota when given (the
        per-class retry_after signal), else the global used/total."""
        with self._lock:
            if qos_class is None:
                return sum(self._used) / self.total
            c = self._clamped(qos_class)
            return self._used[c] / max(self.quota[c], 1)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                name: {
                    "quota": self.quota[i],
                    "used": self._used[i],
                    "waiting": self._waiting[i],
                    "admitted": self.admitted[i],
                    "rejected": self.rejected[i],
                }
                for i, name in enumerate(proto.QOS_NAMES)
            }


# ---------------------------------------------------------------------------
# Channel -> class mapping (client side)
# ---------------------------------------------------------------------------


def parse_qos_map(text: str) -> Dict[str, int]:
    """``paychan=high;spam*=bulk;*=normal`` -> {pattern: class id}.
    Patterns are exact channel ids or a trailing-``*`` prefix match;
    ``*`` alone is the default.  Malformed entries raise ValueError."""
    out: Dict[str, int] = {}
    for raw in text.replace(",", ";").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        pattern, sep, cls_name = entry.partition("=")
        pattern, cls_name = pattern.strip(), cls_name.strip()
        if not sep or not pattern or cls_name not in proto.QOS_NAMES:
            raise ValueError(
                f"qos map entry {entry!r} is not channel=class "
                f"(classes: {proto.QOS_NAMES})"
            )
        out[pattern] = proto.QOS_NAMES.index(cls_name)
    return out


def class_for_channel(
    channel: Optional[str], qos_map: Dict[str, int]
) -> int:
    """Resolve a channel to its admission class: exact match, then the
    longest ``prefix*`` match, then ``*``, then the protocol default."""
    if channel and channel in qos_map:
        return qos_map[channel]
    if channel:
        best: Optional[Tuple[int, int]] = None  # (prefix_len, class)
        for pattern, cls in qos_map.items():
            if pattern.endswith("*") and pattern != "*":
                prefix = pattern[:-1]
                if channel.startswith(prefix):
                    if best is None or len(prefix) > best[0]:
                        best = (len(prefix), cls)
        if best is not None:
            return best[1]
    if "*" in qos_map:
        return qos_map["*"]
    return proto.DEFAULT_QOS
