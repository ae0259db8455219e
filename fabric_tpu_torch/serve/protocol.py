"""Wire protocol of the resident validation sidecar.

The port's copy of the JAX package's `serve/protocol`: the same frames,
opcodes, statuses and request revisions, byte for byte (the wire contract
between a port peer and a JAX sidecar, or the other way round).

Length-prefixed binary frames over a local stream socket (AF_UNIX path
or 127.0.0.1 TCP) — the software analogue of the whole-block offload
link in Blockchain Machine (PAPERS.md 2104.06968: the peer streams its
validation workload to an attached verifier over a fixed framing).

Frame layout (big-endian)::

    magic   2s   b"FT"
    version u8   the frame's protocol revision (1, 2 or 3)
    opcode  u8   OP_*
    req_id  u32  caller-chosen; echoed verbatim on the response
    length  u32  payload byte count (bounded by MAX_PAYLOAD)
    payload length bytes

A version-1 VERIFY request payload is a key-deduplicated lane table::

    u16 n_keys, then per key:  u16 klen + klen bytes (SEC1 point)
    u32 n_lanes, then per lane: u16 key_idx | u16 siglen + sig
                                | u8 diglen + digest

``key_idx == NO_KEY`` marks a lane with no usable key — the server MUST
verify it as False (fail-closed), never error the whole batch.

Protocol revision 2 (the fleet QoS rev) prefixes the SAME lane table
with an admission-class header so a shared sidecar can shed
priority-aware::

    u8  qos_class   QOS_HIGH | QOS_NORMAL | QOS_BULK
    u8  chan_len  + chan_len bytes of UTF-8 channel id (accounting only)
    ... the v1 lane table, unchanged ...

Protocol revision 3 (the tail-tolerance rev) inserts a per-request
latency budget between the QoS prefix and the lane table::

    u32 deadline_ms   remaining budget when the frame was sent
                      (0 = no deadline — the v2 semantics exactly)
    ... the v1 lane table, unchanged ...

The deadline contract: the server sheds work it provably cannot finish
inside the budget as an explicit ``ST_BUSY`` — never a silent drop,
never a fabricated verdict — and caps its coalescing linger by the
tightest in-flight budget.  Revision 3 also adds ``OP_CANCEL``: a
fire-and-forget frame whose ``req_id`` names an in-flight VERIFY the
client no longer wants (a hedge lost the race, a budget expired).
Cancellation is best-effort bookkeeping, not a correctness lever: a
cancel that arrives before dispatch sheds the work uncomputed, one
that loses the race to the settlement merely suppresses the reply the
client would drop anyway.  ``OP_CANCEL`` carries no response frame —
it must never collide with the cancelled request's own reply in the
client's demux.

Negotiation is per-frame and downgrade-safe in both directions: the
version byte rides every header, a v3 server accepts v1/v2 frames
(class defaults to ``QOS_NORMAL``, deadline to none), and a v3 client
hellos with a PING at its preferred revision, stepping down one
revision per refusal (v3 -> v2 -> v1) so each vintage of server keeps
every feature it understands — an old server costs the client the
newer fields, never the connection.
Revision 2 also adds ``OP_DRAIN``: answer new VERIFY work
``ST_STOPPING`` while in-flight requests settle with their real
verdicts, then exit — the rolling-restart half of the failover story.

A VERIFY response payload::

    u8  status    ST_OK | ST_BUSY | ST_ERROR | ST_STOPPING
    u32 retry_after_ms   (admission control; meaningful for ST_BUSY)
    u32 n         (ST_OK: lane count, mask bytes follow; else message)
    n bytes       0/1 verdict per lane, or a UTF-8 message

Admission-control contract: ST_BUSY is a *rejection*, not an error —
the sidecar's lane budget is full and the client should retry after
``retry_after_ms`` (``common.retry`` paces the client side).  ST_ERROR
and ST_STOPPING are terminal for the request; the client shim rescues
the batch on its in-process provider (masks stay correct, never guessed
VALID).

Every decode path raises :class:`ProtocolError` on malformed input —
a corrupt frame must kill the one request, not wedge the stream.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

PROTOCOL_VERSION = 3
MIN_PROTOCOL_VERSION = 1
MAGIC = b"FT"

# opcodes
OP_PING = 1
OP_VERIFY = 2
OP_STATS = 3
OP_SHUTDOWN = 4
OP_DRAIN = 5  # protocol rev 2: refuse new work, settle in-flight, exit
OP_CANCEL = 6  # protocol rev 3: best-effort abandon of an in-flight VERIFY

# admission (QoS) classes, protocol rev 2.  Lower id = higher priority;
# the names are the metric/scorecard vocabulary (label ``cls``).
QOS_HIGH = 0
QOS_NORMAL = 1
QOS_BULK = 2
QOS_NAMES = ("high", "normal", "bulk")
DEFAULT_QOS = QOS_NORMAL


def qos_name(qos_class: int) -> str:
    """Stable label text for a wire class id (unknown ids are clamped
    to bulk — an out-of-range class must never grant priority)."""
    if 0 <= qos_class < len(QOS_NAMES):
        return QOS_NAMES[qos_class]
    return QOS_NAMES[QOS_BULK]

# response statuses
ST_OK = 0
ST_BUSY = 1
ST_ERROR = 2
ST_STOPPING = 3

#: lane marker: no usable public key — the lane verifies False
NO_KEY = 0xFFFF

#: hard bound on one frame's payload; an oversized frame is a protocol
#: violation (fail-closed: reject, never buffer unbounded attacker data)
MAX_PAYLOAD = 64 << 20

_HEADER = struct.Struct(">2sBBII")
HEADER_SIZE = _HEADER.size


class ProtocolError(Exception):
    """Malformed frame or payload (bad magic, truncation, bounds)."""


def parse_address(address: str) -> Tuple[int, object]:
    """(family, bind/dial target): a path (contains '/') is AF_UNIX,
    else 'host:port' TCP on localhost.  Wire-level address format,
    shared by both ends (the client must not import the server)."""
    import socket

    if "/" in address:
        return socket.AF_UNIX, address
    host, _, port = address.rpartition(":")
    if not host:
        raise ValueError(f"address {address!r} is neither a path nor host:port")
    return socket.AF_INET, (host, int(port))


def pack_frame(
    opcode: int, req_id: int, payload: bytes,
    version: int = PROTOCOL_VERSION,
) -> bytes:
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(
            f"payload {len(payload)} exceeds MAX_PAYLOAD {MAX_PAYLOAD}"
        )
    return _HEADER.pack(
        MAGIC, version, opcode, req_id & 0xFFFFFFFF, len(payload)
    ) + payload


def _recv_exact(sock, n: int) -> Optional[bytes]:
    """n bytes off the socket; None on clean EOF at a frame boundary,
    ProtocolError on EOF mid-frame."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        # the wait is the caller's to bound: the client demux selects
        # before reading, and a server connection thread blocks until
        # stop() shuts its socket down
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(f"connection closed mid-frame ({got}/{n}B)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame_ex(sock) -> Optional[Tuple[int, int, bytes, int]]:
    """(opcode, req_id, payload, version), or None on clean EOF.  Any
    revision in [MIN_PROTOCOL_VERSION, PROTOCOL_VERSION] is accepted —
    a v2 server keeps serving v1 clients, frame by frame."""
    head = _recv_exact(sock, HEADER_SIZE)
    if head is None:
        return None
    magic, version, opcode, req_id, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if not MIN_PROTOCOL_VERSION <= version <= PROTOCOL_VERSION:
        raise ProtocolError(f"unsupported protocol version {version}")
    if length > MAX_PAYLOAD:
        raise ProtocolError(f"frame length {length} exceeds MAX_PAYLOAD")
    payload = _recv_exact(sock, length) if length else b""
    if length and payload is None:
        raise ProtocolError("connection closed before payload")
    return opcode, req_id, payload or b"", version


def recv_frame(sock) -> Optional[Tuple[int, int, bytes]]:
    """(opcode, req_id, payload), or None on clean EOF (the version
    byte dropped — response payload layouts are revision-stable)."""
    frame = recv_frame_ex(sock)
    if frame is None:
        return None
    return frame[0], frame[1], frame[2]


def send_frame(
    sock, opcode: int, req_id: int, payload: bytes,
    version: int = PROTOCOL_VERSION,
) -> None:
    sock.sendall(pack_frame(opcode, req_id, payload, version=version))


# ---------------------------------------------------------------------------
# VERIFY request: key-deduplicated lane table
# ---------------------------------------------------------------------------


def encode_verify_request(
    key_table: Sequence[bytes],
    lanes: Sequence[Tuple[int, bytes, bytes]],
    qos_class: Optional[int] = None,
    channel: str = "",
    deadline_ms: Optional[int] = None,
) -> bytes:
    """key_table: SEC1 key bytes per distinct key; lanes: (key_idx, sig,
    digest) with key_idx == NO_KEY for unusable-key lanes.  Passing a
    ``qos_class`` produces the protocol-rev-2 body (class + channel
    prefix); ``None`` keeps the v1 layout byte-identical, so a client
    latched to v1 never emits a body an old server cannot parse.
    Passing ``deadline_ms`` (remaining latency budget; 0 = no deadline)
    produces the rev-3 body — only valid on top of the QoS prefix, and
    REQUIRED on every v3 frame: the body layout is keyed to the frame
    revision, so a v3 sender with no budget passes 0, never None (a
    v2-latched client passes None).  Callers with a live budget floor
    it at 1 themselves — a budget that rounds to 0 must not decode as
    'no deadline'."""
    out: List[bytes] = []
    if deadline_ms is not None and qos_class is None:
        raise ProtocolError(
            "deadline_ms requires the rev-2 QoS prefix (qos_class)"
        )
    if qos_class is not None:
        if not 0 <= qos_class < len(QOS_NAMES):
            raise ProtocolError(f"qos class {qos_class} out of range")
        chan = channel.encode("utf-8", "backslashreplace")[:255]
        out.append(struct.pack(">BB", qos_class, len(chan)))
        out.append(chan)
    if deadline_ms is not None:
        out.append(struct.pack(">I", max(0, int(deadline_ms)) & 0xFFFFFFFF))
    out.append(_encode_lane_table(key_table, lanes))
    return b"".join(out)


def _encode_lane_table(
    key_table: Sequence[bytes],
    lanes: Sequence[Tuple[int, bytes, bytes]],
) -> bytes:
    if len(key_table) >= NO_KEY:
        raise ProtocolError(f"too many distinct keys ({len(key_table)})")
    out = [struct.pack(">H", len(key_table))]
    for k in key_table:
        if len(k) > 0xFFFF:
            raise ProtocolError("key too long")
        out.append(struct.pack(">H", len(k)))
        out.append(k)
    out.append(struct.pack(">I", len(lanes)))
    for key_idx, sig, digest in lanes:
        if len(sig) > 0xFFFF or len(digest) > 0xFF:
            raise ProtocolError("lane field too long")
        out.append(struct.pack(">HH", key_idx, len(sig)))
        out.append(sig)
        out.append(struct.pack(">B", len(digest)))
        out.append(digest)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        end = self.off + n
        if end > len(self.buf):
            raise ProtocolError("truncated payload")
        out = self.buf[self.off : end]
        self.off = end  # request-scoped reader, single owner thread
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]


def decode_verify_request(
    payload: bytes,
    version: int = 1,
) -> Tuple[List[bytes], List[Tuple[int, bytes, bytes]], int, str, int]:
    """(keys, lanes, qos_class, channel, deadline_ms).  v1 payloads
    decode with the default class (``QOS_NORMAL``) and an empty channel
    — the QoS admission path treats old clients exactly like
    unclassified traffic, never an error.  Pre-v3 payloads decode with
    ``deadline_ms == 0`` (no deadline): an old client's work is never
    shed on a budget it could not have set."""
    r = _Reader(payload)
    qos_class, channel, deadline_ms = DEFAULT_QOS, "", 0
    if version >= 2:
        qos_class = r.u8()
        if not 0 <= qos_class < len(QOS_NAMES):
            raise ProtocolError(f"qos class {qos_class} out of range")
        channel = r.take(r.u8()).decode("utf-8", "replace")
    if version >= 3:
        deadline_ms = r.u32()
    n_keys = r.u16()
    keys = [r.take(r.u16()) for _ in range(n_keys)]
    n_lanes = r.u32()
    if n_lanes > MAX_PAYLOAD:  # cheap sanity before the loop allocates
        raise ProtocolError(f"absurd lane count {n_lanes}")
    lanes = []
    for _ in range(n_lanes):
        key_idx = r.u16()
        sig = r.take(r.u16())
        digest = r.take(r.u8())
        if key_idx != NO_KEY and key_idx >= n_keys:
            raise ProtocolError(f"lane key index {key_idx} out of range")
        lanes.append((key_idx, sig, digest))
    if r.off != len(payload):
        raise ProtocolError("trailing bytes after lane table")
    return keys, lanes, qos_class, channel, deadline_ms


# ---------------------------------------------------------------------------
# VERIFY response
# ---------------------------------------------------------------------------


def encode_verify_response(
    status: int,
    mask: Optional[Sequence[bool]] = None,
    message: str = "",
    retry_after_ms: int = 0,
) -> bytes:
    if status == ST_OK:
        body = bytes(1 if b else 0 for b in (mask or ()))
    else:
        body = message.encode("utf-8", "backslashreplace")[:4096]
    return struct.pack(
        ">BII", status, retry_after_ms & 0xFFFFFFFF, len(body)
    ) + body


def decode_verify_response(
    payload: bytes,
) -> Tuple[int, int, Optional[List[bool]], str]:
    """(status, retry_after_ms, mask-or-None, message)."""
    r = _Reader(payload)
    status = r.u8()
    retry_after_ms = r.u32()
    n = r.u32()
    body = r.take(n)
    if r.off != len(payload):
        raise ProtocolError("trailing bytes after response body")
    if status == ST_OK:
        return status, retry_after_ms, [b != 0 for b in body], ""
    return status, retry_after_ms, None, body.decode("utf-8", "replace")
