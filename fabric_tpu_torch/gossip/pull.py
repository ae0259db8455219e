"""Pull-mediator + certstore identity exchange (reference
gossip/gossip/pull/pullstore.go and gossip/identity + certstore: the
Hello -> DataDigest -> DataRequest -> DataUpdate four-step that spreads
items a push can miss).

Two item types ride the same four-step:

* PEER IDENTITIES: each node holds {pki_id: identity bytes} (its own
  MSP serialized identity plus everything pulled), so policies and
  discovery can resolve remote members' certs without a direct
  connection to them.
* BLOCKS (reference pull.BlockPullPolicy / gossip_impl.go:443): digests
  are recent block sequence numbers; a peer that missed a push — or a
  late joiner whose height metadata never spread — converges through
  pull alone, independent of the height-driven anti-entropy
  (state.go:586) which needs working membership metadata first.

The port's counterpart of the JAX package's `gossip/pull.py`, over the
port's dict messages (`protos/gossip.py`) and blocks. A departure: the hello
nonces come from the mediator's `rng`, a `random.Random` the caller gives
(an unseeded one by default), where the JAX mediator always makes its own
unseeded generator."""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, List, Optional

from fabric_tpu_torch.protos import fabric, gossip, wire

PULL_IDENTITY = 1
PULL_BLOCK = 2
# direct membership probe (reference discovery MembershipRequest: sent
# to a SUSPECT peer; the response is the target's own fresh alive)
PULL_MEMBERSHIP = 3

# how many trailing blocks a responder advertises in a block digest
# (the reference bounds its block pull store the same way; older blocks
# flow through the state-transfer range protocol instead)
BLOCK_DIGEST_WINDOW = 10


class CertStore:
    """pki_id -> serialized identity (gossip/state certstore analog);
    thread-safe, verification hook applied before adoption."""

    def __init__(
        self,
        self_id: str,
        self_identity: bytes,
        verify: Optional[Callable[[bytes, bytes], bool]] = None,
    ):
        self._lock = threading.Lock()
        self._store: Dict[bytes, bytes] = {}
        self._verify = verify
        if self_identity:
            self._store[self_id.encode()] = self_identity

    def put(self, pki_id: bytes, identity: bytes) -> bool:
        if self._verify is not None and not self._verify(pki_id, identity):
            return False
        with self._lock:
            existing = self._store.get(pki_id)
            if existing is not None and existing != identity:
                # FIRST BIND WINS: a pki_id, once bound, cannot be
                # re-bound to a different identity — otherwise any valid
                # same-MSP member could swap a victim's binding and then
                # sign "the victim's" membership messages with its own
                # key (the reference avoids this by deriving pki_id from
                # the cert itself).
                return False
            self._store[pki_id] = identity
        return True

    def get(self, pki_id: bytes) -> Optional[bytes]:
        with self._lock:
            return self._store.get(pki_id)

    def digests(self) -> List[bytes]:
        with self._lock:
            return sorted(self._store)

    def missing(self, digests) -> List[bytes]:
        with self._lock:
            return [d for d in digests if d not in self._store]


def _reply(channel_id: str, kind: str, nonce: int, msg_type: int, items_key: str,
           items) -> dict:
    body = {"nonce": nonce, items_key: list(items), "msg_type": msg_type}
    return {"channel": channel_id, kind: body}


class PullMediator:
    """The requester/responder halves of one pull round. The transport is
    a callable (endpoint, [GossipMessage]) -> [reply GossipMessages]
    (the gossip node's stream send)."""

    def __init__(
        self,
        channel_id: str,
        store: CertStore,
        get_block: Optional[Callable[[int], Optional[dict]]] = None,
        height: Optional[Callable[[], int]] = None,
        add_block: Optional[Callable[[dict], None]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.channel_id = channel_id
        self.store = store
        self._get_block = get_block
        self._height = height
        self._add_block = add_block
        self._rng = rng if rng is not None else random.Random()

    # -- responder side (handled from the gossip stream) -------------------
    def handle(self, msg: dict) -> Optional[dict]:
        kind = gossip.content(msg)
        body = msg.get(kind, {}) if kind else {}
        msg_type = body.get("msg_type", 0)
        nonce = body.get("nonce", 0)
        if kind == "hello" and msg_type == PULL_BLOCK:
            if self._height is None:
                return None
            h = self._height()
            return _reply(self.channel_id, "data_dig", nonce, PULL_BLOCK, "digests",
                          (str(seq).encode() for seq in range(max(0, h - BLOCK_DIGEST_WINDOW), h)))
        if kind == "data_dig" and msg_type == PULL_BLOCK:
            if self._height is None:
                return None
            mine = self._height()
            want = sorted(int(d) for d in body.get("digests", ())
                          if d.isdigit() and int(d) >= mine)
            if not want:
                return None
            return _reply(self.channel_id, "data_req", nonce, PULL_BLOCK, "digests",
                          (str(s).encode() for s in want))
        if kind == "data_req" and msg_type == PULL_BLOCK:
            if self._get_block is None:
                return None
            data = []
            for d in body.get("digests", ()):
                if not d.isdigit():
                    continue
                block = self._get_block(int(d))
                if block is None:
                    continue
                data.append(wire.encode(gossip.GOSSIP_MESSAGE, {
                    "channel": self.channel_id,
                    "data_msg": {"seq_num": block["header"].get("number", 0),
                                 "block": wire.encode(fabric.BLOCK, block)}}))
            if not data:
                return None
            return _reply(self.channel_id, "data_update", nonce, PULL_BLOCK, "data", data)
        if kind == "data_update" and msg_type == PULL_BLOCK:
            if self._add_block is not None:
                for raw in body.get("data", ()):
                    item = wire.decode(gossip.GOSSIP_MESSAGE, raw)
                    if gossip.content(item) != "data_msg":
                        continue
                    self._add_block(wire.decode(fabric.BLOCK, item["data_msg"].get("block", b"")))
            return None
        if kind == "hello" and msg_type == PULL_IDENTITY:
            return _reply(self.channel_id, "data_dig", nonce, PULL_IDENTITY, "digests",
                          self.store.digests())
        if kind == "data_req" and msg_type == PULL_IDENTITY:
            data = []
            for digest in body.get("digests", ()):
                identity = self.store.get(bytes(digest))
                if identity is None:
                    continue
                data.append(wire.encode(gossip.GOSSIP_MESSAGE, {
                    "channel": self.channel_id,
                    "peer_identity": {"pki_id": digest, "cert": identity}}))
            return _reply(self.channel_id, "data_update", nonce, PULL_IDENTITY, "data", data)
        if kind == "data_dig" and msg_type == PULL_IDENTITY:
            want = self.store.missing([bytes(d) for d in body.get("digests", ())])
            if not want:
                return None
            return _reply(self.channel_id, "data_req", nonce, PULL_IDENTITY, "digests", want)
        if kind == "data_update" and msg_type == PULL_IDENTITY:
            for raw in body.get("data", ()):
                item = wire.decode(gossip.GOSSIP_MESSAGE, raw)
                if gossip.content(item) == "peer_identity":
                    ident = item["peer_identity"]
                    self.store.put(ident.get("pki_id", b""), ident.get("cert", b""))
            return None
        if kind == "peer_identity":
            self.store.put(body.get("pki_id", b""), body.get("cert", b""))
            return None
        return None

    # -- requester side (called from the gossip tick) ----------------------
    def hello(self, msg_type: int = PULL_IDENTITY) -> dict:
        return {"channel": self.channel_id,
                "hello": {"nonce": self._rng.getrandbits(63), "msg_type": msg_type}}

    def hello_blocks(self) -> dict:
        return self.hello(PULL_BLOCK)
