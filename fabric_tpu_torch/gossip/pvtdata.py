"""Private-data dissemination + reconciliation over gossip (reference
gossip/privdata/pull.go endorsement-time push/pull and
reconcile.go:104-126 the missed-data loop).

Two flows:

* dissemination: at ENDORSEMENT time the endorsing peer pushes each
  private writeset (PrivatePayload) to other peers' transient stores, so
  the data is already local when the block commits (dissemination in
  coordinator.go/pull.go DistributePrivateData).
* reconciliation: a committed block can still record missing collection
  data (this peer was offline or ineligible-then-eligible); the
  reconciler periodically sends RemotePvtDataRequest digests to peers,
  verifies returned payloads against the on-block hashes, and patches
  the pvt store + state via commit_pvt_data_of_old_blocks.

The port's counterpart of the JAX package's `gossip/pvtdata.py`, over the
port's dict messages (`protos/gossip.py`); the signed bytes are the JAX
module's. A departure: the request nonce comes from `new_nonce` (24 bytes
of `secrets.token_bytes` by default, as in the JAX module), so a test can
give both packages the same nonce.
"""

from __future__ import annotations

import collections
import secrets
import threading
from typing import Callable, List, Optional, Sequence

from fabric_tpu_torch.protos import gossip, wire


class PvtDataHandler:
    """Per-channel gossip hooks for private data."""

    def __init__(
        self,
        channel_id: str,
        transient_store,  # coordinator.TransientStore
        # (block_num, tx_num, ns, coll) -> cleartext rwset bytes or None
        pvt_reader: Callable[[int, int, str, str], Optional[bytes]],
        # (ns, coll) -> may this collection be served at all (e.g. this
        # peer's own eligibility / BTL); collection-level gate.
        serve_policy: Optional[Callable[[str, str], bool]] = None,
        # pki_id -> serialized identity (certstore lookup); with
        # requester_eligible set, requests from unknown pki_ids are denied
        resolve_identity: Optional[Callable[[bytes], Optional[bytes]]] = None,
        # (identity_bytes, data, signature) -> bool: verify the request
        # signature under the channel's MSPs
        verify_member_sig: Optional[Callable[[bytes, bytes, bytes], bool]] = None,
        # (ns, coll, identity_bytes) -> does the REQUESTER satisfy the
        # collection's member-orgs policy (pull.go:614,662
        # filterNotEligible / isEligibleByLatestConfig)?  When set,
        # private_req must carry an authenticated identity; unsigned or
        # unknown requesters are served NOTHING.
        requester_eligible: Optional[Callable[[str, str, bytes], bool]] = None,
        # signer hooks for OUR outgoing reconcile requests
        self_pki_id: bytes = b"",
        sign_request: Optional[Callable[[bytes], bytes]] = None,
        new_nonce: Callable[[], bytes] = lambda: secrets.token_bytes(24),
    ):
        self.channel_id = channel_id
        self.transient = transient_store
        self._pvt_reader = pvt_reader
        self._serve_policy = serve_policy or (lambda ns, coll: True)
        self._resolve_identity = resolve_identity
        self._verify_member_sig = verify_member_sig
        self._requester_eligible = requester_eligible
        self._self_pki_id = self_pki_id
        self._sign_request = sign_request
        self._new_nonce = new_nonce
        # replay window: ordered so eviction drops the OLDEST nonces
        # (a wholesale clear would re-admit every previously consumed
        # request); lock guards check+insert across gossip stream threads
        self._seen_nonces: "collections.OrderedDict[bytes, None]" = collections.OrderedDict()
        self._nonce_lock = threading.Lock()

    def _authenticated_requester(self, req: dict) -> Optional[bytes]:
        """Resolve + signature-check the requester; None when the request
        cannot be tied to a channel identity, or when its nonce was
        already consumed (replay)."""
        pki_id, signature, nonce = (req.get("pki_id", b""), req.get("signature", b""),
                                    req.get("nonce", b""))
        if (self._resolve_identity is None or self._verify_member_sig is None
                or not pki_id or not signature or not nonce):
            return None
        identity = self._resolve_identity(pki_id)
        if identity is None:
            return None
        if not self._verify_member_sig(
            identity, _request_signing_bytes(req, self.channel_id), signature
        ):
            return None
        # replay gate AFTER signature verification so unauthenticated
        # garbage cannot consume nonces; atomic check+insert (concurrent
        # streams must not both pass the membership test)
        with self._nonce_lock:
            if nonce in self._seen_nonces:
                return None
            self._seen_nonces[nonce] = None
            while len(self._seen_nonces) > 65536:
                self._seen_nonces.popitem(last=False)  # evict oldest
        return identity

    # -- message handling (wired into GossipNode._handle) ------------------
    def handle(self, msg: dict) -> Optional[dict]:
        if msg.get("channel", "") != self.channel_id:
            return None  # cross-channel pvt traffic is never served
        kind = gossip.content(msg)
        if kind == "private_data":
            p = msg["private_data"].get("payload", {})
            # endorsement-time push lands in the transient store, exactly
            # where the commit-time coordinator looks first
            self.transient.persist(p.get("tx_id", ""), p.get("namespace", ""),
                                   p.get("collection_name", ""), p.get("private_rwset", b""))
            return None
        if kind == "private_req":
            req = msg["private_req"]
            requester: Optional[bytes] = None
            if self._requester_eligible is not None:
                # per-requester eligibility mode: the request must be
                # signed by a resolvable channel identity, and each digest
                # is filtered by the collection's member-orgs policy
                requester = self._authenticated_requester(req)
                if requester is None:
                    return None
            # one eligibility decision per (ns, coll) per request — a
            # reconcile batch repeats the same collection across digests
            elig_memo: dict = {}

            def eligible(ns: str, coll: str) -> bool:
                key = (ns, coll)
                hit = elig_memo.get(key)
                if hit is None:
                    hit = self._requester_eligible(ns, coll, requester)
                    elig_memo[key] = hit
                return hit

            elements = []
            for digest in req.get("digests", ()):
                ns, coll = digest.get("namespace", ""), digest.get("collection", "")
                if not self._serve_policy(ns, coll):
                    continue
                if self._requester_eligible is not None and not eligible(ns, coll):
                    continue
                payload = self._pvt_reader(digest.get("block_seq", 0),
                                           digest.get("seq_in_block", 0), ns, coll)
                if payload is None:
                    continue
                elements.append({"digest": dict(digest), "payload": payload})
            if elements:
                return {"channel": self.channel_id, "private_res": {"elements": elements}}
            return None
        return None

    # -- endorsement-time push ---------------------------------------------
    def dissemination_messages(
        self,
        tx_id: str,
        pvt_writes: Sequence,  # [(namespace, collection, rwset_bytes)]
    ) -> List[dict]:
        return [{"channel": self.channel_id,
                 "private_data": {"payload": {"tx_id": tx_id, "namespace": namespace,
                                              "collection_name": collection,
                                              "private_rwset": raw}}}
                for namespace, collection, raw in pvt_writes]

    # -- reconciliation ----------------------------------------------------
    def reconcile_request(self, missing) -> Optional[dict]:
        """{block_num: [MissingEntry]} (pvt store get_missing_pvt_data) ->
        one RemotePvtDataRequest (reconcile.go batching)."""
        digests = []
        for block_num in sorted(missing):
            for m in missing[block_num]:
                if not m.eligible:
                    continue
                digests.append({"namespace": m.namespace, "collection": m.collection,
                                "block_seq": block_num, "seq_in_block": m.tx_num})
        if not digests:
            return None
        req = {"digests": digests}
        if self._sign_request is not None and self._self_pki_id:
            req["pki_id"] = self._self_pki_id
            req["nonce"] = self._new_nonce()
            req["signature"] = self._sign_request(_request_signing_bytes(req, self.channel_id))
        return {"channel": self.channel_id, "private_req": req}


def _request_signing_bytes(req: dict, channel_id: str) -> bytes:
    """Deterministic serialization both sides sign/verify.  Binds the
    CHANNEL, the requester's pki_id, and a fresh nonce alongside the
    digest list (signature field excluded) — without those bindings a
    captured request could be replayed verbatim to any serving peer
    forever and the eligibility gate would be worthless."""
    bare = {"digests": list(req.get("digests", ())), "pki_id": req.get("pki_id", b""),
            "nonce": req.get("nonce", b"")}
    return channel_id.encode() + b"\x00" + wire.encode(gossip.REMOTE_PVT_DATA_REQUEST, bare)


def reconcile_response_entries(msg: dict):
    """RemotePvtDataResponse -> [(block_num, tx_num, ns, coll, payload)]."""
    out = []
    for el in msg.get("private_res", {}).get("elements", ()):
        d = el.get("digest", {})
        out.append((d.get("block_seq", 0), d.get("seq_in_block", 0), d.get("namespace", ""),
                    d.get("collection", ""), el.get("payload", b"")))
    return out
