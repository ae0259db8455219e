"""Per-transaction structural validation (reference
core/common/validation/msgvalidation.go) and the rwset parse
(rwsetutil.TxRwSetFromProtoMsg), over the port's wire codec.

The port's counterpart of the JAX package's `ledger/txparse`: `SigJob`
(with the native parse's `digest`), `ParsedTx` (with its lazy `rwset`),
`parse_transaction`, `_parse_endorser_tx`, `_parse_version` and
`parse_tx_rwset`. Malformed bytes raise `wire.WireError`, a ValueError,
wherever `protoutil.unmarshal` raises there, and map to the same codes.

Check order (msgvalidation.go ValidateTransaction): nil envelope ->
NIL_ENVELOPE; envelope unmarshal -> INVALID_OTHER_REASON; payload ->
BAD_PAYLOAD; header/channel-header/signature-header problems ->
BAD_COMMON_HEADER; TxID recompute -> BAD_PROPOSAL_TXID; endorser-tx
structure (single action, proposal-hash binding) ->
INVALID_ENDORSER_TRANSACTION. Signatures are not verified here: the parse
emits signature jobs, which the validator verifies in one batch.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
from typing import List, Optional, Tuple

from fabric_tpu_torch.common.txflags import TxValidationCode
from fabric_tpu_torch.ledger import rwset as rw
from fabric_tpu_torch.protos import fabric, protoutil, wire

logger = logging.getLogger("fabric_tpu_torch.txparse")

SUPPORTED_HEADER_TYPES = {fabric.ENDORSER_TRANSACTION, fabric.CONFIG_UPDATE, fabric.CONFIG}


def _parse_version(v: Optional[dict]) -> Optional[rw.Version]:
    """A present but empty Version message is Version(0, 0); an absent one is None."""
    if v is None:
        return None
    return rw.Version(v.get("block_num", 0), v.get("tx_num", 0))


def _read(r: dict) -> rw.KVRead:
    return rw.KVRead(r.get("key", ""), _parse_version(r.get("version")))


def _entries(m: dict):
    # proto3 cannot tell nil from empty entries; like the reference, empty
    # means metadata delete (None here)
    return tuple((e.get("name", ""), e.get("value", b"")) for e in m.get("entries", ())) or None


def parse_tx_rwset(results: bytes) -> rw.TxRwSet:
    txrw = wire.decode(wire.TX_RWSET, results)
    ns_sets = []
    for ns in txrw.get("ns_rwset", ()):
        kv = wire.decode(wire.KV_RWSET, ns.get("rwset", b""))
        reads = tuple(_read(r) for r in kv.get("reads", ()))
        writes = tuple(
            rw.KVWrite(w.get("key", ""), w.get("is_delete", False), w.get("value", b""))
            for w in kv.get("writes", ())
        )
        md_writes = tuple(
            rw.KVMetadataWrite(m.get("key", ""), _entries(m)) for m in kv.get("metadata_writes", ())
        )
        rqs = []
        for q in kv.get("range_queries_info", ()):
            raw_reads: Tuple[rw.KVRead, ...] = ()
            merkle = None
            if "raw_reads" in q:
                raw_reads = tuple(_read(r) for r in q["raw_reads"].get("kv_reads", ()))
            if "reads_merkle_hashes" in q:
                m = q["reads_merkle_hashes"]
                merkle = (
                    m.get("max_degree", 0),
                    m.get("max_level", 0),
                    tuple(m.get("max_level_hashes", ())),
                )
            rqs.append(
                rw.RangeQueryInfo(
                    q.get("start_key", ""), q.get("end_key", ""), q.get("itr_exhausted", False),
                    raw_reads, merkle,
                )
            )
        colls = []
        for coll in ns.get("collection_hashed_rwset", ()):
            h = wire.decode(wire.HASHED_RWSET, coll.get("hashed_rwset", b""))
            colls.append(
                rw.CollHashedRwSet(
                    coll.get("collection_name", ""),
                    tuple(
                        rw.KVReadHash(r.get("key_hash", b""), _parse_version(r.get("version")))
                        for r in h.get("hashed_reads", ())
                    ),
                    tuple(
                        rw.KVWriteHash(
                            w.get("key_hash", b""), w.get("is_delete", False), w.get("value_hash", b"")
                        )
                        for w in h.get("hashed_writes", ())
                    ),
                    tuple(
                        rw.KVMetadataWriteHash(m.get("key_hash", b""), _entries(m))
                        for m in h.get("metadata_writes", ())
                    ),
                )
            )
        ns_sets.append(
            rw.NsRwSet(
                ns.get("namespace", ""), reads, writes, tuple(rqs), tuple(colls), md_writes
            )
        )
    return rw.TxRwSet(tuple(ns_sets))


class SigJob:
    """One deferred signature check: verify `signature` by the identity
    serialized in `identity_bytes` over `data`.

    When the native block parse made the job, `digest` is the SHA-256 of the
    signed bytes and `data` is b"": the signed bytes are never joined
    (an endorsement signs proposal_response_payload || endorser)."""

    __slots__ = ("identity_bytes", "signature", "data", "digest")

    def __init__(self, identity_bytes: bytes, signature: bytes, data: bytes,
                 digest: Optional[bytes] = None):
        self.identity_bytes = identity_bytes
        self.signature = signature
        self.data = data
        self.digest = digest


def writes_to_namespace(ns_rw: rw.NsRwSet) -> bool:
    """Reference dispatcher.txWritesToNamespace: public writes, metadata
    writes, or per-collection hashed (metadata) writes."""
    if ns_rw.writes or ns_rw.metadata_writes:
        return True
    return any(coll.hashed_writes or coll.metadata_writes for coll in ns_rw.coll_hashed)


class ParsedTx:
    """Host-parse result for one block position. `results` keeps the
    ChaincodeAction's TxReadWriteSet bytes for the commit step.

    After the native block parse the rwset is built lazily: the native walk
    already checked its structure and gave `ns_entries` and `has_md_writes`,
    so the object tree is built only when a consumer (the state-based
    endorsement pass, MVCC) asks for `rwset`. Should the Python parse refuse
    bytes the native walk accepted, the tx is demoted to BAD_RWSET instead
    of failing the block."""

    __slots__ = ("index", "code", "header_type", "channel_id", "tx_id", "creator",
                 "creator_sig_job", "endorsement_jobs", "namespace", "config_data", "results",
                 "_rwset", "_rwset_raw", "_ns_entries", "_has_md_writes")

    def __init__(self, index: int):
        self.index = index
        self.code: TxValidationCode = TxValidationCode.NOT_VALIDATED
        self.header_type: int = -1
        self.channel_id: str = ""
        self.tx_id: str = ""
        self.creator: bytes = b""
        self.creator_sig_job: Optional[SigJob] = None
        self.endorsement_jobs: List[SigJob] = []
        self.namespace: str = ""
        self.config_data: bytes = b""
        self.results: Optional[bytes] = None
        self._rwset: Optional[rw.TxRwSet] = None
        self._rwset_raw: Optional[bytes] = None
        # (namespace, writes_to_namespace) per ns_rw_set, in rwset order
        self._ns_entries: Optional[List[Tuple[str, bool]]] = None
        self._has_md_writes: Optional[bool] = None

    @property
    def rwset(self) -> Optional[rw.TxRwSet]:
        if self._rwset is None and self._rwset_raw is not None:
            raw, self._rwset_raw = self._rwset_raw, None
            try:
                self._rwset = parse_tx_rwset(raw)
            except ValueError:
                # the native walk and the Python parse disagree on these
                # bytes: this tx is BAD_RWSET, the block goes on
                logger.warning("native/Python rwset parse divergence on tx %d (len=%d): "
                               "marking BAD_RWSET", self.index, len(raw))
                self.code = TxValidationCode.BAD_RWSET
        return self._rwset

    @rwset.setter
    def rwset(self, value: Optional[rw.TxRwSet]) -> None:
        self._rwset = value
        self._rwset_raw = None

    @property
    def ns_entries(self) -> Optional[List[Tuple[str, bool]]]:
        """[(namespace, writes_to_namespace)] in rwset order, or None for
        non-endorser / failed txs."""
        if self._ns_entries is None and self.rwset is not None:
            self._ns_entries = [(ns.namespace, writes_to_namespace(ns))
                                for ns in self.rwset.ns_rw_sets]
        return self._ns_entries

    @property
    def has_md_writes(self) -> bool:
        """Any public or collection-hashed metadata write: the trigger for
        the sequential SBE pass (statebased.BlockDependencies)."""
        if self._has_md_writes is None:
            rwset = self.rwset
            self._has_md_writes = rwset is not None and any(
                ns.metadata_writes or any(c.metadata_writes for c in ns.coll_hashed)
                for ns in rwset.ns_rw_sets
            )
        return self._has_md_writes

    @property
    def structurally_valid(self) -> bool:
        return self.code == TxValidationCode.NOT_VALIDATED


def parse_transaction(index: int, data: bytes) -> ParsedTx:
    """Structural validation of one block entry; fills early codes and
    deferred signature jobs. Never verifies a signature."""
    out = ParsedTx(index)
    if not data:
        out.code = TxValidationCode.NIL_ENVELOPE
        return out
    try:
        env = protoutil.unmarshal(fabric.ENVELOPE, data)
    except ValueError:
        out.code = TxValidationCode.INVALID_OTHER_REASON
        return out
    payload_bytes = env.get("payload", b"")
    if not payload_bytes:
        out.code = TxValidationCode.BAD_PAYLOAD
        return out
    try:
        payload = protoutil.unmarshal(fabric.PAYLOAD, payload_bytes)
    except ValueError:
        out.code = TxValidationCode.BAD_PAYLOAD
        return out

    # validateCommonHeader; an absent header is not an empty one
    header = payload.get("header")
    if header is None:
        out.code = TxValidationCode.BAD_COMMON_HEADER
        return out
    try:
        chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER, header.get("channel_header", b""))
        shdr = protoutil.unmarshal(fabric.SIGNATURE_HEADER, header.get("signature_header", b""))
    except ValueError:
        out.code = TxValidationCode.BAD_COMMON_HEADER
        return out
    header_type = chdr.get("type", 0)
    if header_type not in SUPPORTED_HEADER_TYPES or chdr.get("epoch", 0) != 0:
        out.code = TxValidationCode.BAD_COMMON_HEADER
        return out
    nonce, creator = shdr.get("nonce", b""), shdr.get("creator", b"")
    if not nonce or not creator:
        out.code = TxValidationCode.BAD_COMMON_HEADER
        return out

    out.header_type = header_type
    out.channel_id = chdr.get("channel_id", "")
    out.tx_id = chdr.get("tx_id", "")
    out.creator = creator
    # checkSignatureFromCreator, deferred: the signature over the full
    # payload bytes (msgvalidation.go:284)
    out.creator_sig_job = SigJob(creator, env.get("signature", b""), payload_bytes)

    if header_type == fabric.ENDORSER_TRANSACTION:
        if not protoutil.check_tx_id(out.tx_id, nonce, creator):
            out.code = TxValidationCode.BAD_PROPOSAL_TXID
            return out
        code = _parse_endorser_tx(out, payload)
        if code is not None:
            out.code = code
        return out
    if header_type == fabric.CONFIG:
        out.config_data = payload.get("data", b"")
    # CONFIG_UPDATE passes header validation; the validator codes it
    # UNKNOWN_TX_TYPE
    return out


def _parse_endorser_tx(out: ParsedTx, payload: dict) -> Optional[TxValidationCode]:
    """validateEndorserTransaction + the artifact extraction of the builtin
    v20 plugin (validation_logic.go extractValidationArtifacts)."""
    try:
        tx = protoutil.unmarshal(fabric.TRANSACTION, payload.get("data", b""))
    except ValueError:
        return TxValidationCode.INVALID_ENDORSER_TRANSACTION
    actions = tx.get("actions", [])
    if len(actions) != 1:
        return TxValidationCode.INVALID_ENDORSER_TRANSACTION
    action = actions[0]
    action_header = action.get("header", b"")
    try:
        act_shdr = protoutil.unmarshal(fabric.SIGNATURE_HEADER, action_header)
    except ValueError:
        return TxValidationCode.INVALID_ENDORSER_TRANSACTION
    if not act_shdr.get("nonce") or not act_shdr.get("creator"):
        return TxValidationCode.INVALID_ENDORSER_TRANSACTION
    try:
        cap = protoutil.unmarshal(fabric.CHAINCODE_ACTION_PAYLOAD, action.get("payload", b""))
        endorsed = cap.get("action", {})
        prp_bytes = endorsed.get("proposal_response_payload", b"")
        prp = protoutil.unmarshal(fabric.PROPOSAL_RESPONSE_PAYLOAD, prp_bytes)
    except ValueError:
        return TxValidationCode.INVALID_ENDORSER_TRANSACTION

    # proposal-hash binding: sha256(channel_header || action sig header ||
    # chaincode proposal payload) == prp.proposal_hash (txutils.go:431)
    h = hashlib.sha256()
    h.update(payload["header"].get("channel_header", b""))
    h.update(action_header)
    h.update(cap.get("chaincode_proposal_payload", b""))
    if not hmac.compare_digest(h.digest(), prp.get("proposal_hash", b"")):
        return TxValidationCode.INVALID_ENDORSER_TRANSACTION

    try:
        cc_action = protoutil.unmarshal(fabric.CHAINCODE_ACTION, prp.get("extension", b""))
    except ValueError:
        return TxValidationCode.BAD_RESPONSE_PAYLOAD
    chaincode_id = cc_action.get("chaincode_id")
    if chaincode_id is None or not chaincode_id.get("name"):
        return TxValidationCode.INVALID_OTHER_REASON
    results = cc_action.get("results", b"")
    try:
        out.rwset = parse_tx_rwset(results)
    except ValueError:
        return TxValidationCode.BAD_RWSET
    out.results = results
    out.namespace = chaincode_id["name"]

    # endorsement signature jobs: data = prp_bytes || endorser identity
    # (statebased/validator_keylevel.go:243-251)
    for endorsement in endorsed.get("endorsements", ()):
        endorser = endorsement.get("endorser", b"")
        out.endorsement_jobs.append(
            SigJob(endorser, endorsement.get("signature", b""), prp_bytes + endorser)
        )
    return None
