"""Per-channel peer pipeline (reference core/peer/peer.go createChannel
wiring + gossip/privdata/coordinator.go StoreBlock + the MCS block checks).

The port's counterpart of the JAX package's `peer/channel`, over the port's
dict blocks (`protos/fabric.BLOCK`). Block intake order matches the
reference:
1. MCS.VerifyBlock: recompute DataHash, check the header chain, verify the
   orderer block signature when a verifier is configured
   (usable-inter-nal/peer/gossip/mcs.go:124);
2. txvalidator.Validate -> TRANSACTIONS_FILTER (signatures + policies; the
   block's signatures in one provider batch, K2 on the card through
   `CUDAProvider` or a `parallel/batcher.BatchingProvider` over it);
3. kvledger.commit -> MVCC merge (K5 with `device_mvcc`) + block store +
   state/history commit.

The provider is given, never made (the port has no default provider); a
serve-plane provider (`serve/client.SidecarProvider`, `serve/router.
SidecarRouter`) is bound to the channel's admission class through its
`for_channel`, as the JAX channel binds it. `device`
goes to the ledger (`ledger/kvledger.KVLedger`), which resolves it when
`device_mvcc` asks for the card. `writeset_check` and `plugin_registry` go
to the validator, `state_mirror` and `btl_policy` to the ledger.
`last_prepare_ms` and `last_store_ms` hold the host-clock split of the last
stage A and stage B.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from fabric_tpu_torch.common import flogging
from fabric_tpu_torch.common.txflags import TxValidationCode, ValidationFlags
from fabric_tpu_torch.crypto.bccsp import Provider
from fabric_tpu_torch.ledger.kvledger import KVLedger, pvt_data_matches_hashes
from fabric_tpu_torch.ledger.pvtdatastore import MissingEntry
from fabric_tpu_torch.msp.identity import MSPManager
from fabric_tpu_torch.protos import fabric, protoutil
from fabric_tpu_torch.validation.blockparse import parse_block
from fabric_tpu_torch.validation.validator import BlockValidator, ChaincodeRegistry

logger = flogging.must_get_logger("committer")


class BlockVerificationError(Exception):
    pass


class Channel:
    def __init__(
        self,
        channel_id: str,
        ledger_dir: str,
        msp_manager: MSPManager,
        registry: ChaincodeRegistry,
        provider: Provider,
        verify_orderer_sig: Optional[Callable[[dict], bool]] = None,
        apply_config: Optional[Callable[[bytes], None]] = None,
        transient_store=None,  # .get(txid, ns, coll) / .purge_by_txids(txids)
        fetch_pvt: Optional[Callable] = None,  # (blk, tx, txid, ns, coll) -> bytes|None
        is_eligible: Optional[Callable[[str, str], bool]] = None,
        btl_policy: Optional[Callable[[str, str], int]] = None,
        metrics=None,  # ledger.ledgermetrics.CommitterMetrics
        device_mvcc: bool = False,
        writeset_check=None,
        plugin_registry=None,
        state_mirror=None,
        device=None,
    ):
        self.metrics = metrics
        self.channel_id = channel_id
        # serve-plane QoS: a sidecar-routed provider binds this channel's
        # admission class, so a shared sidecar sheds priority-aware;
        # providers without for_channel pass through unchanged
        bind = getattr(provider, "for_channel", None)
        self.provider = bind(channel_id) if callable(bind) else provider
        self.ledger = KVLedger(
            ledger_dir, channel_id, btl_policy=btl_policy,
            device_mvcc=device_mvcc, state_mirror=state_mirror, device=device,
        )
        # host-clock splits of the last prepare_block and store_block, in ms
        # (each written whole by the thread that runs that stage)
        self.last_prepare_ms: Dict[str, float] = {}
        self.last_store_ms: Dict[str, float] = {}
        self.verify_orderer_sig = verify_orderer_sig
        self.transient_store = transient_store
        self.fetch_pvt = fetch_pvt
        self.is_eligible = is_eligible

        def get_state_metadata(ns: str, coll: str, key) -> Optional[bytes]:
            if coll:
                return self.ledger.state_db.get_hashed_metadata(ns, coll, key)
            return self.ledger.state_db.get_state_metadata(ns, key)

        try:
            self.validator = BlockValidator(
                channel_id,
                msp_manager,
                self.provider,
                registry,
                tx_exists=self.ledger.tx_exists,
                apply_config=apply_config,
                get_state_metadata=get_state_metadata,
                writeset_check=writeset_check,
                plugin_registry=plugin_registry,
            )
        except BaseException:
            self.ledger.close()
            raise

    def prepare_block(self, block: dict):
        """Stage A of the commit pipeline: orderer signature check, host
        parse, and the device signature batch — everything that may
        overlap the previous block's sequential MVCC/commit epilogue.
        Returns the opaque tuple store_block takes as `prepared`."""
        t0 = time.perf_counter()
        self._verify_block_content(block)
        parsed = parse_block(list(block.get("data", {}).get("data", ())))
        t1 = time.perf_counter()
        jobs, job_identity, keys, sigs, digests = self.validator.collect_sig_jobs(parsed)
        t2 = time.perf_counter()
        # dispatch WITHOUT waiting when the provider has an async seam: the
        # resolver rides the prepared tuple and store_block collects the
        # verdicts at stage B, so block N's signature math overlaps block
        # N-1's commit epilogue
        dispatch = getattr(self.provider, "batch_verify_async", None)
        if dispatch is None:
            ok_list = self.provider.batch_verify(keys, sigs, digests)
        else:
            ok_list = dispatch(keys, sigs, digests)
        t3 = time.perf_counter()
        self.last_prepare_ms = {"parse": (t1 - t0) * 1e3, "collect": (t2 - t1) * 1e3,
                                "dispatch": (t3 - t2) * 1e3}
        return parsed, jobs, job_identity, ok_list

    def store_block(self, block: dict, prepared=None) -> ValidationFlags:
        """The full commit pipeline for one delivered block. Envelopes are
        parsed once and the result shared between validation and commit;
        a pipelined deliver loop passes `prepared` from prepare_block run
        on another thread.

        Private data is assembled coordinator-style (gossip/privdata/
        coordinator.go:149-209): transient store first, then the peer
        fetcher, with anything still missing recorded for the reconciler."""
        t0 = time.perf_counter()
        self._verify_block_position(block)
        if prepared is None:
            prepared = self.prepare_block(block)
        parsed, jobs, job_identity, ok_list = prepared
        t1 = time.perf_counter()
        if callable(ok_list):
            # async-prepared tuple: resolve the verify dispatch now. A
            # resolver failure raises here and surfaces through the commit
            # error path: the block is NOT committed (fail closed)
            ok_list = ok_list()
        t2 = time.perf_counter()
        sig_results = self.validator.finish_sig_results(jobs, job_identity, ok_list)
        flags = self.validator.validate(block, parsed=parsed, sig_results=sig_results)
        t3 = time.perf_counter()
        t_validate = t3 - t0
        rwsets = [p.rwset for p in parsed]
        # materializing rwsets may demote txs the native walk accepted but
        # the Python parser rejects: fold that into the filter BEFORE it is
        # persisted, so every peer commits the same TRANSACTIONS_FILTER
        refilter = False
        for p in parsed:
            if p.code == TxValidationCode.BAD_RWSET and flags.flag(p.index) == TxValidationCode.VALID:
                flags.set_flag(p.index, TxValidationCode.BAD_RWSET)
                rwsets[p.index] = None
                refilter = True
        if refilter:
            block["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER] = flags.tobytes()
        pvt_data, missing = self._assemble_pvt_data(block, parsed, flags)
        t4 = time.perf_counter()
        result = self.ledger.commit(block, rwsets=rwsets, pvt_data=pvt_data, missing_pvt=missing)
        self.last_store_ms = {"verify_wait": (t2 - t1) * 1e3, "validate": (t3 - t2) * 1e3,
                              "rwsets_and_pvt": (t4 - t3) * 1e3,
                              "commit": (time.perf_counter() - t4) * 1e3}
        if self.transient_store is not None:
            self.transient_store.purge_by_txids([p.tx_id for p in parsed if p.tx_id])
        timings = self.ledger.last_commit_timings
        logger.debug(
            "[%s] committed block [%d] in %dms (state_validation=%dms "
            "block_and_pvtdata_commit=%dms state_commit=%dms)",
            self.channel_id,
            block["header"].get("number", 0),
            int((t_validate + sum(timings.values())) * 1000),
            int(timings.get("state_validation", 0) * 1000),
            int(timings.get("block_and_pvtdata_commit", 0) * 1000),
            int(timings.get("state_commit", 0) * 1000),
        )
        if self.metrics is not None:
            self.metrics.observe_commit(
                self.channel_id,
                result,
                self.ledger.height,
                t_validate + timings.get("state_validation", 0.0),
                timings.get("block_and_pvtdata_commit", 0.0),
                timings.get("state_commit", 0.0),
            )
        return result

    def _assemble_pvt_data(self, block: dict, parsed, flags: ValidationFlags):
        """(tx_num, ns, coll) -> cleartext KVRWSet bytes for every valid tx
        whose hashed rwset references a collection this peer is eligible
        for; plus MissingEntry records for what could not be found."""
        pvt_data = {}
        missing = []
        wanted = []  # (tx_num, tx_id, ns, coll)
        codes = flags.tobytes()
        for p in parsed:
            if codes[p.index] != TxValidationCode.VALID:
                continue
            if p.rwset is None:
                continue
            for ns_rw in p.rwset.ns_rw_sets:
                for coll in ns_rw.coll_hashed:
                    if not coll.hashed_writes:
                        continue
                    if self.is_eligible is not None and not self.is_eligible(
                        ns_rw.namespace, coll.collection_name
                    ):
                        continue
                    wanted.append((p.index, p.tx_id, ns_rw.namespace, coll.collection_name))
        by_index = {p.index: p for p in parsed}
        number = block["header"].get("number", 0)
        for tx_num, tx_id, ns, coll in wanted:
            rwset = by_index[tx_num].rwset
            data = None
            if self.transient_store is not None and tx_id:
                data = self.transient_store.get(tx_id, ns, coll)
                if data is not None and not pvt_data_matches_hashes(rwset, ns, coll, data):
                    data = None
            if data is None and self.fetch_pvt is not None:
                data = self.fetch_pvt(number, tx_num, tx_id, ns, coll)
                # fetched from untrusted peers: a hash mismatch is treated
                # as missing, never an error (coordinator.go fetch path)
                if data is not None and not pvt_data_matches_hashes(rwset, ns, coll, data):
                    data = None
            if data is not None:
                pvt_data[(tx_num, ns, coll)] = data
            else:
                missing.append(MissingEntry(tx_num, ns, coll))
        return pvt_data, missing

    def _verify_block_content(self, block: dict) -> None:
        """Position-independent checks (MCS VerifyBlock: DataHash +
        orderer signature) — safe in pipeline stage A, before the
        preceding block committed."""
        if protoutil.block_data_hash(block.get("data", {})) != block["header"].get("data_hash", b""):
            raise BlockVerificationError("Header.DataHash is different from Hash(block.Data)")
        if self.verify_orderer_sig is not None and not self.verify_orderer_sig(block):
            raise BlockVerificationError("orderer block signature invalid")

    def _verify_block_position(self, block: dict) -> None:
        """Chain-position checks — must run in commit order (stage B)."""
        header = block["header"]
        if header.get("number", 0) != self.ledger.height:
            raise BlockVerificationError(
                f"expected block {self.ledger.height}, got {header.get('number', 0)}"
            )
        if (
            self.ledger.height > 0
            and header.get("previous_hash", b"") != self.ledger.block_store.last_block_hash
        ):
            raise BlockVerificationError("previous-hash mismatch")

    @property
    def height(self) -> int:
        return self.ledger.height
