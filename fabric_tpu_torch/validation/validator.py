"""Block validator (reference core/committer/txvalidator/v20/validator.go +
plugindispatcher + builtin v20 VSCC), with every signature of a block in one
batch on the card.

The port's counterpart of the JAX package's `validation/validator.py`. A
block (a dict in `wire.decode`'s form, `protos/fabric.BLOCK`) is validated
in four phases:

1. host parse: structural checks per tx, emitting deferred signature jobs
   with their digests, in one native pass (`validation/blockparse.py`);
2. device batch: every creator and endorsement signature of the block
   verified in one `provider.batch_verify_async` call (K2 through
   `CUDAProvider`); identities are deserialized and their chains and CRLs
   checked on the host first;
3. host principal matching: (signer, principal) satisfaction bits with an
   identity/principal cache, warmed while the kernel runs;
4. policy circuits: txs grouped by endorsement policy, each group evaluated
   by `policy.evaluator.compile_batched_numpy` once per distinct signer
   pattern, as the JAX validator does (`validator.py:843-851`); blocks that
   touch key-level validation parameters take the sequential state-based
   pass; then duplicate TxIDs, and TRANSACTIONS_FILTER written into the
   block's metadata.

Between the groups and the policy circuits, groups whose definition names a
custom validation plugin go to it (`plugin_registry`, a
`validation/dispatcher.PluginRegistry`): `plugin.validate(ctx)` once per
(transaction, written namespace), with the signers' verdicts from the batch
(`validation/plugin_api.py`); EndorsementInvalid codes the tx
ENDORSEMENT_POLICY_FAILURE, any other exception halts the block with
ValidationError, and a plugin missing from the registry makes the txs
INVALID_CHAINCODE. `writeset_check(rwset, namespace)` (the legacy v1.2/v1.3
rules of `validation/legacy.py`, say) codes a tx ILLEGAL_WRITESET when it
returns an error string. Definitions are resolved once per namespace a
block: `LifecycleRegistry.get` reads `_lifecycle` state and builds a fresh
definition on every call.

The identity cache is the state the two stages of the commit pipeline
(`peer/pipeline.py`) share: stage A fills it in `collect_sig_jobs` on the
deliver thread while stage B's `validate` may clear it on the committer
thread (a config transaction rotating MSPs or CRLs). Every access holds a
lock, and a generation counter bumped by `invalidate_identity_caches` keeps
a fill that began before a rotation from landing after it, as in the JAX
validator (validator.py:155-166, :240-295).

`last_ms` holds the split of the last `validate` in milliseconds: parse
(the native pass), identity (deserialize, chain, expiry, CRL), host_prep
(digests of Python-parsed jobs and the provider's dispatch: DER parse, key
columns, copies, launch), principals (principal matching while the kernel
runs), verify_wait, policy (the custom plugins' calls included), assembly.
`last_parser` says which parse made the block's jobs ("native", or "python"
for a `parse_block_python` block a caller passed in), as `last_sig_backend`
says where the signatures ran.

A multi-channel scheduler (`parallel/multichannel.py`) splits phase 2:
`collect_sig_jobs` for each channel, one launch for every channel, then
`finish_sig_results` and `validate(block, parsed, sig_results=...)`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fabric_tpu_torch.common.txflags import TxValidationCode, ValidationFlags
from fabric_tpu_torch.crypto.bccsp import Provider
from fabric_tpu_torch.ledger.mvcc import deserialize_metadata
from fabric_tpu_torch.ledger.txparse import ParsedTx, SigJob
from fabric_tpu_torch.msp.identity import Identity, MSPError, MSPManager
from fabric_tpu_torch.policy.ast import SignaturePolicyEnvelope
from fabric_tpu_torch.policy.evaluator import compile_batched_numpy, evaluate_host
from fabric_tpu_torch.policy.proto_convert import principal_for
from fabric_tpu_torch.protos import fabric, protoutil, wire
from fabric_tpu_torch.validation.blockparse import ParsedBlock, parse_block
from fabric_tpu_torch.validation.plugin_api import (
    EndorsementInvalid,
    SignerInfo,
    ValidationContext,
)
from fabric_tpu_torch.validation.statebased import (
    VALIDATION_PARAMETER,
    BlockDependencies,
    KeyLevelEvaluator,
)


class ValidationError(Exception):
    """Terminal validation failure: aborts block processing (the
    reference's VSCCExecutionFailureError / config-tx apply errors)."""


@dataclass
class ChaincodeDefinition:
    """What the dispatcher needs per namespace (reference
    plugindispatcher valinforetriever / _lifecycle cache)."""

    name: str
    endorsement_policy: SignaturePolicyEnvelope
    plugin: str = "builtin"


class ChaincodeRegistry:
    """Static stand-in for the _lifecycle validation-info source."""

    def __init__(self, definitions: Sequence[ChaincodeDefinition] = ()):
        self._defs = {d.name: d for d in definitions}

    def get(self, name: str) -> Optional[ChaincodeDefinition]:
        return self._defs.get(name)


# (policy envelope, plugin) -> (definition, [(tx index, namespace), ...])
PolicyGroups = Dict[
    Tuple[SignaturePolicyEnvelope, str],
    Tuple[ChaincodeDefinition, List[Tuple[int, str]]],
]


class BlockValidator:
    """Per-channel validator: block -> TRANSACTIONS_FILTER."""

    def __init__(
        self,
        channel_id: str,
        msp_manager: MSPManager,
        provider: Provider,
        registry: ChaincodeRegistry,
        tx_exists: Optional[Callable[[str], bool]] = None,
        apply_config: Optional[Callable[[bytes], None]] = None,
        get_state_metadata: Optional[Callable[[str, str, object], Optional[bytes]]] = None,
        get_collection_ep: Optional[
            Callable[[str, str], Optional[SignaturePolicyEnvelope]]
        ] = None,
        writeset_check: Optional[Callable] = None,
        plugin_registry=None,
    ):
        # an extra write-set rule, e.g. the v12 system-namespace guards on
        # legacy channels (validation/legacy.check_v12_writeset)
        self.writeset_check = writeset_check
        # named custom validation plugins (dispatcher.PluginRegistry):
        # groups whose plugin resolves to an object with a `validate`
        # callable are dispatched there instead of the builtin path
        self.plugin_registry = plugin_registry
        self.channel_id = channel_id
        self.msp_manager = msp_manager
        self.provider = provider
        # backend label of the most recent signature batch, and the parse
        # ("native" or "python") the last validated block came from
        self.last_sig_backend: Optional[str] = None
        self.last_parser: Optional[str] = None
        self.last_ms: Dict[str, float] = {}
        self.registry = registry
        self.tx_exists = tx_exists or (lambda txid: False)
        self.apply_config = apply_config
        # committed key metadata for state-based endorsement:
        # (ns, coll, key) -> serialized metadata bytes
        self.get_state_metadata = get_state_metadata or (lambda ns, coll, key: None)
        self.get_collection_ep = get_collection_ep
        self._principal_cache: Dict[Tuple[bytes, bytes], bool] = {}
        # keyed by the (hashable, frozen) envelope itself
        self._policy_fn_cache: Dict[SignaturePolicyEnvelope, Callable] = {}
        self._principals_cache: Dict[SignaturePolicyEnvelope, List[Tuple[dict, bytes]]] = {}
        # serialized identity bytes -> validated Identity, or None when
        # deserialization or chain validation failed (msp/cache analog);
        # shared by the pipeline's two stages, so every access holds
        # _ident_lock, and _ident_gen (bumped on every rotation clear)
        # drops a fill that started before the clear
        self._ident_cache: Dict[bytes, Optional[Identity]] = {}
        self._ident_lock = threading.Lock()
        self._ident_gen = 0
        # per-policy memo of circuit verdicts keyed by the tx's signer
        # pattern (tuple of (Identity, sig_ok)); strong refs, no aliasing
        self._pattern_memo: Dict[SignaturePolicyEnvelope, Dict[tuple, bool]] = {}
        self._job_identity: Dict[int, Optional[Identity]] = {}
        self._sig_results: Dict[int, bool] = {}

    def _stamp(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.last_ms[key] = self.last_ms.get(key, 0.0) + (t1 - t0) * 1e3
        return t1

    # ------------------------------------------------------------------
    def validate(
        self,
        block: dict,
        parsed: Optional[ParsedBlock] = None,
        sig_results: Optional[Dict[int, bool]] = None,
    ) -> ValidationFlags:
        """Validate a block; writes TRANSACTIONS_FILTER metadata and returns
        the flags (reference Validate, v20/validator.go:180-265). `parsed`
        lets the caller share one parse with the commit step; `sig_results`
        ({id(job): verdict}, from `finish_sig_results`) lets a multi-channel
        scheduler verify several channels' signatures in one launch."""
        self.last_ms = {}
        t = time.perf_counter()
        data = list(block.get("data", {}).get("data", ()))
        if parsed is None:
            parsed = parse_block(data)
        self.last_parser = "native" if parsed.native else "python"
        t = self._stamp("parse", t)

        if sig_results is None:
            sig_results = self._batch_verify_sigs(parsed)
        t = time.perf_counter()
        flags = ValidationFlags(len(data))
        txid_array: List[str] = [""] * len(data)
        groups = self._assemble_codes(parsed, sig_results, flags, txid_array)
        t = self._stamp("assembly", t)
        groups, plugin_results = self._dispatch_custom_plugins(groups, parsed, flags, block)
        self._evaluate_policies(groups, parsed, flags, plugin_results)
        t = self._stamp("policy", t)

        # duplicate TxIDs: vs ledger first (checkTxIdDupsLedger), then
        # in-block (markTXIdDuplicates); the first occurrence wins
        for tx in parsed:
            i = tx.index
            if flags.flag(i) == TxValidationCode.NOT_VALIDATED:
                # building a lazy rwset in the policy phase may have demoted
                # the tx (the native walk and the Python parse disagreed)
                if tx.code == TxValidationCode.BAD_RWSET:
                    flags.set_flag(i, TxValidationCode.BAD_RWSET)
                    continue
                flags.set_flag(i, TxValidationCode.VALID)
                txid_array[i] = tx.tx_id
        seen: Dict[str, int] = {}
        for i, txid in enumerate(txid_array):
            if not txid:
                continue
            # endorser txs paid the ledger probe in _assemble_codes
            if parsed[i].header_type != fabric.ENDORSER_TRANSACTION and self.tx_exists(txid):
                flags.set_flag(i, TxValidationCode.DUPLICATE_TXID)
                txid_array[i] = ""
                continue
            if txid in seen:
                flags.set_flag(i, TxValidationCode.DUPLICATE_TXID)
            else:
                seen[txid] = i

        protoutil.init_block_metadata(block)
        block["metadata"]["metadata"][fabric.TRANSACTIONS_FILTER] = flags.tobytes()
        self._stamp("assembly", t)
        return flags

    # ------------------------------------------------------------------
    def invalidate_identity_caches(self) -> None:
        """MSPs/CRLs rotated: drop every identity-derived cache. The
        identity cache's clear and generation bump are thread-safe: a
        stage-A fill validated against the pre-rotation CRL compares
        generations and drops. The principal and pattern memos have one
        reader and writer (the validate() thread)."""
        with self._ident_lock:
            self._ident_cache.clear()
            self._ident_gen += 1
        self._principal_cache.clear()
        self._pattern_memo.clear()

    def collect_sig_jobs(
        self, parsed: Sequence[ParsedTx]
    ) -> Tuple[List[SigJob], Dict[int, Optional[Identity]], List, List[bytes], List[bytes]]:
        """Every deferred signature job of the block, identities
        deserialized and chain/CRL validated (reference identities.go:107),
        verifiable jobs flattened into (keys, sigs, digests) batch inputs.
        The native parse's digests are used as they are; the jobs of a
        Python parse are hashed here, in one provider batch."""
        t = time.perf_counter()
        jobs: List[SigJob] = []
        for tx in parsed:
            if tx.creator_sig_job is not None:
                jobs.append(tx.creator_sig_job)
            jobs.extend(tx.endorsement_jobs)
        keys, sigs, verifiable = [], [], []
        job_identity: Dict[int, Optional[Identity]] = {}
        ident_cache = self._ident_cache
        with self._ident_lock:
            if len(ident_cache) > 8192:
                ident_cache.clear()
        _MISS = object()
        for job in jobs:
            ibytes = job.identity_bytes
            with self._ident_lock:
                ident = ident_cache.get(ibytes, _MISS)
                gen = self._ident_gen
            if ident is _MISS:
                # the chain walk and CRL check run outside the lock (a
                # racing duplicate fill is idempotent)
                try:
                    ident, msp = self.msp_manager.deserialize_identity(ibytes)
                    msp.validate(ident)  # cert chain + CRL (identities.go:107)
                except MSPError:
                    ident = None
                with self._ident_lock:
                    # a rotation during the validation: the result reflects
                    # the old CRL and must not enter the new cache
                    if self._ident_gen == gen:
                        ident_cache[ibytes] = ident
            job_identity[id(job)] = ident
            if ident is None:
                continue
            keys.append(ident.public_key)
            sigs.append(job.signature)
            verifiable.append(job)
        t = self._stamp("identity", t)
        digests = [job.digest for job in verifiable]
        raw = [k for k, d in enumerate(digests) if d is None]
        if raw:
            for k, d in zip(raw, self.provider.batch_hash([verifiable[k].data for k in raw])):
                digests[k] = d
        self._stamp("host_prep", t)
        return jobs, job_identity, keys, sigs, digests

    def finish_sig_results(
        self,
        jobs: Sequence[SigJob],
        job_identity: Dict[int, Optional[Identity]],
        ok_list: Sequence[bool],
    ) -> Dict[int, bool]:
        """Map the verdicts of the verifiable jobs, in `collect_sig_jobs`'
        order, back to {id(job): bool}; a job whose identity failed
        deserialization or validation is False."""
        it = iter(ok_list)
        self._job_identity = job_identity
        self._sig_results = {
            id(job): job_identity[id(job)] is not None and bool(next(it)) for job in jobs
        }
        return self._sig_results

    def _batch_verify_sigs(self, parsed: Sequence[ParsedTx]) -> Dict[int, bool]:
        """Verify every deferred signature job in one batch; {id(job): bool},
        False for a job whose identity failed deserialization/validation."""
        jobs, job_identity, keys, sigs, digests = self.collect_sig_jobs(parsed)
        dispatch = getattr(self.provider, "batch_verify_async", None)
        t = time.perf_counter()
        if dispatch is not None:
            # principal matching does not depend on the verdicts: warm the
            # satisfaction cache while the kernel runs
            resolver = dispatch(keys, sigs, digests)
            t = self._stamp("host_prep", t)
            self._prewarm_satisfaction(parsed, job_identity)
            t = self._stamp("principals", t)
            ok_list = resolver()
        else:
            ok_list = self.provider.batch_verify(keys, sigs, digests)
        self._stamp("verify_wait", t)
        self.last_sig_backend = self.provider.describe_backend()
        return self.finish_sig_results(jobs, job_identity, ok_list)

    def _prewarm_satisfaction(
        self, parsed: Sequence[ParsedTx], job_identity: Dict[int, Optional[Identity]]
    ) -> None:
        by_ns: Dict[str, Optional[List]] = {}
        seen = set()
        for tx in parsed:
            if not tx.structurally_valid or tx.header_type != fabric.ENDORSER_TRANSACTION:
                continue
            pairs = by_ns.get(tx.namespace, False)
            if pairs is False:
                definition = self.registry.get(tx.namespace)
                pairs = None if definition is None else self._principal_pairs(
                    definition.endorsement_policy)
                by_ns[tx.namespace] = pairs
            if pairs is None:
                continue
            for job in tx.endorsement_jobs:
                ident = job_identity.get(id(job))
                if ident is None or (id(ident), tx.namespace) in seen:
                    continue
                seen.add((id(ident), tx.namespace))
                for pr, pr_bytes in pairs:
                    self._satisfies(ident, pr, pr_bytes)

    # ------------------------------------------------------------------
    def _assemble_codes(
        self,
        parsed: Sequence[ParsedTx],
        sig_results: Dict[int, bool],
        flags: ValidationFlags,
        txid_array: List[str],
    ) -> PolicyGroups:
        """Reference-ordered early code assembly; returns the policy groups."""
        groups: PolicyGroups = {}
        # one registry lookup a namespace a block (a LifecycleRegistry reads
        # state and builds a fresh definition on every get)
        definitions: Dict[str, Optional[ChaincodeDefinition]] = {}
        for tx in parsed:
            i = tx.index
            if not tx.structurally_valid:
                flags.set_flag(i, tx.code)
                continue
            if not sig_results[id(tx.creator_sig_job)]:
                flags.set_flag(i, TxValidationCode.BAD_CREATOR_SIGNATURE)
                continue
            # channel routing (v20/validator.go:349-357)
            if tx.channel_id != self.channel_id:
                flags.set_flag(i, TxValidationCode.TARGET_CHAIN_NOT_FOUND)
                continue
            if tx.header_type == fabric.CONFIG:
                try:
                    if self.apply_config is not None:
                        self.apply_config(tx.config_data)
                        # a config change can rotate MSPs/CRLs/policies
                        self.invalidate_identity_caches()
                except Exception as e:
                    raise ValidationError(f"error validating config tx: {e}") from e
                continue  # VALID (assigned later)
            if tx.header_type != fabric.ENDORSER_TRANSACTION:
                flags.set_flag(i, TxValidationCode.UNKNOWN_TX_TYPE)
                continue
            # a replayed txid is DUPLICATE_TXID even when its policy would
            # also fail (v20/validator.go:349 runs before the dispatch)
            if tx.tx_id and self.tx_exists(tx.tx_id):
                flags.set_flag(i, TxValidationCode.DUPLICATE_TXID)
                continue
            # the invoked chaincode plus every namespace the tx writes to is
            # validated against its own policy (dispatcher.go:174-218)
            wr_ns = [tx.namespace]
            entries = tx.ns_entries or ()
            names = [ns for ns, _ in entries]
            if len(set(names)) != len(names):  # dup namespace (dispatcher.go:175-178)
                flags.set_flag(i, TxValidationCode.ILLEGAL_WRITESET)
                continue
            wr_ns += [ns for ns, writes in entries if ns != tx.namespace and writes]
            if self.writeset_check is not None and self.writeset_check(
                    tx.rwset, tx.namespace) is not None:
                flags.set_flag(i, TxValidationCode.ILLEGAL_WRITESET)
                continue
            defs = []
            for ns in wr_ns:
                if ns not in definitions:
                    definitions[ns] = self.registry.get(ns)
                definition = definitions[ns]
                if definition is None:
                    flags.set_flag(i, TxValidationCode.INVALID_CHAINCODE)
                    break
                defs.append((ns, definition))
            else:
                for ns, definition in defs:
                    key = (definition.endorsement_policy, definition.plugin)
                    groups.setdefault(key, (definition, []))[1].append((i, ns))
        return groups

    def _dispatch_custom_plugins(
        self,
        groups: PolicyGroups,
        parsed: Sequence[ParsedTx],
        flags: ValidationFlags,
        block: dict,
    ) -> Tuple[PolicyGroups, Dict[int, Dict[str, bool]]]:
        """Route the groups bound to a custom validation plugin (reference
        plugindispatcher: plugin.Validate per written namespace); groups on
        the builtin plugin pass through to the batched or SBE evaluation.

        Returns (remaining groups, plugin_results), plugin_results being
        {tx index: {namespace: ok}}: the SBE pass needs them so that a valid
        plugin-validated tx's key-metadata writes count as applied for the
        txs after it."""
        remaining: PolicyGroups = {}
        plugin_results: Dict[int, Dict[str, bool]] = {}
        datas = block.get("data", {}).get("data", ())
        for key, (definition, entries) in groups.items():
            plugin = None
            if self.plugin_registry is not None:
                plugin = self.plugin_registry.get(definition.plugin)
            if not callable(getattr(plugin, "validate", None)):
                if definition.plugin not in ("builtin", "vscc"):
                    # a named plugin missing from the registry: the
                    # definition is unusable (plugin_validator.go
                    # getOrCreatePlugin error)
                    for i, _ns in entries:
                        flags.set_flag(i, TxValidationCode.INVALID_CHAINCODE)
                    continue
                remaining[key] = (definition, entries)
                continue
            env = definition.endorsement_policy
            for i, ns in entries:
                if flags.flag(i) != TxValidationCode.NOT_VALIDATED:
                    continue
                tx = parsed[i]
                signers = []
                for job in tx.endorsement_jobs:
                    ident = self._job_identity.get(id(job))
                    signers.append(SignerInfo(
                        msp_id=ident.msp_id if ident else "",
                        identity_bytes=job.identity_bytes,
                        sig_valid=self._sig_ok(job),
                    ))
                ctx = ValidationContext(
                    channel_id=self.channel_id,
                    block_num=block["header"].get("number", 0),
                    tx_index=i,
                    namespace=ns,
                    tx_id=tx.tx_id,
                    envelope_bytes=bytes(datas[i]),
                    policy=env,
                    signers=signers,
                    default_check=lambda _tx=tx, _env=env: self._eval_policy_host(_tx, _env),
                    get_state_metadata=self.get_state_metadata,
                    ns_entries=tuple(tx.ns_entries or ()),
                )
                try:
                    plugin.validate(ctx)
                    plugin_results.setdefault(i, {})[ns] = True
                except EndorsementInvalid:
                    flags.set_flag(i, TxValidationCode.ENDORSEMENT_POLICY_FAILURE)
                    plugin_results.setdefault(i, {})[ns] = False
                except Exception as exc:  # noqa: BLE001 - halts the block, never marks the tx
                    raise ValidationError(
                        f"validation plugin {definition.plugin!r} failed "
                        f"on tx {i} ns {ns}: {exc}"
                    ) from exc
        return remaining, plugin_results

    def _satisfies(self, ident: Identity, principal: dict, principal_bytes: bytes) -> bool:
        key = (ident.fingerprint(), principal_bytes)
        hit = self._principal_cache.get(key)
        if hit is None:
            try:
                self.msp_manager.get_msp(ident.msp_id).satisfies_principal(ident, principal)
                hit = True
            except MSPError:
                hit = False
            if len(self._principal_cache) > 65536:
                self._principal_cache.clear()
            self._principal_cache[key] = hit
        return hit

    # ------------------------------------------------------------------
    def _evaluate_policies(
        self,
        groups: PolicyGroups,
        parsed: ParsedBlock,
        flags: ValidationFlags,
        plugin_results: Optional[Dict[int, Dict[str, bool]]] = None,
    ) -> None:
        """The common case, no key-level validation parameters in sight,
        takes the batched path; blocks touching state-based endorsement take
        the exact sequential key-level pass (validator_keylevel.go)."""
        if any(tx.has_md_writes for tx in parsed) or self._any_vp_on_written_keys(groups, parsed):
            deps = BlockDependencies([tx.rwset for tx in parsed])
            self._evaluate_policies_sbe(groups, parsed, flags, deps, plugin_results or {})
        else:
            self._evaluate_policies_batched(groups, parsed, flags)

    def _any_vp_on_written_keys(self, groups: PolicyGroups, parsed: ParsedBlock) -> bool:
        # after the native parse, the columnar written-keys table: no rwset
        # is built. Only txs actually dispatched: invalid txs must not cost
        # state reads or force the sequential path
        dispatched = {i for _d, entries in groups.values() for i, _ns in entries}
        return any(
            i in dispatched and self._has_vp(ns, coll, key)
            for i, ns, coll, key in parsed.iter_written_keys()
        )

    def _has_vp(self, ns: str, coll: str, key) -> bool:
        md = deserialize_metadata(self.get_state_metadata(ns, coll, key))
        return bool(md) and VALIDATION_PARAMETER in md

    def _evaluate_policies_sbe(
        self,
        groups: PolicyGroups,
        parsed: Sequence[ParsedTx],
        flags: ValidationFlags,
        deps: BlockDependencies,
        plugin_results: Dict[int, Dict[str, bool]],
    ) -> None:
        """Sequential key-level pass in tx order over the batch-verified
        signatures."""
        pairs_by_tx: Dict[int, List[Tuple[str, ChaincodeDefinition]]] = {}
        for definition, entries in groups.values():
            for i, ns in entries:
                pairs_by_tx.setdefault(i, []).append((ns, definition))
        for tx in parsed:
            i = tx.index
            rwset = tx.rwset
            namespaces = [ns.namespace for ns in rwset.ns_rw_sets] if rwset else []
            pairs = pairs_by_tx.get(i)
            if pairs is None or rwset is None:
                # a tx validated by custom plugins alone: a valid one's
                # key-metadata writes count as applied for later txs
                plug = plugin_results.get(i)
                if plug is not None and rwset is not None:
                    still_valid = flags.flag(i) == TxValidationCode.NOT_VALIDATED
                    for ns in namespaces:
                        deps.set_result(i, ns, still_valid and plug.get(ns, True))
                    continue
                # invalidated earlier / config tx: its metadata writes do
                # not update validation parameters
                for ns in namespaces:
                    deps.set_result(i, ns, False)
                continue
            # each written namespace validates against its own policy
            # (dispatcher.go:190); the first failure fails the rest. A tx
            # that spans plugin-bound and builtin namespaces carries its
            # plugin verdicts in
            plug = plugin_results.get(i) or {}
            validated: Dict[str, bool] = dict(plug)
            failed = not all(plug.values()) if plug else False
            for ns, definition in pairs:
                if failed:
                    validated[ns] = False
                    continue
                evaluator = KeyLevelEvaluator(
                    definition.endorsement_policy,
                    deps,
                    self.get_state_metadata,
                    lambda env, _tx_num, _tx=tx: self._eval_policy_host(_tx, env),
                    self.get_collection_ep,
                )
                ok, _why = evaluator.evaluate(rwset, ns, i)
                validated[ns] = ok
                if not ok:
                    failed = True
            if failed:
                flags.set_flag(i, TxValidationCode.ENDORSEMENT_POLICY_FAILURE)
            for ns in set(namespaces) | {tx.namespace}:
                deps.set_result(i, ns, validated.get(ns, False) and not failed)

    def _eval_policy_host(self, tx: ParsedTx, env: SignaturePolicyEnvelope) -> bool:
        return evaluate_host(env, self.signer_sat_rows(tx, env))

    def signer_sat_rows(self, tx: ParsedTx, env: SignaturePolicyEnvelope) -> np.ndarray:
        """(valid deduped signers x principals) satisfaction matrix for one
        tx (SignatureSetToValidIdentities + principal matching): signers are
        deduped by (MSP, fingerprint) before non-verifying ones drop."""
        pairs = self._principal_pairs(env)
        rows = []
        seen_ids = set()
        for job in tx.endorsement_jobs:
            ident = self._job_identity.get(id(job))
            if ident is None:
                continue
            fp = (ident.msp_id, ident.fingerprint())
            if fp in seen_ids:
                continue
            seen_ids.add(fp)
            if not self._sig_ok(job):
                continue
            rows.append([self._satisfies(ident, pr, b) for pr, b in pairs])
        return np.array(rows, dtype=bool).reshape(len(rows), len(pairs))

    def _pattern_key(self, tx: ParsedTx) -> tuple:
        """(Identity, sig_ok) per endorsement job with a resolvable
        identity, in job order: equal patterns give equal satisfaction rows
        for any policy."""
        return tuple(
            (ident, self._sig_ok(job))
            for job in tx.endorsement_jobs
            if (ident := self._job_identity.get(id(job))) is not None
        )

    def _evaluate_policies_batched(
        self, groups: PolicyGroups, parsed: Sequence[ParsedTx], flags: ValidationFlags
    ) -> None:
        """Batched endorsement-policy evaluation per chaincode definition,
        once per distinct (policy, signer pattern); the verdict fans out."""
        if len(self._pattern_memo) > 64:
            self._pattern_memo.clear()
        for definition, entries in groups.values():
            env = definition.endorsement_policy
            memo = self._pattern_memo.setdefault(env, {})
            if len(memo) > 4096:
                memo.clear()
            fresh: Dict[tuple, List[int]] = {}
            for i, _ns in entries:
                key = self._pattern_key(parsed[i])
                verdict = memo.get(key)
                if verdict is None:
                    fresh.setdefault(key, []).append(i)
                elif verdict is False:
                    flags.set_flag(i, TxValidationCode.ENDORSEMENT_POLICY_FAILURE)
            if not fresh:
                continue
            reps = [txs[0] for txs in fresh.values()]
            per_rep_sat = [self.signer_sat_rows(parsed[i], env) for i in reps]
            max_signers = max((s.shape[0] for s in per_rep_sat), default=0)
            if max_signers == 0:
                ok = np.zeros(len(reps), dtype=bool)
            else:
                batch = np.zeros((len(reps), max_signers, len(env.identities)), dtype=bool)
                for j, sat in enumerate(per_rep_sat):
                    batch[j, : sat.shape[0]] = sat
                ok = np.asarray(self._policy_fn(env)(batch))
                # a rep with zero valid signers never satisfies the policy
                for j, sat in enumerate(per_rep_sat):
                    if sat.shape[0] == 0:
                        ok[j] = False
            for j, (key, txs) in enumerate(fresh.items()):
                memo[key] = bool(ok[j])
                if not ok[j]:
                    for i in txs:
                        flags.set_flag(i, TxValidationCode.ENDORSEMENT_POLICY_FAILURE)

    def _sig_ok(self, job: SigJob) -> bool:
        return self._sig_results.get(id(job), False)

    def _policy_fn(self, env: SignaturePolicyEnvelope):
        fn = self._policy_fn_cache.get(env)
        if fn is None:
            fn = self._policy_fn_cache[env] = compile_batched_numpy(env)
        return fn

    def _principal_pairs(self, env: SignaturePolicyEnvelope) -> List[Tuple[dict, bytes]]:
        """[(principal, serialized)], serialized once per policy."""
        ps = self._principals_cache.get(env)
        if ps is None:
            ps = [(pr, wire.encode(fabric.MSP_PRINCIPAL, pr))
                  for pr in (principal_for(p) for p in env.identities)]
            self._principals_cache[env] = ps
        return ps
