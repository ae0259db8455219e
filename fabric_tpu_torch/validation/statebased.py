"""State-based (key-level) endorsement validation: a copy of the JAX
package's `validation/statebased.py` over the port's ledger and policy modules.

Reference: core/common/validation/statebased/{validator_keylevel.go,
vpmanagerimpl.go, v20.go}. Semantics reproduced:

- each key a tx writes (public value/metadata writes and per-collection
  hashed value/metadata writes) is checked against the key's
  VALIDATION_PARAMETER metadata if set, else the chaincode (or
  collection) endorsement policy;
- if an earlier tx in the same block wrote metadata for that key and
  that tx validated successfully, the later tx is invalidated
  (ValidationParameterUpdatedError -> policy error), because its
  endorsements predate the new policy;
- the chaincode EP is evaluated at most once per (tx, namespace) and is
  always evaluated if nothing else was checked (FAB-9473,
  v20.go CheckCCEPIfNoEPChecked).

The reference runs txs concurrently and synchronizes with per-key waits
(vpmanagerimpl.go:293-308). Here validation is phased: signatures are
batch-verified on the device first (SURVEY.md §2.13 P1/P2), so the
key-level pass is a deterministic in-order host scan whose policy
evaluations hit the pre-computed (signer x principal) satisfaction bits
— same partial order, no locks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from fabric_tpu_torch.ledger.mvcc import deserialize_metadata
from fabric_tpu_torch.ledger.rwset import TxRwSet
from fabric_tpu_torch.policy.ast import SignaturePolicyEnvelope
from fabric_tpu_torch.policy.proto_convert import (
    PolicyConversionError,
    unmarshal_application_policy,
)

VALIDATION_PARAMETER = "VALIDATION_PARAMETER"


class ValidationParameterUpdatedError(Exception):
    """A preceding valid tx in this block updated the key's validation
    parameters — the tx's endorsements predate the new policy."""


class SBEExecutionError(Exception):
    """Unexpected (non-deterministic) failure: halts channel processing
    (reference VSCCExecutionFailureError)."""


class BlockDependencies:
    """Per-block in-block validation-parameter dependency tracking
    (vpmanagerimpl.go validationContext, made deterministic)."""

    def __init__(self, rwsets: Sequence[Optional[TxRwSet]]):
        # (ns, coll, key) -> sorted tx indices that metadata-write it
        self._writers: Dict[Tuple[str, str, object], List[int]] = {}
        # tx -> {ns: validated_ok}
        self._results: Dict[int, Dict[str, bool]] = {}
        for tx_num, rwset in enumerate(rwsets):
            if rwset is None:
                continue
            for ns_rw in rwset.ns_rw_sets:
                for mw in ns_rw.metadata_writes:
                    self._writers.setdefault(
                        (ns_rw.namespace, "", mw.key), []
                    ).append(tx_num)
                for coll in ns_rw.coll_hashed:
                    for mw in coll.metadata_writes:
                        self._writers.setdefault(
                            (
                                ns_rw.namespace,
                                coll.collection_name,
                                mw.key_hash,
                            ),
                            [],
                        ).append(tx_num)

    def set_result(self, tx_num: int, ns: str, ok: bool) -> None:
        """SetTxValidationResult: record tx_num's verdict for ns."""
        self._results.setdefault(tx_num, {})[ns] = ok

    def updated_by_earlier_valid_tx(
        self, ns: str, coll: str, key, tx_num: int
    ) -> bool:
        """waitForValidationResults: does any tx with a lower index that
        metadata-writes this key have a successful validation result for
        this namespace? Requires txs to be processed in index order.

        A missing result means the writer tx was invalidated before its
        SBE stage ran; that is treated like a failed validation (no
        dependency conflict) — the same outcome as the reference when
        the writer reaches the plugin and fails, and it avoids the
        reference's unresolvable wait when the writer never reaches the
        plugin at all."""
        for writer in self._writers.get((ns, coll, key), ()):
            if writer >= tx_num:
                break
            if self._results.get(writer, {}).get(ns):
                return True
        return False


class KeyLevelEvaluator:
    """Per-tx/namespace evaluator (baseEvaluator + policyCheckerV20).

    evaluate_policy(policy_env, tx_index) -> bool is supplied by the
    caller and is expected to consult the batch-verified signature /
    principal-satisfaction data for that tx's endorsements.
    """

    def __init__(
        self,
        cc_ep: SignaturePolicyEnvelope,
        deps: BlockDependencies,
        get_metadata: Callable[[str, str, object], Optional[bytes]],
        evaluate_policy: Callable[[SignaturePolicyEnvelope, int], bool],
        get_collection_ep: Optional[
            Callable[[str, str], Optional[SignaturePolicyEnvelope]]
        ] = None,
    ):
        self.cc_ep = cc_ep
        self.deps = deps
        self.get_metadata = get_metadata
        self.evaluate_policy = evaluate_policy
        self.get_collection_ep = get_collection_ep or (lambda cc, coll: None)
        # per-tx evaluation state (policyCheckerV20)
        self._ns_ep_checked: Set[str] = set()
        self._some_ep_checked = False

    def _reset_tx_state(self) -> None:
        self._ns_ep_checked = set()
        self._some_ep_checked = False

    def evaluate(
        self, rwset: TxRwSet, ns: str, tx_num: int
    ) -> Tuple[bool, str]:
        """baseEvaluator.Evaluate for one (tx, namespace). Returns
        (ok, reason)."""
        self._reset_tx_state()
        for ns_rw in rwset.ns_rw_sets:
            if ns_rw.namespace != ns:
                continue
            for w in ns_rw.writes:
                ok, why = self._check_key(ns, "", w.key, tx_num)
                if not ok:
                    return False, why
            for mw in ns_rw.metadata_writes:
                ok, why = self._check_key(ns, "", mw.key, tx_num)
                if not ok:
                    return False, why
            for coll in ns_rw.coll_hashed:
                cname = coll.collection_name
                for hw in coll.hashed_writes:
                    ok, why = self._check_key(ns, cname, hw.key_hash, tx_num)
                    if not ok:
                        return False, why
                for mw in coll.metadata_writes:
                    ok, why = self._check_key(ns, cname, mw.key_hash, tx_num)
                    if not ok:
                        return False, why
        # FAB-9473: always check at least the chaincode EP
        if not self._some_ep_checked:
            if not self.evaluate_policy(self.cc_ep, tx_num):
                return False, f"chaincode EP failed for ns {ns!r}"
            self._ns_ep_checked.add("")
            self._some_ep_checked = True
        return True, ""

    def _check_key(
        self, ns: str, coll: str, key, tx_num: int
    ) -> Tuple[bool, str]:
        """checkSBAndCCEP for one written key."""
        if self.deps.updated_by_earlier_valid_tx(ns, coll, key, tx_num):
            return False, (
                f"validation parameters for key {key!r} "
                f"(coll {coll!r}, ns {ns!r}) updated in this block"
            )
        vp_bytes = self._validation_parameter(ns, coll, key)
        if vp_bytes:
            try:
                policy = unmarshal_application_policy(vp_bytes)
            except PolicyConversionError as e:
                raise SBEExecutionError(
                    f"could not translate policy for {ns}:{key!r}: {e}"
                ) from e
            if not self.evaluate_policy(policy, tx_num):
                return False, (
                    f"key-level policy for key {key!r} failed"
                )
            self._some_ep_checked = True
            return True, ""
        return self._check_ccep_if_not_checked(ns, coll, tx_num)

    def _validation_parameter(self, ns: str, coll: str, key) -> Optional[bytes]:
        md = deserialize_metadata(self.get_metadata(ns, coll, key))
        if not md:
            return None
        return md.get(VALIDATION_PARAMETER)

    def _check_ccep_if_not_checked(
        self, ns: str, coll: str, tx_num: int
    ) -> Tuple[bool, str]:
        if coll:
            if coll in self._ns_ep_checked:
                return True, ""
            coll_ep = self.get_collection_ep(ns, coll)
            if coll_ep is not None:
                if not self.evaluate_policy(coll_ep, tx_num):
                    return False, (
                        f"collection EP for {coll!r} failed"
                    )
                self._ns_ep_checked.add(coll)
                self._some_ep_checked = True
                return True, ""
            # fall through to the chaincode EP
        if "" in self._ns_ep_checked:
            return True, ""
        if not self.evaluate_policy(self.cc_ep, tx_num):
            return False, f"chaincode EP failed for ns {ns!r}"
        self._ns_ep_checked.add("")
        self._some_ep_checked = True
        return True, ""
