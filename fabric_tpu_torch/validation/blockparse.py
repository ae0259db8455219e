"""Block-level structural parse: every envelope of a block through the
per-transaction parser.

The port's counterpart of the JAX package's `validation/blockparse.py`,
per-transaction path only. The JAX module's native C++ pass
(`native/blockparse.cc`) is host code, not a device kernel, and is not
ported yet; it gives the same codes and jobs as the per-transaction parser.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

from fabric_tpu_torch.ledger.txparse import ParsedTx, parse_transaction


class ParsedBlock(list):
    """List of ParsedTx with the written-keys walk the validator's
    state-based endorsement gate reads."""

    def iter_written_keys(self) -> Iterator[Tuple[int, str, str, object]]:
        """(tx_index, namespace, collection, key) for every written key of
        every structurally valid endorser tx. Public keys are str,
        collection-hashed keys are bytes."""
        for tx in self:
            if tx.rwset is None:
                continue
            for ns_rw in tx.rwset.ns_rw_sets:
                for w in ns_rw.writes:
                    yield tx.index, ns_rw.namespace, "", w.key
                for coll in ns_rw.coll_hashed:
                    for hw in coll.hashed_writes:
                        yield tx.index, ns_rw.namespace, coll.collection_name, hw.key_hash


def parse_block(datas: Sequence[bytes]) -> ParsedBlock:
    """Parse every envelope of a block (reference: the per-goroutine
    validateTx fan-out in v20/validator.go:180-265)."""
    return ParsedBlock([parse_transaction(i, d) for i, d in enumerate(datas)])
