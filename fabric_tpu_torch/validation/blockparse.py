"""Block-level structural parse: one native C++ pass over every envelope
(`native/blockparse.cc` through `utils/native.block_parse`).

The port's counterpart of the JAX package's `validation/blockparse.py`.
It replaces, on the host path, the per-transaction unwrap of the reference's
core/common/validation/msgvalidation.go:248-330 (ValidateTransaction) and
core/handlers/validation/builtin/v20/validation_logic.go:109-177
(extractValidationArtifacts).

`parse_block` takes the native pass and builds the `ParsedTx` objects from
its columns: lazy rwsets (the native walk already checked their
structure), each job's digest, one bytes object per distinct identity, and
the columnar written-keys table the state-based endorsement gate reads, so
a block with no key-level policies never builds a Python rwset tree while
it is validated. `parse_block_python`, the per-transaction Python parse,
is the plain version the tests hold it to; nothing picks between the two
silently (a failed native build raises).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

from fabric_tpu_torch.common.txflags import TxValidationCode
from fabric_tpu_torch.ledger.txparse import ParsedTx, SigJob, parse_transaction
from fabric_tpu_torch.protos import fabric
from fabric_tpu_torch.utils import native


class ParsedBlock(list):
    """List of ParsedTx; after the native pass (`native` True) also the
    columnar written-keys table, read by `iter_written_keys` without
    building rwsets."""

    def __init__(self, txs: Sequence[ParsedTx], columns: native.BlockColumns = None):
        super().__init__(txs)
        self.native = columns is not None
        self._columns = columns

    def iter_written_keys(self) -> Iterator[Tuple[int, str, str, object]]:
        """(tx_index, namespace, collection, key) for every written key of
        every structurally valid endorser tx. Public keys are str,
        collection-hashed keys are bytes."""
        if not self.native:
            for tx in self:
                if tx.rwset is None:
                    continue
                for ns_rw in tx.rwset.ns_rw_sets:
                    for w in ns_rw.writes:
                        yield tx.index, ns_rw.namespace, "", w.key
                    for coll in ns_rw.coll_hashed:
                        for hw in coll.hashed_writes:
                            yield tx.index, ns_rw.namespace, coll.collection_name, hw.key_hash
            return
        c = self._columns
        buf = c.buf
        ns_str = c.ns_str.tolist()
        wk_coll, wk_key = c.wk_coll.tolist(), c.wk_key.tolist()
        names = {}
        for k, (tx, ns, hashed) in enumerate(zip(c.wk_tx.tolist(), c.wk_ns.tolist(),
                                                 c.wk_hashed.tolist())):
            name = names.get(ns)
            if name is None:
                o, n = ns_str[2 * ns], ns_str[2 * ns + 1]
                name = names[ns] = buf[o:o + n].decode("utf-8")
            ko, kn = wk_key[2 * k], wk_key[2 * k + 1]
            if hashed:
                co, cn = wk_coll[2 * k], wk_coll[2 * k + 1]
                yield tx, name, buf[co:co + cn].decode("utf-8"), buf[ko:ko + kn]
            else:
                yield tx, name, "", buf[ko:ko + kn].decode("utf-8")


def parse_block_python(datas: Sequence[bytes]) -> ParsedBlock:
    """Every envelope through the per-transaction Python parse
    (`ledger/txparse.parse_transaction`; reference: the per-goroutine
    validateTx fan-out in v20/validator.go:180-265)."""
    return ParsedBlock([parse_transaction(i, d) for i, d in enumerate(datas)])


def parse_block(datas: Sequence[bytes]) -> ParsedBlock:
    """Parse every envelope of a block in one native pass: the same codes,
    fields and jobs as `parse_block_python`, with each job's digest."""
    c = native.block_parse(datas)
    buf = c.buf
    # one tolist() per column: numpy scalar indexing in this loop costs
    # about ten times a list index
    code, header, has_md, strs = (c.code.tolist(), c.header_type.tolist(), c.has_md.tolist(),
                                  c.strs.tolist())

    def text(base: int) -> str:
        return buf[strs[base]:strs[base] + strs[base + 1]].decode("utf-8")

    def raw(base: int) -> bytes:
        return buf[strs[base]:strs[base] + strs[base + 1]]

    txs: List[ParsedTx] = []
    for i in range(len(datas)):
        tx = ParsedTx(i)
        tx.code = TxValidationCode(code[i])
        ht = tx.header_type = header[i]
        if ht >= 0:
            base = 12 * i
            tx.channel_id, tx.tx_id, tx.creator = text(base), text(base + 2), raw(base + 4)
            if ht == fabric.CONFIG:
                tx.config_data = raw(base + 6)
            elif ht == fabric.ENDORSER_TRANSACTION and tx.structurally_valid:
                tx.namespace = text(base + 8)
                tx.results = tx._rwset_raw = raw(base + 10)
                tx._has_md_writes = bool(has_md[i])
                tx._ns_entries = []
        txs.append(tx)

    ns_str = c.ns_str.tolist()
    for e, (i, writes) in enumerate(zip(c.ns_tx.tolist(), c.ns_writes.tolist())):
        o, n = ns_str[2 * e], ns_str[2 * e + 1]
        txs[i]._ns_entries.append((buf[o:o + n].decode("utf-8"), bool(writes)))

    # one bytes object per distinct identity: the validator's identity
    # cache then hashes and compares each signer once
    uniq = c.uniq.tolist()
    identities = [buf[uniq[2 * u]:uniq[2 * u] + uniq[2 * u + 1]] for u in range(len(uniq) // 2)]
    digests = c.job_digest.tobytes()
    sig = c.job_sig.tolist()
    for k, (i, ident, creator) in enumerate(zip(c.job_tx.tolist(), c.job_ident.tolist(),
                                                c.job_is_creator.tolist())):
        job = SigJob(identities[ident], buf[sig[2 * k]:sig[2 * k] + sig[2 * k + 1]], b"",
                     digests[32 * k:32 * k + 32])
        if creator:
            txs[i].creator_sig_job = job
        else:
            txs[i].endorsement_jobs.append(job)
    return ParsedBlock(txs, c)
