"""Deliver engine (reference common/deliver/deliver.go Handle + the peer's
DeliverFiltered variants, core/peer/deliverevents.go).

Serves block ranges described by SeekInfo over any source exposing
`height` and `get_block(n)` (orderer chains, peer ledgers). Sessions are
policy-checked once per delivery and bound to a cert-expiry deadline
(ExpirationCheckFunc).

The port's counterpart of the JAX package's `deliver/server.py`: envelopes,
blocks and DeliverResponses are message dicts (`protos/ab.py`) whose bytes
are the JAX engine's, the signer's `not_after` is read through the port's
own X.509 reader, and the clock is the caller's (`clock`, UTC now by
default). A departure: only a failed policy (`PolicyError`) from the
policy checker becomes FORBIDDEN; any other error of the checker (a
provider that fails) raises out of the stream, where the JAX engine reads
every exception as FORBIDDEN. `filter_block` skips a transaction whose
bytes are no Envelope, as it skips one whose payload does not parse (the
JAX engine lets protobuf's DecodeError out for the first).
"""

from __future__ import annotations

import datetime
from typing import Callable, Iterator, Optional

from fabric_tpu_torch.common.txflags import TxValidationCode
from fabric_tpu_torch.orderer.msgprocessor import Clock, identity_expiration, utc_now
from fabric_tpu_torch.policy.manager import PolicyError, SignedData
from fabric_tpu_torch.protos import ab, fabric, protoutil, wire

__all__ = ["BlockSource", "DeliverError", "DeliverHandler", "deliver_filtered",
           "deliver_with_pvtdata", "filter_block", "identity_expiration", "pvt_data_map"]


class DeliverError(Exception):
    def __init__(self, status: int, msg: str = ""):
        super().__init__(msg or f"status {status}")
        self.status = status


class BlockSource:
    """What the engine needs from a chain/ledger. `wait_for(n)` blocks
    until height > n (BLOCK_UNTIL_READY) or raises on timeout."""

    def __init__(self, get_block, height_fn, wait_for=None):
        self.get_block = get_block
        self._height_fn = height_fn
        self._wait_for = wait_for

    @property
    def height(self) -> int:
        return self._height_fn()

    def wait_for(self, number: int, timeout: float) -> bool:
        if self._wait_for is not None:
            return self._wait_for(number, timeout)
        return self.height > number


def _status(status: int) -> dict:
    return {"status": status}


class DeliverHandler:
    def __init__(
        self,
        sources: Callable[[str], Optional[BlockSource]],
        policy_checker: Optional[Callable[[str, SignedData], None]] = None,
        wait_timeout: float = 10.0,
        clock: Optional[Clock] = None,
    ):
        """sources: channel_id -> BlockSource; policy_checker raises
        PolicyError to deny (reference: the Readers policy of the
        channel)."""
        self._sources = sources
        self._policy_checker = policy_checker
        self._wait_timeout = wait_timeout
        self._clock = clock or utc_now

    def deliver_blocks(self, envelope: dict) -> Iterator[dict]:
        """One seek session: yields block responses then a status."""
        try:
            payload = protoutil.unmarshal(fabric.PAYLOAD, envelope.get("payload", b""))
            header = payload.get("header", {})
            if not header.get("channel_header"):
                raise DeliverError(fabric.BAD_REQUEST, "missing channel header")
            chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER, header["channel_header"])
            channel_id = chdr.get("channel_id", "")
            seek = protoutil.unmarshal(ab.SEEK_INFO, payload.get("data", b""))
            source = self._sources(channel_id)
            if source is None:
                raise DeliverError(fabric.NOT_FOUND, f"channel {channel_id} not found")

            expires: Optional[datetime.datetime] = None
            creator = b""
            if header.get("signature_header"):
                shdr = protoutil.unmarshal(fabric.SIGNATURE_HEADER, header["signature_header"])
                creator = shdr.get("creator", b"")
                expires = identity_expiration(creator)
                if expires is not None and expires < self._clock():
                    raise DeliverError(fabric.FORBIDDEN, "client identity expired")
            if self._policy_checker is not None:
                if not header.get("signature_header"):
                    raise DeliverError(fabric.FORBIDDEN, "missing signature header")
                sd = SignedData(envelope.get("payload", b""), creator,
                                envelope.get("signature", b""))
                try:
                    self._policy_checker(channel_id, sd)
                except PolicyError as e:
                    raise DeliverError(fabric.FORBIDDEN, str(e)) from e

            start, stop = self._resolve_range(seek, source)
            number = start
            while number <= stop:
                if expires is not None and expires < self._clock():
                    raise DeliverError(fabric.FORBIDDEN, "session expired")
                if number >= source.height:
                    if seek.get("behavior", 0) == ab.FAIL_IF_NOT_READY:
                        raise DeliverError(fabric.NOT_FOUND, f"block {number} not yet available")
                    if not source.wait_for(number, self._wait_timeout):
                        raise DeliverError(fabric.SERVICE_UNAVAILABLE, "timed out waiting")
                block = source.get_block(number)
                if block is None:
                    raise DeliverError(fabric.NOT_FOUND, f"block {number} missing")
                yield {"block": block}
                number += 1
            yield _status(fabric.SUCCESS)
        except DeliverError as e:
            yield _status(e.status)
        except wire.WireError:  # only the codec's: a provider's ValueError raises
            yield _status(fabric.BAD_REQUEST)

    @staticmethod
    def _resolve_range(seek: dict, source: BlockSource):
        def pos(p: dict, default: int) -> int:
            if "oldest" in p:
                return 0
            if "newest" in p:
                return max(source.height - 1, 0)
            if "specified" in p:
                return p["specified"].get("number", 0)
            if "next_commit" in p:
                return source.height
            return default

        start = pos(seek.get("start", {}), 0)
        stop = pos(seek["stop"], start) if "stop" in seek else start
        if stop == ab.SEEK_MAX:  # "max" convention: deliver forever
            stop = 2**63
        if stop < start:
            raise DeliverError(fabric.BAD_REQUEST, "start number greater than stop number")
        return start, stop


def filter_block(block: dict, channel_id: str) -> dict:
    """Full block -> FilteredBlock (reference core/peer/deliverevents.go
    blockResponseSenderWithFilteredBlocks): txid/type/validation code only."""
    fb = {"channel_id": channel_id, "number": block["header"].get("number", 0),
          "filtered_transactions": []}
    metas = block.get("metadata", {}).get("metadata", [])
    flags = None
    if len(metas) > fabric.TRANSACTIONS_FILTER and metas[fabric.TRANSACTIONS_FILTER]:
        flags = list(metas[fabric.TRANSACTIONS_FILTER])
    for i, data in enumerate(block.get("data", {}).get("data", [])):
        try:
            env = protoutil.get_envelope_from_block_data(data)
            payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
            chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER,
                                       payload.get("header", {}).get("channel_header", b""))
        except ValueError:
            continue
        fb["filtered_transactions"].append({
            "txid": chdr.get("tx_id", ""),
            "type": chdr.get("type", 0),
            "tx_validation_code": flags[i] if flags is not None and i < len(flags)
            else int(TxValidationCode.NOT_VALIDATED),
        })
    return fb


def deliver_filtered(handler: DeliverHandler, envelope: dict) -> Iterator[dict]:
    """DeliverFiltered stream: same engine, filtered payloads."""
    payload = protoutil.unmarshal(fabric.PAYLOAD, envelope.get("payload", b""))
    chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER,
                               payload.get("header", {}).get("channel_header", b""))
    for resp in handler.deliver_blocks(envelope):
        if "block" in resp:
            yield {"filtered_block": filter_block(resp["block"], chdr.get("channel_id", ""))}
        else:
            yield resp


def pvt_data_map(entries) -> dict:
    """Stored PvtEntry rows for one block -> {tx_num: TxPvtReadWriteSet
    dict} (the wire shape of core/ledger TxPvtData in BlockAndPvtData)."""
    by_tx: dict = {}
    for e in sorted(entries, key=lambda e: (e.tx_num, e.namespace, e.collection)):
        tx = by_tx.setdefault(e.tx_num, {"ns_pvt_rwset": []})
        ns = next((c for c in tx["ns_pvt_rwset"] if c["namespace"] == e.namespace), None)
        if ns is None:
            ns = {"namespace": e.namespace, "collection_pvt_rwset": []}
            tx["ns_pvt_rwset"].append(ns)
        ns["collection_pvt_rwset"].append({"collection_name": e.collection, "rwset": e.rwset})
    return by_tx


def deliver_with_pvtdata(
    handler: DeliverHandler,
    envelope: dict,
    pvt_entries: Callable[[str, int], list],
    policy_checker: Optional[Callable] = None,
) -> Iterator[dict]:
    """DeliverWithPrivateData stream (reference
    core/peer/deliverevents.go:270 blockResponseSenderWithPrivateData):
    each block response carries the peer's stored cleartext private
    rwsets for that block, keyed by tx index. Blocks whose private data the
    peer never held have no map entry.

    This stream exposes private collection cleartext, so when a
    ``policy_checker(channel_id, SignedData)`` is configured the request
    MUST be signed and satisfy it; a PolicyError gets a FORBIDDEN status
    and no blocks, any other error of the checker raises."""
    try:
        payload = protoutil.unmarshal(fabric.PAYLOAD, envelope.get("payload", b""))
        header = payload.get("header", {})
        chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER, header.get("channel_header", b""))
    except ValueError:
        yield _status(fabric.BAD_REQUEST)
        return
    channel_id = chdr.get("channel_id", "")
    if policy_checker is not None:
        if not header.get("signature_header"):
            yield _status(fabric.FORBIDDEN)
            return
        shdr = protoutil.unmarshal(fabric.SIGNATURE_HEADER, header["signature_header"])
        try:
            policy_checker(channel_id, SignedData(envelope.get("payload", b""),
                                                  shdr.get("creator", b""),
                                                  envelope.get("signature", b"")))
        except PolicyError:
            yield _status(fabric.FORBIDDEN)
            return
    for resp in handler.deliver_blocks(envelope):
        if "block" in resp:
            block = resp["block"]
            entries = pvt_entries(channel_id, block["header"].get("number", 0))
            yield {"block_and_private_data": {"block": block,
                                              "private_data_map": pvt_data_map(entries)}}
        else:
            yield resp
