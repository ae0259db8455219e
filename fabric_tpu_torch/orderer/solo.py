"""Solo consenter (reference orderer/consensus/solo/consensus.go).

Single-node ordering for dev/test networks: envelopes go straight through
the blockcutter; each batch becomes a signed block chained by
previous_hash via the shared BlockWriter. Config messages cut their own
block (msgprocessor classification), matching the reference's isolation
of config txs.

The port's counterpart of the JAX package's `orderer/solo.py`: envelopes and
blocks are message dicts.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from fabric_tpu_torch.msp.signer import SigningIdentity
from fabric_tpu_torch.orderer.blockcutter import BatchConfig, BlockCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter


class SoloChain:
    """One channel's chain: Order/Configure + block creation."""

    def __init__(
        self,
        channel_id: str,
        signer: Optional[SigningIdentity] = None,
        batch_config: Optional[BatchConfig] = None,
        deliver: Optional[Callable[[dict], None]] = None,
        genesis_block: Optional[dict] = None,
        on_config_block: Optional[Callable[[dict], None]] = None,
    ):
        self.channel_id = channel_id
        self.cutter = BlockCutter(batch_config)
        self.deliver = deliver
        self.blocks: List[dict] = []
        self._on_config_block = on_config_block
        self.writer = BlockWriter(signer=signer, sink=self._store)
        if genesis_block is not None:
            self.writer.append_bootstrap(genesis_block)

    def _store(self, block: dict) -> None:
        self.blocks.append(block)
        if self.deliver is not None:
            self.deliver(block)

    # -- consensus.Chain surface -------------------------------------------
    def order(self, env: dict) -> None:
        """Normal message path (broadcast -> ProcessNormalMsg -> Order)."""
        batches, _pending = self.cutter.ordered(env)
        for batch in batches:
            self._write_batch(batch)

    def configure(self, env: dict) -> None:
        """Config messages cut pending txs first, then go alone in a block."""
        pending = self.cutter.cut()
        if pending:
            self._write_batch(pending)
        self._write_batch([env], is_config=True)

    def flush(self) -> None:
        """Batch-timeout expiry analog: cut whatever is pending."""
        pending = self.cutter.cut()
        if pending:
            self._write_batch(pending)

    def _write_batch(
        self, batch: List[dict], is_config: bool = False
    ) -> None:
        block = self.writer.create_next_block(batch)
        self.writer.write_block(block, is_config=is_config)
        if is_config and self._on_config_block is not None:
            self._on_config_block(block)

    # -- deliver service surface -------------------------------------------
    @property
    def height(self) -> int:
        return self.writer.height

    def get_block(self, number: int) -> Optional[dict]:
        return self.blocks[number] if number < len(self.blocks) else None
