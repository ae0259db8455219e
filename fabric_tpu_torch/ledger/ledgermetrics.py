"""Committer metrics (reference core/ledger/kvledger/metrics.go +
gossip/privdata/coordinator.go:161-163): the histograms/gauges/counters
every peer emits from the commit hot path, built over the metrics SPI.

The port's counterpart of the JAX package's `ledger/ledgermetrics`; the
port's provider is `common/metrics.PrometheusProvider`, whose series are
read in process."""

from __future__ import annotations

from fabric_tpu_torch.common.metrics import (
    CounterOpts,
    GaugeOpts,
    HistogramOpts,
    Provider,
)


class CommitterMetrics:
    """One instance per node; label 'channel' selects the ledger."""

    def __init__(self, provider: Provider):
        self.blockchain_height = provider.new_gauge(
            GaugeOpts(
                namespace="ledger",
                name="blockchain_height",
                help="Height of the chain in blocks.",
                label_names=("channel",),
            )
        )
        self.block_processing_time = provider.new_histogram(
            HistogramOpts(
                namespace="ledger",
                name="block_processing_time",
                help="Time taken in seconds for ledger block processing.",
                label_names=("channel",),
            )
        )
        self.blockstorage_commit_time = provider.new_histogram(
            HistogramOpts(
                namespace="ledger",
                name="blockstorage_and_pvtdata_commit_time",
                help="Time taken in seconds for committing the block and "
                "private data to storage.",
                label_names=("channel",),
            )
        )
        self.statedb_commit_time = provider.new_histogram(
            HistogramOpts(
                namespace="ledger",
                name="statedb_commit_time",
                help="Time taken in seconds for committing block changes "
                "to state db.",
                label_names=("channel",),
            )
        )
        self.transaction_count = provider.new_counter(
            CounterOpts(
                namespace="ledger",
                name="transaction_count",
                help="Number of transactions processed.",
                label_names=("channel", "validation_code"),
            )
        )
        self.validation_duration = provider.new_histogram(
            HistogramOpts(
                namespace="gossip",
                subsystem="privdata",
                name="validation_duration",
                help="Time it takes to validate a block (in seconds).",
                label_names=("channel",),
            )
        )

    # -- commit-path hooks -------------------------------------------------
    def observe_commit(
        self,
        channel_id: str,
        flags,
        height: int,
        validate_seconds: float,
        store_seconds: float,
        state_seconds: float,
    ) -> None:
        self.blockchain_height.with_labels("channel", channel_id).set(height)
        self.block_processing_time.with_labels("channel", channel_id).observe(
            validate_seconds + store_seconds + state_seconds
        )
        self.validation_duration.with_labels("channel", channel_id).observe(
            validate_seconds
        )
        self.blockstorage_commit_time.with_labels("channel", channel_id).observe(
            store_seconds
        )
        self.statedb_commit_time.with_labels("channel", channel_id).observe(
            state_seconds
        )
        from fabric_tpu_torch.common.txflags import TxValidationCode

        for code in flags.tobytes():
            self.transaction_count.with_labels(
                "channel",
                channel_id,
                "validation_code",
                TxValidationCode(int(code)).name,
            ).add(1)
