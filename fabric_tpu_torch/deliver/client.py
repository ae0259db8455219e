"""Block-deliver client (reference core/deliverservice +
internal/pkg/peer/blocksprovider/blocksprovider.go).

Pulls blocks from an ordering endpoint with the reference's failure
discipline: exponential backoff with base 1.2 capped per-sleep and by a
total-duration budget (blocksprovider.go:109-146), endpoint failover on
error, endpoint refresh when the channel config changes.

Transport-agnostic: an endpoint is any callable
`(seek_envelope) -> iterator of DeliverResponse` (a transport layer adapts
the AtomicBroadcast/Deliver streams to this shape).

The port's counterpart of the JAX package's `deliver/client.py`: envelopes,
responses and blocks are message dicts (`protos/ab.py`), and the seek
envelope's bytes are the JAX client's. The backoff is one `RetryPolicy`
(`DELIVER_POLICY` by default); the JAX client's `max_retry_delay` and
`max_total_delay` are that policy's `cap_s` and `deadline_s`. A `verify_block` that raises (a
provider that fails rather than refuses) ends the pull with its error; it is
never read as a failed verification.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

from fabric_tpu_torch.common.faults import InjectedFault, fault_point
from fabric_tpu_torch.common.retry import DELIVER_POLICY, Backoff, RetryPolicy
from fabric_tpu_torch.protos import ab, fabric, protoutil, wire


def seek_position(value) -> dict:
    """A block number or "oldest" / "newest" as a SeekPosition dict."""
    if value == "oldest":
        return {"oldest": {}}
    if value == "newest":
        return {"newest": {}}
    return {"specified": {"number": value}}


def seek_envelope(channel_id: str, start, signer=None, stop=ab.SEEK_MAX) -> dict:
    """SeekInfo [start, stop] envelope (BLOCK_UNTIL_READY), signed when a
    signer is given. start/stop are block numbers or the strings
    "oldest"/"newest" (ab.SeekPosition oneof)."""
    seek = {"start": seek_position(start), "stop": seek_position(stop),
            "behavior": ab.BLOCK_UNTIL_READY}
    chdr = protoutil.make_channel_header(fabric.DELIVER_SEEK_INFO, channel_id)
    shdr = (protoutil.make_signature_header(signer.serialize(), signer.new_nonce())
            if signer is not None else {})
    payload = {"header": {"channel_header": wire.encode(fabric.CHANNEL_HEADER, chdr),
                          "signature_header": wire.encode(fabric.SIGNATURE_HEADER, shdr)},
               "data": wire.encode(ab.SEEK_INFO, seek)}
    env = {"payload": wire.encode(fabric.PAYLOAD, payload)}
    if signer is not None:
        env["signature"] = signer.sign(env["payload"])
    return env


@dataclass
class DelivererStats:
    connect_attempts: int = 0
    blocks_received: int = 0
    failures: int = 0


class BlockDeliverer:
    """Per-channel block pull loop (reference Deliverer.DeliverBlocks)."""

    def __init__(
        self,
        channel_id: str,
        endpoints: Sequence[Callable],
        on_block: Callable[[dict], None],
        next_block: Callable[[], int],
        signer=None,
        verify_block: Optional[Callable[[dict], bool]] = None,
        sleeper: Callable[[float], None] = time.sleep,
        retry_policy: RetryPolicy = DELIVER_POLICY,
        retry_seed: Optional[int] = None,
    ):
        self.channel_id = channel_id
        self._endpoints = list(endpoints)
        self._on_block = on_block
        self._next_block = next_block
        self._signer = signer
        self._verify_block = verify_block
        self._sleeper = sleeper
        # the reference backoff (retry.DELIVER_POLICY: 1.2**n * 60 ms,
        # capped per-sleep and by a total-duration budget) unless the
        # caller gives its own. retry_seed arms ±20% seeded jitter so a
        # fleet of deliverers retrying the same dead orderer desynchronizes
        # — only when the chosen policy doesn't already set its own.
        if retry_seed is not None and retry_policy.jitter == 0.0:
            retry_policy = replace(retry_policy, jitter=0.2)
        self._retry_policy = retry_policy
        self._retry_seed = retry_seed
        self.stats = DelivererStats()
        self._stop = threading.Event()
        self._endpoint_idx = 0
        # the pull thread (failover) and the config-update path
        # (update_endpoints) both write the endpoint list and index
        self._ep_lock = threading.Lock()

    def update_endpoints(self, endpoints: Sequence[Callable]) -> None:
        """Channel-config change handed us fresh orderer endpoints
        (reference deliveryclient endpoint refresh)."""
        with self._ep_lock:
            self._endpoints = list(endpoints)
            self._endpoint_idx = 0

    def _current_endpoint(self) -> Optional[Callable]:
        with self._ep_lock:
            if not self._endpoints:
                return None
            return self._endpoints[self._endpoint_idx % len(self._endpoints)]

    def _failover(self) -> None:
        with self._ep_lock:
            self._endpoint_idx += 1

    def stop(self) -> None:
        self._stop.set()

    def run(self, max_blocks: Optional[int] = None) -> int:
        """Pull until stopped, the budget is exhausted, or max_blocks
        arrive. Returns blocks received."""
        received = 0
        backoff = Backoff(self._retry_policy, seed=self._retry_seed, sleeper=self._sleeper)
        while not self._stop.is_set():
            endpoint = self._current_endpoint()
            if endpoint is None:
                return received
            self.stats.connect_attempts += 1
            try:
                # chaos seam: keyed per connection attempt, so a seeded
                # plan flaps a deterministic prefix of attempts
                fault_point("deliver.pull", key=self.stats.connect_attempts)
                env = seek_envelope(self.channel_id, self._next_block(), self._signer)
                for resp in endpoint(env):
                    if self._stop.is_set():
                        return received
                    if ab.response_type(resp) != "block":
                        raise ConnectionError(f"deliver status {resp.get('status', 0)}")
                    block = resp["block"]
                    number = block.get("header", {}).get("number", 0)
                    if number != self._next_block():
                        raise ConnectionError(f"got block {number}, want {self._next_block()}")
                    if self._verify_block is not None and not self._verify_block(block):
                        raise ConnectionError(f"block {number} failed verification")
                    self._on_block(block)
                    received += 1
                    self.stats.blocks_received += 1
                    backoff.reset()  # progress restarts the ramp
                    if max_blocks is not None and received >= max_blocks:
                        return received
                # clean end of stream: session served its range
                return received
            except (ConnectionError, OSError, StopIteration, InjectedFault):
                self.stats.failures += 1
                self._failover()
                if not backoff.sleep():
                    # per-policy retry budget exhausted (deadline or
                    # attempt cap): surface what we have
                    return received
        return received
