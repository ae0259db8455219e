"""Orderer node composition root (reference orderer/common/server/
main.go): multichannel registrar + broadcast handler + deliver engine
behind one gRPC server serving orderer.AtomicBroadcast.

The port's counterpart of the JAX package's `nodes/orderer.py`, over the
port's Registrar, BroadcastHandler, DeliverHandler, `orderer/cluster` and
`operations`. Departures:

- the provider is the caller's: a `Registrar` needs the provider its
  bundles verify with, and the port makes none;
- a raft tick or a flush that raises is kept in `loop_error` and ends its
  loop, where the JAX loops swallow every exception and go on (fail closed);
- `stop()` joins the loops, every follower, every cluster sender and the
  servers with no time limit, and closes each chain's WAL and block store,
  so a node can restart on its directory in the same process.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from fabric_tpu_torch.comm.server import GRPCServer
from fabric_tpu_torch.comm.services import register_atomic_broadcast
from fabric_tpu_torch.deliver.server import BlockSource, DeliverHandler
from fabric_tpu_torch.operations import Options as OpsOptions
from fabric_tpu_torch.operations import System
from fabric_tpu_torch.orderer.broadcast import BroadcastHandler
from fabric_tpu_torch.orderer.multichannel import Registrar
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import protoutil


def parse_duration(text: str, default: float) -> float:
    """"2s" / "500ms" / "1m" -> seconds (orderer.yaml BatchTimeout)."""
    if not text:
        return default
    text = text.strip().lower()
    try:
        if text.endswith("ms"):
            return float(text[:-2]) / 1000.0
        if text.endswith("s"):
            return float(text[:-1])
        if text.endswith("m"):
            return float(text[:-1]) * 60.0
        return float(text)
    except ValueError:
        return default


class OrdererNode:
    def __init__(
        self,
        work_dir: str,
        signer=None,
        listen_address: str = "127.0.0.1:0",
        system_channel_id: Optional[str] = None,
        ops_address: Optional[str] = None,
        provider=None,
        raft_node_id: int = 1,
        raft_tick_seconds: float = 0.1,
        # grpc.ServerCredentials (comm.server.CertReloader.credentials()
        # for hot rotation) + per-service concurrent-RPC caps, matching
        # the peer node's surface (General.TLS / General.Limits)
        tls_credentials=None,
        rpc_limits=None,
        # root CA PEM for OUTBOUND intra-cluster dials (Step/raft + the
        # follower block puller): when this node serves TLS, its peers
        # do too, so the cluster client must dial TLS as well
        cluster_root_ca: bytes = b"",
    ):
        from fabric_tpu_torch.orderer.cluster import ClusterClient, ClusterService

        # cluster comm (orderer/common/cluster): raft messages between
        # orderers ride the Step stream on THIS node's gRPC listener;
        # consenter endpoints come from each channel's consensus metadata
        # at join time (main.go initializeClusterClientConfig).
        self.raft_node_id = raft_node_id
        self.raft_tick_seconds = raft_tick_seconds
        # ticker threads (created by start(); stop() joins them, and
        # must stay a safe no-op before start)
        self._flusher: Optional[threading.Thread] = None
        self._raft_ticker: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.loop_error: Optional[BaseException] = None
        self._cluster_root_ca = cluster_root_ca or None
        self.cluster_client = ClusterClient(
            raft_node_id, {}, root_ca=self._cluster_root_ca
        )
        self.registrar = Registrar(
            work_dir,
            signer=signer,
            system_channel_id=system_channel_id,
            provider=provider,
            raft_node_id=raft_node_id,
            raft_transport_factory=self.cluster_client.transport_factory,
            follower_endpoint_factory=self._follower_endpoints,
        )
        self.broadcast = BroadcastHandler(
            self.registrar, signer=signer, cluster_client=self.cluster_client
        )
        self._block_events: dict[str, threading.Condition] = {}
        self.registrar.on_block(self._notify_block)
        # keep consenter endpoints current for channels created ANY way
        # (join, system-channel creation, consenter-set config updates)
        self.registrar.on_chain(self._refresh_cluster_endpoints)

        self.deliver = DeliverHandler(self._block_source)

        self.ops: Optional[System] = None
        interceptors = []
        if ops_address is not None:
            # same provider discipline as the peer shell: the fabobs
            # data-plane registry IS the /metrics surface
            from fabric_tpu_torch.common import fabobs

            obs = fabobs.ensure_enabled()
            self.ops = System(
                OpsOptions(listen_address=ops_address, provider=obs.provider)
            )
            self.ops.register_checker("registrar", lambda: None)
            from fabric_tpu_torch.comm.interceptors import (
                LoggingInterceptor,
                MetricsInterceptor,
            )

            interceptors = [
                LoggingInterceptor(),
                MetricsInterceptor(self.ops.provider),
            ]

        if rpc_limits:
            from fabric_tpu_torch.comm.server import ConcurrencyLimiter

            interceptors = [ConcurrencyLimiter(dict(rpc_limits))] + list(
                interceptors
            )
        self.server = GRPCServer(
            listen_address,
            credentials=tls_credentials,
            interceptors=interceptors,
        )
        register_atomic_broadcast(self.server, self.broadcast, self.deliver)
        ClusterService(self.registrar, self.broadcast).register(self.server)

    # -- block availability signaling (deliver BLOCK_UNTIL_READY) --------
    def _cond(self, channel_id: str) -> threading.Condition:
        return self._block_events.setdefault(channel_id, threading.Condition())

    def _notify_block(self, channel_id: str, _block) -> None:
        cond = self._cond(channel_id)
        with cond:
            cond.notify_all()

    def _follower_endpoints(self, addresses):
        """addresses -> deliver-endpoint callables for FollowerChain block
        pulling (cluster.BlockPuller analog over fellow orderers'
        AtomicBroadcast/Deliver)."""
        from fabric_tpu_torch.comm.server import channel_to
        from fabric_tpu_torch.comm.services import DeliverEndpoint

        def make(addr):
            def endpoint(env):
                # a failed or cancelled call surfaces as the deliver
                # client's retryable ConnectionError (DeliverEndpoint)
                conn = channel_to(addr, self._cluster_root_ca)
                try:
                    yield from DeliverEndpoint(conn)(env)
                finally:
                    conn.close()

            return endpoint

        return [make(a) for a in addresses]

    def _block_source(self, channel_id: str) -> Optional[BlockSource]:
        support = self.registrar.get_chain(channel_id)
        if support is None:
            # followers serve deliver too (participation-API semantics):
            # readers can tail a replicating channel
            follower = self.registrar.followers.get(channel_id)
            if follower is None:
                return None

            def wait_poll(number: int, timeout: float) -> bool:
                # poll the replicating ledger for the FULL timeout (the
                # deliver engine calls this once and errors on False)
                budget = (
                    threading.TIMEOUT_MAX if timeout is None else timeout
                )
                deadline = time.monotonic() + budget
                while True:
                    if follower.height > number:
                        return True
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    threading.Event().wait(min(remaining, 0.1))

            return BlockSource(
                follower.get_block, lambda: follower.height, wait_poll
            )
        cond = self._cond(channel_id)

        def wait_for(number: int, timeout: float) -> bool:
            deadline = threading.TIMEOUT_MAX if timeout is None else timeout
            with cond:
                if support.height > number:
                    return True
                cond.wait(timeout=deadline)
            return support.height > number

        return BlockSource(support.get_block, lambda: support.height, wait_for)

    # -- lifecycle -------------------------------------------------------
    def join_channel(self, genesis_block: dict):
        return self.registrar.join_channel(genesis_block)

    def _refresh_cluster_endpoints(self, support) -> None:
        """Per-channel consenter endpoints from the channel's consensus
        metadata (reference: cluster endpoints come from the config
        block; refreshed on chain start and every config block)."""
        bundle = support.bundle
        if bundle.orderer is None or bundle.orderer.consensus_type != "etcdraft":
            return
        try:
            meta = protoutil.unmarshal(cfgpb.RAFT_CONFIG_METADATA,
                                       bundle.orderer.consensus_metadata)
        except ValueError:
            return
        # raft ids are STABLE per consenter (orderer/consenter_ids.py) —
        # route by the chain's tracker, never by list position: after a
        # non-tail removal the positions shift but the ids must not
        tracker = getattr(support.chain, "tracker", None)
        if tracker is not None:
            endpoints = {
                node_id: addr for addr, node_id in tracker.ids.items()
            }
        else:
            endpoints = {
                i + 1: f"{c.get('host', '')}:{c.get('port', 0)}"
                for i, c in enumerate(meta.get("consenters", []))
            }
        self.cluster_client.set_channel_endpoints(
            support.channel_id, endpoints
        )

    def _raft_tick_loop(self) -> None:
        """Wall-clock ticker driving raft election/heartbeat timers for
        every raft channel (etcdraft chain.go's clock)."""
        while not self._stopped.wait(self.raft_tick_seconds):
            for support in list(self.registrar.chains.values()):
                chain = support.chain
                if hasattr(chain, "tick") and hasattr(chain, "node"):
                    try:
                        chain.tick()
                    except Exception as exc:
                        self.loop_error = exc
                        return

    def _flush_loop(self) -> None:
        """Batch-timeout ticker (reference blockcutter timer in the
        consenter run loops): a channel's pending batch is cut only once
        its OLDEST message has waited the channel's BatchTimeout — a
        fixed global cadence would force-cut partial blocks and make any
        BatchTimeout above the cadence meaningless."""
        while not self._stopped.wait(self._next_flush_interval()):
            for support in list(self.registrar.chains.values()):
                timeout = (
                    parse_duration(support.bundle.orderer.batch_timeout, 0.5)
                    if support.bundle.orderer is not None
                    else 0.5
                )
                cutter = getattr(support.chain, "cutter", None)
                age = cutter.pending_age() if cutter is not None else None
                if age is None or age < timeout:
                    continue
                try:
                    support.chain.flush()
                except Exception as exc:
                    self.loop_error = exc
                    return

    def _next_flush_interval(self) -> float:
        """Poll at a fraction of the smallest BatchTimeout so expiry is
        detected promptly without busy-spinning."""
        intervals = [0.5]
        for support in self.registrar.chains.values():
            if support.bundle.orderer is not None:
                intervals.append(
                    parse_duration(support.bundle.orderer.batch_timeout, 0.5)
                )
        return min(0.5, max(0.02, min(intervals) / 4.0))

    def start(self) -> str:
        if self.ops is not None:
            self.ops.start()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="blockcutter-timeout", daemon=True
        )
        self._flusher.start()
        self._raft_ticker = threading.Thread(
            target=self._raft_tick_loop, name="raft-ticker", daemon=True
        )
        self._raft_ticker.start()
        return self.server.start()

    def stop(self) -> None:
        self._stopped.set()
        # reap the cutter/raft loops: both poll _stopped, so the joins
        # settle within one tick — an unjoined ticker surviving stop()
        # keeps firing raft ticks into a torn-down registrar
        for t in (self._flusher, self._raft_ticker):
            if t is not None and t is not threading.current_thread():
                t.join()
        for follower in list(self.registrar.followers.values()):
            follower.stop()
        self.cluster_client.stop()
        self.server.stop()
        if self.ops is not None:
            self.ops.stop()
        for support in list(self.registrar.chains.values()):
            chain = support.chain
            for store in (getattr(chain, "wal", None), getattr(chain, "block_store", None)):
                if store is not None:
                    store.close()

    @property
    def addr(self) -> str:
        return self.server.addr
