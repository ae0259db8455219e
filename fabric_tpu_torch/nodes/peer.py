"""Peer node composition root (reference usable-inter-nal/peer/node/
start.go serve()): channels + endorser + chaincode support + system
chaincodes + deliver services behind one gRPC server, plus a
deliver-client loop pulling blocks from the orderer into the commit
pipeline (core/deliverservice).

The port's counterpart of the JAX package's `nodes/peer.py`, wired as it is
wired: the Endorser, peer deliver, the snapshot service, the chaincode
listener, discovery and the operations server on one gRPC server, and a
BatchingProvider over the node's provider. Messages and blocks are the
port's dicts. Departures:

- the provider is the caller's, or `default_provider()`: the card's
  `CUDAProvider` or a `FactoryError`, never a software degrade;
- the `bccsp-device` health checker is kept under its name. The port has no
  software degrade: a failed launch raises. The only provider that sets
  `degraded` is a serve client (`serve/client.py`), on the first batch it
  rescued in process because its sidecar was lost; the rescue still runs
  K2 on the card, so the check names the lost sidecar, not a software
  path;
- every random choice and every clock comes from the caller: `rng=` (a
  `random.Random`) seeds each gossip node's choices, as in the port's
  `GossipNode`;
- the gossip verifiers read only a refusal of the channel's MSPs (an
  `MSPError`, a malformed identity, a signature that does not verify) as
  False; a failing provider raises into the gossip node, which keeps it
  (the JAX node reads every exception as False);
- `start_deliver_for_channel` takes one orderer address or a list, tried in
  turn on each failure (the reference deliveryclient's endpoint list); a
  deliver loop's failure is kept in `deliver_errors` as in the JAX node;
- the latest config block is looked up once a ledger height, where the JAX
  node reads and decodes the last block on every call: each transaction's
  write-set check makes one, so a 1,000-tx block behind a 1,000-tx block
  read that 3 MB block 1,000 times;
- `stop()` stops every gossip node, deliver loop and commit pipeline, joins
  their threads, stops the chaincode listener, the launcher, the batcher
  and the servers, and closes each channel's ledger, so no thread of the
  node is left (the JAX node leaves its deliver threads and pipelines).
"""

from __future__ import annotations

import json
import os
import random
import threading
import traceback
from typing import Callable, Dict, Optional, Sequence, Union

from fabric_tpu_torch.chaincode.extbuilder import ExternalBuilder, Launcher
from fabric_tpu_torch.chaincode.extserver import ChaincodeListener
from fabric_tpu_torch.chaincode.package import PackageStore
from fabric_tpu_torch.chaincode.support import ChaincodeSupport
from fabric_tpu_torch.comm.server import GRPCServer, channel_to
from fabric_tpu_torch.comm.services import (
    deliver_stream,
    register_endorser,
    register_peer_deliver,
    register_snapshot_service,
)
from fabric_tpu_torch.crypto.bccsp import VerifyError
from fabric_tpu_torch.deliver.client import seek_envelope
from fabric_tpu_torch.deliver.server import BlockSource, DeliverHandler
from fabric_tpu_torch.discovery.server import DiscoveryServer
from fabric_tpu_torch.discovery.service import DiscoveryService, PeerInfo
from fabric_tpu_torch.endorser.endorser import Endorser
from fabric_tpu_torch.gossip.coordinator import TransientStore
from fabric_tpu_torch.msp.identity import MSPError, MSPManager
from fabric_tpu_torch.msp.signer import SigningIdentity
from fabric_tpu_torch.parallel.batcher import BatchingProvider
from fabric_tpu_torch.peer.channel import Channel
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.protos import ab, fabric, protoutil
from fabric_tpu_torch.scc import CSCC, LSCC, QSCC
from fabric_tpu_torch.scc.lifecycle_scc import LifecycleSCC
from fabric_tpu_torch.validation.validator import ChaincodeRegistry


class PeerNode:
    def __init__(
        self,
        work_dir: str,
        msp_manager: MSPManager,
        signer: SigningIdentity,
        registry_factory: Callable[[str], ChaincodeRegistry],
        listen_address: str = "127.0.0.1:0",
        ops_address: Optional[str] = None,
        provider=None,
        external_builders=None,
        device_mvcc: bool = False,
        # dispatcher.PluginRegistry with custom validation plugins
        plugin_registry=None,
        # grpc.ServerCredentials (e.g. comm.server.CertReloader
        # .credentials() for hot-rotating TLS) — None = plaintext
        tls_credentials=None,
        # per-service concurrent-RPC caps, e.g. {"protos.Endorser": 50}
        rpc_limits=None,
        # channel_id -> statecouch.CouchStateAdapter (public-state mirror)
        state_mirror_factory=None,
        # root CA PEM for the deliver client's orderer dials
        orderer_root_ca: bytes = b"",
        # the device each channel's kernels run on (None: the card)
        device=None,
        # the source of every random choice the node makes (gossip)
        rng: Optional[random.Random] = None,
    ):
        self.work_dir = work_dir
        self.msp_manager = msp_manager
        self.signer = signer
        if provider is None:
            from fabric_tpu_torch.crypto.bccsp import default_provider

            provider = default_provider()
        # every channel validator funnels its device batches through one
        # coalescing launch queue
        self.provider = BatchingProvider(provider)
        self.device_mvcc = device_mvcc
        self.device = device
        self.rng = rng or random.Random()
        self.plugin_registry = plugin_registry
        self._state_mirror_factory = state_mirror_factory
        self._orderer_root_ca = orderer_root_ca or None
        self._registry_factory = registry_factory
        self.channels: Dict[str, Channel] = {}
        self.transient = TransientStore()
        self._commit_conds: Dict[str, threading.Condition] = {}
        self._stop = threading.Event()
        self._pull_threads: list = []
        self._deliver_calls: Dict[str, object] = {}  # channel -> open deliver call
        # last deliver-loop failure per channel (blocksprovider logging)
        self.deliver_errors: Dict[str, str] = {}
        self._commit_listeners: list = []
        self.snapshot_managers: Dict[str, object] = {}
        self.gossip_nodes: Dict[str, object] = {}
        self._pipelines: Dict[str, CommitPipeline] = {}

        # out-of-process chaincode runtime (reference core/container
        # externalbuilder + core/chaincode/persistence): installed
        # packages on disk, a launcher for subprocesses, and the shim
        # stream listener on this peer's gRPC server.
        self.package_store = PackageStore(os.path.join(work_dir, "lifecycle", "chaincodes"))
        self.launcher = Launcher(
            os.path.join(work_dir, "ccbuild"),
            builders=[ExternalBuilder(p) for p in (external_builders or [])],
        )
        self.cc_listener = ChaincodeListener()
        self._cc_sources: Dict[tuple, str] = self._load_cc_sources()

        self.support = ChaincodeSupport(
            state_getter=lambda cid: (
                self.channels[cid].ledger.state_db if cid in self.channels else None
            ),
            listener=self.cc_listener,
            launcher=self.launcher,
            package_store=self.package_store,
            source_resolver=lambda cid, name: self._cc_sources.get((cid, name))
            or self._cc_sources.get(("", name)),
            chaincode_address=lambda: self.addr,
        )
        self.support.register("qscc", QSCC(lambda cid: self._ledger(cid)), system=True)
        self.support.register(
            "cscc",
            CSCC(
                join_chain=self.join_channel,
                channel_list=lambda: sorted(self.channels),
                get_config_block=self._config_block,
                join_by_snapshot=self.join_channel_by_snapshot,
            ),
            system=True,
        )
        self.support.register(
            "lscc", LSCC(self._list_chaincodes, v20_active=self._v20_active), system=True
        )
        self.support.register(
            "_lifecycle",
            LifecycleSCC(
                install=self.install_chaincode,
                list_installed=self.package_store.list_installed,
                approve=self.approve_chaincode,
                load_package=self.package_store.load,
            ),
            system=True,
        )

        self.endorser = Endorser(
            signer,
            msp_manager,
            self.support,
            get_ledger=lambda cid: self._ledger(cid),
            on_pvt_results=self._distribute_pvt,
        )
        self.deliver = DeliverHandler(self._block_source)

        self.ops = None
        self.committer_metrics = None
        interceptors = []
        if ops_address is not None:
            # the data plane (batcher, ladder rungs, pipeline stages,
            # retries, fault fires) reports onto the SAME provider the
            # ops server scrapes: first enabler wins process-wide, and
            # this node's System serves whichever registry is live
            from fabric_tpu_torch.comm.interceptors import (
                LoggingInterceptor,
                MetricsInterceptor,
            )
            from fabric_tpu_torch.common import fabobs
            from fabric_tpu_torch.ledger.ledgermetrics import CommitterMetrics
            from fabric_tpu_torch.operations import Options as OpsOptions
            from fabric_tpu_torch.operations import System

            obs = fabobs.ensure_enabled()
            self.ops = System(OpsOptions(listen_address=ops_address, provider=obs.provider))
            # committer metrics (kvledger/metrics.go) surface on /metrics;
            # RPC logs + counters (grpclogging/grpcmetrics) wrap the server
            self.committer_metrics = CommitterMetrics(self.ops.provider)
            interceptors = [LoggingInterceptor(), MetricsInterceptor(self.ops.provider)]

            def _device_check():
                # a serve client's latch: its sidecar was lost and its
                # batches are rescued in process, still on the card
                if getattr(self.provider, "degraded", False):
                    raise RuntimeError(
                        "verify sidecar unavailable: batches rescued in process")

            self.ops.register_checker("bccsp-device", _device_check)

        if rpc_limits:
            from fabric_tpu_torch.comm.server import ConcurrencyLimiter

            interceptors = [ConcurrencyLimiter(dict(rpc_limits))] + list(interceptors)
        self.server = GRPCServer(listen_address, credentials=tls_credentials,
                                 interceptors=interceptors)
        register_endorser(self.server, self.endorser)
        register_peer_deliver(
            self.server,
            self.deliver,
            pvt_entries=self._pvt_entries_for,
            # private-collection cleartext leaves the peer only for
            # clients satisfying the channel Readers policy
            pvt_policy_checker=lambda cid, sd: self._channel_policy_check(
                cid, "/Channel/Application/Readers", sd
            ),
        )
        register_snapshot_service(
            self.server,
            lambda cid: self.snapshot_managers.get(cid),
            # snapshot admin ops need channel admins (reference
            # snapshot/* ACL defaults)
            policy_checker=lambda cid, sd: self._channel_policy_check(
                cid, "/Channel/Application/Admins", sd
            ),
        )
        self.cc_listener.register(self.server)

        # discovery service (discovery/service.go) on the same listener
        self.discovery = DiscoveryService(
            peers_provider=self._discovery_peers,
            bundle_provider=self._discovery_bundle,
            policy_provider=self._discovery_policy,
        )
        DiscoveryServer(self.discovery).register(self.server)
        self._bundle_cache: Dict[str, tuple] = {}
        self._config_blocks: Dict[str, tuple] = {}  # channel -> (height, config block)

    # -- chaincode lifecycle (install/approve, the org-local half) --------
    def _sources_path(self) -> str:
        return os.path.join(self.work_dir, "lifecycle", "local_sources.json")

    def _load_cc_sources(self) -> Dict[tuple, str]:
        try:
            with open(self._sources_path()) as f:
                raw = json.load(f)
            return {tuple(k.split("\x00", 1)): v for k, v in raw.items()}
        except (OSError, ValueError):
            return {}

    def install_chaincode(self, package_bytes: bytes) -> str:
        """`peer lifecycle chaincode install` (lifecycle.go InstallChaincode):
        persist the package, return its package-id."""
        return self.package_store.install(package_bytes).package_id

    def approve_chaincode(self, channel_id: str, name: str, package_id: str) -> None:
        """The org-local half of ApproveChaincodeDefinitionForOrg
        (lifecycle.go:415): bind this org's installed package-id to the
        chaincode name — the reference stores this in the org's implicit
        collection, i.e. per-peer state, which is exactly what this is."""
        self._cc_sources[(channel_id, name)] = package_id
        os.makedirs(os.path.dirname(self._sources_path()), exist_ok=True)
        with open(self._sources_path(), "w") as f:
            json.dump({"\x00".join(k): v for k, v in self._cc_sources.items()}, f,
                      sort_keys=True)

    # -- private data distribution (endorser.go distributePrivateData) ----
    def _distribute_pvt(self, channel_id: str, tx_id: str, pvt_writes) -> None:
        """Endorsement-time private data: local transient store first,
        then a gossip push to the channel's members so their transient
        stores are warm before the block commits (gossip/privdata
        pull.go DistributePrivateData)."""
        for ns, coll, raw in pvt_writes:
            self.transient.persist(tx_id, ns, coll, raw)
        node = self.gossip_nodes.get(channel_id)
        if node is not None:
            node.disseminate_pvt(tx_id, pvt_writes)

    # -- discovery providers (discovery/support analog) -------------------
    def _discovery_peers(self, channel_id: str):
        ch = self.channels.get(channel_id)
        if ch is None:
            return []
        chaincodes = tuple(ch.validator.registry.names())
        peers = [PeerInfo(msp_id=self.signer.msp_id, endpoint=self.addr,
                          ledger_height=ch.ledger.height, chaincodes=chaincodes)]
        node = self.gossip_nodes.get(channel_id)
        if node is not None:
            # gossip peer ids are "MSPID:host:port" (see
            # enable_gossip_for_channel)
            for member in node.membership.alive_peers():
                msp_id, _, endpoint = str(member).partition(":")
                if endpoint and endpoint != self.addr:
                    peers.append(PeerInfo(msp_id=msp_id, endpoint=endpoint,
                                          chaincodes=chaincodes))
        return peers

    def _discovery_bundle(self, channel_id: str):
        block = self._config_block(channel_id)
        if block is None:
            return None
        number = block["header"].get("number", 0)
        cached = self._bundle_cache.get(channel_id)
        if cached is not None and cached[0] == number:
            return cached[1]
        from fabric_tpu_torch.channelconfig.bundle import bundle_from_genesis_block

        bundle = bundle_from_genesis_block(block, self.provider)
        self._bundle_cache[channel_id] = (number, bundle)
        return bundle

    def _discovery_policy(self, chaincode: str, channel_id: str):
        ch = self.channels.get(channel_id)
        if ch is None:
            return None
        definition = ch.validator.registry.get(chaincode)
        return definition.endorsement_policy if definition else None

    # -- helpers ---------------------------------------------------------
    def _ledger(self, channel_id: str):
        ch = self.channels.get(channel_id)
        return ch.ledger if ch else None

    def _config_block(self, channel_id: str):
        """Latest config block via the last block's LAST_CONFIG pointer
        (reference cscc getConfigBlock -> blockledger lastConfig), looked
        up once a ledger height: every transaction's write-set check asks
        for it, and reading the last block is a block's read and decode."""
        ch = self.channels.get(channel_id)
        if ch is None:
            return None
        store = ch.ledger.block_store
        height = store.height
        cached = self._config_blocks.get(channel_id)
        if cached is not None and cached[0] == height:
            return cached[1]
        block = self._find_config_block(store)
        self._config_blocks[channel_id] = (height, block)
        return block

    @staticmethod
    def _find_config_block(store):
        last = store.get_block_by_number(store.height - 1)
        if last is None:
            return None
        metas = last.get("metadata", {}).get("metadata", [])
        if len(metas) > fabric.SIGNATURES and metas[fabric.SIGNATURES]:
            try:
                meta = protoutil.unmarshal(fabric.METADATA, metas[fabric.SIGNATURES])
                if meta.get("value"):
                    lc = protoutil.unmarshal(fabric.LAST_CONFIG, meta["value"])
                    pointed = store.get_block_by_number(lc.get("index", 0))
                    if pointed is not None:
                        return pointed
            except ValueError:
                pass
        return store.get_block_by_number(store.base_height)

    def _list_chaincodes(self):
        out = []
        for ch in self.channels.values():
            for name in ch.validator.registry.names():
                out.append((name, "1.0"))
        return sorted(set(out))

    def _block_source(self, channel_id: str) -> Optional[BlockSource]:
        ch = self.channels.get(channel_id)
        if ch is None:
            return None
        cond = self._commit_conds.setdefault(channel_id, threading.Condition())

        def wait_for(number: int, timeout: float) -> bool:
            with cond:
                if ch.ledger.height > number:
                    return True
                cond.wait(timeout=timeout)
            return ch.ledger.height > number

        return BlockSource(ch.ledger.block_store.get_block_by_number,
                           lambda: ch.ledger.height, wait_for)

    def _v20_active(self, channel_id: str) -> bool:
        """ONE definition of 'this channel runs the v2.0 lifecycle' shared
        by lscc (deploy refusal) and the validator's write-set routing —
        a missing bundle/capabilities section counts as V2_0, so the two
        can never disagree about which regime governs the channel."""
        caps = self._app_capabilities(channel_id)
        return caps is None or caps.v20_validation

    def _app_capabilities(self, channel_id: str):
        bundle = self._discovery_bundle(channel_id)
        app = bundle.application if bundle is not None else None
        return app.capabilities if app is not None else None

    def _legacy_writeset_check(self, channel_id, rwset, invoked_ns):
        """Capability-routed legacy write-set guards (txvalidator v14
        router analog): V2_0 channels use the lifecycle rules only;
        V1_2+ channels get the v13 guards incl. collection validation
        against the committed LSCC record; older channels get v12."""
        from fabric_tpu_torch.validation.legacy import (
            check_v12_writeset,
            check_v13_writeset,
            collection_key,
        )

        if self._v20_active(channel_id):
            return None  # _lifecycle governs deploys on V2_0 channels
        caps = self._app_capabilities(channel_id)
        ch = self.channels.get(channel_id)

        def committed_collections(cc: str):
            if ch is None:
                return None
            vv = ch.ledger.state_db.get_state("lscc", collection_key(cc))
            return vv.value if vv is not None else None

        if caps.v12_validation:
            return check_v13_writeset(rwset, invoked_ns, committed_collections)
        return check_v12_writeset(rwset, invoked_ns)

    def _collection_access(self, channel_id: str, ns: str, coll: str):
        """CollectionAccess for a committed chaincode's collection
        (reference core/common/privdata/store.go: _lifecycle definitions
        first, then the legacy LSCC '<cc>~collection' record).  None when
        undefined."""
        from fabric_tpu_torch.ledger.collections import CollectionStore, NoSuchCollectionError
        from fabric_tpu_torch.lifecycle.lifecycle import NAMESPACE as LIFECYCLE_NS
        from fabric_tpu_torch.lifecycle.lifecycle import LifecycleResources
        from fabric_tpu_torch.validation.legacy import collection_key

        ch = self.channels.get(channel_id)
        if ch is None:
            return None

        def state_get(state_ns: str, key: str):
            vv = ch.ledger.state_db.get_state(state_ns, key)
            return vv.value if vv is not None else None

        def collections_bytes(cc: str) -> bytes:
            resources = LifecycleResources(
                public_get=lambda key: state_get(LIFECYCLE_NS, key),
                public_put=lambda *a: None,
                org_get=lambda org, key: None,
                org_put=lambda *a: None,
                org_names=[],
            )
            cd = resources.query_chaincode_definition(cc)
            if cd is not None and cd.collections:
                return cd.collections
            return state_get("lscc", collection_key(cc)) or b""

        try:
            return CollectionStore(collections_bytes).collection(ns, coll)
        except NoSuchCollectionError:
            return None

    def _channel_policy_check(self, channel_id: str, path: str, sd) -> None:
        """Evaluate one SignedData against a channel policy path (raises
        on failure; signature verification happens inside the policy
        evaluation, policies/policy.go SignatureSetToValidIdentities)."""
        bundle = self._discovery_bundle(channel_id)
        if bundle is None:
            raise ValueError(f"channel {channel_id} not found")
        policy, ok = bundle.policy_manager.get_policy(path)
        if not ok:
            raise ValueError(f"policy {path} not found on {channel_id}")
        policy.evaluate_signed_data([sd])

    def _pvt_entries_for(self, channel_id: str, block_num: int):
        """DeliverWithPrivateData source: this peer's stored cleartext
        private rwsets for one block (deliverevents.go:270)."""
        ch = self.channels.get(channel_id)
        if ch is None:
            return []
        return ch.ledger.pvt_store.get_pvt_data_by_block(block_num)

    # -- channel lifecycle ----------------------------------------------
    def _channel(self, channel_id: str, ledger_dir: str) -> Channel:
        return Channel(
            channel_id,
            ledger_dir,
            self.msp_manager,
            self._registry_factory(channel_id),
            self.provider,
            transient_store=self.transient,
            metrics=self.committer_metrics,
            device_mvcc=self.device_mvcc,
            writeset_check=lambda rwset, ns, cid=channel_id: (
                self._legacy_writeset_check(cid, rwset, ns)
            ),
            plugin_registry=self.plugin_registry,
            state_mirror=(
                self._state_mirror_factory(channel_id)
                if self._state_mirror_factory is not None
                else None
            ),
            device=self.device,
        )

    def join_channel(self, genesis_block: dict) -> Channel:
        """cscc JoinChain: bootstrap the channel from its genesis block
        (core/peer/peer.go createChannel)."""
        from fabric_tpu_torch.ledger.snapshot import SnapshotRequestManager

        env = protoutil.get_envelope_from_block_data(genesis_block["data"]["data"][0])
        payload = protoutil.unmarshal(fabric.PAYLOAD, env.get("payload", b""))
        chdr = protoutil.unmarshal(fabric.CHANNEL_HEADER,
                                   payload.get("header", {}).get("channel_header", b""))
        channel_id = chdr.get("channel_id", "")
        if channel_id in self.channels:
            raise ValueError(f"channel {channel_id} already joined")
        if os.path.exists(os.path.join(self.work_dir, channel_id, "PAUSED")):
            # peer node pause marker (reference kvledger pause_resume.go:
            # a paused channel's ledger is not opened and no deliver runs)
            raise ValueError(f"channel {channel_id} is paused")
        ch = self._channel(channel_id, os.path.join(self.work_dir, channel_id))
        if ch.ledger.height == 0:
            ch.ledger.commit(genesis_block)
        self.channels[channel_id] = ch
        # snapshot request bookkeeping (snapshot_mgr.go) + commit hook
        self.snapshot_managers[channel_id] = SnapshotRequestManager(
            ch.ledger, os.path.join(self.work_dir, "snapshots")
        )
        return ch

    def join_channel_by_snapshot(self, snap_dir: str) -> str:
        """cscc JoinChainBySnapshot (reference core/peer
        CreateChannelFromSnapshot): build the channel's ledger from an
        exported snapshot (ledger/snapshot.py create_from_snapshot), then
        wire the Channel around it.  The ledger starts at the snapshot
        height with no block prefix; deliver loops resume from there."""
        from fabric_tpu_torch.ledger.snapshot import (
            SnapshotRequestManager,
            create_from_snapshot,
            verify_snapshot,
        )

        meta = verify_snapshot(snap_dir)
        channel_id = meta["channel_name"]
        if channel_id in self.channels:
            raise ValueError(f"channel {channel_id} already joined")
        ledger_dir = os.path.join(self.work_dir, channel_id)
        # build the persistent stores, then let the Channel reopen them
        create_from_snapshot(snap_dir, ledger_dir).close()
        ch = self._channel(channel_id, ledger_dir)
        self.channels[channel_id] = ch
        self.snapshot_managers[channel_id] = SnapshotRequestManager(
            ch.ledger, os.path.join(self.work_dir, "snapshots")
        )
        return channel_id

    def commit_block(self, channel_id: str, block: dict):
        ch = self.channels[channel_id]
        flags = ch.store_block(block)
        self._after_commit(channel_id, block)
        return flags

    def _after_commit(self, channel_id: str, block: dict) -> None:
        cond = self._commit_conds.setdefault(channel_id, threading.Condition())
        with cond:
            cond.notify_all()
        mgr = self.snapshot_managers.get(channel_id)
        if mgr is not None:
            mgr.on_block_committed()
        for fn in self._commit_listeners:
            fn(channel_id, block)

    def commit_pipeline(self, channel_id: str) -> CommitPipeline:
        """Per-channel two-stage commit pipeline: the deliver loop prepares
        block N (parse + device sig batch) while the committer thread
        finishes block N-1."""
        pipe = self._pipelines.get(channel_id)
        if pipe is None:
            ch = self.channels[channel_id]
            pipe = CommitPipeline(
                ch,
                on_commit=lambda block, _flags: self._after_commit(channel_id, block),
                on_error=lambda block, exc: self.deliver_errors.__setitem__(
                    channel_id, f"pipeline commit failed: {exc}"
                ),
            )
            self._pipelines[channel_id] = pipe
        return pipe

    def on_commit(self, fn: Callable[[str, dict], None]) -> None:
        self._commit_listeners.append(fn)

    # -- gossip (gossip/service gossip_service.go InitializeChannel) -----
    def enable_gossip_for_channel(
        self,
        channel_id: str,
        bootstrap: Sequence[str] = (),
        orderer_addr=None,
        gossip_listen: str = "127.0.0.1:0",
        # mTLS + TLS-bound ConnEstablish handshake (gossip/comm):
        # {"server_creds": grpc.ServerCredentials,
        #  "client": (root_ca_pem, (key_pem, cert_pem)),
        #  "self_cert_der": bytes, "require_handshake": bool}
        tls: Optional[dict] = None,
    ):
        """Start a gossip node for the channel. With an orderer address,
        the elected leader runs the deliver client and pushes blocks to
        followers; followers self-heal via anti-entropy (state.go)."""
        from fabric_tpu_torch.gossip.comm import GossipNode
        from fabric_tpu_torch.gossip.state import StateProvider

        ch = self.channels[channel_id]
        mgr = self.msp_manager
        state = StateProvider(channel_id, lambda b: self.commit_block(channel_id, b),
                              lambda: ch.ledger.height)

        def pvt_reader(block_num, tx_num, ns, coll):
            for e in ch.ledger.pvt_store.get_pvt_data(block_num, tx_num):
                if e.namespace == ns and e.collection == coll:
                    return e.rwset
            return None

        def verify_identity(pki_id: bytes, identity: bytes) -> bool:
            """Certstore adoption gate (reference certstore: identity must
            hash to the claimed pki_id): the claimed MSP id must match the
            serialized identity's, and the identity must deserialize +
            validate (cert chain, CRL) under this channel's MSPs."""
            try:
                ident, msp = mgr.deserialize_identity(identity)
                if ident.msp_id != pki_id.decode().split(":", 1)[0]:
                    return False
                msp.validate(ident)
                return True
            except (MSPError, ValueError):
                return False

        def verify_member_sig(identity: bytes, data: bytes, sig: bytes) -> bool:
            try:
                ident, msp = mgr.deserialize_identity(identity)
                msp.validate(ident)
            except (MSPError, ValueError):
                return False
            try:
                ident.verify(data, sig)
                return True
            except MSPError as exc:
                # a refusal: a signature that does not verify or parse; a
                # provider that fails raises through
                if exc.__context__ is None or isinstance(exc.__context__, VerifyError):
                    return False
                raise

        def requester_eligible(ns: str, coll: str, identity: bytes) -> bool:
            """pull.go:614,662: serve a digest only when the REQUESTER's
            identity satisfies that collection's member-orgs policy (read
            from the channel's committed lifecycle definition)."""
            access = self._collection_access(channel_id, ns, coll)
            if access is None:
                return False
            try:
                ident, msp = mgr.deserialize_identity(identity)
            except (MSPError, ValueError):
                return False
            return access.is_member(ident, msp)

        node = GossipNode(
            f"{self.signer.msp_id}:{self.addr}",
            channel_id,
            state,
            ch.ledger.block_store.get_block_by_number,
            lambda: ch.ledger.height,
            listen_address=gossip_listen,
            identity_bytes=self.signer.serialize(),
            verify_identity=verify_identity,
            transient_store=self.transient,
            pvt_reader=pvt_reader,
            pvt_serve_policy=ch.is_eligible,
            pvt_verify_member_sig=verify_member_sig,
            pvt_requester_eligible=requester_eligible,
            pvt_sign_request=self.signer.sign,
            sign_message=self.signer.sign,
            require_signed_alive=True,
            tls_server_creds=(tls or {}).get("server_creds"),
            tls_client=(tls or {}).get("client"),
            self_tls_cert_der=(tls or {}).get("self_cert_der", b""),
            require_handshake=bool((tls or {}).get("require_handshake")),
            rng=random.Random(self.rng.getrandbits(64)),
        )
        # reconciler loop (reconcile.go:104-126): patch missing pvt data
        # recorded at commit from peers, hash-checked on arrival
        node.enable_reconciliation(ch.ledger.pvt_store.get_missing_pvt_data,
                                   ch.ledger.commit_reconciled_pvt)
        self.gossip_nodes[channel_id] = node

        if orderer_addr is not None:
            deliver_state = {"thread": None}

            def on_leadership(am_leader: bool) -> None:
                # one gated thread: it pulls while leader, idles when
                # demoted, resumes on re-election (deliveryclient yield)
                if am_leader and deliver_state["thread"] is None:
                    deliver_state["thread"] = self.start_deliver_for_channel(
                        channel_id, orderer_addr, should_run=lambda: node.is_leader)

            node.election.on_leadership_change = on_leadership
            self.on_commit(
                lambda cid, block: (
                    node.broadcast_block(block)
                    if cid == channel_id and node.is_leader
                    else None
                )
            )
        node.start()
        for endpoint in bootstrap:
            node.connect(endpoint)
        return node

    # -- deliver client (core/deliverservice) ----------------------------
    def start_deliver_for_channel(
        self,
        channel_id: str,
        orderer_addr: Union[str, Sequence[str]],
        should_run: Optional[Callable[[], bool]] = None,
        pipelined: bool = True,
    ) -> threading.Thread:
        """Pull blocks from the orderer and feed the commit pipeline
        (blocksprovider.DeliverBlocks). Reconnects with backoff until
        stop() — each reconnect re-seeks from the current height, at the
        next of `orderer_addr`'s endpoints after a failure.
        ``should_run`` gates the loop (gossip leadership: a demoted
        leader must stop pulling, reference deliveryclient leadership
        yield). ``pipelined`` overlaps block N's parse + device sig batch
        with block N-1's commit; pass False for strictly sequential
        commits."""
        endpoints = [orderer_addr] if isinstance(orderer_addr, str) else list(orderer_addr)
        pipe = self.commit_pipeline(channel_id) if pipelined else None

        def run():
            backoff = 0.05
            turn = 0
            while not self._stop.is_set():
                if should_run is not None and not should_run():
                    self._stop.wait(0.2)
                    continue
                try:
                    ch = self.channels[channel_id]
                    if pipe is not None:
                        pipe.drain()  # reseek only from a settled height
                    env = seek_envelope(channel_id, start=ch.ledger.height, signer=self.signer)
                    conn = channel_to(endpoints[turn % len(endpoints)], self._orderer_root_ca)
                    try:
                        call = deliver_stream(conn, env)
                        self._deliver_calls[channel_id] = call
                        if self._stop.is_set():
                            return
                        for resp in call:
                            if self._stop.is_set():
                                return
                            if should_run is not None and not should_run():
                                break  # demoted: idle in the outer loop
                            kind = ab.response_type(resp)
                            if kind == "block":
                                if pipe is not None:
                                    pipe.submit(resp["block"])
                                else:
                                    self.commit_block(channel_id, resp["block"])
                                backoff = 0.05
                            elif kind == "status":
                                break
                    finally:
                        self._deliver_calls.pop(channel_id, None)
                        conn.close()
                except Exception as exc:  # noqa: BLE001 - retried with backoff
                    if self._stop.is_set():
                        return
                    self.deliver_errors[channel_id] = f"{exc}\n{traceback.format_exc()}"
                    turn += 1
                self._stop.wait(backoff)
                backoff = min(backoff * 1.2, 2.0)  # reference base 1.2

        t = threading.Thread(target=run, name=f"deliver-{channel_id}", daemon=True)
        t.start()
        self._pull_threads.append(t)
        return t

    # -- lifecycle -------------------------------------------------------
    def start(self) -> str:
        if self.ops is not None:
            self.ops.start()
        return self.server.start()

    def stop(self) -> None:
        self._stop.set()
        for node in self.gossip_nodes.values():
            node.stop()
        for call in list(self._deliver_calls.values()):
            call.cancel()
        for t in self._pull_threads:
            if t is not threading.current_thread():
                t.join()
        for pipe in self._pipelines.values():
            pipe.stop()
        self.provider.stop()
        self.cc_listener.stop()
        self.launcher.stop()
        self.server.stop()
        if self.ops is not None:
            self.ops.stop()
        for ch in self.channels.values():
            ch.ledger.close()

    @property
    def addr(self) -> str:
        return self.server.addr
