"""The port imports neither JAX, nor the JAX package, nor protobuf, nor
cryptography (the card's machine has neither of the last two), nor yaml
(not known to be on the card's machine); only its gRPC modules
(`comm.*`, `gossip.comm`, `orderer.cluster`, `discovery.server`,
`chaincode.{extserver,extshim}` and the nodes) import grpc; and its device
entry points refuse to run without a card instead of falling back to the
CPU: a KVLedger or Channel asked for MVCC on the card without a device
raises at construction, and so do `bccsp.probe_provider()`, a serve
sidecar on the "auto" or "device" engine, the default device mesh and
`MeshCUDAProvider()`. The alias modules under the JAX package's old paths
(`validation/{msgvalidation,txflags}`, `crypto/{der,p256,fp256bn}`) are the
port's own modules; loading a validation plugin by module path brings in no
JAX; and a Channel takes `writeset_check`, `plugin_registry` and
`state_mirror`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fabric_tpu_torch.ops import cudalib

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import fabric_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fabric_tpu_torch.__path__, "fabric_tpu_torch.")]
# the gRPC modules load grpc; _GRPC_PROBE imports them on their own
GRPC_MODULES = {"fabric_tpu_torch.comm.server", "fabric_tpu_torch.comm.services",
                "fabric_tpu_torch.comm.interceptors", "fabric_tpu_torch.gossip.comm",
                "fabric_tpu_torch.orderer.cluster", "fabric_tpu_torch.discovery.server",
                "fabric_tpu_torch.chaincode.extserver", "fabric_tpu_torch.chaincode.extshim",
                "fabric_tpu_torch.nodes.orderer", "fabric_tpu_torch.nodes.peer"}
for name in names:
    if name not in GRPC_MODULES:
        importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "fabric_tpu" or m.startswith("fabric_tpu.")
    or m == "google.protobuf" or m.startswith("google.protobuf.")
    or m == "cryptography" or m.startswith("cryptography.")
    or m == "yaml" or m.startswith("yaml.")
    or m == "grpc" or m.startswith("grpc.")
)
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider
from fabric_tpu_torch.ledger.mvcc_device import DeviceValidator, ResidentDeviceValidator
from fabric_tpu_torch.ledger.statedb import VersionedDB
from fabric_tpu_torch.common import fp256bn
from fabric_tpu_torch.idemix.batch import verify_signatures_batch
from fabric_tpu_torch.ops.bn256_kernel import msm_host_batch
from fabric_tpu_torch.ops.pairing_kernel import Ate2Kernel, kernel_for_issuer, miller2_values
from fabric_tpu_torch.msp.identity import MSPManager
from fabric_tpu_torch.policy.ast import from_dsl
from fabric_tpu_torch.policy.evaluator import compile_batched
from fabric_tpu_torch.validation.validator import BlockValidator, ChaincodeRegistry
from fabric_tpu_torch.parallel.multichannel import MultiChannelValidator
from fabric_tpu_torch.validation.blockparse import parse_block
import tempfile
from fabric_tpu_torch.ledger.kvledger import KVLedger
from fabric_tpu_torch.peer.channel import Channel
from fabric_tpu_torch.crypto.bccsp import probe_provider
from fabric_tpu_torch.crypto.factory import FactoryError
from fabric_tpu_torch.serve.server import SidecarServer
from fabric_tpu_torch.parallel import MeshCUDAProvider, flat_mesh, grid_mesh
scratch = tempfile.mkdtemp()
parse_block([b""])  # the native pass: the port's own library, built on first use
with open("/proc/self/maps") as maps:
    libraries = sorted({line.split()[-1] for line in maps if "fabric_native" in line})
refused = {}
for name, make in (("CUDAProvider", CUDAProvider),
                   ("DeviceValidator", lambda: DeviceValidator(VersionedDB())),
                   ("ResidentDeviceValidator", lambda: ResidentDeviceValidator(VersionedDB())),
                   ("verify_signatures_batch", lambda: verify_signatures_batch(
                       [{}], [[0]], {"attribute_names": ["a"]}, [b""], [[None]], 0)),
                   ("Ate2Kernel", lambda: Ate2Kernel(fp256bn.G2_GEN)),
                   ("kernel_for_issuer", lambda: kernel_for_issuer(
                       fp256bn.g2_to_bytes(fp256bn.G2_GEN))),
                   ("msm_host_batch", lambda: msm_host_batch([[fp256bn.G1_GEN]], [[1]])),
                   ("miller2_values", lambda: miller2_values(
                       fp256bn.G2_GEN, [(fp256bn.G1_GEN, fp256bn.G1_GEN)])),
                   ("compile_batched", lambda: compile_batched(from_dsl("OR('A.member')"), 1)),
                   ("BlockValidator", lambda: BlockValidator(
                       "ch", MSPManager([]), CUDAProvider(), ChaincodeRegistry())),
                   ("MultiChannelValidator", lambda: MultiChannelValidator({})),
                   ("KVLedger", lambda: KVLedger(scratch + "/a", "ch", device_mvcc=True)),
                   ("Channel", lambda: Channel("ch", scratch + "/b", MSPManager([]),
                                               ChaincodeRegistry(), None, device_mvcc=True)),
                   ("probe_provider", probe_provider),
                   ("SidecarServer", lambda: SidecarServer(scratch + "/s.sock")),
                   ("SidecarServer_device", lambda: SidecarServer(scratch + "/t.sock",
                                                                  engine="device")),
                   ("flat_mesh", flat_mesh), ("grid_mesh", lambda: grid_mesh(1)),
                   ("MeshCUDAProvider", MeshCUDAProvider)):
    try:
        make()
        refused[name] = None
    except (RuntimeError, FactoryError) as exc:
        refused[name] = str(exc)
print(json.dumps({"modules": names, "leaked": leaked, "refused": refused,
                  "libraries": libraries}))
"""


def test_port_imports_no_jax_and_needs_a_card():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO)],
        capture_output=True, text=True, check=True, timeout=300, cwd=REPO,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fabric_tpu_torch.ops.p256_kernel" in report["modules"]
    assert "fabric_tpu_torch.crypto.cuda_provider" in report["modules"]
    assert "fabric_tpu_torch.ledger.mvcc_device" in report["modules"]
    assert "fabric_tpu_torch.protos.wire" in report["modules"]
    for name in ("common.fp256bn", "ops.bn256_kernel", "ops.fp12", "ops.pairing_kernel",
                 "protos.idemix", "idemix.scheme", "idemix.batch", "protos.fabric",
                 "protos.protoutil", "common.x509", "msp.identity", "msp.cryptogen", "msp.signer",
                 "policy.ast", "policy.proto_convert", "policy.evaluator", "ops.policy_kernel",
                 "ledger.txparse", "validation.blockparse", "validation.statebased",
                 "validation.validator", "endorser.txbuilder", "utils.native",
                 "parallel.sharded", "parallel.multichannel", "parallel.batcher",
                 "peer.channel", "peer.pipeline", "ledger.blockstore", "ledger.pvtdatastore",
                 "ledger.persistent", "ledger.queries", "ledger.kvledger", "ledger.confighistory",
                 "ledger.ledgermetrics", "common.faults", "common.fabobs", "common.retry",
                 "common.flogging", "common.metrics", "ledger.history", "ledger.collections",
                 "ledger.snapshot", "ledger.statecouch", "lifecycle", "lifecycle.lifecycle",
                 "validation.plugin_api", "validation.dispatcher", "validation.legacy",
                 "validation.msgvalidation", "validation.txflags", "crypto.der", "crypto.p256",
                 "crypto.fp256bn", "protos.configtx", "policy.manager", "channelconfig",
                 "channelconfig.capabilities", "channelconfig.bundle", "channelconfig.configtx",
                 "channelconfig.encoder", "peer.aclmgmt", "crypto.hostec", "crypto.hostec_np",
                 "crypto.hostbn", "crypto.factory", "crypto.pkcs11", "serve", "serve.__main__",
                 "serve.protocol", "serve.qos", "serve.registry", "serve.server", "serve.client",
                 "serve.router", "serve.fleetload", "common.p384", "msp.idemix_msp", "cli",
                 "cli.idemixgen", "parallel", "parallel.mesh", "parallel.provider",
                 "ledger.simulator", "chaincode", "chaincode.shim", "chaincode.support",
                 "chaincode.package", "chaincode.extbuilder", "endorser.endorser", "scc",
                 "scc.qscc", "scc.cscc", "scc.lscc", "scc.lifecycle_scc", "orderer",
                 "orderer.blockcutter", "orderer.blockwriter", "orderer.solo", "protos.ab",
                 "orderer.consenter_ids", "orderer.raft", "orderer.raft_chain",
                 "orderer.msgprocessor", "orderer.multichannel", "orderer.broadcast",
                 "orderer.follower", "deliver", "deliver.client", "deliver.server",
                 "discovery", "discovery.inquire", "discovery.service", "protos.gossip",
                 "gossip", "gossip.msgstore", "gossip.membership", "gossip.state",
                 "gossip.pull", "gossip.pvtdata", "gossip.coordinator", "gossip.comm", "comm",
                 "comm.server", "comm.services", "comm.interceptors", "operations",
                 "operations.pprof", "operations.system", "protos.cluster",
                 "protos.discovery", "protos.chaincode", "orderer.cluster",
                 "discovery.server", "chaincode.extserver", "chaincode.extshim",
                 "chaincode.launcher", "nodes", "nodes.orderer", "nodes.peer"):
        assert f"fabric_tpu_torch.{name}" in report["modules"]
    assert report["leaked"] == []
    # the port's native library, never the JAX package's native/libfabric_native.so
    assert [Path(p).parent.name for p in report["libraries"]] == ["torch_native"]
    for path in (REPO / "fabric_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cc", ".h", ".cu"):
            assert "libfabric_native" not in path.read_text(), path
    if not torch.cuda.is_available():
        assert {"probe_provider", "SidecarServer", "SidecarServer_device", "flat_mesh",
                "grid_mesh", "MeshCUDAProvider"} <= set(report["refused"])
        for name, refused in report["refused"].items():
            assert refused, f"{name}() must raise without a card"


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """A missing compiler is an error, never a silent CPU route."""
    monkeypatch.setattr(cudalib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cudalib.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cudalib.build("p256_verify")


ALIASES = {
    "fabric_tpu_torch.validation.msgvalidation": "fabric_tpu_torch.ledger.txparse",
    "fabric_tpu_torch.validation.txflags": "fabric_tpu_torch.common.txflags",
    "fabric_tpu_torch.crypto.der": "fabric_tpu_torch.common.der",
    "fabric_tpu_torch.crypto.p256": "fabric_tpu_torch.common.p256",
    "fabric_tpu_torch.crypto.fp256bn": "fabric_tpu_torch.common.fp256bn",
}


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_alias_modules_are_the_port_modules(alias):
    """Each alias under a JAX path is the port's module itself, as each JAX
    alias is the JAX module (`fabric_tpu/crypto/p256.py:11-13`)."""
    import importlib

    target = importlib.import_module(ALIASES[alias])
    assert importlib.import_module(alias) is target
    assert target.__name__.startswith("fabric_tpu_torch.")


_PLUGIN_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch.validation.dispatcher import PluginRegistry
registry = PluginRegistry()
plugin = registry.load("guard", "fabric_tpu_torch.validation.plugin_api:ValidationPlugin")
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "fabric_tpu" or m.startswith("fabric_tpu."))
print(json.dumps({"leaked": leaked, "plugin": type(plugin).__module__,
                  "registered": registry.get("guard") is plugin}))
"""


def test_plugin_load_brings_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _PLUGIN_PROBE, str(REPO)],
                         capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"leaked": [], "plugin": "fabric_tpu_torch.validation.plugin_api",
                      "registered": True}


def test_channel_takes_writeset_check_plugins_and_mirror(tmp_path):
    """The three arguments that raised NotImplementedError before are taken
    and reach the validator and the ledger."""
    from fabric_tpu_torch.ledger.statecouch import CouchClient, CouchStateAdapter
    from fabric_tpu_torch.msp.identity import MSPManager
    from fabric_tpu_torch.peer.channel import Channel
    from fabric_tpu_torch.validation.dispatcher import PluginRegistry
    from fabric_tpu_torch.validation.legacy import check_v13_writeset
    from fabric_tpu_torch.validation.validator import ChaincodeRegistry

    plugins = PluginRegistry()
    mirror = CouchStateAdapter(CouchClient("http://127.0.0.1:1"), "ch")
    ch = Channel("ch", str(tmp_path), MSPManager([]), ChaincodeRegistry(), None,
                 writeset_check=check_v13_writeset, plugin_registry=plugins, state_mirror=mirror)
    try:
        assert ch.validator.writeset_check is check_v13_writeset
        assert ch.validator.plugin_registry is plugins
        assert ch.ledger.state_mirror is mirror
    finally:
        ch.ledger.close()


_SLICE_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch import chaincode, orderer, scc
from fabric_tpu_torch.chaincode import extbuilder, package
from fabric_tpu_torch.endorser import endorser, txbuilder
from fabric_tpu_torch.ledger import simulator
from fabric_tpu_torch.orderer import blockwriter
from fabric_tpu_torch.scc import lifecycle_scc
print(json.dumps(sorted(m for m in ("torch", "grpc", "yaml") if m in sys.modules)))
"""


_ORDERING_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch.orderer import (broadcast, consenter_ids, follower, msgprocessor,
                                      multichannel, raft, raft_chain)
from fabric_tpu_torch.deliver import client, server
from fabric_tpu_torch.discovery import inquire, service
from fabric_tpu_torch.protos import ab
print(json.dumps(sorted(m for m in ("torch", "grpc", "yaml") if m in sys.modules)))
"""


def test_ordering_and_delivery_modules_import_no_torch():
    """The raft orderer, the ordering front door, block delivery and
    discovery (twelve modules and their schemas) touch no tensor: they load
    neither torch nor grpc nor yaml, though their bundles verify through a
    provider that may run K2."""
    out = subprocess.run([sys.executable, "-c", _ORDERING_PROBE, str(REPO)],
                         capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_endorsement_and_orderer_modules_import_no_torch():
    """The endorsement side and the solo orderer touch no tensor, so they
    load neither torch nor grpc nor yaml."""
    out = subprocess.run([sys.executable, "-c", _SLICE_PROBE, str(REPO)],
                         capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_HOST_TIER_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch.crypto import hostbn, hostec, hostec_np
from fabric_tpu_torch.idemix import batch
print(json.dumps({"torch": "torch" in sys.modules, "numpy": "numpy" in sys.modules}))
"""


def test_host_tiers_import_no_torch():
    """The host tiers and the Idemix batch module (what the pools' workers
    import) load numpy and never torch, so the workers start light."""
    out = subprocess.run([sys.executable, "-c", _HOST_TIER_PROBE, str(REPO)],
                         capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"torch": False, "numpy": True}


_GRPC_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch.comm import interceptors, server, services
from fabric_tpu_torch.gossip import comm
from fabric_tpu_torch.orderer import cluster
from fabric_tpu_torch.discovery import server as discovery_server
from fabric_tpu_torch.chaincode import extserver, extshim
no_torch = "torch" not in sys.modules
from fabric_tpu_torch.nodes import orderer, peer
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "fabric_tpu" or m.startswith("fabric_tpu.")
    or m == "google.protobuf" or m.startswith("google.protobuf.")
    or m == "cryptography" or m.startswith("cryptography.")
    or m == "yaml" or m.startswith("yaml.")
)
print(json.dumps({"leaked": leaked, "grpc": "grpc" in sys.modules, "no_torch": no_torch}))
"""


def test_grpc_modules_import_grpc_and_nothing_forbidden():
    """The gRPC modules, imported alone, load grpc and none of jax, the JAX
    package, protobuf, cryptography or yaml; all but the nodes load no torch
    (gossip.comm, the cluster, discovery's server and the shim stream reach
    the card only through the callables they are given; a peer node's
    channels run the kernels)."""
    out = subprocess.run([sys.executable, "-c", _GRPC_PROBE, str(REPO)],
                         capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "leaked": [], "grpc": True, "no_torch": True}


_CHAINCODE_PROCESS_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch.chaincode import launcher
first = sorted(m for m in ("torch", "grpc") if m in sys.modules)
from fabric_tpu_torch.chaincode import extshim
print(json.dumps({"launcher": first,
                  "with_shim": sorted(m for m in ("torch", "grpc") if m in sys.modules)}))
"""


def test_chaincode_process_imports_no_torch():
    """What a chaincode process runs (`python -m
    fabric_tpu_torch.chaincode.launcher`, then the shim stream) loads no
    torch: the launcher alone loads neither torch nor grpc, the shim adds
    grpc."""
    out = subprocess.run([sys.executable, "-c", _CHAINCODE_PROCESS_PROBE, str(REPO)],
                         capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"launcher": [],
                                                                "with_shim": ["grpc"]}


_GOSSIP_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from fabric_tpu_torch.protos import gossip
from fabric_tpu_torch.gossip import coordinator, membership, msgstore, pull, pvtdata, state
first = sorted(m for m in ("torch", "grpc", "yaml") if m in sys.modules)
from fabric_tpu_torch.gossip import comm
print(json.dumps({"modules_1_7": first, "with_comm": "torch" in sys.modules}))
"""


def test_gossip_modules_load_no_torch_or_grpc():
    """The gossip schemas and modules (msgstore, membership, state, pull,
    pvtdata, coordinator) load no torch, grpc or yaml; gossip.comm adds
    grpc and still no torch."""
    out = subprocess.run([sys.executable, "-c", _GOSSIP_PROBE, str(REPO)],
                         capture_output=True, text=True, check=True, timeout=120, cwd=REPO)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"modules_1_7": [],
                                                                "with_comm": False}
