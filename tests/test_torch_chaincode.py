"""The port's chaincode runtime (fabric_tpu_torch.chaincode) against the JAX
package's, with no tolerance: ChaincodeSupport.execute's responses, events
(the port's ChaincodeEvent dict encoded equals protobuf's message bytes)
and rwset bytes over the same seeded state; the chaincode-panic mapping;
cc2cc within a channel (one shared rwset) and across two channels
(read-only); the stub's surface (composite keys, SBE parameters, private
data, transient data, pagination); package bytes and ids, parse errors and
PackageStore; the out-of-process resolution against duck-typed listeners
and launchers (installed packages, ccaas connection.json, Go durations);
ExternalBuilder and Launcher over shell-script tools in a tmp dir."""

import io
import json
import os
import stat
import tarfile

import pytest

from fabric_tpu.chaincode import package as jpkg
from fabric_tpu.chaincode import shim as jshim
from fabric_tpu.chaincode import support as jsup
from fabric_tpu.chaincode import extbuilder as jext
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.ledger import simulator as jsim
from fabric_tpu.ledger import statedb as jdb
from fabric_tpu_torch.chaincode import extbuilder as text
from fabric_tpu_torch.chaincode import package as tpkg
from fabric_tpu_torch.chaincode import shim as tshim
from fabric_tpu_torch.chaincode import support as tsup
from fabric_tpu_torch.ledger import rwset as trw
from fabric_tpu_torch.ledger import simulator as tsim
from fabric_tpu_torch.ledger import statedb as tdb
from fabric_tpu_torch.ledger.mvcc import serialize_metadata_entries
from fabric_tpu_torch.protos import fabric, wire

PACKAGES = {
    "jax": (jshim, jsup, jsim, jdb, jrw),
    "port": (tshim, tsup, tsim, tdb, trw),
}


def make_cc(shim):
    """One chaincode class written against either package's shim."""

    class AssetCC:
        def init(self, stub):
            stub.put_state("init", b"1")
            return shim.success(b"init")

        def invoke(self, stub):
            fn, params = stub.get_function_and_parameters()
            if fn == "put":
                stub.put_state(params[0], params[1].encode())
                stub.set_event("put", params[0].encode())
                return shim.success(b"ok")
            if fn == "get":
                return shim.success(stub.get_state(params[0]) or b"")
            if fn == "del":
                stub.del_state(params[0])
                return shim.success()
            if fn == "scan":
                rows = list(stub.get_state_by_range(params[0], params[1]))
                return shim.success(b",".join(k.encode() for k, _ in rows))
            if fn == "composite":
                key = stub.create_composite_key("color~name", params)
                stub.put_state(key, b"c")
                typ, attrs = stub.split_composite_key(key)
                rows = list(stub.get_state_by_partial_composite_key("color~name", params[:1]))
                return shim.success(json.dumps([typ, attrs, [k for k, _ in rows]]).encode())
            if fn == "sbe":
                stub.set_state_validation_parameter(params[0], params[1].encode())
                return shim.success(stub.get_state_validation_parameter(params[0]) or b"none")
            if fn == "pvt":
                stub.put_private_data("secret", params[0], stub.get_transient()["v"])
                got = stub.get_private_data("secret", params[0])
                h = stub.get_private_data_hash("secret", params[0])
                stub.del_private_data("shared", params[0])
                return shim.success(repr((got, h)).encode())
            if fn == "page":
                page, mark = stub.get_state_by_range_with_pagination("a", "z", 2)
                return shim.success(json.dumps([[k for k, _ in page], mark]).encode())
            if fn == "query":
                rows = list(stub.get_query_result(json.dumps({"selector": {"t": "x"}})))
                qpage, qmark = stub.get_query_result_with_pagination(
                    json.dumps({"selector": {"t": "x"}}), 1)
                return shim.success(json.dumps([[k for k, _ in rows], qmark]).encode())
            if fn == "creator":
                return shim.success(stub.get_creator() + stub.get_args()[0])
            if fn == "call":
                channel = params[2] if len(params) > 2 else ""
                return stub.invoke_chaincode(params[0], [b"get", params[1].encode()], channel)
            if fn == "callput":
                return stub.invoke_chaincode(params[0], [b"put", params[1].encode(), b"z"])
            if fn == "boom":
                raise RuntimeError("chaincode panic")
            if fn == "none":
                return "not a response"
            if fn == "noevent":
                stub.set_event("", b"x")
            return shim.error_response(f"unknown function {fn}")

    return AssetCC()


def seeded_db(pkg, extra=()):
    _, _, _, db_mod, rw_mod = PACKAGES[pkg]
    db = db_mod.VersionedDB()
    batch = db_mod.UpdateBatch()
    rows = [("mycc", "a", b"100", None), ("mycc", "b", b"200", None),
            ("mycc", "c", b'{"t": "x"}', serialize_metadata_entries(
                [("VALIDATION_PARAMETER", b"ep")])),
            ("mycc", "d", b'{"t": "x"}', None), ("othercc", "a", b"other-a", None),
            *extra]
    for n, (ns, key, value, meta) in enumerate(rows):
        batch.put(ns, key, value, rw_mod.Version(1, n), meta)
    db.apply_updates(batch)
    return db


def make_support(pkg, state_getter=None):
    shim, sup, *_ = PACKAGES[pkg]
    support = sup.ChaincodeSupport(state_getter=state_getter)
    support.register("mycc", make_cc(shim))
    support.register("othercc", make_cc(shim), system=True)
    return support


def run_both(args, is_init=False, transient=None, creator=b"alice"):
    """Execute `args` on mycc in both packages; return the comparable
    outcome of each."""
    out = {}
    for pkg in PACKAGES:
        _, sup, sim_mod, db_mod, _ = PACKAGES[pkg]
        other = seeded_db(pkg, extra=(("othercc", "b", b"ch2-b", None),))
        support = make_support(pkg, state_getter=lambda ch, o=other: o if ch == "ch2" else None)
        db = seeded_db(pkg)
        sim = sim_mod.TxSimulator(db, tx_id="tx1")
        resp, event = support.execute(
            sup.TxParams("ch", "tx1", sim, creator=creator, transient=transient),
            "mycc", args, is_init=is_init)
        res = sim.get_tx_simulation_results()
        if event is None:
            ev = None
        elif pkg == "jax":
            ev = event.SerializeToString()
        else:
            ev = wire.encode(fabric.CHAINCODE_EVENT, event)
        out[pkg] = ((resp.status, resp.message, resp.payload), ev, res.public_bytes,
                    res.pvt_rwset_bytes())
    return out


CASES = [
    [b"put", b"k", b"v"], [b"get", b"a"], [b"get", b"zz"], [b"del", b"b"], [b"scan", b"a", b"d"],
    [b"composite", b"red", b"car1"], [b"sbe", b"a", b"policy"], [b"sbe", b"c", b"p2"],
    [b"page"], [b"query"], [b"creator"], [b"call", b"othercc", b"a"],
    [b"call", b"othercc", b"b", b"ch2"], [b"call", b"othercc", b"b", b"ch9"],
    [b"call", b"ghostcc", b"a"], [b"callput", b"othercc", b"q"], [b"boom"], [b"none"],
    [b"noevent"], [b"nope"], [],
]


@pytest.mark.parametrize("args", CASES, ids=lambda a: b"_".join(a).decode() or "empty")
def test_execute_equals_jax(args):
    """Responses, events and rwset bytes of each invocation."""
    out = run_both(args)
    assert out["port"] == out["jax"]


def test_init_and_transient_private_data():
    assert run_both([], is_init=True)["port"][0] == (200, "", b"init")
    out = run_both([b"pvt", b"k1"], transient={"v": b"secret-v"})
    assert out["port"] == out["jax"]
    assert out["port"][3]  # a TxPvtReadWriteSet


def test_panic_and_cross_channel_mapping():
    """The chaincode-panic mapping and the cc2cc rules, spelled out."""
    out = run_both([b"boom"])["port"]
    assert out[0] == (500, "chaincode mycc failed: chaincode panic", b"")
    assert run_both([b"none"])["port"][0] == (500, "chaincode mycc returned no Response", b"")
    # across channels: the callee reads ch2's state and records nothing here
    cross = run_both([b"call", b"othercc", b"b", b"ch2"])["port"]
    assert cross[0] == (200, "", b"ch2-b")
    same = run_both([b"call", b"othercc", b"a"])["port"]
    assert same[0] == (200, "", b"other-a")
    assert b"othercc" in same[2] and b"othercc" not in cross[2]
    assert run_both([b"call", b"othercc", b"b", b"ch9"])["port"][0] == (
        500, "channel ch9 not found", b"")


def test_unknown_chaincode_raises_launch_error():
    for pkg in PACKAGES:
        _, sup, sim_mod, db_mod, _ = PACKAGES[pkg]
        support = make_support(pkg)
        with pytest.raises(sup.LaunchError, match="ghostcc is not installed/launched"):
            support.execute(sup.TxParams("ch", "t", sim_mod.TxSimulator(db_mod.VersionedDB())),
                            "ghostcc", [])
        with pytest.raises(sup.LaunchError, match="already registered"):
            support.register("mycc", object())
        assert support.is_system_chaincode("othercc") and not support.is_system_chaincode("mycc")
        assert support.launched("mycc") and not support.launched("ghostcc")


def test_stub_without_support_and_cross_channel_without_getter():
    for pkg in PACKAGES:
        shim, sup, sim_mod, db_mod, _ = PACKAGES[pkg]
        stub = shim.ChaincodeStub("mycc", "ch", "t", [b"x"], sim_mod.TxSimulator(db_mod.VersionedDB()))
        resp = stub.invoke_chaincode("othercc", [b"get"])
        assert (resp.status, resp.message) == (500, "chaincode support not wired for cc2cc")
        support = make_support(pkg)
        resp, _ = support.execute(sup.TxParams("ch", "t", sim_mod.TxSimulator(db_mod.VersionedDB())),
                                  "mycc", [b"call", b"othercc", b"a", b"ch2"])
        assert (resp.status, resp.message) == (
            500, "cross-channel invocation requires a state getter")


# ---------------------------------------------------------------------------
# packages
# ---------------------------------------------------------------------------

FILES = {"chaincode.py": b"chaincode = None\n", "lib/util.py": b"X = 1\n", "README": b"r"}


@pytest.mark.parametrize("label,cc_type,path", [("mycc_1", "python", ""),
                                                 ("asset-2.0", "ccaas", "src/asset")])
def test_package_bytes_and_ids_equal_jax(label, cc_type, path):
    raw = tpkg.package(label, FILES, cc_type=cc_type, path=path)
    assert raw == jpkg.package(label, FILES, cc_type=cc_type, path=path)
    assert tpkg.package_id(raw) == jpkg.package_id(raw)
    assert tpkg.parse_package(raw) == jpkg.parse_package(raw)


def _tgz(members):
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w:gz") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return out.getvalue()


@pytest.mark.parametrize("raw", [
    b"not a tarball",
    _tgz([("metadata.json", b"{}")]),
    _tgz([("metadata.json", b"{bad json"), ("code.tar.gz", _tgz([]))]),
    _tgz([("metadata.json", b'{"type": "python"}'), ("code.tar.gz", _tgz([]))]),
    _tgz([("metadata.json", b'{"label": "x"}'), ("code.tar.gz", _tgz([("../evil", b"e")]))]),
], ids=["garbage", "no-code", "bad-json", "no-label", "unsafe-path"])
def test_malformed_packages_refused_alike(raw):
    with pytest.raises(jpkg.PackageError) as jerr:
        jpkg.parse_package(raw)
    with pytest.raises(tpkg.PackageError) as terr:
        tpkg.parse_package(raw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("label", ["", "a:b", "a/b", "a\\b"])
def test_bad_labels_refused_alike(label):
    for mod in (jpkg, tpkg):
        with pytest.raises(mod.PackageError, match="invalid label"):
            mod.package(label, FILES)


def test_package_store_equals_jax(tmp_path):
    raws = [tpkg.package(f"cc{i}", {"chaincode.py": b"%d" % i}) for i in range(3)]
    stores = {"jax": jpkg.PackageStore(str(tmp_path / "j")),
              "port": tpkg.PackageStore(str(tmp_path / "t"))}
    installed = {k: [s.install(r) for r in raws + raws[:1]] for k, s in stores.items()}
    for (j, t) in zip(installed["jax"], installed["port"]):
        assert (t.package_id, t.label, t.cc_type, os.path.basename(t.path)) == (
            j.package_id, j.label, j.cc_type, os.path.basename(j.path))
    listed = {k: [(p.package_id, p.label, p.cc_type, os.path.basename(p.path))
                  for p in s.list_installed()] for k, s in stores.items()}
    assert listed["port"] == listed["jax"] and len(listed["port"]) == 3
    pid = installed["port"][1].package_id
    assert stores["port"].load(pid) == stores["jax"].load(pid) == raws[1]
    with pytest.raises(tpkg.PackageError, match="is not installed"):
        stores["port"].load("ghost:00")


# ---------------------------------------------------------------------------
# the out-of-process runtime against duck-typed listeners and launchers
# ---------------------------------------------------------------------------


class FakeListener:
    """The listener surface ChaincodeSupport uses, recording each call."""

    def __init__(self, shim, connected=(), register_on_launch=True):
        self.shim = shim
        self._connected = set(connected)
        self.calls = []
        self.register_on_launch = register_on_launch

    def connected(self, name):
        return name in self._connected

    def chaincode(self, name):
        self.calls.append(("chaincode", name))
        return make_cc(self.shim)

    def wait_for(self, pid, timeout):
        self.calls.append(("wait_for", pid, timeout))
        return pid in self._connected

    def connect_ccaas(self, address, timeout, root_ca, expected_name):
        self.calls.append(("connect_ccaas", address, timeout, root_ca, expected_name))
        if address.startswith("bad"):
            raise ConnectionError("refused")
        self._connected.add(expected_name)


class FakeLauncher:
    def __init__(self, listener):
        self.listener = listener
        self.launched = []

    def launch(self, installed, addr):
        self.launched.append((installed.package_id, addr))
        if self.listener.register_on_launch:
            self.listener._connected.add(installed.package_id)


def external_outcome(pkg, tmp_path, package_raw, name="extcc", connected=(), register=True,
                     address="peer:7052", resolver=True):
    shim, sup, sim_mod, db_mod, _ = PACKAGES[pkg]
    store_mod = jpkg if pkg == "jax" else tpkg
    store = store_mod.PackageStore(str(tmp_path / pkg))
    pid = store.install(package_raw).package_id if package_raw else "ghost:00"
    listener = FakeListener(shim, connected, register)
    launcher = FakeLauncher(listener)
    support = sup.ChaincodeSupport(
        listener=listener, launcher=launcher, package_store=store,
        source_resolver=(lambda ch, n: pid if n == name else None) if resolver else None,
        chaincode_address=(lambda: address) if address else None)
    sim = sim_mod.TxSimulator(seeded_db(pkg), tx_id="t")
    try:
        resp, _ = support.execute(sup.TxParams("ch", "t", sim), name, [b"get", b"a"])
        result = ("ok", resp.status, resp.payload)
    except sup.LaunchError as e:
        result = ("LaunchError", str(e))
    return result, listener.calls, launcher.launched


def conn(**cfg):
    return json.dumps(cfg).encode()


EXTERNAL = {
    "python": lambda: (tpkg.package("extcc", {"chaincode.py": b"x"}), {}),
    "never-registers": lambda: (tpkg.package("extcc", {"chaincode.py": b"x"}),
                                {"register": False}),
    "no-address": lambda: (tpkg.package("extcc", {"chaincode.py": b"x"}), {"address": None}),
    "not-installed": lambda: (None, {}),
    "ccaas": lambda: (tpkg.package("extcc", {"connection.json": conn(
        address="cc:9999", dial_timeout="1m30s")}, cc_type="ccaas"), {}),
    "ccaas-src-path": lambda: (tpkg.package("extcc", {"src/connection.json": conn(
        address="cc:1", dial_timeout="500ms", tls_required=True, root_cert="PEM")},
        cc_type="ccaas"), {}),
    "ccaas-tls-no-root": lambda: (tpkg.package("extcc", {"connection.json": conn(
        address="cc:1", tls_required=True)}, cc_type="ccaas"), {}),
    "ccaas-no-json": lambda: (tpkg.package("extcc", {"x": b"y"}, cc_type="ccaas"), {}),
    "ccaas-bad-json": lambda: (tpkg.package("extcc", {"connection.json": b"{nope"},
                                            cc_type="ccaas"), {}),
    "ccaas-no-address": lambda: (tpkg.package("extcc", {"connection.json": conn(x=1)},
                                              cc_type="ccaas"), {}),
    "ccaas-dial-fails": lambda: (tpkg.package("extcc", {"connection.json": conn(
        address="bad:1", dial_timeout="7x")}, cc_type="ccaas"), {}),
    "preconnected": lambda: (None, {"connected": ("extcc",), "resolver": False}),
    "unresolved": lambda: (None, {"resolver": False}),
}


@pytest.mark.parametrize("case", sorted(EXTERNAL))
def test_external_resolution_equals_jax(case, tmp_path):
    """_resolve_external and _connect_ccaas: the same outcome, the same
    calls on the listener and the launcher."""
    raw, kw = EXTERNAL[case]()
    port = external_outcome("port", tmp_path, raw, **kw)
    jax = external_outcome("jax", tmp_path, raw, **kw)
    assert port == jax


@pytest.mark.parametrize("value", [None, "", "10s", "500ms", "1m30s", "2h", "1.5s", "3us",
                                   "7x", "10", "5s5", 7])
def test_go_durations_equal_jax(value):
    assert tsup._parse_go_duration(value, 10.0) == jsup._parse_go_duration(value, 10.0)


# ---------------------------------------------------------------------------
# external builders
# ---------------------------------------------------------------------------


def write_builder(root, detect_rc=0, build_rc=0):
    bin_dir = root / "bin"
    bin_dir.mkdir(parents=True)
    scripts = {
        "detect": f"#!/bin/sh\ntest -f \"$1/chaincode.py\" || exit 1\nexit {detect_rc}\n",
        "build": f"#!/bin/sh\ncp -r \"$1\"/. \"$3\"\necho built > \"$3/BUILT\"\n"
                 f"echo build-stderr >&2\nexit {build_rc}\n",
        "run": "#!/bin/sh\ncp \"$2/chaincode.json\" \"$1/RAN\"\n",
    }
    for name, body in scripts.items():
        path = bin_dir / name
        path.write_text(body)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return root


@pytest.mark.parametrize("detect_rc,build_rc", [(0, 0), (1, 0), (0, 3)])
def test_external_builder_and_launcher_equal_jax(tmp_path, detect_rc, build_rc):
    """bin/detect, bin/build and bin/run as subprocesses: the same claim,
    build output, run metadata and errors in both packages."""
    raw = tpkg.package("extcc", {"chaincode.py": b"chaincode = None\n"}, cc_type="golang")
    outcomes = {}
    for name, ext, pkgmod in (("jax", jext, jpkg), ("port", text, tpkg)):
        root = tmp_path / name
        builder = ext.ExternalBuilder(str(write_builder(root / "builder", detect_rc, build_rc)))
        installed = pkgmod.PackageStore(str(root / "store")).install(raw)
        launcher = ext.Launcher(str(root / "work"), [builder])
        try:
            proc = launcher.launch(installed, "peer:7052")
            proc.wait(timeout=30)
            out_dir = root / "work" / installed.package_id.replace(":", ".") / "bld"
            outcomes[name] = ("ran", sorted(os.listdir(out_dir)),
                              json.loads((out_dir / "RAN").read_text()), proc.returncode)
            assert launcher.launch(installed, "peer:7052") is proc or proc.poll() is not None
        except ext.BuildError as e:
            outcomes[name] = ("BuildError", str(e))
        finally:
            launcher.stop()
    assert outcomes["port"] == outcomes["jax"]
    if (detect_rc, build_rc) == (0, 0):
        assert outcomes["port"][2] == {"chaincode_id": installed.package_id,
                                       "peer_address": "peer:7052"}


def test_builder_without_tools_and_unclaimed_packages(tmp_path):
    for name, ext in (("jax", jext), ("port", text)):
        bare = ext.ExternalBuilder(str(tmp_path / name / "bare"))
        assert bare.name == "bare"
        assert not bare.detect(str(tmp_path), str(tmp_path))
        with pytest.raises(ext.BuildError, match="lacks bin/build"):
            bare.build(str(tmp_path), str(tmp_path), str(tmp_path))
        with pytest.raises(ext.BuildError, match="lacks bin/run"):
            bare.run(str(tmp_path), str(tmp_path))
    raw = tpkg.package("gocc", {"main.go": b"package main"}, cc_type="golang")
    installed = tpkg.PackageStore(str(tmp_path / "s")).install(raw)
    with pytest.raises(text.BuildError, match=r"no builder claimed .* \(type golang\)"):
        text.Launcher(str(tmp_path / "w")).launch(installed, "peer:1")
    # the port has no built-in python builder (its launcher needs grpc): a
    # python package that no builder claims is refused too
    py = tpkg.PackageStore(str(tmp_path / "s")).install(tpkg.package("pycc", FILES))
    with pytest.raises(text.BuildError, match=r"no builder claimed .* \(type python\)"):
        text.Launcher(str(tmp_path / "w")).launch(py, "peer:1")
