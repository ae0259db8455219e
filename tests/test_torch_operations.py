"""operations/{system,pprof} against the JAX package: every endpoint of a
port System and of a JAX System configured alike answers the same status
and body (the profiles' bodies by their shape, since they sample this
process); TLS and required client certificates on the port's server; and
the heap profile's repair: the port's `heap_profile` leaves tracemalloc as
it found it, and its text is the JAX one's for the same snapshot."""

import datetime
import ipaddress
import json
import ssl
import tracemalloc
import urllib.error
import urllib.request

import pytest

from fabric_tpu.common import fabobs as jobs
from fabric_tpu.common import flogging as jflog
from fabric_tpu.common import metrics as jm
from fabric_tpu.operations import pprof as jpprof
from fabric_tpu.operations import system as jsys
from fabric_tpu_torch.common import fabobs as tobs
from fabric_tpu_torch.common import flogging as tflog
from fabric_tpu_torch.common import metrics as tm
from fabric_tpu_torch.operations import pprof as tpprof
from fabric_tpu_torch.operations import system as tsys

PKGS = {"jax": (jsys, jm, jflog, jobs), "port": (tsys, tm, tflog, tobs)}

# (method, path, body): every endpoint and its refusals
REQUESTS = [
    ("GET", "/metrics", None), ("GET", "/healthz", None), ("GET", "/logspec", None),
    ("PUT", "/logspec", b'{"spec": "gossip=warn:info"}'), ("GET", "/logspec", None),
    ("PUT", "/logspec", b'{"spec": ["x"]}'), ("PUT", "/logspec", b'{"spec": "bad=lvl"}'),
    ("POST", "/logspec", b'{"spec": "info"}'), ("PUT", "/other", b"{}"),
    ("GET", "/version", None), ("GET", "/trace", None), ("GET", "/nowhere", None),
    ("GET", "/debug/pprof/", None), ("GET", "/debug/pprof/goroutine", None),
    ("GET", "/debug/pprof/threads", None), ("GET", "/debug/pprof/profile?seconds=0.1", None),
    ("GET", "/debug/pprof/profile?seconds=x", None), ("GET", "/debug/pprof/nope", None),
]


def call(addr, method, path, body=None, scheme="http", context=None):
    req = urllib.request.Request(f"{scheme}://{addr}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10, context=context) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def shape(path, body):
    """A body as compared: a profile by its first line's kind."""
    if path.startswith("/debug/pprof/profile?seconds=0"):
        return body.split(b":", 1)[0]
    if path.startswith(("/debug/pprof/goroutine", "/debug/pprof/threads")):
        return body.split(b" ", 1)[0]
    return body


def answers(pkg, profile=True, checkers=(), obs=False):
    sysmod, metrics, flog, fobs = PKGS[pkg]
    provider = metrics.PrometheusProvider()
    provider.new_counter(metrics.CounterOpts(namespace="ops", name="hits",
                                             label_names=("who",))).with_labels("who", "a").add(3)
    system = sysmod.System(sysmod.Options(provider=provider, profile_enabled=profile))
    for name, check in checkers:
        system.register_checker(name, check)
    addr = system.start()
    fobs.disable()
    if obs:
        fobs.ensure_enabled()
    try:
        return [(status, shape(p, body)) for status, body, p in (
            (*call(addr, m, p, b), p) for m, p, b in REQUESTS)]
    finally:
        system.stop()
        fobs.disable()
        flog.reset()


def failing():
    raise RuntimeError("disk full")


@pytest.mark.parametrize("case", ["plain", "unprofiled", "failing_checks", "obs"])
def test_endpoints_answer_as_jax(case):
    kw = {"plain": {}, "unprofiled": {"profile": False},
          "failing_checks": {"checkers": [("b", failing), ("a", failing), ("ok", lambda: None)]},
          "obs": {"obs": True}}[case]
    port, jax = answers("port", **kw), answers("jax", **kw)
    if case == "obs":  # the flight ring's events: both empty, same keys
        i = [p for _, p, _ in REQUESTS].index("/trace")
        assert port[i][0] == jax[i][0] == 200
        assert json.loads(port[i][1]) == json.loads(jax[i][1])
    assert port == jax
    statuses = dict(zip([p for _, p, _ in REQUESTS], [s for s, _ in port]))
    assert statuses["/metrics"] == 200 and statuses["/nowhere"] == 404
    assert statuses["/healthz"] == (503 if case == "failing_checks" else 200)


def test_metrics_refused_for_a_provider_without_text():
    for pkg, (sysmod, metrics, _, _) in PKGS.items():
        for provider in (metrics.DisabledProvider(), metrics.StatsdProvider(lambda line: None)):
            system = sysmod.System(sysmod.Options(provider=provider))
            addr = system.start()
            try:
                assert call(addr, "GET", "/metrics") == (404, b"metrics provider is not prometheus")
            finally:
                system.stop()
        with pytest.raises(ValueError, match="unknown metrics provider"):
            sysmod.System(sysmod.Options(metrics_provider="nope"))


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    tmp = tmp_path_factory.mktemp("opscerts")
    out = {}
    for name in ("server", "client"):
        key = ec.derive_private_key(7 if name == "server" else 11, ec.SECP256R1())
        subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "127.0.0.1")])
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (x509.CertificateBuilder().subject_name(subject).issuer_name(subject)
                .public_key(key.public_key()).serial_number(1000 + len(out))
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(days=1))
                .add_extension(x509.SubjectAlternativeName(
                    [x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]), critical=False)
                .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
                .sign(key, hashes.SHA256()))
        cert_path, key_path = tmp / f"{name}.crt", tmp / f"{name}.key"
        cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
        key_path.write_bytes(key.private_bytes(serialization.Encoding.PEM,
                                               serialization.PrivateFormat.PKCS8,
                                               serialization.NoEncryption()))
        out[name] = (str(cert_path), str(key_path))
    return out


@pytest.mark.parametrize("client_auth", [False, True])
def test_tls_and_client_auth(certs, client_auth):
    cert, key = certs["server"]
    opts = tsys.Options(tls_cert_file=cert, tls_key_file=key,
                        client_ca_file=certs["client"][0] if client_auth else None)
    system = tsys.System(opts)
    addr = system.start()
    try:
        ctx = ssl.create_default_context(cafile=cert)
        if client_auth:
            with pytest.raises(Exception):
                call(addr, "GET", "/version", scheme="https", context=ctx)
            ctx.load_cert_chain(*certs["client"])
        assert call(addr, "GET", "/version", scheme="https", context=ctx) == (
            200, b'{"Version": "0.1.0"}')
        with pytest.raises(Exception):
            call(addr, "GET", "/version")
    finally:
        system.stop()
    with pytest.raises(ValueError, match="requires both"):
        tsys.System(tsys.Options(tls_cert_file=cert)).start()


@pytest.fixture
def tracing_restored():
    was = tracemalloc.is_tracing()
    yield
    if tracemalloc.is_tracing() and not was:
        tracemalloc.stop()
    elif was and not tracemalloc.is_tracing():
        tracemalloc.start()


def test_heap_profile_leaves_tracing_as_it_found_it(tracing_restored):
    """The repair: with tracing off, the port's heap profile traces for its
    window, answers the profile and stops; with tracing on, it stays on.
    The JAX one leaves tracing on after its first call."""
    if tracemalloc.is_tracing():
        tracemalloc.stop()
    text = tpprof.heap_profile(top=5, seconds=0.05)
    assert text.startswith("# heap: ") and not tracemalloc.is_tracing()
    tracemalloc.start()
    text = tpprof.heap_profile(top=5, seconds=0.05)
    assert text.startswith("# heap: ") and tracemalloc.is_tracing()
    tracemalloc.stop()
    assert jpprof.heap_profile().startswith("# tracemalloc started")
    assert tracemalloc.is_tracing()  # the JAX one's leak, which the fixture undoes
    tracemalloc.stop()


def test_heap_profile_text_equals_jax_for_one_snapshot(monkeypatch, tracing_restored):
    tracemalloc.start()
    blocks = [bytes(1000 + i) for i in range(50)]  # noqa: F841 - traced allocations
    snap = tracemalloc.take_snapshot()
    monkeypatch.setattr(tracemalloc, "take_snapshot", lambda: snap)
    port, jax = tpprof.heap_profile(top=10), jpprof.heap_profile(top=10)
    assert port == jax == tpprof.render_snapshot(snap, 10)
    assert port.startswith("# heap: ") and port.splitlines()[0].endswith(" sites")
    tracemalloc.stop()


def test_heap_endpoint_and_its_window(tracing_restored):
    if tracemalloc.is_tracing():
        tracemalloc.stop()
    system = tsys.System(tsys.Options(profile_enabled=True))
    addr = system.start()
    try:
        status, body = call(addr, "GET", "/debug/pprof/heap?seconds=0.05")
        assert status == 200 and body.startswith(b"# heap: ") and not tracemalloc.is_tracing()
        assert call(addr, "GET", "/debug/pprof/heap?seconds=x") == (400,
                                                                    b"seconds must be a number")
    finally:
        system.stop()


def test_thread_dump_and_cpu_profile_shape():
    for mod in (tpprof, jpprof):
        assert mod.thread_dump().startswith("thread ")
        assert mod.cpu_profile(0.1, hz=50).startswith("# cpu profile: ")
