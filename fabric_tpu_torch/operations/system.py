"""Operations server (reference core/operations/system.go).

Serves the node admin plane over HTTP on a local port:

* ``GET  /metrics``  — Prometheus text format  (system.go:134)
* ``GET  /healthz``  — runs registered health checkers; 200 {"status":"OK"}
                       or 503 with the failed checks (system.go:154)
* ``GET  /logspec``  — active flogging spec     (system.go:149)
* ``PUT  /logspec``  — activate a new spec from {"spec": "..."}
* ``GET  /version``  — version payload          (system.go:157-163)

The reference gates mutating endpoints behind TLS client auth; here the
server binds loopback by default and exposes the same surface. Providers:
``prometheus`` | ``statsd`` | ``disabled`` (system.go initializeMetrics).
Also ``GET /trace`` (the fabobs flight ring as Chrome trace-event JSON) and,
when profiling is enabled, ``GET /debug/pprof/{profile,goroutine,heap}``.

The port's counterpart of the JAX package's `operations/system.py`: the same
endpoints, status codes and bodies, with TLS and client auth, over the
port's `common/{flogging,metrics,fabobs}` and `operations/pprof`. The heap
profile takes `?seconds=N` (1 by default) for the window it traces when
tracing is off (`operations/pprof.heap_profile`).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from fabric_tpu_torch.common import flogging
from fabric_tpu_torch.common.metrics import (
    DisabledProvider,
    PrometheusProvider,
    Provider,
    StatsdProvider,
)

VERSION = "0.1.0"


@dataclass
class Options:
    listen_address: str = "127.0.0.1:0"
    metrics_provider: str = "prometheus"  # prometheus | statsd | disabled
    # an already-live provider to serve instead of constructing one —
    # how the serve sidecar and the node shells hand the fabobs
    # data-plane registry to /metrics (overrides metrics_provider)
    provider: Optional[Provider] = None
    statsd_sink: Optional[Callable[[str], None]] = None
    statsd_prefix: str = ""
    version: str = VERSION
    # TLS + optional mutual-TLS client auth (reference core/operations/
    # system.go TLS.Enabled / ClientCertRequired)
    tls_cert_file: Optional[str] = None
    tls_key_file: Optional[str] = None
    client_ca_file: Optional[str] = None  # set -> client certs REQUIRED
    # profiling endpoints (reference General.Profile.Enabled pprof
    # service, orderer/common/server/main.go:458; gated off by default)
    profile_enabled: bool = False


class System:
    """Owns the metrics provider, the health checker registry and the
    admin HTTP server for one node process."""

    def __init__(self, options: Optional[Options] = None):
        self.options = options or Options()
        self._checkers: Dict[str, Callable[[], None]] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

        kind = self.options.metrics_provider
        if self.options.provider is not None:
            self.provider = self.options.provider
        elif kind == "prometheus":
            self.provider: Provider = PrometheusProvider()
        elif kind == "statsd":
            self.provider = StatsdProvider(
                self.options.statsd_sink or (lambda line: None),
                prefix=self.options.statsd_prefix,
            )
        elif kind == "disabled":
            self.provider = DisabledProvider()
        else:
            raise ValueError(f"unknown metrics provider: {kind}")

    # -- health checker registry (healthz.HealthHandler analog) --
    def register_checker(self, component: str, check: Callable[[], None]) -> None:
        """check() raises to signal failure (healthz lib contract)."""
        with self._lock:
            if component in self._checkers:
                raise ValueError(f"duplicate health checker: {component}")
            self._checkers[component] = check

    def deregister_checker(self, component: str) -> None:
        with self._lock:
            self._checkers.pop(component, None)

    def run_checks(self) -> Dict[str, str]:
        """component -> failure reason for every failing checker."""
        with self._lock:
            checkers = dict(self._checkers)
        failures = {}
        for name, check in checkers.items():
            try:
                check()
            except Exception as exc:  # noqa: BLE001 - report any failure
                failures[name] = str(exc)
        return failures

    # -- HTTP server --
    @property
    def addr(self) -> str:
        assert self._server is not None, "system not started"
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> str:
        host, _, port = self.options.listen_address.rpartition(":")
        system = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    if isinstance(system.provider, PrometheusProvider):
                        self._reply(
                            200,
                            system.provider.gather().encode(),
                            "text/plain; version=0.0.4",
                        )
                    else:
                        self._reply(404, b"metrics provider is not prometheus",
                                    "text/plain")
                elif self.path == "/healthz":
                    failures = system.run_checks()
                    if failures:
                        body = json.dumps(
                            {
                                "status": "Service Unavailable",
                                "failed_checks": [
                                    {"component": c, "reason": r}
                                    for c, r in sorted(failures.items())
                                ],
                            }
                        ).encode()
                        self._reply(503, body, "application/json")
                    else:
                        self._reply(
                            200, b'{"status":"OK"}', "application/json"
                        )
                elif self.path == "/logspec":
                    body = json.dumps({"spec": flogging.spec()}).encode()
                    self._reply(200, body, "application/json")
                elif self.path == "/version":
                    body = json.dumps(
                        {"Version": system.options.version}
                    ).encode()
                    self._reply(200, body, "application/json")
                elif self.path == "/trace":
                    # fabobs flight recorder on demand: the bounded span
                    # ring as Chrome trace-event JSON (404 when the obs
                    # registry is disabled in this process)
                    from fabric_tpu_torch.common import fabobs

                    reg = fabobs.active()
                    if reg is None:
                        self._reply(
                            404, b"observability is not enabled",
                            "text/plain",
                        )
                    else:
                        self._reply(
                            200, reg.dump().encode(), "application/json"
                        )
                elif self.path.startswith("/debug/pprof"):
                    self._pprof()
                else:
                    self._reply(404, b"not found", "text/plain")

            def _pprof(self):
                """Go-pprof analog endpoints (main.go:458 Profile service):
                profile (sampled CPU), goroutine (thread dump), heap."""
                if not system.options.profile_enabled:
                    self._reply(
                        404, b"profiling is not enabled", "text/plain"
                    )
                    return
                from urllib.parse import parse_qs, urlparse

                from fabric_tpu_torch.operations import pprof

                parsed = urlparse(self.path)
                name = parsed.path[len("/debug/pprof") :].strip("/")
                if name == "profile":
                    q = parse_qs(parsed.query)
                    try:
                        seconds = float(q.get("seconds", ["2"])[0])
                    except ValueError:
                        self._reply(
                            400, b"seconds must be a number", "text/plain"
                        )
                        return
                    self._reply(
                        200, pprof.cpu_profile(seconds).encode(), "text/plain"
                    )
                elif name in ("goroutine", "threads"):
                    self._reply(200, pprof.thread_dump().encode(), "text/plain")
                elif name == "heap":
                    q = parse_qs(parsed.query)
                    try:
                        seconds = float(q.get("seconds", ["1"])[0])
                    except ValueError:
                        self._reply(
                            400, b"seconds must be a number", "text/plain"
                        )
                        return
                    self._reply(
                        200, pprof.heap_profile(seconds=seconds).encode(),
                        "text/plain",
                    )
                elif name == "":
                    self._reply(
                        200,
                        b"profiles: profile?seconds=N goroutine heap\n",
                        "text/plain",
                    )
                else:
                    self._reply(404, b"unknown profile", "text/plain")

            def do_PUT(self):
                if self.path != "/logspec":
                    self._reply(404, b"not found", "text/plain")
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    spec = payload.get("spec", "") if isinstance(
                        payload, dict
                    ) else None
                    if not isinstance(spec, str):
                        # {"spec": ["not","a","string"]} used to escape
                        # as an AttributeError out of activate_spec —
                        # a malformed body must 400 and leave the
                        # active spec untouched
                        raise ValueError("logspec body must be {\"spec\": str}")
                    flogging.activate_spec(spec)
                except (ValueError, flogging.InvalidSpecError) as exc:
                    body = json.dumps({"error": str(exc)}).encode()
                    self._reply(400, body, "application/json")
                    return
                self._reply(204, b"", "application/json")

            do_POST = do_PUT

        self._server = ThreadingHTTPServer(
            (host or "127.0.0.1", int(port or 0)), Handler
        )
        tls_bits = (
            self.options.tls_cert_file,
            self.options.tls_key_file,
        )
        if any(tls_bits) or self.options.client_ca_file:
            if not all(tls_bits):
                # never degrade to cleartext on a partial TLS config
                raise ValueError(
                    "operations TLS requires both tls_cert_file and "
                    "tls_key_file"
                )
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(
                self.options.tls_cert_file, self.options.tls_key_file
            )
            if self.options.client_ca_file:
                ctx.load_verify_locations(self.options.client_ca_file)
                ctx.verify_mode = ssl.CERT_REQUIRED
            # defer the handshake to the per-request handler thread — on
            # the listening socket it would run in the accept loop, where
            # one stalled client starves every other ops request
            self._server.socket = ctx.wrap_socket(
                self._server.socket,
                server_side=True,
                do_handshake_on_connect=False,
            )
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="operations", daemon=True
        )
        self._thread.start()
        return self.addr

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        # shutdown() blocks until serve_forever returns; the join makes
        # the reap explicit (and covers the not-yet-serving window)
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
            self._thread = None
