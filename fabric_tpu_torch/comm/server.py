"""gRPC server/client plumbing (reference usable-inter-nal/pkg/comm:
GRPCServer with mutual TLS, keepalive and max-message-size settings).

Services register by their Fabric wire names ("orderer.AtomicBroadcast",
"protos.Endorser", ...) through generic method handlers, so the wire
format matches stock Fabric SDK expectations without generated *_grpc
stubs.

The port's counterpart of the JAX package's `comm/server.py`, the same
options (MAX_MSG_SIZE of 100 MB, the keepalive) and credentials. A handler's
(de)serializers are the port's wire codec (`wire_codec`), where the JAX
package passes protobuf's; nothing here imports protobuf. A departure:
`GRPCServer.stop` waits until the server has stopped (its handlers have
returned or been cancelled) and its worker threads have ended, where the JAX
server returns at once and leaves its thread pool running.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Callable, Dict, Optional, Tuple

import grpc

from fabric_tpu_torch.protos import wire

MAX_MSG_SIZE = 100 * 1024 * 1024  # reference comm defaults: 100MB

UNARY = "unary"
STREAM_STREAM = "stream_stream"
UNARY_STREAM = "unary_stream"


def wire_codec(schema: wire.Schema) -> Tuple[Callable[[bytes], dict], Callable[[dict], bytes]]:
    """(deserializer, serializer) of one message type for a gRPC handler or
    stub: the port's wire codec over `schema`. Unknown fields are kept, so a
    message that is decoded and sent on comes out as protobuf's would."""
    return (lambda raw: wire.decode(schema, raw, keep_unknown=True),
            lambda msg: wire.encode(schema, msg))


def _options():
    return [
        ("grpc.max_send_message_length", MAX_MSG_SIZE),
        ("grpc.max_receive_message_length", MAX_MSG_SIZE),
        ("grpc.keepalive_time_ms", 300_000),
    ]


def tls_server_credentials(
    cert_pem: bytes, key_pem: bytes, client_ca_pem: Optional[bytes] = None
) -> grpc.ServerCredentials:
    """Server TLS, optionally requiring client certs (mutual TLS —
    reference comm/creds.go)."""
    return grpc.ssl_server_credentials(
        [(key_pem, cert_pem)],
        root_certificates=client_ca_pem,
        require_client_auth=client_ca_pem is not None,
    )


class CertReloader:
    """File-backed server cert source with hot reload (reference
    usable-inter-nal/pkg/comm/server.go:44 SetServerCertificate: certs
    rotate without restarting the server). gRPC asks the fetcher for a
    fresh certificate configuration on every new TLS handshake; this
    one re-reads the PEMs only when an mtime changed, so rotation is a
    file swap (the k8s secret-mount pattern)."""

    def __init__(
        self,
        cert_path: str,
        key_path: str,
        client_ca_path=None,  # str | Sequence[str] (reference dialect:
        # ClientRootCAs is a LIST; multiple PEMs concatenate)
    ):
        import os as _os

        self._os = _os
        self._cert_path = cert_path
        self._key_path = key_path
        if isinstance(client_ca_path, (str, bytes)) or client_ca_path is None:
            self._ca_paths = [client_ca_path] if client_ca_path else []
        else:
            self._ca_paths = list(client_ca_path)
        self._mtimes = None
        self._config = None
        self.reloads = 0  # introspection for tests/ops
        self._fetch(strict=True)  # misconfigured paths fail at startup

    @property
    def requires_client_auth(self) -> bool:
        return bool(self._ca_paths)

    def _stat(self):
        paths = [self._cert_path, self._key_path, *self._ca_paths]
        return tuple(self._os.stat(p).st_mtime_ns for p in paths)

    def _fetch(self, strict: bool = False):
        try:
            mtimes = self._stat()
            if self._config is None or mtimes != self._mtimes:
                with open(self._key_path, "rb") as f:
                    key = f.read()
                with open(self._cert_path, "rb") as f:
                    cert = f.read()
                ca = None
                if self._ca_paths:
                    parts = []
                    for p in self._ca_paths:
                        with open(p, "rb") as f:
                            parts.append(f.read())
                    ca = b"".join(parts)
                self._config = grpc.ssl_server_certificate_configuration(
                    [(key, cert)], root_certificates=ca
                )
                self._mtimes = mtimes
                self.reloads += 1
        except OSError:
            if strict:
                raise  # startup: surface the misconfiguration now
            # rotation in progress (file momentarily absent): keep
            # serving the last good configuration
        return self._config

    def credentials(self) -> grpc.ServerCredentials:
        return grpc.dynamic_ssl_server_credentials(
            self._config,
            self._fetch,
            require_client_authentication=self.requires_client_auth,
        )


def tls_credentials_from_config(tls_cfg) -> Optional[grpc.ServerCredentials]:
    """One TLS-config dialect for BOTH node CLIs (accepts the peer's
    cert/key/clientRootCAs and the orderer's Certificate/PrivateKey/
    ClientRootCAs spellings). Enabled-but-incomplete is a HARD error —
    the reference refuses to start rather than silently serving
    plaintext when the operator asked for TLS."""
    if not tls_cfg:
        return None
    enabled = tls_cfg.get("enabled", tls_cfg.get("Enabled"))
    cert = tls_cfg.get("cert") or tls_cfg.get("Certificate")
    key = tls_cfg.get("key") or tls_cfg.get("PrivateKey")
    if enabled is False:
        return None
    if enabled is None and not (cert or key):
        return None
    if not cert or not key:
        raise ValueError(
            "TLS is enabled but cert/key paths are incomplete "
            f"(cert={cert!r}, key={key!r})"
        )
    cas = tls_cfg.get("clientRootCAs") or tls_cfg.get("ClientRootCAs")
    return CertReloader(cert, key, cas).credentials()


class ConcurrencyLimiter(grpc.ServerInterceptor):
    """Per-service concurrent-RPC limits (reference
    usable-inter-nal/peer/node/grpc_limiters.go: the endorser and
    deliver services get independent caps so one flooded service cannot
    starve the node). Over-limit RPCs are refused with
    RESOURCE_EXHAUSTED rather than queued — backpressure the client can
    see, like the reference's limiter returning ErrLimitExceeded."""

    def __init__(self, limits: Dict[str, int]):
        import threading

        self._sems = {
            svc: threading.BoundedSemaphore(n) for svc, n in limits.items()
        }

    def intercept_service(self, continuation, handler_call_details):
        # method: "/service.Name/Method"
        parts = handler_call_details.method.split("/")
        svc = parts[1] if len(parts) > 1 else ""
        sem = self._sems.get(svc)
        handler = continuation(handler_call_details)
        if sem is None or handler is None:
            return handler
        return _limited_handler(handler, sem, svc)


def _limited_handler(handler, sem, svc: str):
    def wrap_unary(behavior):
        def limited(request, context):
            if not sem.acquire(blocking=False):
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"concurrency limit reached for {svc}",
                )
            try:
                return behavior(request, context)
            finally:
                sem.release()

        return limited

    def wrap_stream(behavior):
        def limited(request_or_iterator, context):
            if not sem.acquire(blocking=False):
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"concurrency limit reached for {svc}",
                )
            try:
                yield from behavior(request_or_iterator, context)
            finally:
                sem.release()

        return limited

    if handler.unary_unary:
        return grpc.unary_unary_rpc_method_handler(
            wrap_unary(handler.unary_unary),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
    if handler.unary_stream:
        return grpc.unary_stream_rpc_method_handler(
            wrap_stream(handler.unary_stream),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
    if handler.stream_unary:
        return grpc.stream_unary_rpc_method_handler(
            wrap_unary(handler.stream_unary),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
    return grpc.stream_stream_rpc_method_handler(
        wrap_stream(handler.stream_stream),
        request_deserializer=handler.request_deserializer,
        response_serializer=handler.response_serializer,
    )


class GRPCServer:
    def __init__(
        self,
        address: str = "127.0.0.1:0",
        credentials: Optional[grpc.ServerCredentials] = None,
        max_workers: int = 32,
        interceptors=(),  # comm.interceptors logging/metrics
    ):
        self._pool = futures.ThreadPoolExecutor(max_workers=max_workers)
        self._server = grpc.server(
            self._pool,
            options=_options(),
            interceptors=tuple(interceptors),
        )
        if credentials is not None:
            self._port = self._server.add_secure_port(address, credentials)
        else:
            self._port = self._server.add_insecure_port(address)
        host = address.rsplit(":", 1)[0]
        self.addr = f"{host}:{self._port}"

    def register(
        self,
        service_name: str,
        methods: Dict[str, Tuple[str, Callable, Callable, Callable]],
    ) -> None:
        """methods: name -> (kind, handler, request_deserializer,
        response_serializer). Handler signatures follow grpc generic
        handlers: unary (request, context) -> response; stream_stream
        (request_iterator, context) -> response iterator."""
        handlers = {}
        for name, (kind, fn, req_des, resp_ser) in methods.items():
            if kind == UNARY:
                handlers[name] = grpc.unary_unary_rpc_method_handler(
                    fn, request_deserializer=req_des, response_serializer=resp_ser
                )
            elif kind == UNARY_STREAM:
                handlers[name] = grpc.unary_stream_rpc_method_handler(
                    fn, request_deserializer=req_des, response_serializer=resp_ser
                )
            elif kind == STREAM_STREAM:
                handlers[name] = grpc.stream_stream_rpc_method_handler(
                    fn, request_deserializer=req_des, response_serializer=resp_ser
                )
            else:
                raise ValueError(f"unknown method kind {kind}")
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(service_name, handlers),)
        )

    def start(self) -> str:
        self._server.start()
        return self.addr

    def stop(self, grace: float = 0.5) -> None:
        """Stop serving and return once no thread of the server is left:
        grpc's stop starts a thread that cancels the calls left after
        `grace` and is still running when its event is set, so that thread
        is joined too."""
        before = set(threading.enumerate())
        done = self._server.stop(grace)
        cancels = [t for t in threading.enumerate() if t not in before
                   and t.name.endswith("(cancel_all_calls_after_grace)")]
        done.wait()
        for t in cancels:
            t.join()
        self._pool.shutdown(wait=True)


def channel_to(
    addr: str,
    root_ca_pem: Optional[bytes] = None,
    client_cert: Optional[Tuple[bytes, bytes]] = None,
) -> grpc.Channel:
    """Client channel (reference comm/client.go); TLS when a root CA is
    given, mutual TLS when a client (key, cert) pair is too."""
    if root_ca_pem is None:
        return grpc.insecure_channel(addr, options=_options())
    if client_cert is not None:
        key, cert = client_cert
        creds = grpc.ssl_channel_credentials(root_ca_pem, key, cert)
    else:
        creds = grpc.ssl_channel_credentials(root_ca_pem)
    return grpc.secure_channel(addr, creds, options=_options())
