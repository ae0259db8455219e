"""gRPC server interceptors (reference common/grpclogging zap
interceptors + common/grpcmetrics): per-RPC logs with durations and
status, and RPC counters/duration histograms over the metrics SPI.
Unary and streaming RPCs get separate metric families, mirroring
grpcmetrics' unary_*/stream_* split; outcomes are recorded in `finally`
so client-cancelled streams (GeneratorExit) still count.

The port's counterpart of the JAX package's `comm/interceptors.py`, over the
port's `comm/server.GRPCServer` and `common/metrics` providers: the same
log lines, metric families, labels and codes. A departure: a payload log
line is written where the message crosses the wire codec (its deserializer
for a request, its serializer for a response) and gives the wire bytes'
length, with no message type, since the port's messages are dicts; the JAX
line names the protobuf class and measures `SerializeToString()`."""

from __future__ import annotations

import time

import grpc

from fabric_tpu_torch.common import flogging
from fabric_tpu_torch.common.metrics import CounterOpts, HistogramOpts, Provider


def _split_method(full_method: str):
    # "/orderer.AtomicBroadcast/Broadcast" -> ("orderer.AtomicBroadcast",
    # "Broadcast")
    parts = full_method.lstrip("/").split("/", 1)
    if len(parts) == 2:
        return parts[0], parts[1]
    return full_method, ""


def _wrap_handler(handler, around, codec=None):
    """Wrap whichever of the four handler kinds this is with `around`,
    which receives (behavior, kind) and returns a new behavior; `codec`,
    when given, takes (request_deserializer, response_serializer) and
    returns the pair the wrapped handler uses."""
    if handler is None:
        return None
    des, ser = handler.request_deserializer, handler.response_serializer
    if codec is not None:
        des, ser = codec(des, ser)
    for kind, make in (
        ("unary_unary", grpc.unary_unary_rpc_method_handler),
        ("unary_stream", grpc.unary_stream_rpc_method_handler),
        ("stream_unary", grpc.stream_unary_rpc_method_handler),
        ("stream_stream", grpc.stream_stream_rpc_method_handler),
    ):
        behavior = getattr(handler, kind)
        if behavior:
            return make(around(behavior, kind), request_deserializer=des,
                        response_serializer=ser)
    return None


class LoggingInterceptor(grpc.ServerInterceptor):
    """grpclogging analog: one log line per completed RPC with service,
    method, duration and outcome.

    Payload logging (grpclogging/server.go payloadLogger): when the
    `comm.grpc.payload` logger is at DEBUG — via the /logspec flogging
    spec, like the reference's `grpc.payload=debug` — every request and
    response message is logged with its size on the wire."""

    PAYLOAD_LOGGER = "comm.grpc.payload"

    def __init__(self, logger=None, payload_logger=None):
        self.logger = logger or flogging.must_get_logger("comm.grpc")
        self.payload_logger = payload_logger or flogging.must_get_logger(
            self.PAYLOAD_LOGGER
        )

    def _log_payload(self, service, method, direction, size: int) -> None:
        self.payload_logger.debug(
            "payload %s grpc.service=%s grpc.method=%s bytes=%d",
            direction,
            service,
            method,
            size,
        )

    def _codec(self, service, method):
        """The handler's codec with a payload log line for each message
        that crosses it while the payload logger is at DEBUG."""
        plog, log_payload = self.payload_logger, self._log_payload

        def wrap(des, ser):
            def deserialize(raw):
                if plog.isEnabledFor(10):  # logging.DEBUG
                    log_payload(service, method, "recv", len(raw))
                return des(raw) if des is not None else raw

            def serialize(msg):
                raw = ser(msg) if ser is not None else msg
                if plog.isEnabledFor(10):
                    log_payload(service, method, "send", len(raw))
                return raw

            return deserialize, serialize

        return wrap

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        service, method = _split_method(handler_call_details.method)
        logger = self.logger

        def around(behavior, kind):
            streaming_resp = kind.endswith("_stream")
            shape = "streaming" if "stream" in kind else "unary"

            def log(start, outcome):
                logger.debug(
                    "%s call %s grpc.service=%s grpc.method=%s "
                    "grpc.call_duration=%.3fms",
                    shape,
                    outcome,
                    service,
                    method,
                    (time.perf_counter() - start) * 1000,
                )

            def unary(request_or_iterator, context):
                start = time.perf_counter()
                outcome = "failed"
                try:
                    out = behavior(request_or_iterator, context)
                    outcome = "completed"
                    return out
                finally:
                    log(start, outcome)

            def streaming(request_or_iterator, context):
                start = time.perf_counter()
                outcome = "failed"
                try:
                    yield from behavior(request_or_iterator, context)
                    outcome = "completed"
                except GeneratorExit:
                    outcome = "cancelled"
                    raise
                finally:
                    log(start, outcome)

            return streaming if streaming_resp else unary

        return _wrap_handler(handler, around, self._codec(service, method))


class MetricsInterceptor(grpc.ServerInterceptor):
    """grpcmetrics analog: requests_received/requests_completed counters
    and request_duration histograms, labeled (service, method[, code]),
    with separate unary_* and stream_* families."""

    def __init__(self, provider: Provider):
        def families(prefix):
            return (
                provider.new_counter(
                    CounterOpts(
                        namespace="grpc",
                        subsystem="server",
                        name=f"{prefix}_requests_received",
                        help=f"The number of {prefix} requests received.",
                        label_names=("service", "method"),
                    )
                ),
                provider.new_counter(
                    CounterOpts(
                        namespace="grpc",
                        subsystem="server",
                        name=f"{prefix}_requests_completed",
                        help=f"The number of {prefix} requests completed.",
                        label_names=("service", "method", "code"),
                    )
                ),
                provider.new_histogram(
                    HistogramOpts(
                        namespace="grpc",
                        subsystem="server",
                        name=f"{prefix}_request_duration",
                        help=f"The time to complete a {prefix} request.",
                        label_names=("service", "method"),
                    )
                ),
            )

        self._unary = families("unary")
        self._stream = families("stream")

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        service, method = _split_method(handler_call_details.method)

        def around(behavior, kind):
            streaming_resp = kind.endswith("_stream")
            received, completed, duration = (
                self._stream if "stream" in kind else self._unary
            )

            def observe(start, code):
                duration.with_labels(
                    "service", service, "method", method
                ).observe(time.perf_counter() - start)
                completed.with_labels(
                    "service", service, "method", method, "code", code
                ).add(1)

            def unary(request_or_iterator, context):
                received.with_labels(
                    "service", service, "method", method
                ).add(1)
                start = time.perf_counter()
                code = "Unknown"
                try:
                    out = behavior(request_or_iterator, context)
                    code = "OK"
                    return out
                finally:
                    observe(start, code)

            def streaming(request_or_iterator, context):
                received.with_labels(
                    "service", service, "method", method
                ).add(1)
                start = time.perf_counter()
                code = "Unknown"
                try:
                    yield from behavior(request_or_iterator, context)
                    code = "OK"
                except GeneratorExit:
                    code = "Canceled"
                    raise
                finally:
                    observe(start, code)

            return streaming if streaming_resp else unary

        return _wrap_handler(handler, around)
