"""comm/interceptors against the JAX package: a port GRPCServer and a JAX
GRPCServer, each under its package's LoggingInterceptor and
MetricsInterceptor, take the same unary and streaming calls (answered,
failing, and a stream the client cancels); their metric text (durations
aside) and their log records (durations aside) are equal. The payload
logger at DEBUG logs each message with its wire bytes' length in the port
(the JAX line names the protobuf class: the port's messages are dicts)."""

import logging
import re
import threading

import grpc
import pytest

from fabric_tpu.comm import interceptors as jint
from fabric_tpu.comm import server as jserver
from fabric_tpu.common import metrics as jm
from fabric_tpu_torch.comm import interceptors as tint
from fabric_tpu_torch.comm import server as tserver
from fabric_tpu_torch.common import metrics as tm

PKGS = {"jax": (jint, jserver, jm), "port": (tint, tserver, tm)}


class Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def make(pkg, gate):
    interceptors, server_mod, metrics = PKGS[pkg]
    provider = metrics.PrometheusProvider()
    log = logging.getLogger(f"test.interceptors.{pkg}")
    plog = logging.getLogger(f"test.interceptors.{pkg}.payload")
    for lg in (log, plog):
        lg.setLevel(logging.DEBUG)
        lg.propagate = False
    records, payloads = Records(), Records()
    log.addHandler(records)
    plog.addHandler(payloads)
    server = server_mod.GRPCServer("127.0.0.1:0", interceptors=[
        interceptors.LoggingInterceptor(logger=log, payload_logger=plog),
        interceptors.MetricsInterceptor(provider)])

    def echo(request, context):
        if request == b"boom":
            raise ValueError("boom")
        return request

    def echo_stream(request_iterator, context):
        for req in request_iterator:
            if req == b"wait":
                # answer only once the client's cancel reached the server
                gate.set()
                for _ in range(1000):
                    if not context.is_active():
                        break
                    threading.Event().wait(0.01)
            yield req

    server.register("test.Echo", {
        "Call": (server_mod.UNARY, echo, lambda b: b, lambda b: b),
        "Stream": (server_mod.STREAM_STREAM, echo_stream, lambda b: b, lambda b: b),
    })
    server.start()
    return server, provider, records, payloads


def drive(addr, gate):
    ch = grpc.insecure_channel(addr)
    try:
        call = ch.unary_unary("/test.Echo/Call")
        assert call(b"hello") == b"hello" and call(b"hi") == b"hi"
        with pytest.raises(grpc.RpcError):
            call(b"boom")
        stream = ch.stream_stream("/test.Echo/Stream")
        assert list(stream(iter([b"a", b"bb"]))) == [b"a", b"bb"]
        cancelled = stream(iter([b"x", b"wait"]))
        assert next(cancelled) == b"x"
        assert gate.wait(10)
        cancelled.cancel()
    finally:
        ch.close()


@pytest.fixture(scope="module")
def outcomes():
    out = {}
    for pkg in PKGS:
        gate = threading.Event()
        server, provider, records, payloads = make(pkg, gate)
        try:
            drive(server.addr, gate)
            # the cancelled stream's handler ends before the server stops
            for _ in range(1000):
                if sum("Stream" in ln for ln in records.lines) == 2:
                    break
                threading.Event().wait(0.01)
        finally:
            server.stop(grace=1.0)
        out[pkg] = (provider.gather(), records.lines, payloads.lines)
    return out


def without_durations(text):
    return "\n".join(ln for ln in text.splitlines() if "_request_duration" not in ln)


def test_metrics_equal_jax(outcomes):
    port, jax = outcomes["port"][0], outcomes["jax"][0]
    assert without_durations(port) == without_durations(jax)
    for line in ('grpc_server_unary_requests_received{service="test.Echo",method="Call"} 3',
                 'grpc_server_unary_requests_completed{service="test.Echo",method="Call",'
                 'code="OK"} 2',
                 'grpc_server_unary_requests_completed{service="test.Echo",method="Call",'
                 'code="Unknown"} 1',
                 'grpc_server_stream_requests_received{service="test.Echo",method="Stream"} 2',
                 'grpc_server_stream_requests_completed{service="test.Echo",method="Stream",'
                 'code="OK"} 1',
                 'grpc_server_stream_requests_completed{service="test.Echo",method="Stream",'
                 'code="Canceled"} 1'):
        assert line in port.splitlines()
    # the duration histograms count the same calls
    counts = [ln for ln in port.splitlines() if "_request_duration_count" in ln]
    assert counts == [ln for ln in jax.splitlines() if "_request_duration_count" in ln]


def test_log_records_equal_jax(outcomes):
    def shape(lines):
        return sorted(re.sub(r"call_duration=[0-9.]+ms", "call_duration=Xms", ln)
                      for ln in lines)

    port, jax = shape(outcomes["port"][1]), shape(outcomes["jax"][1])
    assert port == jax
    assert port == sorted([
        "unary call completed grpc.service=test.Echo grpc.method=Call "
        "grpc.call_duration=Xms"] * 2 + [
        "unary call failed grpc.service=test.Echo grpc.method=Call grpc.call_duration=Xms",
        "streaming call completed grpc.service=test.Echo grpc.method=Stream "
        "grpc.call_duration=Xms",
        "streaming call cancelled grpc.service=test.Echo grpc.method=Stream "
        "grpc.call_duration=Xms"])


def test_payload_lines_carry_the_wire_length(outcomes):
    port, jax = outcomes["port"][2], outcomes["jax"][2]
    assert len(port) == len(jax)
    assert sorted(port) == sorted(
        ["payload recv grpc.service=test.Echo grpc.method=Call bytes=5",
         "payload send grpc.service=test.Echo grpc.method=Call bytes=5",
         "payload recv grpc.service=test.Echo grpc.method=Call bytes=2",
         "payload send grpc.service=test.Echo grpc.method=Call bytes=2",
         "payload recv grpc.service=test.Echo grpc.method=Call bytes=4",
         "payload recv grpc.service=test.Echo grpc.method=Stream bytes=1",
         "payload send grpc.service=test.Echo grpc.method=Stream bytes=1",
         "payload recv grpc.service=test.Echo grpc.method=Stream bytes=2",
         "payload send grpc.service=test.Echo grpc.method=Stream bytes=2",
         "payload recv grpc.service=test.Echo grpc.method=Stream bytes=1",
         "payload send grpc.service=test.Echo grpc.method=Stream bytes=1",
         "payload recv grpc.service=test.Echo grpc.method=Stream bytes=4",
         "payload send grpc.service=test.Echo grpc.method=Stream bytes=4"])
