"""The port's request tracing (``seist_tpu_torch/obs/trace.py``) against
the JAX package's (``seist_tpu/obs/trace.py``), and the traced ``/predict``
of the port's server on the CPU.

The same headers, durations and request sequences go through both
packages: ``traceparent`` parsing, ``Server-Timing``, the tail-retention
decisions and the ``/traces`` payloads must agree. The units of
``tests/test_trace.py`` that concern these modules run against the port,
with the JAX package's overhead bound (``TestOverhead``).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seist_tpu.obs import trace as J

import seist_tpu_torch
from seist_tpu_torch.obs import trace as T
from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.serve import server as tserver
from seist_tpu_torch.serve.batcher import BatcherConfig, MicroBatcher
from seist_tpu_torch.serve.protocol import ServeError

SEGMENTS = ("parse", "normalize", "queue_wait", "forward", "decode")


@pytest.fixture(autouse=True)
def _fresh_buffer():
    T.BUFFER.reset()
    yield
    T.BUFFER.reset()


def _tid(i: int) -> str:
    """A fixed trace id whose first 8 hex digits spread over [0, 1)."""
    return f"{(i * 2654435761) % 2**32:08x}" + f"{i + 1:024x}"


def _header(i: int) -> str:
    return f"00-{_tid(i)}-{i + 1:016x}-01"


class FakeClock:
    def __init__(self):
        self.t = 50.0

    def __call__(self) -> float:
        self.t += 0.0015
        return self.t


# ------------------------------------------------------------ traceparent
HEADERS = [
    None, "", "garbage", "00-zz-yy-01", 42, b"00-" + b"1" * 32,
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "  00-" + "AB" * 16 + "-" + "CD" * 8 + "-01 ",
    "ff-" + "12" * 16 + "-" + "34" * 8 + "-00",
    "00-" + "12" * 16 + "-" + "34" * 8,
    "00-" + "12" * 15 + "-" + "34" * 8 + "-01",
    "00-" + "12" * 16 + "-" + "34" * 9 + "-01",
    "00-" + "g2" * 16 + "-" + "34" * 8 + "-01",
    "00_" + "12" * 16 + "_" + "34" * 8 + "_01",
    _header(3),
]


def test_traceparent_parsing_matches_jax():
    for h in HEADERS:
        assert T.parse_traceparent(h) == J.parse_traceparent(h), h
    assert T.parse_traceparent(HEADERS[9]) == ("ab" * 16, "cd" * 8)
    header = T.mint_traceparent()
    tid, sid = T.parse_traceparent(header)
    assert T.format_traceparent(tid, sid) == header == J.format_traceparent(tid, sid)
    assert len({T.mint_traceparent() for _ in range(64)}) == 64


def test_replica_suffix_and_label_follow_the_env(monkeypatch):
    monkeypatch.delenv("SEIST_SERVE_REPLICA", raising=False)
    assert T.replica_suffix() == J.replica_suffix() == ""
    assert T.process_label() == J.process_label()
    monkeypatch.setenv("SEIST_SERVE_REPLICA", "3")
    assert T.replica_suffix() == J.replica_suffix() == "_r3"
    assert T.process_label() == J.process_label() == "replica-3"


# ------------------------------------------------------------ RequestTrace
def _timing(mod, monkeypatch, status=200):
    monkeypatch.setattr(mod, "monotonic", FakeClock())
    buf = mod.TraceBuffer(capacity=8, sample=1.0)
    rt = mod.RequestTrace(_header(1), name="server:/predict", buffer=buf, slo_ms=0.0)
    for name, dur in (("parse", 1.25), ("normalize", 0.75), ("queue_wait", 12.0),
                      ("forward", 5.14), ("decode", 0.5), ("queue wait/odd", 3.25)):
        rt.add_child(name, dur, flush=1)
    with rt.span("inner") as sp:
        sp.annotate(bytes=100)
    rt.finish(status)
    return rt.server_timing(), buf.get(rt.trace_id)


def test_server_timing_and_spans_match_jax(monkeypatch):
    jst, jpayload = _timing(J, monkeypatch)
    tst, tpayload = _timing(T, monkeypatch)
    assert tst == jst
    assert tst.startswith("total;dur=") and "queue_wait_odd;dur=3.2" in tst

    def shape(p):
        return [(s["name"], s["dur_ms"] if s["name"] != "inner" else None,
                 s.get("annotations"), s.get("root", False), s["parent_id"] is None)
                for s in p["spans"]]

    assert shape(tpayload) == shape(jpayload)
    assert {k for k in tpayload} == {k for k in jpayload}
    root = [s for s in tpayload["spans"] if s.get("root")][0]
    assert root["parent_id"] == "0" * 15 + "2"  # the upstream span id
    assert tpayload["flags"] == [] and _timing(T, monkeypatch, 500)[1]["flags"] == ["error"]


def _retention(mod, sample, capacity):
    """One sequence of requests: flagged (error, shed, slo breach, hedged),
    plain, and open ones; returns the buffer's index (times dropped), its
    stats and each trace's fate."""
    buf = mod.TraceBuffer(capacity=capacity, sample=sample)
    fates = {}
    for i in range(40):
        slo = 0.0001 if i % 11 == 0 else 0.0
        rt = mod.RequestTrace(_header(i), buffer=buf, slo_ms=slo)
        rt.add_child("queue_wait", 1.0)
        if i % 7 == 0:
            rt.flag("shed")
            status = 503
        elif i % 5 == 0:
            status = 500
        elif i % 13 == 0:
            rt.flag("hedged")
            status = 200
        else:
            status = 200
        if i % 17 == 16:
            continue  # never finished: an open trace
        if slo:
            time.sleep(0.0005)
        rt.finish(status)
    for i in range(40):
        fates[i] = (buf.get(_tid(i)) or {}).get("flags")
    index = [{k: v for k, v in e.items() if k not in ("t0", "dur_ms")} for e in buf.index()]
    return index, buf.stats(), fates


@pytest.mark.parametrize("sample,capacity", [(1.0, 256), (0.0, 256), (0.5, 256), (0.5, 12),
                                             (1.0, 6)])
def test_retention_decisions_match_jax(sample, capacity):
    assert _retention(T, sample, capacity) == _retention(J, sample, capacity)


def test_sampling_is_deterministic_by_trace_id():
    ids = [_tid(i) for i in range(256)]
    t, j = T.TraceBuffer(capacity=512, sample=0.5), J.TraceBuffer(capacity=512, sample=0.5)
    assert [t.sampled(x) for x in ids] == [j.sampled(x) for x in ids]
    assert 32 < sum(t.sampled(x) for x in ids) < 224


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("SEIST_TRACE_CAPACITY", "7")
    monkeypatch.setenv("SEIST_TRACE_SAMPLE", "0.25")
    monkeypatch.setenv("SEIST_TRACE_SLO_MS", "0.0001")
    buf = T.TraceBuffer()
    assert (buf.capacity, buf.sample) == (7, 0.25)
    rt = T.RequestTrace(None, buffer=buf)
    time.sleep(0.001)
    rt.finish(200)
    assert buf.flags(rt.trace_id) == frozenset({"slo_breach"})


def test_traces_payloads_match_jax():
    payloads = {}
    for name, mod in (("jax", J), ("torch", T)):
        buf = mod.TraceBuffer(capacity=8)
        rt = mod.RequestTrace(_header(5), buffer=buf)
        rt.flag("hedged")
        rt.add_child("forward", 2.0, program="m/full/b4/fp32", aot=True)
        rt.finish(200)
        payloads[name] = (mod.index_payload(buf), mod.trace_payload(_tid(5), buf),
                          mod.trace_payload("not-a-trace", buf),
                          mod.handle_traces_path("/traces?x=1", buf)[0],
                          mod.handle_traces_path(f"/traces/{_tid(5)}", buf)[0],
                          mod.handle_traces_path("/traces/nope", buf),
                          mod.handle_traces_path("/metrics", buf))
    (ji, jp, jn, *jr), (ti, tp, tn, *tr) = payloads["jax"], payloads["torch"]
    assert set(ti) == set(ji) and set(ti["stats"]) == set(ji["stats"])
    assert [set(e) for e in ti["traces"]] == [set(e) for e in ji["traces"]]
    assert ti["traces"][0]["flags"] == ["hedged"] and ti["capacity"] == 8
    assert set(tp) == set(jp) and [set(s) for s in tp["spans"]] == [set(s) for s in jp["spans"]]
    assert tn is None and jn is None
    assert tr[:2] == jr[:2] == [200, 200] and tr[2][0] == jr[2][0] == 404
    assert tr[3] is None and jr[3] is None


def test_finish_idempotent_straggler_dropped_and_null_trace():
    buf = T.TraceBuffer(capacity=8)
    rt = T.RequestTrace(None, buffer=buf)
    d1 = rt.finish(200)
    assert rt.finish(200) == d1
    rt.add_child("queue_wait", 5.0)  # after the verdict: dropped
    assert len(buf.get(rt.trace_id)["spans"]) == 1
    n = T.NULL
    with n.span("x") as sp:
        sp.annotate(a=1)
    n.add_child("y", 1.0)
    assert n.finish(200) == 0.0 and n.server_timing() == ""
    assert T.ensure(None) is T.NULL and T.ensure(rt) is rt


def test_flush_scope_annotations_and_nesting():
    buf = T.TraceBuffer(capacity=8)
    rts = [T.RequestTrace(None, buffer=buf) for _ in range(3)]
    with T.flush_scope(rts + [None]) as scope:
        assert T.in_flush()
        T.annotate_flush(program="m/full/b4/fp32", aot=True)
        with T.flush_scope([]):
            T.annotate_flush(inner=1)
    assert not T.in_flush()
    assert scope.annotations == {"program": "m/full/b4/fp32", "aot": True}
    T.annotate_flush(program="zzz")  # outside a flush: a no-op


def test_trace_collector_registration():
    from seist_tpu_torch.obs.bus import MetricsBus

    bus = MetricsBus()
    T.register_trace_collector(bus)
    rt = T.RequestTrace(None)
    rt.finish(200)
    assert bus.snapshot()["collectors"]["trace_kept"] >= 1.0


# ------------------------------------------------------- the batcher's spans
def test_batcher_queue_wait_and_forward_spans():
    buf = T.TraceBuffer(capacity=16)

    def forward(batch):
        T.annotate_flush(program="fake/full/b4/fp32", aot=True)
        return batch

    b = MicroBatcher(forward, BatcherConfig(max_batch=4, max_delay_ms=5.0), name="tr")
    rt = T.RequestTrace(None, buffer=buf)
    b.submit(np.zeros((2, 3), np.float32), timeout_ms=5000, trace=rt)
    rt.finish(200)
    assert BUS.snapshot()["collectors"]["serve_batcher_forwards{model=tr}"] == 1.0
    b.shutdown()
    assert not any(k.endswith("{model=tr}") for k in BUS.snapshot()["collectors"])
    spans = {s["name"]: s for s in buf.get(rt.trace_id)["spans"]}
    assert spans["queue_wait"]["annotations"] == {"flush": 1, "bucket": 1, "batch_n": 1}
    fwd = spans["forward"]["annotations"]
    assert fwd == {"flush": 1, "bucket": 1, "occupancy": 1.0,
                   "program": "fake/full/b4/fp32", "aot": True}


def test_batcher_forward_error_and_expiry_on_the_trace():
    buf = T.TraceBuffer(capacity=16)

    def boom(batch):
        raise RuntimeError("device boom")

    b = MicroBatcher(boom, BatcherConfig(max_batch=2, max_delay_ms=5.0), name="tr2")
    rt = T.RequestTrace(None, buffer=buf)
    with pytest.raises(ServeError):
        b.submit(np.zeros((2,), np.float32), timeout_ms=3000, trace=rt)
    rt.finish(500)
    b.shutdown()
    spans = {s["name"]: s for s in buf.get(rt.trace_id)["spans"]}
    assert spans["forward"]["annotations"]["error"] == "RuntimeError"
    assert "error" in buf.get(rt.trace_id)["flags"]



def test_an_item_expired_in_the_queue_gets_a_flagged_queue_wait():
    from seist_tpu_torch.serve.batcher import _Pending
    from seist_tpu_torch.serve.protocol import DeadlineExceeded

    buf = T.TraceBuffer(capacity=4)
    b = MicroBatcher(lambda batch: batch, BatcherConfig(max_batch=2, max_delay_ms=5.0),
                     name="tr3")
    rt = T.RequestTrace(None, buffer=buf)
    item = _Pending(np.zeros(1, np.float32), deadline=time.monotonic() - 1.0, trace=rt)
    b._run_batch([item])
    b.shutdown()
    assert isinstance(item.error, DeadlineExceeded) and item.event.is_set()
    (span,) = buf.get(rt.trace_id)["spans"]
    assert span["name"] == "queue_wait" and span["annotations"] == {"expired": True}


# ------------------------------------------------------------- overhead
def test_full_request_trace_far_under_serve_budget():
    """``tests/test_trace.py::TestOverhead`` against the port: a traced
    request (mint, root and five children, commit) under 150 us of host
    time, min of 3 passes."""
    buf = T.TraceBuffer(capacity=256, sample=1.0)
    n = 400

    def one_pass():
        t0 = time.perf_counter()
        for _ in range(n):
            rt = T.RequestTrace(T.mint_traceparent(), name="server:/predict", buffer=buf)
            with rt.span("parse"):
                pass
            with rt.span("normalize"):
                pass
            rt.add_child("queue_wait", 1.0, flush=1, bucket=4)
            rt.add_child("forward", 2.0, program="m/full/b4/fp32", aot=True)
            with rt.span("decode"):
                pass
            rt.finish(200)
        return (time.perf_counter() - t0) / n * 1e6

    per_request_us = min(one_pass() for _ in range(3))
    assert per_request_us < 150.0, f"tracing costs {per_request_us:.1f} us/request"


# --------------------------------------------------- /predict on the CPU
WINDOW = 512


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``serve --model seist_s_dpk --model-group seist_s=dpk,emg --device
    cpu`` at window 512, over HTTP, with the serve entry's telemetry."""
    from seist_tpu_torch.obs import flight
    from seist_tpu_torch.utils import logger as tlogger

    seist_tpu_torch.load_all()
    saved = tlogger._LOGDIR
    tlogger.set_logdir(str(tmp_path_factory.mktemp("serve_logs")))
    events = tserver.start_telemetry()
    args = tserver.get_serve_args(["--model", "seist_s_dpk", "--model-group", "seist_s=dpk,emg",
                                   "--window", str(WINDOW), "--device", "cpu", "--max-batch",
                                   "2", "--max-delay-ms", "50",
                                   # the CPU's slow flushes are no overload to shed on
                                   "--shed-batch-delay-ms", "inf",
                                   "--shed-interactive-delay-ms", "inf"])
    service = tserver.service_from_args(args)
    server = tserver.start_http_server(service, "127.0.0.1", 0)
    yield service, "http://127.0.0.1:%d" % server.server_address[1]
    server.shutdown()
    service.shutdown()
    events.close()
    flight.install(None)
    tlogger._LOGDIR = saved


def _post(url, body, headers=None):
    req = urllib.request.Request(url + "/predict", data=json.dumps(body).encode(),
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _segments(server_timing: str):
    out = {}
    for part in server_timing.split(", "):
        name, dur = part.split(";dur=")
        out[name] = float(dur)
    return out


def _data(seed: int):
    return np.random.default_rng(seed).standard_normal((WINDOW, 3)).astype(np.float32).tolist()


def test_predict_carries_server_timing_and_traceparent(served):
    _, url = served
    header = "00-" + "5e" * 16 + "-" + "17" * 8 + "-01"
    status, body, headers = _post(url, {"model": "seist_s_dpk", "data": _data(1)},
                                  {"traceparent": header})
    assert status == 200 and body["task"] == "picking"
    seg = _segments(headers["Server-Timing"])
    assert list(seg)[0] == "total" and set(SEGMENTS) <= set(seg)
    assert sum(seg[s] for s in SEGMENTS) <= seg["total"] + 0.1 * len(SEGMENTS)  # 0.1 ms rounding
    echo = T.parse_traceparent(headers["traceparent"])
    assert echo[0] == "5e" * 16 and echo[1] != "17" * 8
    trace = json.loads(_get(f"{url}/traces/{'5e' * 16}"))
    spans = {s["name"]: s for s in trace["spans"]}
    assert set(SEGMENTS) | {"server:/predict"} <= set(spans)
    assert spans["server:/predict"]["parent_id"] == "17" * 8
    fwd = spans["forward"]["annotations"]
    assert fwd["program"].startswith("seist_s_dpk/full/b") and fwd["aot"] is True
    assert fwd["variant"] == "fp32"
    index = json.loads(_get(url + "/traces"))
    assert "5e" * 16 in {t["trace_id"] for t in index["traces"]}


def test_group_flushes_run_the_trunk_once_on_the_bus(served):
    service, url = served
    snap0 = json.loads(_get(url + "/metrics.json"))
    forwards0 = service.metrics()["models"]["seist_s"]["forwards"]
    results = [None] * 4

    def one(i):
        results[i] = _post(url, {"model": "seist_s", "data": _data(10 + i)})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(r is not None and r[0] == 200 for r in results)
    for _, body, headers in results:
        assert sorted(body["tasks"]) == ["dpk", "emg"] and body["trunk_runs"] == 1
        seg = _segments(headers["Server-Timing"])
        assert set(SEGMENTS) <= set(seg)
    flushes = service.metrics()["models"]["seist_s"]["forwards"] - forwards0
    snap = json.loads(_get(url + "/metrics.json"))

    def moved(key):
        return snap["counters"].get(key, 0.0) - snap0["counters"].get(key, 0.0)

    assert 1 <= flushes <= 4
    assert moved("serve_trunk_runs{model=seist_s}") == flushes
    assert moved("serve_head_runs{model=seist_s,task=dpk}") == flushes
    assert moved("serve_head_runs{model=seist_s,task=emg}") == flushes
    assert snap["gauges"]["serve_model_version{model=seist_s}"] == 1.0
    assert snap["gauges"]["serve_aot_programs{model=seist_s}"] >= 2 * 3  # 2 buckets x 3
    trace = json.loads(_get(url + "/traces/" + T.parse_traceparent(
        results[0][2]["traceparent"])[0]))
    spans = {s["name"]: s for s in trace["spans"]}
    assert spans["decode"]["annotations"]["heads"] == "dpk,emg"
    assert spans["forward"]["annotations"]["heads"] == "dpk,emg"
    assert spans["forward"]["annotations"]["program"].startswith("seist_s/trunk/b")


def test_prometheus_text_parses_line_by_line(served):
    _, url = served
    _post(url, {"model": "seist_s_dpk", "data": _data(2)})
    text = _get(url + "/metrics?format=prometheus")
    assert text.endswith("\n")
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
                        r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? \S+$')
    typed = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram|untyped)$")
    for line in text.splitlines():
        assert typed.match(line) or sample.match(line), line
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    for name in ("seist_serve_batcher_forwards{model=\"seist_s_dpk\"}",
                 "seist_serve_requests", "seist_trace_kept",
                 "seist_serve_aot_compile_ms{model=\"seist_s\"}"):
        assert name in text, name
    assert json.loads(_get(url + "/metrics"))["requests"]["predict"] >= 1  # bare: the JSON


def test_error_reply_carries_server_timing(served):
    _, url = served
    status, body, headers = _post(url, {"model": "nope", "data": _data(3)})
    assert status == 404 and body["error"] == "unknown_model"
    assert _segments(headers["Server-Timing"])["total"] >= 0.0
    trace = json.loads(_get(url + "/traces/" + T.parse_traceparent(headers["traceparent"])[0]))
    assert trace["flags"] == []  # a 4xx is no server error
    status, body, headers = _post(url, {"model": "seist_s_dpk", "data": [[1.0, 2.0]]})
    assert status == 400 and "Server-Timing" in headers
    trace = json.loads(_get(url + "/traces/" + T.parse_traceparent(headers["traceparent"])[0]))
    # The admission gate passes it; its parse fails.
    names = [sp["name"] for sp in trace["spans"]]
    assert names[:2] == ["admission", "parse"]
    assert trace["spans"][1]["annotations"]["error"]
