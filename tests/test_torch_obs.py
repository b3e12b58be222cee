"""The port's metrics bus, event log, flight recorder and metrics endpoint
(``seist_tpu_torch/obs/``) against the JAX package's (``seist_tpu/obs/``).

The same operations go through both packages' buses, with their clocks
replaced by one fake clock so that span durations are equal: the
snapshots and the Prometheus texts must be identical. The units of
``tests/test_obs.py`` that concern these modules run against the port.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from collections import deque

import pytest

from seist_tpu.obs import bus as jbus
from seist_tpu.obs import flight as jflight
from seist_tpu.utils import meters as jmeters
from seist_tpu.utils.logger import logger as jlogger

from seist_tpu_torch import obs
from seist_tpu_torch.obs import bus as tbus
from seist_tpu_torch.obs import flight as tflight
from seist_tpu_torch.utils import logger as tlogger
from seist_tpu_torch.utils import meters as tmeters


class FakeClock:
    """A monotonic clock that advances 1.25 ms per read."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        self.t += 0.00125
        return self.t


def _scenario(mod, monkeypatch):
    """One sequence of bus operations (counters, gauges, histograms, spans,
    sinks, collectors, type conflicts, a sick collector and a sick sink);
    returns the snapshot, the Prometheus text and what the sinks saw."""
    monkeypatch.setattr(mod, "monotonic", FakeClock())
    bus = mod.MetricsBus()
    bus.counter("reads", source="h5").inc(3)
    bus.counter("reads").inc()
    bus.counter("reads").inc(2.5)
    bus.gauge("depth").set(4)
    g = bus.gauge("loss", model="m1")
    g.set(1.5)
    g.inc(0.25)
    bus.gauge("path", path='a"b\\c\nd').set(1)
    h = bus.histogram("lat_ms", bounds=(1.0, 10.0))
    for v in (0.5, 5.0, 100.0):
        h.observe(v)
    for v in (0.3, 3.0, 30.0, 300.0, 3000.0, 30000.0, 7.0):
        bus.histogram("serve_ms", model="m1").observe(v)
    conflicts = []
    for make in (lambda: bus.gauge("reads", source="h5"), lambda: bus.counter("depth"),
                 lambda: bus.histogram("loss", model="m1")):
        with pytest.raises(TypeError) as ei:
            make()
        conflicts.append(str(ei.value))
    seen = []
    bus.add_span_sink(lambda sp: seen.append((sp.name, dict(sp.labels), sp.duration_s)))

    def sick(span):
        raise RuntimeError("sink died")

    bus.add_span_sink(sick)
    with bus.span("step_dispatch"):
        pass
    with bus.span("step_dispatch", k="v"):
        pass
    sp = bus.begin("log_interval")
    first = sp.end()
    assert sp.end() == first  # idempotent
    assert list(mod.timed_iter([1, 2, 3], "host_wait", bus=bus)) == [1, 2, 3]
    bus.register_collector("src", lambda: {"a": 1, "nested": {"b": 2.5}, "flag": True,
                                           "off": False, "skip": "str", "list": [1]})
    bus.register_collector("bad", lambda: 1 / 0)
    bus.register_collector("serve_batcher:m1", lambda: {"n": 3, "lat": {"p50": 1.5}},
                           name="serve_batcher", model="m1")
    bus.register_collector("gone", lambda: {"x": 1})
    bus.unregister_collector("gone")
    keep = lambda: {"v": 7}  # noqa: E731
    bus.register_collector("kept", keep)
    bus.unregister_collector("kept", fn=lambda: {"v": 8})  # not the registered one: stays
    bus.register_collector("replaced", lambda: {"v": 1})
    bus.register_collector("replaced", lambda: {"v": 2})
    return bus.snapshot(), mod.render_prometheus(bus), seen, conflicts


def test_same_operations_give_identical_snapshot_and_prometheus(monkeypatch):
    jsnap, jtext, jseen, jconf = _scenario(jbus, monkeypatch)
    tsnap, ttext, tseen, tconf = _scenario(tbus, monkeypatch)
    assert tsnap == jsnap
    assert ttext == jtext
    assert tseen == jseen and len(tseen) == 6
    assert tconf == jconf
    json.dumps(tsnap)
    assert tsnap["collectors"]["serve_batcher_n{model=m1}"] == 3.0
    assert "bad_v" not in json.dumps(tsnap) and "gone_x" not in tsnap["collectors"]
    assert tsnap["histograms"]["step_dispatch_ms"]["count"] == 1.0
    assert 'seist_path{path="a\\"b\\\\c\\nd"} 1' in ttext


def test_latency_histogram_is_the_jax_packages():
    assert tmeters.LATENCY_BOUNDS_MS == jmeters.LATENCY_BOUNDS_MS
    assert tbus.SPAN_BOUNDS_MS == jbus.SPAN_BOUNDS_MS
    values = [0.1, 0.9, 1.0, 1.5, 4.0, 40.0, 400.0, 4000.0, 40000.0, 12.0, 12.0]
    jh, th = jmeters.LatencyHistogram(), tmeters.LatencyHistogram()
    for v in values:
        jh.observe(v)
        th.observe(v)
    assert th.summary() == jh.summary()
    assert th.buckets() == jh.buckets()
    assert (th.count, th.mean) == (jh.count, jh.mean)
    for q in (0.0, 0.1, 0.5, 0.99, 1.0):
        assert th.percentile(q) == jh.percentile(q)


def test_render_prometheus_format():
    bus = tbus.MetricsBus()
    bus.counter("reads", source="h5").inc(3)
    bus.gauge("depth").set(4)
    h = bus.histogram("lat_ms", bounds=(1.0, 10.0))
    for v in (0.5, 5.0, 100.0):
        h.observe(v)
    bus.register_collector("io", lambda: {"retries": 2})
    text = tbus.render_prometheus(bus)
    assert '# TYPE seist_reads_total counter' in text
    assert 'seist_reads_total{source="h5"} 3' in text
    assert "seist_depth 4" in text
    assert 'seist_lat_ms_bucket{le="1"} 1' in text
    assert 'seist_lat_ms_bucket{le="10"} 2' in text
    assert 'seist_lat_ms_bucket{le="+Inf"} 3' in text
    assert "seist_lat_ms_count 3" in text
    assert "seist_io_retries 2" in text
    assert text.endswith("\n")


def test_span_records_histogram_and_duration():
    bus = tbus.MetricsBus()
    with bus.span("phase") as sp:
        time.sleep(0.01)
    assert sp.duration_s is not None and sp.duration_s >= 0.01
    assert bus.histogram("phase_ms").count == 1 and bus.histogram("phase_ms").mean >= 10.0


def test_default_collectors_read_the_ports_data_plane_counters():
    from seist_tpu_torch.data import io_guard

    bus = tbus.MetricsBus()
    tbus.register_default_collectors(bus)
    before = bus.snapshot()["collectors"]
    assert set(before) == {f"data_plane_{k}" for k in io_guard.COUNTERS.snapshot()}
    io_guard.COUNTERS.inc("retries")
    after = bus.snapshot()["collectors"]
    assert after["data_plane_retries"] == before["data_plane_retries"] + 1


def test_event_log_lines_have_the_jax_keys(tmp_path):
    lines = {}
    for name, mod in (("jax", jbus), ("torch", tbus)):
        path = tmp_path / f"{name}.jsonl"
        log = mod.EventLog(str(path))
        log.emit("epoch_summary", epoch=1, loss=0.5)
        log.emit("weird", obj=object())  # unserializable -> str
        log.close()
        log.emit("after_close")  # dropped, no raise
        lines[name] = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines["torch"]) == 2
    for j, t in zip(lines["jax"], lines["torch"]):
        assert set(t) == set(j)
        assert {k: v for k, v in t.items() if k != "t"} == {k: v for k, v in j.items()
                                                            if k != "t"}


# ---------------------------------------------------------- flight recorder
@pytest.fixture
def fresh_flight(monkeypatch, tmp_path):
    """Both packages' installed recorders, dedup clocks and log dirs
    isolated."""
    for mod in (jflight, tflight):
        monkeypatch.setattr(mod, "_INSTALLED", None)
        monkeypatch.setattr(mod, "_LAST_DUMP_MONO", None)
        monkeypatch.setattr(mod, "DUMPED", [])
    monkeypatch.setattr(jlogger, "_logdir", str(tmp_path / "jax"), raising=False)
    monkeypatch.setattr(tlogger, "_LOGDIR", str(tmp_path / "torch"))
    yield tmp_path
    jflight.install(None)
    tflight.install(None)


def _keys(payload):
    """The key structure of a dump: top level, and each record's keys."""
    return ({k for k in payload},
            {k for s in payload["steps"] for k in s},
            {k for s in payload["spans"] for k in s},
            {k for e in payload["events"] for k in e},
            set(payload["metrics"]))


def test_flight_dump_keys_ring_and_step_tags_match_jax(fresh_flight):
    dumps = {}
    for name, pkg, bus_mod, flight_mod in (("jax", None, jbus, jflight),
                                           ("torch", obs, tbus, tflight)):
        rec = flight_mod.FlightRecorder(capacity=8)
        flight_mod.install(rec)
        for i in range(20):
            rec.record_step(i, loss=float(i), skipped=None)
        with bus_mod.BUS.span("host_wait"):
            pass
        with bus_mod.BUS.span("step_dispatch", k="v"):
            pass
        rec.record_event("bad_update_rollback", "rolled back", rollback_to_step=4)
        path = flight_mod.dump_on_death("stall_watchdog", waited_s=1.5)
        flight_mod.install(None)
        dumps[name] = json.loads(open(path).read())
        assert os.path.basename(path).startswith("flight_stall_watchdog_")
        assert os.path.dirname(path).endswith(os.path.join(name, "flight"))
    j, t = dumps["jax"], dumps["torch"]
    assert _keys(t) == _keys(j)
    assert [s["step"] for s in t["steps"]] == list(range(12, 20)) == [s["step"] for s in
                                                                     j["steps"]]
    assert t["last_step"] == 19 and t["capacity"] == 8 and t["waited_s"] == 1.5
    assert [(s["name"], s["step"]) for s in t["spans"]] == [("host_wait", 19),
                                                            ("step_dispatch", 19)]
    assert t["spans"][1]["labels"] == {"k": "v"}
    assert t["events"][0]["kind"] == "bad_update_rollback" and t["events"][0]["step"] == 19


def test_dump_on_death_no_recorder_and_dedup(fresh_flight):
    assert tflight.dump_on_death("x") is None
    rec = obs.FlightRecorder(capacity=4)
    tflight.install(rec)
    rec.record_step(3)
    p1 = tflight.dump_on_death("stall_watchdog")
    assert p1 and "stall_watchdog" in p1
    # The hard_exit funnel dedups against the richer dump just written...
    assert tflight.dump_on_death("hard_exit", dedup_s=5.0) is None
    # ...but a dump without dedup lands, and a non-fatal one arms nothing.
    assert tflight.dump_on_death("hard_exit") is not None
    assert tflight.DUMPED[0] == p1
    tflight._LAST_DUMP_MONO = None
    assert tflight.dump_on_death("bad_update_rollback", arm_dedup=False) is not None
    assert tflight.dump_on_death("exception", dedup_s=5.0) is not None
    # A payload field named like the dump's location parameter is renamed.
    p = tflight.dump_on_death("preempt", path="/nowhere/x.json")
    assert json.loads(open(p).read())["path_field"] == "/nowhere/x.json"


def test_install_swaps_bus_sink(fresh_flight):
    r1, r2 = obs.FlightRecorder(capacity=4), obs.FlightRecorder(capacity=4)
    tflight.install(r1)
    tflight.install(r2)  # replaces r1's sink
    r1.record_step(0)
    r2.record_step(0)
    with obs.BUS.span("swap_probe"):
        pass
    assert len(r1.payload("t")["spans"]) == 0 and len(r2.payload("t")["spans"]) == 1
    tflight.install(None)
    with obs.BUS.span("swap_probe"):
        pass
    assert len(r2.payload("t")["spans"]) == 1


def test_flight_capacity_must_be_positive():
    with pytest.raises(ValueError):
        obs.FlightRecorder(capacity=0)


# ------------------------------------------------------------- http server
def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode(), r.headers.get("Content-Type", "")


def test_metrics_http_endpoints(fresh_flight):
    bus = tbus.MetricsBus()
    bus.counter("reads").inc(2)
    rec = obs.FlightRecorder(capacity=4)
    rec.record_step(1)
    tflight.install(rec)
    trigger = obs.ProfileTrigger()
    server = obs.start_metrics_server(-1, bus=bus, profile_trigger=trigger)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, text, ctype = _get(base + "/metrics")
        assert status == 200 and "seist_reads_total 2" in text
        assert ctype.startswith("text/plain")
        status, text, _ = _get(base + "/metrics.json")
        assert status == 200 and json.loads(text)["counters"]["reads"] == 2.0
        status, text, _ = _get(base + "/flight")
        assert status == 200 and json.loads(text)["steps"][0]["step"] == 1
        status, text, _ = _get(base + "/healthz")
        assert status == 200 and json.loads(text) == {"status": "ok"}
        status, text, _ = _get(base + "/traces")
        assert status == 200 and "traces" in json.loads(text)
        req = urllib.request.Request(base + "/profile?steps=3", method="POST", data=b"")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200 and json.loads(r.read())["requested_steps"] == 3
        assert trigger.consume() == 3
        assert trigger.consume() == 0  # one-shot
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/nope")
        assert ei.value.code == 404
        tflight.install(None)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/flight")
        assert ei.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_profile_trigger_last_write_wins():
    t = obs.ProfileTrigger()
    assert t.consume() == 0
    t.request(2)
    t.request(7)
    assert t.consume() == 7
    t.request(0)  # clamped to >= 1
    assert t.consume() == 1


def test_profile_trigger_request_during_consume_not_dropped():
    """A request landing while consume() drains (the HTTP thread against
    the train loop's poll) is taken by that poll or the next, never lost."""
    t = obs.ProfileTrigger()

    class MidDrainRequest(deque):
        injected = False

        def popleft(self):
            v = deque.popleft(self)
            if not MidDrainRequest.injected:
                MidDrainRequest.injected = True
                t.request(20)
            return v

    t._requests = MidDrainRequest([5], maxlen=64)
    assert t.consume() == 20
    assert t.consume() == 0


def test_stopwatch_reads_the_bus_clock(monkeypatch):
    from seist_tpu_torch.utils import profiling

    clock = FakeClock()
    monkeypatch.setattr(tbus, "monotonic", clock)
    with profiling.stopwatch() as elapsed:
        inside = elapsed()
    after = elapsed()
    assert inside == pytest.approx(0.00125) and after == pytest.approx(0.0025)
    assert elapsed() == after  # frozen at exit
