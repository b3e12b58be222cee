"""The port's long-record and streaming planes through ``ServeService``
and its HTTP front end, on the CPU.

Most cases serve a batch-invariant fake picker (the torch twin of
``tests/test_serve_stream.py``'s): a window's probabilities depend only on
its own samples, so ``/stream``'s bucket-1 flushes and ``/annotate``'s
bucket-4 batches give the same bits, and ``/stream`` must equal
``/annotate`` exactly. The last case annotates through a SeisT group's
replayed trunk and dpk head and holds it to the single-task model's."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_pair

from seist_tpu_torch.models.convert import save_torch_weights
from seist_tpu_torch.ops.stream import window_offsets
from seist_tpu_torch.serve import server as tserver
from seist_tpu_torch.serve.batcher import BatcherConfig
from seist_tpu_torch.serve.protocol import BadRequest, Overloaded
from seist_tpu_torch.serve.shed import ShedConfig
from seist_tpu_torch.utils.faults import StreamFaultInjector, StreamFaultPlan

WINDOW = 64
OPTS = {"ppk_threshold": 0.05, "spk_threshold": 0.05, "det_threshold": 0.05,
        "min_peak_dist": 0.1, "combine": "max", "record_max_events": 240}
N = 500  # a record's samples; /annotate's pick capacity (240) does not bind


class _FakeEntry:
    """A picking entry whose forward is elementwise per window."""

    name, window, in_channels, channel0 = "envpick", WINDOW, 3, "non"
    is_picker, is_group, version, variants = True, False, 1, ("fp32",)
    device, fallback_runs = torch.device("cpu"), 0
    spec = SimpleNamespace(labels=[("non", "ppk", "spk")])  # PhaseNet's heads

    def run(self, x, variant="fp32"):
        x = torch.as_tensor(np.asarray(x))
        a = x[..., 0].abs()
        p = a / (a.amax(dim=1, keepdim=True) + 1e-9)
        s = (x[..., 1].abs() / 3.0).clamp(0.0, 1.0)
        return torch.stack([1.0 - p, p, s], dim=-1)

    def all_programs(self):
        return []

    def resolve_tasks(self, tasks):
        return None

    def supported_variants(self, tasks=None):
        return ["fp32"]


class _FakePool:
    warmup_report, program_stats = [], {}

    def __init__(self):
        self.entry = _FakeEntry()

    def names(self):
        return ["envpick"]

    def get(self, name=None):
        return self.entry

    def entries(self):
        return {"envpick": self.entry}

    def warmup(self, buckets):
        pass


def _service(**kw):
    stream = {"assoc_min_stations": 3, "assoc_window_s": 60.0, "assoc_tolerance_s": 3.0,
              "max_stations": 64}
    stream.update(kw.pop("stream", {}))
    return tserver.ServeService(_FakePool(), BatcherConfig(max_batch=4, max_delay_ms=2.0),
                                stream_config=stream, **kw)


@pytest.fixture(scope="module")
def service():
    svc = _service()
    yield svc
    svc.shutdown()


def _record(length, seed=0):
    rng = np.random.default_rng(seed)
    rec = (rng.standard_normal((length, 3)) * 0.1).astype(np.float32)
    for e in range(40, length - 40, 150):
        rec[e : e + 4, 0] += 40.0
        rec[e + 30, 1] += 6.0
    return rec


def _merge(out, r):
    out["ppk"] += [p["sample"] for p in r["ppk"]]
    out["spk"] += [p["sample"] for p in r["spk"]]
    out["det"] += [(d["onset"], d["offset"]) for d in r["det"]]


def _stream(svc, station, rec, packet=23, first_seq=1, end=True, opts=OPTS, start=0):
    out = {"ppk": [], "spk": [], "det": []}
    responses, seq = [], first_seq
    for pos in range(start, len(rec), packet):
        r = svc.stream({"model": "envpick", "station": station, "seq": seq,
                        "data": rec[pos : pos + packet].tolist(), "options": opts})
        responses.append(r)
        _merge(out, r)
        seq += 1
    if end:
        r = svc.stream({"model": "envpick", "station": station, "end": True, "seq": seq,
                        "options": opts})
        assert r["closed"] is True
        responses.append(r)
        _merge(out, r)
    return out, responses


def _offline(svc, rec):
    a = svc.annotate(rec.tolist(), options=OPTS)
    return a, {"ppk": sorted(p["sample"] for p in a["ppk"]),
               "spk": sorted(p["sample"] for p in a["spk"]),
               "det": sorted((d["onset"], d["offset"]) for d in a["det"])}


def _sorted(picks):
    return {k: sorted(v) for k, v in picks.items()}


@pytest.mark.parametrize("packet", [23, 64, 200])
def test_stream_equals_annotate(service, packet):
    rec = _record(N, seed=packet)
    got, responses = _stream(service, {"id": f"PAR{packet}"}, rec, packet=packet)
    offline, want = _offline(service, rec)
    assert _sorted(got) == want and want["ppk"] and want["det"]
    assert sum(r["windows"] for r in responses) == offline["windows"]
    assert responses[-1]["n_samples"] == N and not any(r["degraded"] for r in responses)
    # Picks come out along the way, not only at the end.
    assert sum(len(r["ppk"]) for r in responses[:-1]) > 0


def test_duplicate_packet_is_dropped(service):
    st, rec = {"id": "DUP1"}, _record(WINDOW, seed=2)
    service.stream({"model": "envpick", "station": st, "data": rec.tolist(), "seq": 7,
                    "options": OPTS})
    r = service.stream({"model": "envpick", "station": st, "data": rec.tolist(), "seq": 7,
                        "options": OPTS})
    assert r["duplicate"] is True and r["windows"] == 0
    service.stream({"model": "envpick", "station": st, "end": True, "seq": 8, "options": OPTS})


def test_requests_are_validated(service):
    rec = _record(32, seed=3).tolist()
    bad = [({"data": rec}, "station"), ({"station": {"id": "X", "lat": 35.0}, "data": rec}, "lat"),
           ({"station": {"id": "X"}, "data": rec, "seq": "one"}, "seq"),
           ({"station": {"id": "X"}}, "data"),
           ({"station": {"id": "X"}, "data": rec, "options": {"variant": "bf16"}}, "variant")]
    for body, match in bad:
        with pytest.raises(BadRequest, match=match):
            service.stream(dict(body, model="envpick", options=body.get("options", OPTS)))
    with pytest.raises(BadRequest, match="< window"):
        service.annotate(rec, options=OPTS)
    with pytest.raises(BadRequest, match="fp32"):
        service.annotate(_record(N).tolist(), options=dict(OPTS, variant="int8"))
    # /predict echoes a station block and validates it.
    st = {"id": "CI.PAS", "network": "CI", "lat": 34.1, "lon": -118.2}
    assert service.predict(rec, options=OPTS, station=st)["station"] == st
    with pytest.raises(BadRequest, match="station"):
        service.predict(rec, options=OPTS, station={"id": ""})


def test_colocated_stations_raise_one_alert(service):
    rec = _record(400, seed=4)
    geometry = [{"id": "EW1", "network": "CI", "lat": 35.00, "lon": -117.00},
                {"id": "EW2", "network": "CI", "lat": 35.05, "lon": -117.05},
                {"id": "EW3", "network": "CI", "lat": 35.02, "lon": -116.95}]
    alerts = []
    for st in geometry:
        _, responses = _stream(service, st, rec, packet=100)
        alerts += [a for r in responses for a in r["alerts"]]
    assert alerts and len({a["alert_id"] for a in alerts}) == len(alerts)
    assert alerts[0]["n_stations"] == 3
    recent = service.stream_alerts()["models"]["envpick"]
    assert [a["alert_id"] for a in recent["alerts"]][-len(alerts):] == [
        a["alert_id"] for a in alerts]
    stats = service.metrics()["stream"]["envpick"]
    assert stats["alerts"] >= 1 and stats["windows_dropped"] == 0


def test_end_packets_pass_a_shedding_tier():
    svc = _service(shed_config=ShedConfig(alert_delay_ms=-1.0))  # alerts always shed
    try:
        st = {"id": "SHED1"}
        with pytest.raises(Overloaded) as e:
            svc.stream({"model": "envpick", "station": st, "seq": 1,
                        "data": _record(80).tolist(), "options": OPTS})
        assert e.value.headers()["Retry-After"] == "1"
        r = svc.stream({"model": "envpick", "station": st, "end": True, "seq": 2,
                        "options": OPTS})
        assert r["closed"] is True
        tiers = svc.metrics()["shed"]["envpick"]["tiers"]
        assert tiers["alert"]["final_exempt"] == 1 and tiers["alert"]["shed"] == 1
        # Another tier is untouched.
        assert svc.predict(_record(32).tolist(), options=OPTS)["model"] == "envpick"
    finally:
        svc.shutdown()


def test_packet_faults_degrade_but_the_stream_goes_on():
    svc = _service()
    svc._stream_faults = StreamFaultInjector(StreamFaultPlan(drop_p=0.15, dup_p=0.15,
                                                             reorder_p=0.15))
    try:
        rec = _record(900, seed=6)
        fates = [svc._stream_faults.packet_fate("FLT1", s) for s in range(1, 41)]
        assert {"drop", "dup", "reorder", "ok"} <= set(fates)
        got, responses = _stream(svc, {"id": "FLT1"}, rec, packet=23)
        stats = svc.metrics()["stream"]["envpick"]
        assert stats["duplicates"] >= 1 and stats["gaps"] >= 1
        assert responses[-1]["closed"] and got["ppk"]
        assert sum(r["windows"] for r in responses) > 0
    finally:
        svc.shutdown()


def test_a_restarted_service_resumes_from_the_journal(tmp_path):
    rec = _record(600, seed=8)
    stream = {"journal_dir": str(tmp_path), "journal_every_s": 0.0}
    first = _service(stream=stream)
    offline, want = _offline(first, rec)
    part1, _ = _stream(first, {"id": "JRN1"}, rec[:299], packet=23, end=False)
    first.shutdown()  # journals the session
    second = _service(stream=stream)
    try:
        part2, responses = _stream(second, {"id": "JRN1"}, rec, packet=23, first_seq=14,
                                   start=299)
        merged = {k: part1[k] + part2[k] for k in part1}
        assert _sorted(merged) == want
        assert responses[0]["n_samples"] == 299 + 23
        assert second.metrics()["stream"]["envpick"]["restores"] == 1.0
    finally:
        second.shutdown()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_http_routes_and_health():
    svc = _service(shed_config=ShedConfig(batch_delay_ms=-1.0))  # batch always shed
    server = tserver.start_http_server(svc, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        assert _get(url + "/healthz/live")[:2] == (200, {"status": "ok"})
        status, body, _ = _get(url + "/healthz/ready")
        assert status == 200 and body == {"status": "ok", "ready": True,
                                          "versions": {"envpick": 1}}
        rec = _record(N, seed=9)
        windows = len(window_offsets(N, WINDOW, WINDOW // 2))
        status, body, headers = _post(url + "/annotate", {"data": rec.tolist(), "options": OPTS})
        assert status == 200 and body["windows"] == windows and body["ppk"]
        assert "stream;dur=" in headers["Server-Timing"] and "admission" in headers[
            "Server-Timing"]
        status, r, headers = _post(url + "/stream", {"model": "envpick", "station": {"id": "H1"},
                                                     "seq": 1, "data": rec.tolist(),
                                                     "options": OPTS})
        assert status == 200 and r["windows"] == windows - 1  # the tail waits for end
        assert "stream_feed" in headers["Server-Timing"]
        status, body, headers = _post(url + "/predict", {"data": rec[:64].tolist(),
                                                         "options": {"priority": "batch"}})
        assert (status, body["error"], headers["Retry-After"]) == (503, "shed", "1")
        status, alerts, _ = _get(url + "/stream/alerts")
        assert status == 200 and alerts["models"]["envpick"]["stats"]["sessions"] == 1.0
        metrics = _get(url + "/metrics")[1]
        assert metrics["requests"] == {"predict": 1, "annotate": 1, "stream": 1}
        assert metrics["annotate"]["windows"] == windows and "envpick" in metrics["shed"]
        with urllib.request.urlopen(url + "/metrics?format=prometheus", timeout=30) as resp:
            text = resp.read().decode()
        for name in ("seist_stream_windows_total", "seist_serve_shed_tiers_batch_shed",
                     "seist_serve_state_code", "seist_serve_requests_stream"):
            assert name in text, name
        svc.begin_drain()
        assert _get(url + "/healthz/ready")[:2] == (503, {"status": "draining", "ready": False,
                                                          "versions": {"envpick": 1}})
        assert _get(url + "/healthz/live")[0] == 200
        assert _post(url + "/stream", {"model": "envpick", "station": {"id": "H1"}, "seq": 2,
                                       "data": rec.tolist()})[0] == 503
    finally:
        server.shutdown()
        svc.shutdown()


def test_annotate_on_a_group_replays_its_trunk_and_dpk_head(tmp_path):
    window = 256
    _, variables, _ = model_pair("seist_s_dpk", window, seed=3)
    path = str(tmp_path / "dpk.pt")
    save_torch_weights(jax.device_get(variables), path)
    svc = tserver.build_service([("seist_s_dpk", path)], groups=[("seist_s", [("dpk", path)])],
                                window=window, device="cpu", max_batch=2, max_delay_ms=2.0)
    try:
        group = svc.entries["seist_s"]
        assert group.is_picker and group.channel0 == "det"
        rec = _record(700, seed=10)
        opts = {"ppk_threshold": 0.3, "spk_threshold": 0.3, "combine": "mean"}
        fallback0 = svc.metrics()["fallback_runs"]
        runs0 = group.fanout_stats()["trunk_runs"]
        got = svc.annotate(rec.tolist(), model="seist_s", options=opts)
        want = svc.annotate(rec.tolist(), model="seist_s_dpk", options=opts)
        assert {k: got[k] for k in ("ppk", "spk", "det", "windows")} == {
            k: want[k] for k in ("ppk", "spk", "det", "windows")}
        assert svc.metrics()["fallback_runs"] == fallback0
        assert group.fanout_stats()["trunk_runs"] - runs0 == 3  # 5 windows in batches of 2
        x = np.random.default_rng(0).standard_normal((2, window, 3)).astype(np.float32)
        np.testing.assert_allclose(group.picker_forward(x).numpy(),
                                   svc.entries["seist_s_dpk"].run(x).numpy(), rtol=0, atol=1e-5)
        with pytest.raises(BadRequest, match="group"):
            svc.stream({"model": "seist_s", "station": {"id": "G"}, "data": rec.tolist()})
    finally:
        svc.shutdown()


def test_annotate_waits_its_turn_within_its_deadline(service):
    lock = service._annotate_locks["envpick"]
    lock.acquire()
    try:
        with pytest.raises(tserver.DeadlineExceeded):
            service.annotate(_record(N).tolist(), options=dict(OPTS, timeout_ms=1))
    finally:
        lock.release()
    done = threading.Event()
    threading.Thread(target=lambda: (service.annotate(_record(N).tolist(), options=OPTS),
                                     done.set()), daemon=True).start()
    assert done.wait(timeout=30)
