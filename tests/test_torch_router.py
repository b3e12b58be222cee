"""The port's front-tier router against the JAX package's, on the CPU.

Both routers are model-free stdlib code, so the same inputs go through
both and the results must be identical: the outcome classification, the
circuit breaker's state trail under an injected clock, the registry's
rotation, the rendezvous placement of stations, the forward loop against
the same scriptable fake replicas (final status and error code, and the
``router_*`` counters each package's bus counted), the canary's routing
over sockets, and the admin routes of the HTTP shim."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from seist_tpu.obs import bus as jbus
from seist_tpu.serve import canary as jcanary
from seist_tpu.serve import router as jrouter

from seist_tpu_torch.obs import bus as tbus
from seist_tpu_torch.serve import canary as tcanary
from seist_tpu_torch.serve import router as trouter

PKGS = {"jax": (jrouter, jcanary, jbus), "torch": (trouter, tcanary, tbus)}
BODY = json.dumps({"data": [[0.0, 0.0, 0.0]], "options": {}}).encode()


# ----------------------------------------------------------- fake replicas
class _Fake:
    """A scriptable replica: ``behavior`` is 'ok', 'error:<status>[:<code>]',
    'blackhole' (accepts and never answers in time) or 'slow:<ms>';
    ``stop()`` makes it refuse connections. ``/healthz/ready`` reports
    ``versions``."""

    def __init__(self, behavior="ok", version=1):
        self.behavior = behavior
        self.version = version
        self.hits = 0
        self._lock = threading.Lock()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, status, payload):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(200, {"status": "ok", "ready": True,
                                  "versions": {"m": fake.version}})

            def do_POST(self):
                with fake._lock:
                    fake.hits += 1
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                behavior = fake.behavior
                if behavior == "blackhole":
                    time.sleep(1.5)
                    return
                if behavior.startswith("slow:"):
                    time.sleep(float(behavior.split(":")[1]) / 1e3)
                    behavior = "ok"
                if behavior == "ok":
                    self._reply(200, {"task": "regression", "emg": 4.0,
                                      "model_version": fake.version})
                else:
                    parts = behavior.split(":")
                    code = parts[2] if len(parts) > 2 else "err"
                    self._reply(int(parts[1]), {"error": code, "message": code})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def _router(pkg, urls, versions=None, **config):
    router_mod, _, bus_mod = PKGS[pkg]
    kw = dict(retries=2, request_timeout_s=0.5, breaker_failures=3, breaker_cooldown_s=0.2)
    kw.update(config)
    router = router_mod.Router(config=router_mod.RouterConfig(**kw), bus=bus_mod.MetricsBus())
    for i, url in enumerate(urls):
        rep = router.registry.add(url)
        if versions is not None:
            rep.versions = {"m": versions[i]}  # what the prober would learn
    return router


def _router_counters(router):
    """The ``router_*`` counters of the router's own bus (``seist_router_*``
    on its Prometheus page)."""
    counters = router._bus.snapshot()["counters"]
    return {k: v for k, v in counters.items() if k.startswith("router_")}


# ----------------------------------------------------------- classification
CLASSIFY_TABLE = [
    (0, ""), (500, "internal"), (502, ""), (429, "queue_full"), (503, "shutting_down"),
    (503, "shed"), (503, "no_replica"), (504, "deadline_exceeded"), (200, ""),
    (400, "bad_request"), (404, "not_found"), (503, ""),
]


@pytest.mark.parametrize("status,code", CLASSIFY_TABLE)
def test_classify_equals_jax(status, code):
    got = {}
    for pkg, (mod, _, _) in PKGS.items():
        body = json.dumps({"error": code}).encode() if code else b""
        out = mod._Outcome(status, {}, body, error="refused" if status == 0 else "")
        got[pkg] = (mod._classify(out), mod._classify_label(out), out.error_code(),
                    out.is_net_error)
    assert got["torch"] == got["jax"]


# --------------------------------------------------------- circuit breaker
# (failures to open, [(event, argument)]): "f" a failure, "s" a success of
# that latency, "a" an allow(), "t" advances the injected clock.
BREAKER_SCRIPTS = {
    "opens_then_recovers": (3, [("f", 0), ("f", 0), ("s", 5.0), ("f", 0), ("f", 0), ("f", 0),
                            ("a", 0), ("t", 1.0), ("a", 0), ("t", 1.5), ("a", 0), ("a", 0),
                            ("s", 3.0), ("a", 0)]),
    "failed_probe_doubles_cooldown": (1, [("f", 0), ("t", 2.0), ("a", 0), ("f", 0), ("t", 3.0),
                                      ("a", 0), ("t", 1.5), ("a", 0), ("f", 0), ("t", 9.0),
                                      ("a", 0), ("s", 1.0), ("a", 0)]),
    "slow_successes_trip": (3, [("s", 10.0), ("s", 250.0), ("s", 300.0), ("a", 0), ("t", 2.5),
                            ("a", 0), ("s", 400.0), ("t", 5.0), ("a", 0), ("s", 20.0)]),
    "lost_probe_regranted": (1, [("f", 0), ("t", 2.0), ("a", 0), ("a", 0), ("t", 7.0), ("a", 0),
                             ("f", 0), ("t", 40.0), ("a", 0), ("s", 0.0)]),
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_circuit_breaker_trail_equals_jax(script):
    trails = {}
    for pkg, (mod, _, _) in PKGS.items():
        now = [0.0]
        failures_to_open, events = BREAKER_SCRIPTS[script]
        cb = mod.CircuitBreaker(failures_to_open=failures_to_open, cooldown_s=2.0,
                                max_cooldown_s=8.0,
                                latency_trip_ms=200.0, probe_timeout_s=6.0,
                                clock=lambda: now[0])
        trail = []
        for ev, arg in events:
            if ev == "f":
                cb.record_failure()
                out = None
            elif ev == "s":
                cb.record_success(arg)
                out = None
            elif ev == "a":
                out = cb.allow()
            else:
                now[0] += arg
                out = None
            trail.append((ev, out, cb.state, cb.stats()))
        trails[pkg] = trail
    assert trails["torch"] == trails["jax"]
    assert {s for _, _, s, _ in trails["torch"]} >= {"closed", "open"}


# --------------------------------------------------------------- registry
def test_registry_rotation_and_marks_equal_jax():
    trails = {}
    for pkg, (mod, _, _) in PKGS.items():
        reg = mod.ReplicaRegistry(mod.RouterConfig(breaker_failures=2))
        for u in ("a:1", "b:2", "c:3"):
            reg.add(u)
        trail = [[reg.pick().url for _ in range(6)]]
        reg.mark_down("a:1", reason="rc=-9")
        trail.append([reg.pick().url for _ in range(4)])
        trail.append(reg.pick(exclude={"b:2"}).url)
        for _ in range(2):
            reg.replicas()[2].breaker.record_failure()  # open c's breaker
        trail.append([getattr(reg.pick(), "url", None) for _ in range(3)])
        trail.append(reg.pick(versions_pred=lambda v: v.get("m") == 2))
        trail.append((reg.ready_count(), reg.remove("b:2"), reg.remove("b:2"),
                      reg.add("a:1") is reg.add("a:1")))
        trail.append([{k: v for k, v in s.items()} for s in reg.snapshot()])
        trails[pkg] = trail
    assert trails["torch"] == trails["jax"]


# ------------------------------------------------------- station affinity
def test_station_affinity_ranks_and_rehomes_equal_jax():
    urls = [f"127.0.0.1:{18100 + i}" for i in range(5)]
    stations = [f"NET.S{i:04d}" for i in range(500)]
    ranks, homes = {}, {}
    for pkg, (mod, _, _) in PKGS.items():
        aff = mod.StationAffinity()
        ranks[pkg] = [aff.rank(s, urls) for s in stations]
        before = {s: aff.rank(s, urls)[0] for s in stations}
        for s in stations:
            aff.note(s, before[s])
        survivors = [u for u in urls if u != urls[2]]
        moved = []
        for s in stations:
            after = aff.rank(s, survivors)[0]
            prev = aff.note(s, after)
            if prev is not None:
                moved.append((s, prev, after))
        homes[pkg] = (moved, aff.snapshot(), [aff.score(s, urls[0]) for s in stations[:20]])
    assert ranks["torch"] == ranks["jax"]
    assert homes["torch"] == homes["jax"]
    moved, snap, _ = homes["torch"]
    # Only the removed replica's stations moved, each to its second choice.
    assert moved and all(prev == urls[2] for _, prev, _ in moved)
    assert snap["rehomes"] == len(moved) and urls[2] not in snap["by_replica"]


# ------------------------------------------------------------ forward loop
FORWARD_SCENARIOS = {
    "ok": (("ok", "ok"), {}, 4),
    "first_stopped": (("stopped", "ok"), {}, 6),
    "both_500": (("error:500:internal", "error:500:internal"), {"retries": 1}, 2),
    "shed_passes_through": (("error:503:shed", "error:503:shed"), {}, 2),
    "queue_full_retried": (("error:429:queue_full", "ok"), {}, 2),
    "deadline_relayed": (("error:504:deadline_exceeded", "ok"), {}, 2),
    "blackhole": (("blackhole", "ok"), {"request_timeout_s": 0.3}, 4),
    "all_down": (("stopped", "stopped"), {"retries": 1}, 4),
    "hedged": (("slow:600", "ok"), {"hedge_ms": 100.0, "request_timeout_s": 2.0}, 1),
}


def _error_code(payload):
    try:
        return json.loads(payload).get("error", "")
    except ValueError:
        return "?"


@pytest.mark.parametrize("scenario", sorted(FORWARD_SCENARIOS))
def test_forward_equals_jax(scenario):
    behaviors, config, n = FORWARD_SCENARIOS[scenario]
    results = {}
    for pkg in PKGS:
        fakes = [_Fake("ok" if b == "stopped" else b) for b in behaviors]
        for f, b in zip(fakes, behaviors):
            if b == "stopped":
                f.stop()
        router = _router(pkg, [f.url for f in fakes], **config)
        try:
            outs = []
            for _ in range(n):
                status, headers, payload = router.forward("/predict", BODY)
                outs.append((status, _error_code(payload), "traceparent" in headers,
                             headers.get("Server-Timing", "").startswith("router;dur=")))
            breakers = [r["breaker"]["state"] for r in router.registry.snapshot()]
            results[pkg] = (outs, _router_counters(router), breakers)
        finally:
            router.stop()
            for f, b in zip(fakes, behaviors):
                if b != "stopped":
                    f.stop()
    assert results["torch"] == results["jax"], (results["torch"], results["jax"])


def test_router_metrics_collector_registers_and_unregisters_like_jax():
    got = {}
    for pkg, (mod, _, bus_mod) in PKGS.items():
        bus = bus_mod.MetricsBus()
        router = mod.Router(config=mod.RouterConfig(), bus=bus)
        router.registry.add("a:1")
        router.registry.add("b:2")
        during = sorted(k for k in bus.snapshot()["collectors"] if k.startswith("router"))
        router.stop()
        after = sorted(k for k in bus.snapshot()["collectors"] if k.startswith("router"))
        got[pkg] = (during, after)
    assert got["torch"] == got["jax"] and got["torch"][0] and not got["torch"][1]


# ------------------------------------------------------ canary over sockets
@pytest.mark.parametrize("bad", [False, True], ids=["healthy", "bad_candidate"])
def test_canary_routing_and_rollback_equal_jax(bad):
    results = {}
    for pkg, (mod, canary_mod, _) in PKGS.items():
        incumbent = _Fake("ok", version=1)
        candidate = _Fake("error:500:bad_candidate" if bad else "ok", version=2)
        router = _router(pkg, [incumbent.url, candidate.url], versions=[1, 2],
                         request_timeout_s=5.0, breaker_failures=100)
        try:
            router.canary.start(2, 50.0, canary_mod.CanaryBudget(max_error_delta=0.3,
                                                                 min_requests=4))
            statuses = [router.forward("/predict", BODY)[0] for _ in range(30)]
            at_rollback = candidate.hits
            statuses += [router.forward("/predict", BODY)[0] for _ in range(10)]
            status = router.status()
            canary = dict(status["canary"])
            for cohort in canary["cohorts"].values():
                cohort.pop("latency_ewma_ms")  # wall time, not a decision
            results[pkg] = (statuses, incumbent.hits, candidate.hits, at_rollback,
                            canary, _router_counters(router))
        finally:
            router.stop()
            incumbent.stop()
            candidate.stop()
    assert results["torch"] == results["jax"]
    statuses, _, cand_hits, at_rollback, canary, _ = results["torch"]
    assert statuses == [200] * 40
    if bad:
        assert canary["state"] == "rolled_back" and cand_hits == at_rollback
    else:
        assert canary["state"] == "active"


# ------------------------------------------------------------ HTTP shim
def _http(hostport, method, path, body=None):
    status, _, payload = trouter._http_request(hostport, method, path,
                                               body=json.dumps(body).encode() if body is not None
                                               else None, timeout_s=5.0)
    ctype_json = payload[:1] in (b"{", b"[")
    return status, (json.loads(payload) if ctype_json else payload.decode())


def test_admin_routes_equal_jax(tmp_path):
    """GET and POST routes of the router's HTTP shim, the same requests
    against both packages' servers over the same two fake replicas."""
    fakes = [_Fake("ok", version=1), _Fake("ok", version=2)]
    results = {}
    try:
        for pkg, (mod, _, _) in PKGS.items():
            router = _router(pkg, [fakes[0].url], versions=[1], request_timeout_s=2.0,
                             probe_interval_s=0.05)
            server = mod.start_router_server(router, "127.0.0.1", 0)
            hp = "127.0.0.1:%d" % server.server_address[1]
            try:
                got = []
                got.append(_http(hp, "POST", "/router/register", {"url": fakes[1].url}))
                got.append(_http(hp, "POST", "/router/register", {"nope": 1}))
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:  # the prober learns both versions
                    reps = _http(hp, "GET", "/router/replicas")[1]["replicas"]
                    if sorted(r["versions"].get("m", 0) for r in reps) == [1, 2]:
                        break
                    time.sleep(0.05)
                reps = _http(hp, "GET", "/router/replicas")[1]
                got.append(sorted((r["url"] == fakes[1].url, r["probe_state"], r["versions"])
                                  for r in reps["replicas"]))
                got.append(sorted(k for k in reps if k != "replicas"))
                got.append(_http(hp, "GET", "/healthz"))
                got.append(_http(hp, "POST", "/router/canary", {"version": 2, "percent": 25,
                                                                "min_requests": 7}))
                got.append(_http(hp, "GET", "/router/canary"))
                got.append(_http(hp, "POST", "/router/canary", {"percent": 101, "version": 2}))
                got.append(_http(hp, "POST", "/router/canary", [1]))
                got.append(_http(hp, "POST", "/router/canary", {"percent": 0}))
                report = str(tmp_path / f"shadow_{pkg}.jsonl")
                shadow = _http(hp, "POST", "/router/shadow", {"version": 2, "sample": 0.5,
                                                              "report": report})
                shadow[1].pop("report_path")
                got.append(shadow)
                cleared = _http(hp, "POST", "/router/shadow", {"sample": 0})
                cleared[1].pop("report_path")
                got.append(cleared)
                status, body = _http(hp, "POST", "/predict", {"data": [[0.0] * 3]})
                got.append((status, body))
                got.append(_http(hp, "POST", "/router/deregister", {"url": fakes[1].url}))
                got.append(_http(hp, "POST", "/router/deregister", {"url": fakes[1].url}))
                got.append(_http(hp, "GET", "/nope")[0])
                got.append(_http(hp, "GET", "/fleet/metrics.json")[1]["error"])
                text = _http(hp, "GET", "/metrics")[1]
                got.append(sorted({line.split("{")[0].split(" ")[0]
                                   for line in text.splitlines()
                                   if line.startswith("seist_router")}))
                snap = _http(hp, "GET", "/metrics.json")[1]
                got.append(sorted(k for k in snap["counters"] if k.startswith("router_")))
                results[pkg] = got
            finally:
                server.shutdown()
                router.stop()
    finally:
        for f in fakes:
            f.stop()
    assert results["torch"] == results["jax"]
