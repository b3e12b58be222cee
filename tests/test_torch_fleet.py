"""The port's fleet plane against the JAX package's, on the CPU: the fleet
metrics pane (``obs/fleet.py::FleetAggregator``), the rolling restart's
command rewrite and state machine, the preemption exit code, and the
port's supervisor (``python -m seist_tpu_torch supervise-fleet``) run as
a subprocess over the stdlib stand-in replica ``tests/_fake_serve_replica.py``:
a crash relaunched after its backoff, a SIGTERM'd replica (exit 75)
relaunched at once with its budget untouched, a SIGHUP subset roll, and
``/fleet/metrics.json``."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import http.client
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import supervise_fleet as jfleet  # noqa: E402  (tools/supervise_fleet.py)

from seist_tpu.obs import fleet as jobs_fleet  # noqa: E402
from seist_tpu.serve import server as jserver  # noqa: E402

from seist_tpu_torch import supervise_fleet as tfleet  # noqa: E402
from seist_tpu_torch.obs import fleet as tobs_fleet  # noqa: E402
from seist_tpu_torch.train import checkpoint as tcheckpoint  # noqa: E402

FAKE_REPLICA = str(ROOT / "tests" / "_fake_serve_replica.py")


def test_preempt_exit_code_is_one_contract():
    """75 (EX_TEMPFAIL): the port's replica, the port's fleet supervisor,
    the port's train plane and the JAX replica agree."""
    from seist_tpu_torch.serve import server as tserver

    assert (tserver.PREEMPT_EXIT_CODE == jserver.PREEMPT_EXIT_CODE
            == tcheckpoint.PREEMPT_EXIT_CODE == tfleet.PREEMPT_EXIT_CODE
            == jfleet.PREEMPT_EXIT_CODE == 75)


# ------------------------------------------------------------- fleet pane
def _hist(counts, bounds=(1.0, 10.0, 100.0), total=None):
    n = float(sum(counts))
    return {"count": n, "mean": (total or n) / max(n, 1.0), "max": 50.0,
            "sum": float(total or n), "p50": 1.0, "p99": 2.0,
            "bounds": list(bounds), "bucket_counts": list(counts)}


SNAPSHOTS = {
    "router": {"counters": {"router_requests{path=predict}": 7, "router_retries": 2},
               "gauges": {"router_ready_replicas": 2.0},
               "histograms": {}, "collectors": {"router_replicas": 2.0,
                                                "router": {"nested": 1}}},
    "replica-0": {"counters": {"serve_requests{route=predict}": 4,
                               "serve_batcher_submitted{model=seist_l_dpk}": 4},
                  "gauges": {"serve_state_code": 2.0, "flag": True},
                  "histograms": {"serve_latency_ms{model=seist_l_dpk}": _hist([1, 2, 1, 0], total=90.0),
                                 "odd_ladder": _hist([1, 1, 0], bounds=(5.0, 50.0))},
                  "collectors": {"serve_uptime_s": 10.0}},
    "replica-1": {"counters": {"serve_requests{route=predict}": 3,
                               "serve_requests{route=annotate}": 1},
                  "gauges": {"serve_state_code": 2.0},
                  "histograms": {"serve_latency_ms{model=seist_l_dpk}": _hist([0, 2, 0, 1], total=400.0),
                                 "odd_ladder": _hist([2, 0, 0, 0])},
                  "collectors": {"serve_uptime_s": 4.5}},
}


def _down():
    raise OSError("connection refused")


def test_fleet_aggregator_merge_and_prometheus_equal_jax():
    views = {}
    for pkg, mod in (("jax", jobs_fleet), ("torch", tobs_fleet)):
        agg = mod.FleetAggregator(interval_s=3600.0)
        for name, snap in SNAPSHOTS.items():
            agg.add_source(name, lambda s=snap: json.loads(json.dumps(s)))
        agg.add_source("replica-2", _down)
        merged = agg.merged()
        merged.pop("scraped_at")
        text = agg.render_prometheus(refresh=False)
        agg.remove_source("replica-1")
        after = agg.merged(refresh=False)
        after.pop("scraped_at")
        views[pkg] = (merged, text, after)
    assert views["torch"] == views["jax"]
    merged, text, _ = views["torch"]
    agg = merged["aggregate"]
    assert merged["up"] == 3 and not merged["sources"]["replica-2"]["up"]
    assert agg["counters"]["serve_requests{route=predict}"] == 7.0
    h = agg["histograms"]["serve_latency_ms{model=seist_l_dpk}"]
    assert h["count"] == 7.0 and h["bucket_counts"] == [1, 4, 1, 1]
    assert merged["skipped_histograms"] == ["replica-1:odd_ladder"]
    assert 'replica="fleet"' in text and 'seist_fleet_source_up{source="replica-2"} 0' in text


def test_fleet_aggregator_scrapes_a_replica_url_like_jax():
    """A source given as ``host:port`` is scraped at ``/metrics.json``."""
    proc, port = _fake_replica()
    try:
        views = {}
        for pkg, mod in (("jax", jobs_fleet), ("torch", tobs_fleet)):
            agg = mod.FleetAggregator(interval_s=3600.0)
            agg.add_source("replica-0", f"127.0.0.1:{port}")
            agg.add_source("gone", "127.0.0.1:1")
            merged = agg.merged()
            merged.pop("scraped_at")
            for src in merged["sources"].values():
                src["error"] = src["error"].split(":")[0]
            views[pkg] = merged
        assert views["torch"] == views["jax"] and views["torch"]["up"] == 1
    finally:
        proc.terminate()
        proc.wait(10)


def _fake_replica():
    port = _free_port()
    proc = subprocess.Popen([sys.executable, FAKE_REPLICA, "--port", str(port)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            return proc, port
        except OSError:
            time.sleep(0.05)
    proc.kill()
    raise AssertionError("fake replica never listened")


# --------------------------------------------------------- rollout command
ROLLOUT_CMDS = [
    (["serve", "--model-version", "1", "--window", "256"], 2, None),
    (["serve", "--model-version=3", "--window", "256"], 4, None),
    (["serve", "--model", "phasenet=old.ck", "--checkpoint", "o2",
      "--model-group", "seist_s=dpk:a,emg:b"], 3, "new.ck"),
    (["serve", "--model", "phasenet=old.ck"], 4, None),
    (["serve", "--model", "seist_l_dpk", "--model", "phasenet=x.pt"], 5, "w2.pt"),
    (["serve", "--model-group", "seist_l=dpk,emg:e.pt,dis"], 2, "g.pt"),
    (["python", "-m", "seist_tpu_torch", "serve", "--model", "seist_l_dpk=w.pt",
      "--window", "8192", "--device", "cpu", "--model"], 9, "w2.pt"),
    ([], 1, None),
]


@pytest.mark.parametrize("case", range(len(ROLLOUT_CMDS)))
def test_rollout_cmd_equals_jax(case):
    cmd, version, ckpt = ROLLOUT_CMDS[case]
    assert tfleet.rollout_cmd(list(cmd), version, ckpt) == jfleet.rollout_cmd(list(cmd), version,
                                                                             ckpt)


# ------------------------------------------------- rollout state machine
class _FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.signals = []

    def poll(self):
        return None

    def send_signal(self, sig):
        self.signals.append(int(sig))


class _FakeSlot:
    def __init__(self, index, port):
        self.index, self.port = index, port
        self.url = f"127.0.0.1:{port}"
        self.cmd = ["serve", "--model", "seist_l_dpk=", "--host", "127.0.0.1", "--port",
                    str(port)]
        self.proc = _FakeProc(1000 + index)
        self.retired = False


class _FakeRegistry:
    def __init__(self, slots):
        self.ready = {s.url: True for s in slots}

    def replicas(self):
        class R:
            def __init__(self, url, ready):
                self.url, self.probe_ready = url, ready

        return [R(u, r) for u, r in self.ready.items()]


# Each step: ("tick", probe answer for every slot) | ("respawn", i) |
# ("retire", i) | ("unready", i) | ("readmit", i) | ("sleep", s).
UP2 = (True, {"seist_l_dpk": 2})
ROLL_SCRIPTS = {
    "one_at_a_time": (2, {}, [("tick", (False, {})), ("respawn", 0), ("tick", (False, {})),
                              ("tick", (False, {})), ("tick", UP2), ("tick", UP2),
                              ("respawn", 1), ("tick", UP2), ("tick", UP2)]),
    "stale_version": (1, {}, [("tick", (True, {"seist_l_dpk": 1})), ("respawn", 0)]
                      + [("tick", (True, {"seist_l_dpk": 1}))] * 4),
    "ready_timeout": (2, {"ready_timeout_s": 0.05}, [("tick", (False, {})), ("respawn", 0),
                                                     ("tick", (False, {})), ("sleep", 0.06),
                                                     ("tick", (False, {}))]),
    "wedged_drain": (2, {"ready_timeout_s": 0.05}, [("tick", (False, {})), ("sleep", 0.06),
                                                    ("tick", (False, {}))]),
    "retired_mid_roll": (2, {}, [("tick", (False, {})), ("retire", 0), ("tick", (False, {}))]),
    "retired_upfront": (2, {}, [("retire", 0), ("tick", UP2), ("respawn", 1), ("tick", UP2),
                                ("tick", UP2)]),
    "subset": (3, {"subset": [1], "checkpoint": "w2.pt"},
               [("tick", UP2), ("respawn", 1), ("tick", UP2), ("tick", UP2)]),
    "not_in_rotation": (1, {}, [("tick", UP2), ("respawn", 0), ("tick", UP2), ("unready", 0),
                                ("tick", UP2), ("readmit", 0), ("tick", UP2)]),
    "full_cmd": (1, {"cmd": ["serve", "--model", "seist_l_dpk=w3.pt"]},
                 [("tick", UP2), ("respawn", 0), ("tick", UP2), ("tick", UP2)]),
}


def _roll_trail(mod, script):
    n, kw, steps = ROLL_SCRIPTS[script]
    kw = dict(kw)
    kw.setdefault("ready_timeout_s", 30.0)
    slots = [_FakeSlot(i, 18100 + i) for i in range(n)]
    reg = _FakeRegistry(slots)
    roll = mod.FleetRollout(slots, version=2, **kw)
    trail = [[s.index for s in roll.queue]]
    for step, arg in steps:
        if step == "tick":
            roll.advance(reg, lambda slot, _a=arg: _a)
        elif step == "respawn":
            slots[arg].proc = _FakeProc(2000 + arg)
        elif step == "retire":
            slots[arg].retired = True
        elif step == "unready":
            reg.ready[slots[arg].url] = False
        elif step == "readmit":
            reg.ready[slots[arg].url] = True
        else:
            time.sleep(arg)
        trail.append((step, roll.phase, roll.done, roll.aborted, list(roll.rolled),
                      [(s.proc.pid, list(s.proc.signals), list(s.cmd)) for s in slots]))
    return trail


@pytest.mark.parametrize("script", sorted(ROLL_SCRIPTS))
def test_fleet_rollout_trail_equals_jax(script):
    assert _roll_trail(tfleet, script) == _roll_trail(jfleet, script)


# ------------------------------------------------- the supervisor, live
def _free_port(n=1):
    """A port where ``n`` consecutive ports are free, below the ephemeral
    range (so no outgoing connection takes one before a replica binds it)."""
    rng = random.Random()
    while True:
        base = rng.randrange(20000, 32000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()


def _drain(pipe, buf):
    for line in pipe:
        buf.append(line)


def _start_fleet(env_extra=None, replicas=2, extra_args=(), cmd=(sys.executable, FAKE_REPLICA),
                 cwd=ROOT):
    """The port's supervisor over ``replicas`` copies of ``cmd``; returns
    (process, router host, router port). Its stderr (the ``[fleet]`` log)
    collects in ``process.err``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "seist_tpu_torch", "supervise-fleet",
         "--replicas", str(replicas), "--base-port", str(_free_port(replicas)),
         "--router-port", "0",
         "--probe-interval-s", "0.2", "--backoff", "0.4", "--drain-timeout-s", "30",
         *extra_args, "--", *cmd],
        cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    proc.err = []
    proc.err_thread = threading.Thread(target=_drain, args=(proc.stderr, proc.err), daemon=True)
    proc.err_thread.start()
    seen = []
    for _ in range(400):
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        m = re.search(r"\[fleet\] ROUTER=http://([\d.]+):(\d+)", line)
        if m:
            threading.Thread(target=_drain, args=(proc.stdout, []), daemon=True).start()
            return proc, m.group(1), int(m.group(2))
    proc.kill()
    raise AssertionError(f"no ROUTER line from the supervisor: {seen!r}")


def _get(host, port, path, timeout=5.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _predict(host, port):
    conn = http.client.HTTPConnection(host, port, timeout=5.0)
    try:
        conn.request("POST", "/predict", json.dumps({"data": [[0.0] * 3]}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _replicas(host, port):
    try:
        return _get(host, port, "/router/replicas")[1].get("replicas", [])
    except OSError:
        return []


def _wait(pred, timeout_s=30.0, what="", proc=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    log = "".join(proc.err)[-3000:] if proc is not None else ""
    raise AssertionError(f"timed out waiting for {what}\n{log}")


def _stop(proc, expect_rc=0):
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=30)
    proc.err_thread.join(timeout=10)
    err = "".join(proc.err)
    assert rc == expect_rc, f"supervisor rc={rc}\n{err}"
    return err


def _pid_of(err_lines, index):
    pids = [int(m.group(1)) for line in err_lines
            for m in [re.search(rf"replica {index} \(port \d+\) started pid=(\d+)", line)] if m]
    return pids[-1]


def test_supervisor_relaunches_rolls_and_aggregates(tmp_path):
    """One fleet of two stand-in replicas through the supervisor's whole
    contract: replica 0 crashes once (relaunched after the backoff, the
    clients see no failure), replica 1 is SIGTERM'd (exit 75, relaunched
    at once, no budget spent), ``/fleet/metrics.json`` sums both replicas'
    counters, a SIGHUP rolls replica 0 alone to version 2, and SIGTERM to
    the supervisor drains both with exit 75 and exits 0."""
    stamp, spec = tmp_path / "crash.stamp", tmp_path / "rollout.json"
    proc, host, port = _start_fleet(
        env_extra={"FAKE_CRASH_AFTER_S": "1.5", "FAKE_CRASH_REPLICA": "0",
                   "FAKE_CRASH_STAMP": str(stamp)},
        extra_args=("--rollout-file", str(spec), "--rollout-ready-timeout-s", "30",
                    "--fleet-scrape-interval-s", "0.3"))
    try:
        _wait(lambda: sum(r["probe_state"] == "ok" for r in _replicas(host, port)) == 2,
              what="two probed-ready replicas", proc=proc)
        failures, sent, stop = [], [0], threading.Event()

        def client():
            while not stop.is_set():
                try:
                    status, body = _predict(host, port)
                except OSError as e:
                    status, body = repr(e), None
                sent[0] += 1
                if status != 200:
                    failures.append((status, body))
                time.sleep(0.02)

        t = threading.Thread(target=client)
        t.start()
        _wait(stamp.exists, what="the scripted crash")
        _wait(lambda: "replica 0 crashed rc=3; relaunch" in "".join(proc.err), what="relaunch")
        # Back in rotation: probed ready, and its breaker closed again by a
        # request after the cooldown (only then may the other replica go).
        _wait(lambda: [(r["probe_state"], r["breaker"]["state"]) for r in _replicas(host, port)]
              == [("ok", "closed")] * 2, what="the crashed replica back in rotation")
        # A SIGTERM'd replica exits 75 and is relaunched at once.
        os.kill(_pid_of(proc.err, 1), signal.SIGTERM)
        _wait(lambda: "replica 1 clean preempt (rc=75)" in "".join(proc.err), what="exit 75")
        _wait(lambda: sum(r["probe_state"] == "ok" for r in _replicas(host, port)) == 2,
              what="the preempted replica back in rotation")
        stop.set()
        t.join(10)
        assert not failures, failures[:5]
        # The fleet pane: the replicas' counters sum (the crashed process's
        # counts died with it, so the sum is at most what was sent).
        view = {}

        def merged():
            view.update(_get(host, port, "/fleet/metrics.json", timeout=10.0)[1])
            return view.get("up", 0) == 3

        _wait(merged, what="three sources up in /fleet/metrics.json")
        per = {n: (s or {}).get("counters", {}).get("fake_requests{path=predict}", 0)
               for n, s in view["replicas"].items() if n.startswith("replica-")}
        assert len(per) == 2
        assert view["aggregate"]["counters"].get("fake_requests{path=predict}", 0) == sum(
            per.values()) <= sent[0]
        assert any(k.startswith("router_requests") for k in view["replicas"]["router"]["counters"])
        # The subset roll: replica 0 to version 2, replica 1 untouched.
        spec.write_text(json.dumps({"version": 2, "replicas": [0]}))
        proc.send_signal(signal.SIGHUP)
        _wait(lambda: sorted(r.get("versions", {}).get("fake", 0) for r in _replicas(host, port)
                             if r["probe_state"] == "ok") == [1, 2], what="the subset roll")
        _wait(lambda: "rollout complete: version 2 on replica(s) [0]" in "".join(proc.err),
              what="the roll's completion")
    finally:
        err = _stop(proc, expect_rc=0)
    assert "budget 1/3" in err and "draining replica 1" not in err, err
    assert err.count("drained (rc=75)") == 2, err


def test_supervisor_retires_a_crash_looping_slot_and_exits_1():
    proc, _, _ = _start_fleet(env_extra={"FAKE_CRASH_AFTER_S": "0.3"}, replicas=1,
                              extra_args=("--retries", "1", "--backoff", "0.2"))
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    proc.err_thread.join(timeout=10)
    err = "".join(proc.err)
    assert rc == 1 and "budget exhausted" in err and "slot retired" in err, err


def test_crash_reports_the_stations_the_router_rehomed_before_the_poll(capsys):
    """A replica's death is polled every 0.2 s, and the router may move all
    of its stations to survivors at their next packets before that poll:
    the supervisor still reports the stations it was home to."""
    from types import SimpleNamespace

    from seist_tpu_torch.serve.router import StationAffinity

    dead, alive = "127.0.0.1:9100", "127.0.0.1:9101"
    affinity = StationAffinity()
    stations = [f"ST{i:02d}" for i in range(5)]
    for st in stations:
        affinity.note(st, dead)
    stop = threading.Event()
    marked = []

    class Proc:
        calls = 0

        def poll(self):
            Proc.calls += 1
            if Proc.calls == 1:  # alive; then it dies and is re-homed
                for st in stations:
                    affinity.note(st, alive)
                return None
            return -9

    slot = SimpleNamespace(index=0, url=dead, proc=Proc(), retired=False, failures=0,
                           started_at=time.monotonic(), restart_at=None,
                           spawn=stop.set)
    registry = SimpleNamespace(mark_down=lambda url, reason="": marked.append(url),
                               add=lambda url: None, remove=lambda url: None)
    router = SimpleNamespace(registry=registry, affinity=affinity)
    args = SimpleNamespace(retries=3, backoff=0.0, healthy_reset_s=60.0, rollout_file="")
    thread = threading.Thread(target=tfleet._monitor, args=([slot], router, args, stop))
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    err = capsys.readouterr().err
    assert marked == [dead] and affinity.snapshot()["by_replica"] == {alive: 5}
    assert "replica 0 was stream home to 5 stations" in err, err
    assert "replica 0 crashed rc=-9; relaunch" in err, err
