"""The port's network digital twin (``seist_tpu_torch/twin.py``,
``twin_replica.py``) against the JAX package's ``tools/twin.py`` on the CPU.

* The scenario and its schedule: stations, events, waveforms (bitwise),
  the truth table and the rounds equal ``tools/twin.py``'s for two seeds,
  and ``export_schedule``'s files are byte-identical.
* ``twinpick`` equals the JAX tool's picker on the same windows; ``evaluate``
  gives equal gates and detail for one run.
* One small scenario (24 stations, 30 s, one driving worker) in process
  through both: the same alerts (ids, origins, picks), gates, stream
  counters (timings aside), exit code and result keys.
* One ``twin-replica`` over HTTP, SIGKILLed between two rounds and
  relaunched on its journal directory: its stations resume from their
  journals and the alerts are those of an uninterrupted run.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from seist_tpu_torch import stream_chaos, twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import twin as jtwin  # noqa: E402  (the JAX package's tool)

SMALL = ["--stations", "24", "--duration-s", "30", "--workers", "1"]
#: Timings and wall-clock fields, which no two runs share.
TIMING_STATS = ("journal_writes",)


def _scenario(mod, argv):
    args = mod.get_args(argv)
    stations, events, waves, expected = mod.build_scenario(args)
    return args, stations, events, waves, expected, mod.make_schedule(args, stations)


@pytest.mark.parametrize("seed", [0, 7])
def test_scenario_and_schedule_equal_the_jax_tool(seed, tmp_path):
    argv = ["--stations", "40", "--duration-s", "60", "--seed", str(seed)]
    got, want = _scenario(twin, argv), _scenario(jtwin, argv)
    for i in (1, 2, 4, 5):  # stations, events, expected, rounds
        assert got[i] == want[i]
    assert got[3].keys() == want[3].keys()
    for sid, w in want[3].items():
        assert got[3][sid].dtype == w.dtype and np.array_equal(got[3][sid], w), sid
    paths = [str(tmp_path / f"{name}.json") for name in ("port", "jax")]
    for mod, sc, path in ((twin, got, paths[0]), (jtwin, want, paths[1])):
        mod.export_schedule(path, sc[0], sc[1], sc[2], sc[5])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_twinpick_equals_the_jax_tools_picker():
    args = jtwin.get_args(SMALL)
    service = jtwin._make_service(args)
    try:
        jrun = service.pool.get("twinpick").run
        x = np.random.default_rng(0).standard_normal((5, 256, 3)).astype(np.float32) * 3.0
        x[0, 100, 0] = 6.0
        x[1, 10, 1] = -5.2
        want = np.asarray(jrun(x))
    finally:
        service.shutdown()
    got = twin.TwinPickEntry(256, "cpu").run(x).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 1] > 0).sum() > 0 and (got[..., 2] > 0).sum() > 0


def _drive(mod, argv):
    args, stations, events, waves, expected, rounds = _scenario(mod, argv)
    service = mod._make_service(args)
    try:
        run = mod.drive(args, service, stations, waves, rounds)
        stats = service.metrics()["stream"].get("twinpick", {})
    finally:
        service.shutdown()
    return args, events, expected, run, stats


def _alerts(run):
    return [{k: v for k, v in a.items() if k != "latency_ms"} for a in run["alerts"]]


def test_evaluate_equals_the_jax_tools_on_one_run():
    args, events, expected, run, stats = _drive(twin, SMALL + ["--device", "cpu", "--seed", "7"])
    got = twin.evaluate(args, events, expected, run, stats)
    want = jtwin.evaluate(args, events, expected, run, stats)
    assert got == want
    assert all(got[0].values())


@pytest.mark.parametrize("seed,code", [(7, 0), (0, 3)])
def test_small_scenario_equals_the_jax_tool_in_process(seed, code, tmp_path):
    argv = SMALL + ["--seed", str(seed)]
    t_args, t_events, t_expected, t_run, t_stats = _drive(twin, argv + ["--device", "cpu"])
    j_args, j_events, j_expected, j_run, j_stats = _drive(jtwin, argv)
    assert _alerts(t_run) == _alerts(j_run) and t_run["alerts"]
    for k in ("packets", "windows", "sheds", "errors"):
        assert t_run[k] == j_run[k], k
    assert ({k: v for k, v in t_stats.items() if k not in TIMING_STATS}
            == {k: v for k, v in j_stats.items() if k not in TIMING_STATS})
    assert (twin.evaluate(t_args, t_events, t_expected, t_run, t_stats)[0]
            == jtwin.evaluate(j_args, j_events, j_expected, j_run, j_stats)[0])
    outs = [str(tmp_path / f"{name}.json") for name in ("port", "jax")]
    assert twin.main(argv + ["--device", "cpu", "--output", outs[0]]) == code
    assert jtwin.main(argv + ["--output", outs[1]]) == code
    docs = [json.load(open(p)) for p in outs]
    assert docs[0].keys() == docs[1].keys()
    for key in ("gates", "detail", "scenario", "run", "stream_stats"):
        assert docs[0][key].keys() == docs[1][key].keys(), key
    assert docs[0]["gates"] == docs[1]["gates"]


def test_twin_writes_no_file_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert twin.get_args([]).output is None
    assert twin.main(SMALL + ["--seed", "7", "--device", "cpu"]) == 0
    assert os.listdir(tmp_path) == []


# --------------------------------------------------- one replica, killed
def _start_replica(port, journal_dir):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "seist_tpu_torch", "twin-replica", "--device", "cpu",
         "--port", str(port), "--journal-dir", journal_dir, "--journal-every-s", "0.2",
         "--stations", "48"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _wait_ready(port, proc, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stderr.read()[-2000:]
        try:
            status, _ = stream_chaos.get("127.0.0.1", port, "/healthz/ready", timeout=2.0)
            if status == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("the replica never became ready")


def test_sigkilled_replica_resumes_its_stations_from_the_journal(tmp_path):
    argv = ["--stations", "24", "--duration-s", "30", "--seed", "7"]
    ref = _drive(twin, argv + ["--workers", "1", "--device", "cpu"])[3]
    args, stations, events, waves, expected, rounds = _scenario(twin, argv)
    doc = {"stations": stations, "rounds": rounds, "scenario": {"fs": args.fs}}
    jd = str(tmp_path / "journals")
    port = stream_chaos.free_port()
    proc = _start_replica(port, jd)
    kill_after = int(events[0]["t"] * args.fs) // (args.window // 2) - 1  # before the mainshock
    try:
        _wait_ready(port, proc)
        client = stream_chaos.StreamClient("127.0.0.1", port, dict(doc, rounds=rounds[:kill_after]),
                                           waves, workers=1, round_pause_s=0.25)
        client.drive()
        time.sleep(0.3)
        proc.send_signal(signal.SIGKILL)
        assert proc.wait(timeout=30) == -signal.SIGKILL
        proc = _start_replica(port, jd)
        _wait_ready(port, proc)
        rest = stream_chaos.StreamClient("127.0.0.1", port, dict(doc, rounds=rounds[kill_after:]),
                                         waves, workers=1, round_pause_s=0.0)
        rest.drive()
        _, alerts = stream_chaos.get("127.0.0.1", port, "/stream/alerts?n=1000")
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    assert rc == 0
    assert client.dropped == rest.dropped == 0
    stats = alerts["models"]["twinpick"]["stats"]
    assert stats["restores"] > 0 and stats["restores_failed"] == 0, stats
    got = sorted(a["alert_id"] for a in client.alerts + rest.alerts)
    assert got == sorted(a["alert_id"] for a in ref["alerts"])
    main = stream_chaos._mainshock_ids(rest.alerts, events[0]["t"])
    assert main and set(main) <= {a["alert_id"] for a in ref["alerts"]}
    picks = {a["alert_id"]: a["picks"] for a in ref["alerts"]}
    for a in rest.alerts:
        assert a["picks"] == picks[a["alert_id"]]
