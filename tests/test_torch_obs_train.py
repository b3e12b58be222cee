"""The train worker's telemetry on the CPU (``seist_tpu_torch/train/
worker.py`` with ``obs/``), against the JAX package where the two compute
the same thing.

* ``_update_task_metrics``: the port's and the JAX worker's, fed the same
  decoded outputs and metrics targets (numpy from a seed), give the same
  per-batch and merged metrics within 1e-6 of max(1, |value|), the limit
  of ``tests/test_torch_metrics.py``.
* A ``train --device cpu`` run of ``seist_s_dpk`` with ``--metrics-port -1
  --flight-steps 8 --profile-steps 1 --log-step 1``: ``/metrics`` scraped
  while it runs, ``POST /profile`` re-arming a capture, ``events.jsonl``,
  ``scalars.jsonl`` with ``train-loss/step`` and the task metrics at every
  call, and the profiler's trace directories.
* The JAX obs smoke's contract (``tests/test_obs_e2e.py``): an injected
  data-plane stall trips the watchdog, the run exits 75, and the flight
  dump has reason ``stall_watchdog``, steps, ``host_wait`` and
  ``step_dispatch`` spans, and ``data_plane_stall_trips`` >= 1.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import glob
import json
import logging
import os
import subprocess
import sys
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from seist_tpu import taskspec as jts
from seist_tpu.train import worker as jworker

import seist_tpu_torch
from seist_tpu_torch import cli as tcli
from seist_tpu_torch import obs
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.obs import flight as tflight
from seist_tpu_torch.train import worker as tworker
from seist_tpu_torch.utils import logger as tlogger
from seist_tpu_torch.utils.logger import logger

ROOT = Path(__file__).resolve().parent.parent
MODEL = "seist_s_dpk"
L = 1000
ARGS = SimpleNamespace(time_threshold=0.1, in_samples=L, ppk_threshold=0.3, spk_threshold=0.3,
                       det_threshold=0.5, min_peak_dist=1.0, max_detect_event_num=1)


def _batches(model: str, n_batches: int = 3, n: int = 8):
    """(outputs, metrics targets) per batch, from one seed: clean phase
    bumps and detection plateaus (every probability far from a threshold),
    or values and class scores."""
    rng = np.random.default_rng(17)
    t = np.arange(L)
    out = []
    for _ in range(n_batches):
        if model.endswith("dpk"):
            p = rng.integers(150, 500, n)
            s = p + rng.integers(100, 400, n)
            jitter = rng.integers(-8, 9, (n, 2))
            probs = np.zeros((n, L, 3), np.float32)
            for i in range(n):
                probs[i, :, 1] = 0.9 * np.exp(-0.5 * ((t - p[i] - jitter[i, 0]) / 10.0) ** 2)
                probs[i, :, 2] = 0.9 * np.exp(-0.5 * ((t - s[i] - jitter[i, 1]) / 10.0) ** 2)
                probs[i, p[i]:s[i] + 150, 0] = 0.9
            probs[1, :, 1] = 0.01  # a missed pick
            targets = {"ppk": p[:, None], "spk": s[:, None],
                       "det": np.stack([p, s + 150 + rng.integers(-30, 30, n)], 1)}
            out.append((probs, targets))
        elif model.endswith("emg"):
            y = rng.uniform(0, 6, (n, 1)).astype(np.float32)
            out.append((y + rng.normal(0, 0.4, (n, 1)).astype(np.float32), {"emg": y}))
        else:  # pmp: one-hot scores
            cls = rng.integers(0, 2, n)
            scores = rng.uniform(0, 1, (n, 2)).astype(np.float32)
            out.append((scores, {"pmp": np.eye(2)[cls].astype(np.float32)}))
    return out


@pytest.mark.parametrize("model", ["seist_s_dpk", "seist_s_emg", "seist_s_pmp"])
def test_update_task_metrics_matches_jax(model):
    jspec, tspec = jts.get_task_spec(model), tts.get_task_spec(model)
    tasks = list(tspec.eval)
    assert tasks == list(jspec.eval)
    fs = 50
    merged = {"jax": jworker._make_metrics(ARGS, tasks, fs),
              "torch": tworker._make_metrics(ARGS, tasks, fs)}
    for outputs, targets in _batches(model):
        per_batch = {}
        for name, wk, spec, arr in (("jax", jworker, jspec, outputs),
                                    ("torch", tworker, tspec, torch.from_numpy(outputs))):
            results = wk._postprocess_batch(ARGS, spec, arr, fs)
            per_batch[name] = wk._make_metrics(ARGS, tasks, fs)
            wk._update_task_metrics(merged[name], per_batch[name], results, targets, 8)
        for task in tasks:
            _close(per_batch["torch"][task].get_all_metrics(),
                   per_batch["jax"][task].get_all_metrics())
    for task in tasks:
        got, want = merged["torch"][task].get_all_metrics(), merged["jax"][task].get_all_metrics()
        _close(got, want)
        assert set(got) == set(want) and got


def _close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= 1e-6 * max(1.0, abs(w)), (k, got[k], w)


def test_an_uncaught_exception_leaves_a_flight_dump(tmp_path, monkeypatch):
    monkeypatch.setattr(tflight, "_INSTALLED", None)
    monkeypatch.setattr(tflight, "_LAST_DUMP_MONO", None)
    monkeypatch.setattr(tflight, "DUMPED", [])
    monkeypatch.setattr(tlogger, "_LOGDIR", str(tmp_path))
    closed = []

    @tworker._dump_flight_on_exception
    def run():
        rec = obs.FlightRecorder(capacity=4)
        tflight.install(rec)
        tworker._OBS_CLEANUP.append(lambda: (closed.append(1), tflight.install(None)))
        rec.record_step(7)
        raise ValueError("boom")

    with pytest.raises(ValueError):
        run()
    (path,) = tflight.DUMPED
    dump = json.loads(open(path).read())
    assert dump["reason"] == "exception" and dump["error"] == "ValueError('boom')"
    assert dump["last_step"] == 7 and closed == [1] and tflight.get() is None


# ------------------------------------------------------------ a CPU run
def _base(log_base):
    return ["--device", "cpu", "--model-name", MODEL, "--dataset-name", "synthetic",
            "--synthetic-events", "30", "--in-samples", "256", "--batch-size", "8", "--epochs",
            "1", "--workers", "2", "--seed", "0", "--mode", "train", "--log-base",
            str(log_base)]


class _Scraper(logging.Handler):
    """At the run's first loss line (call 0's, printed during call 3):
    scrape ``/metrics`` and ask for a one-step profiler capture."""

    def __init__(self):
        super().__init__()
        self.url = None
        self.text = None
        self.profile = None

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("[obs] metrics endpoint: "):
            self.url = msg.split(": ", 1)[1].rsplit("/metrics", 1)[0]
        elif self.text is None and " loss " in msg and "_train epoch" in msg:
            with urllib.request.urlopen(self.url + "/metrics", timeout=30) as r:
                self.text = r.read().decode()
            req = urllib.request.Request(self.url + "/profile?steps=1", method="POST", data=b"")
            with urllib.request.urlopen(req, timeout=30) as r:
                self.profile = json.loads(r.read())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One train epoch (6 calls of 8) with the telemetry flags, the
    tensorboard package hidden so that the JSONL writer takes the scalars,
    as on the card's machine."""
    seist_tpu_torch.load_all()
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    scraper = _Scraper()
    logger.addHandler(scraper)
    try:
        best = tcli.main(_base(tmp_path_factory.mktemp("obs_run")) + [
            "--metrics-port", "-1", "--flight-steps", "8", "--profile-steps", "1",
            "--log-step", "1"])
    finally:
        logger.removeHandler(scraper)
        mp.undo()
    return Path(best).parent.parent, scraper


def test_metrics_endpoint_scraped_mid_run(run):
    _, scraper = run
    text = scraper.text
    assert text is not None and scraper.profile == {"requested_steps": 1}
    # The bus is the process's: counts may include earlier runs in it.
    for name in ("seist_step_dispatch_ms_count", "seist_host_wait_ms_count",
                 "seist_global_step 3", "seist_epoch 0", "seist_data_plane_reads",
                 "seist_loader_batches_total", "seist_train_loss", "seist_waveforms_per_sec"):
        assert name in text, name
    wps = [line for line in text.splitlines() if line.startswith("seist_waveforms_per_sec ")]
    assert float(wps[0].split()[1]) > 0
    # The endpoint closed with the run.
    with pytest.raises(OSError):
        urllib.request.urlopen(scraper.url + "/healthz", timeout=5)


def test_scalars_events_and_profiles_are_written(run):
    log_dir, _ = run
    rows = [json.loads(x) for x in (log_dir / "tensorboard" / "scalars.jsonl").read_text()
            .splitlines()]
    steps = {tag: [r["step"] for r in rows if r["tag"] == tag] for tag in {r["tag"] for r in rows}}
    assert steps["train-loss/step"] == list(range(6))
    for task in ("det", "ppk", "spk"):
        assert steps[f"train.{task}.metrics/step/f1"] == list(range(6))
        assert steps[f"train.{task}.metrics/epoch/f1"] == [0]
        assert steps[f"val.{task}.metrics/epoch/f1"] == [0]
    assert steps["val-loss/epoch"] == [0]
    assert all(np.isfinite(r["value"]) for r in rows)
    events = [json.loads(x) for x in (log_dir / "events.jsonl").read_text().splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds == ["profile_requested", "epoch_summary", "train_done"]
    assert events[1]["epoch"] == 0 and events[1]["wps"] > 0
    # --profile-steps 1: call 3; the re-armed one: call 5, cut by the epoch end.
    traces = sorted(glob.glob(str(log_dir / "profile" / "*" / "trace.json")))
    assert len(traces) == 2
    for t in traces:
        events = json.load(open(t))["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
    assert not glob.glob(str(log_dir / "flight" / "*.json"))  # a clean run dumps nothing


def test_a_stall_leaves_a_stall_watchdog_flight_dump(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "seist_tpu_torch", "train", *_base(tmp_path),
         "--data-watchdog-sec", "2", "--flight-steps", "8", "--use-tensorboard", "false"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT), SEIST_FAULT_IO_STALL_BATCH="2",
                 SEIST_FAULT_IO_STALL_SEC="600"))
    assert proc.returncode == 75, proc.stdout[-3000:] + proc.stderr[-3000:]
    (path,) = glob.glob(str(tmp_path / "*" / "flight" / "flight_*.json"))
    dump = json.load(open(path))
    assert dump["reason"] == "stall_watchdog" and "--- thread" in dump["thread_stacks"]
    assert len(dump["steps"]) >= 1
    assert {"host_wait", "step_dispatch"} <= {s["name"] for s in dump["spans"]}
    assert dump["metrics"]["collectors"]["data_plane_stall_trips"] >= 1
