"""Preemption, loader death, the stall watchdog and ``supervise`` on the
port's train run, on the CPU, over a pack of the synthetic dataset.

* ``SEIST_FAULT_SIGTERM_STEP=3``: the run exits 75 with ``model_3.pt`` and
  ``state_3.pt``; resumed from :func:`find_newest_checkpoint`, it ends
  bitwise equal to an uninterrupted run, losses included.
* ``python -m seist_tpu_torch supervise`` relaunches such a run (with
  loader processes) to the same final weights.
* A loader death checkpoints the position reached and exits 75; a
  quarantine overflow ends the run with its own error.
* An armed stall trips the watchdog and exits 75 well within a minute; a
  slow step never trips it (the watchdog is disarmed outside the wait for a
  batch).
* The test metrics JSON carries the data plane's counters.

SIGTERM runs in a subprocess: a handler installs only in a main thread.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch.data import io_guard, packed, pipeline
from seist_tpu_torch.train.checkpoint import find_newest_checkpoint

ROOT = Path(__file__).resolve().parent.parent
MODEL = "seist_s_dpk"


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """30 synthetic events: 24 train (48 with augmentation) -> 6 batches of
    8; 3 val, 3 test."""
    out = str(tmp_path_factory.mktemp("pack") / "p")
    packed.pack_sources([packed.PackSource(
        name="synthetic", dataset_kwargs={"num_events": 30, "trace_samples": 1024})], out,
        samples_per_shard=8)
    return out


def _base(pack):
    return ["--device", "cpu", "--model-name", MODEL, "--dataset-name", "packed", "--data", pack,
            "--in-samples", "256", "--batch-size", "8", "--epochs", "1", "--workers", "2",
            "--log-step", "100", "--seed", "0"]


def _files(run: Path, step: int):
    return run / "checkpoints" / f"model_{step}.pt", run / "checkpoints" / f"state_{step}.pt"


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same(a, b):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def _run(args, timeout=300, **env):
    return subprocess.run([sys.executable, "-m", "seist_tpu_torch", *args], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT), **env),
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def uninterrupted(pack, tmp_path_factory):
    """train_test without faults: (run dir, model_6, state_6, losses)."""
    seist_tpu_torch.load_all()
    best = cli.main(_base(pack) + ["--log-base", str(tmp_path_factory.mktemp("run"))])
    run = Path(best).parent.parent
    weights, state = _files(run, 6)
    assert Path(best) == weights
    return run, _load(weights), _load(state), np.load(run / "train_losses.npy")


def test_test_metrics_carry_the_data_plane(uninterrupted):
    run = uninterrupted[0]
    payload = json.loads((run / "test_metrics_packed.json").read_text())
    plane = payload["data_plane"]
    assert set(plane["counters"]) == set(io_guard.Counters._FIELDS)
    assert plane["counters"]["reads"] == 8  # one padded test batch: 3 events + 5 repeats
    assert not any(v for k, v in plane["counters"].items() if k != "reads")
    assert plane["quarantine"]["quarantined"] == [] and plane["quarantine"]["n_total"] == 3


def test_sigterm_checkpoints_exits_75_and_resumes_bitwise(pack, uninterrupted, tmp_path):
    _, weights, record, losses = uninterrupted
    proc = _run(["train", *_base(pack), "--mode", "train", "--log-base", str(tmp_path)],
                SEIST_FAULT_SIGTERM_STEP="3")
    assert proc.returncode == 75, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Preempted: checkpoint step 3 durable" in proc.stdout
    ckpt = find_newest_checkpoint(str(tmp_path))
    run = Path(ckpt).parent.parent
    assert Path(ckpt) == _files(run, 3)[0] and _files(run, 3)[1].exists()
    assert _load(_files(run, 3)[1])["step"] == 3
    cli.main(_base(pack) + ["--mode", "train", "--checkpoint", ckpt])
    _assert_same(_load(_files(run, 6)[0]), weights)
    _assert_same(_load(_files(run, 6)[1]), record)
    np.testing.assert_array_equal(np.load(run / "train_losses.npy"), losses[3:])
    assert find_newest_checkpoint(str(tmp_path)) == str(_files(run, 6)[0])


def test_supervise_relaunches_a_preempted_run_to_completion(pack, uninterrupted, tmp_path):
    weights = uninterrupted[1]
    logs = tmp_path / "logs"
    train = [sys.executable, "-m", "seist_tpu_torch", "train", *_base(pack), "--mode", "train",
             "--loader-processes", "2", "--log-base", str(logs)]
    proc = _run(["supervise", "--retries", "1", "--backoff", "0", "--", *train], timeout=600,
                SEIST_FAULT_SIGTERM_STEP="3", SEIST_FAULT_STAMP=str(tmp_path / "stamp"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "clean preempt (rc=75)" in proc.stderr and "attempt 2" in proc.stderr
    assert "Mid-epoch resume: epoch 0 from batch 3" in proc.stdout
    (run,) = logs.iterdir()
    _assert_same(_load(_files(run, 6)[0]), weights)


def test_loader_death_checkpoints_and_exits_75(pack, tmp_path, monkeypatch):
    def hard_exit(code):
        raise SystemExit(code)

    monkeypatch.setattr(io_guard, "hard_exit", hard_exit)
    real, calls = pipeline.SeismicDataset.__getitem__, {"n": 0}

    def dying(self, idx):
        calls["n"] += 1
        if calls["n"] > 3 * 8:  # batch 3 never assembles
            raise RuntimeError("loader bug")
        return real(self, idx)

    monkeypatch.setattr(pipeline.SeismicDataset, "__getitem__", dying)
    before = io_guard.COUNTERS.snapshot()["loader_deaths"]
    with pytest.raises(SystemExit) as ei:
        cli.main(_base(pack) + ["--mode", "train", "--log-base", str(tmp_path)])
    assert ei.value.code == 75
    assert io_guard.COUNTERS.snapshot()["loader_deaths"] - before == 1
    ckpt = find_newest_checkpoint(str(tmp_path))
    assert Path(ckpt).name == "model_3.pt"
    assert _load(Path(ckpt).with_name("state_3.pt"))["meta"]["data_batch_offset"] == 3


def test_quarantine_overflow_ends_the_run(pack, tmp_path, monkeypatch):
    monkeypatch.setenv("SEIST_FAULT_IO_CORRUPT", "0,1,2,3,4,5")
    with pytest.raises(io_guard.QuarantineOverflowError):
        cli.main(_base(pack) + ["--mode", "train", "--log-base", str(tmp_path),
                                "--max-quarantine-frac", "0.05"])


def test_a_stall_trips_the_watchdog_and_exits_75(pack, tmp_path):
    t0 = time.monotonic()
    proc = _run(["train", *_base(pack), "--mode", "train", "--log-base", str(tmp_path),
                 "--data-watchdog-sec", "2"],
                SEIST_FAULT_IO_STALL_BATCH="2", SEIST_FAULT_IO_STALL_SEC="600")
    assert proc.returncode == 75, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert time.monotonic() - t0 < 60
    assert "[io-guard] pipeline stall" in proc.stdout and "--- thread" in proc.stderr


def test_a_slow_step_never_trips_the_watchdog(pack, tmp_path):
    proc = _run(["train", *_base(pack), "--mode", "train", "--log-base", str(tmp_path),
                 "--data-watchdog-sec", "1"],
                SEIST_FAULT_SLOW_MS="2000", SEIST_FAULT_SLOW_STEP="2")  # twice the timeout
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "pipeline stall" not in proc.stdout and "Best val loss" in proc.stdout
