"""The lagged bad-update guard of the port's train worker against the JAX
package's, on the CPU.

* ``_BadUpdateMonitor`` reads verdicts two calls late and counts the
  consecutive skips as the JAX worker's does (tests/test_faults.py:248):
  the same pushes give the same answers, runs and totals.
* Under the same ``SEIST_FAULT_NAN_STEP`` injection (three NaN batches
  from step 1, an interval save every 4 steps, ``seist_s_dpk`` at window
  256 on 40 synthetic events), the port's run and the JAX package's run
  (``python main.py``) roll back to the same checkpoint step, skip the
  same steps and record the same non-finite losses.
"""

from __future__ import annotations

import glob
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seist_tpu.train.worker import _BadUpdateMonitor as JaxMonitor

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch.train.worker import _BadUpdateMonitor
from seist_tpu_torch.utils.logger import logger

ROOT = Path(__file__).resolve().parent.parent

PUSHES = [
    (3, 2, [0, 0, 0, 0, 0]),
    (2, 0, [0, 1, 0, 0]),
    (4, 0, [[0, 0, 0], [0, 0, 1], [1, 0, 0], [0, 0, 0]]),
    (0, 0, [0] * 10),
    (3, 2, [1, 0, 0, 1, 0, 0, 0, 1]),
    (2, 2, [[1, 0], [0, 0], [1, 1], [0, 1], [0, 0]]),
]


@pytest.mark.parametrize("max_bad,lag,pushes", PUSHES)
def test_monitor_matches_the_jax_monitor(max_bad, lag, pushes):
    mine, theirs = _BadUpdateMonitor(max_bad, lag), JaxMonitor(max_bad, lag)
    for applied in pushes:
        # The port pushes device tensors (int32 masks, bool scalars).
        dev = (torch.tensor(applied, dtype=torch.int32) if isinstance(applied, list)
               else torch.tensor(bool(applied)))
        assert mine.push(dev) == theirs.push(np.asarray(applied, np.int32))
        assert (mine.bad_run, mine.total_skipped) == (theirs.bad_run, theirs.total_skipped)
    assert mine.flush() == theirs.flush()
    assert (mine.bad_run, mine.total_skipped) == (theirs.bad_run, theirs.total_skipped)
    mine.reset()
    theirs.reset()
    assert mine.bad_run == theirs.bad_run == 0


# 40 events: 32 train (64 with augmentation) -> 8 batches of 8.
ARGS = ["--mode", "train", "--model-name", "seist_s_dpk", "--dataset-name", "synthetic",
        "--synthetic-events", "40", "--in-samples", "256", "--batch-size", "8", "--epochs", "1",
        "--workers", "2", "--seed", "0", "--augmentation", "true", "--save-interval-steps", "4",
        "--log-step", "100"]
NAN = {"SEIST_FAULT_NAN_STEP": "1", "SEIST_FAULT_NAN_COUNT": "3"}


def _guard_lines(text: str):
    return [line.split("| ")[-1].strip() for line in text.splitlines()
            if "Bad-update guard" in line]


def test_rollback_lands_on_the_jax_workers_step(tmp_path, monkeypatch):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEIST_FAULT_")}
    env.update(NAN, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    jax_base = tmp_path / "jax"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "main.py"), *ARGS, "--use-tensorboard", "false",
         "--log-base", str(jax_base)],
        env=env, cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (jax_run,) = glob.glob(str(jax_base / "*"))
    with open(os.path.join(jax_run, "train.log")) as f:
        jax_lines = _guard_lines(f.read())
    jax_losses = np.load(os.path.join(jax_run, "train_losses.npy"))

    seist_tpu_torch.load_all()
    for k, v in NAN.items():
        monkeypatch.setenv(k, v)
    lines = []

    class _Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = _Lines()
    logger.addHandler(handler)
    try:
        best = cli.main(ARGS + ["--device", "cpu", "--log-base", str(tmp_path / "port")])
    finally:
        logger.removeHandler(handler)
    run = Path(best).parent.parent
    losses = np.load(run / "train_losses.npy")
    mine = [x for x in lines if x.startswith("Bad-update guard")]

    rollback = [x for x in jax_lines if "rolling back to checkpoint step 4" in x]
    assert rollback and rollback == [x for x in mine if "rolling back" in x], (jax_lines, mine)
    assert mine == jax_lines
    np.testing.assert_array_equal(np.isfinite(losses), np.isfinite(jax_losses))
    assert not np.isfinite(losses[1:4]).any() and len(losses) == 8
    # One update before the save at 4, rolled back to there, then steps 6 and 7.
    record = torch.load(run / "checkpoints" / "state_8.pt", map_location="cpu",
                        weights_only=True)
    assert record["step"] == 3
