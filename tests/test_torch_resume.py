"""Checkpoints, resume and rollback of the port's train run, on the CPU.

* A run of ``seist_s_dpk`` (window 256, batch 8, 6 steps, an interval
  save every 3) resumed from ``model_3.pt`` ends bitwise equal to the
  uninterrupted run: weights, BatchNorm statistics, Adam's moments and
  step (the data order, the augmentation and the dropout of step t are
  pure functions of (seed, epoch, index) and of the update count).
* A mid-epoch resume under another ``--seed`` or ``--batch-size`` raises,
  as the JAX package's does.
* Retention keeps the last K steps plus the best-val one, across managers.
* A JAX train state written by ``convert.save_torch_train_state`` resumes
  at its data position and update count.
* Three non-finite batches in a row roll back to the last interval save,
  with the guard's verdicts read two calls late; without a save, the run
  raises, as the JAX package's does.
* The command line: a ``train_test`` subprocess writes the weights, the
  results CSV and the metrics JSON, and ``--mode test --checkpoint``
  writes the same JSON again.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import seist_tpu
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.convert import (
    save_torch_train_state,
    state_dict_from_flax,
)
from seist_tpu_torch.train import worker as tworker
from seist_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.step import TrainState
from seist_tpu_torch.utils.logger import logger

from _torch_parity import model_pair

ROOT = Path(__file__).resolve().parent.parent
MODEL = "seist_s_dpk"
# 30 events: 24 train (48 with augmentation) -> 6 batches of 8; 3 val, 3 test.
BASE = ["--device", "cpu", "--model-name", MODEL, "--dataset-name", "synthetic",
        "--synthetic-events", "30", "--in-samples", "256", "--batch-size", "8",
        "--epochs", "1", "--workers", "2", "--log-step", "100", "--seed", "0"]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def log_lines():
    h = _Lines()
    logger.addHandler(h)
    try:
        yield h.lines
    finally:
        logger.removeHandler(h)


def _files(run: Path, step: int):
    return run / "checkpoints" / f"model_{step}.pt", run / "checkpoints" / f"state_{step}.pt"


def _load(path: Path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same(a, b):
    """Bitwise equality of nested dicts/lists of tensors and scalars."""
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


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """6 steps with saves every 3; returns (run dir, final weights, final
    state record, losses)."""
    seist_tpu_torch.load_all()
    base = tmp_path_factory.mktemp("run")
    best = cli.main(BASE + ["--mode", "train", "--save-interval-steps", "3",
                            "--log-base", str(base)])
    run = Path(best).parent.parent
    weights, state = _files(run, 6)
    assert Path(best) == weights
    return run, _load(weights), _load(state), np.load(run / "train_losses.npy")


def test_resume_from_an_interval_save_is_bitwise_equal(uninterrupted, tmp_path, log_lines):
    run0, weights, record, losses = uninterrupted
    run = tmp_path / "run"
    shutil.copytree(run0, run)
    for f in _files(run, 6):  # the resumed run writes them again
        f.unlink()
    best = cli.main(BASE + ["--mode", "train", "--save-interval-steps", "3",
                            "--checkpoint", str(_files(run, 3)[0])])
    assert Path(best) == _files(run, 6)[0]
    assert "Mid-epoch resume: epoch 0 from batch 3" in log_lines
    _assert_same(_load(_files(run, 6)[0]), weights)
    resumed = _load(_files(run, 6)[1])
    _assert_same(resumed, record)
    assert resumed["step"] == 6 and resumed["meta"]["data_epoch"] == 1
    np.testing.assert_array_equal(np.load(run / "train_losses.npy"), losses[3:])


@pytest.mark.parametrize("flag,value", [("--seed", "1"), ("--batch-size", "4")])
def test_mid_epoch_resume_refuses_another_seed_or_batch_geometry(uninterrupted, flag, value):
    run = uninterrupted[0]
    argv = BASE + ["--mode", "train", "--checkpoint", str(_files(run, 3)[0])]
    argv[argv.index(flag) + 1] = value
    with pytest.raises(ValueError, match="mid-epoch resume"):
        cli.main(argv)


def test_retention_keeps_the_last_k_and_the_best(tmp_path):
    model = torch.nn.Linear(3, 2)
    state = TrainState(model, build_optimizer("adam", model.parameters()))
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    geometry = dict(seed=0, steps_per_epoch=10, batch_size=4)
    for step in range(1, 7):
        val = {2: 0.5, 4: 0.7}.get(step)  # step 2 is the best
        mgr.save(step, state, epoch=0, data_epoch=0, data_batch_offset=step, val_loss=val,
                 **geometry)
    assert mgr.all_steps() == [2, 5, 6] and mgr.best_step == 2
    again = CheckpointManager(str(tmp_path), keep_last=2)  # best.json survives
    again.save(7, state, epoch=0, data_epoch=0, data_batch_offset=7, **geometry)
    assert again.all_steps() == [2, 6, 7] and again.latest_step() == 7
    assert sorted(os.listdir(tmp_path)) == [
        "best.json", "model_2.pt", "model_6.pt", "model_7.pt",
        "state_2.pt", "state_6.pt", "state_7.pt"]


def test_a_jax_train_state_resumes_at_its_position(tmp_path, log_lines):
    seist_tpu.load_all()
    jm, variables, _ = model_pair(MODEL, 256, seed=3)
    jstate = create_train_state(jm, variables, j_build_optimizer("adam", 1e-3))
    rng = np.random.default_rng(5)
    adam = jstate.opt_state[0]
    moments = {
        slot: jax.tree.map(lambda p: rng.uniform(0, 1e-3, p.shape).astype(np.float32),
                           jstate.params)
        for slot in ("mu", "nu")
    }
    jstate = jstate.replace(opt_state=(adam._replace(count=np.int32(5), **moments),)
                            + tuple(jstate.opt_state[1:]))
    meta = {"epoch": 0, "loss": 0.6, "step": 5, "data_epoch": 0, "data_batch_offset": 3,
            "total_batches": 3, "seed": 0, "steps_per_epoch": 6, "batch_size": 8}
    run = tmp_path / "run"
    path = save_torch_train_state(jax.device_get(jstate), meta, str(run), 3, model_name=MODEL)
    assert Path(path) == _files(run, 3)[0]

    model = tapi.create_model(MODEL, in_samples=256)
    state = TrainState(model, build_optimizer("adam", model.parameters()))
    record = load_checkpoint(path, state)
    assert state.step == 5 and record["meta"] == meta
    _assert_same(model.state_dict(), state_dict_from_flax(jax.device_get(variables)))
    names = [n for n, _ in model.named_parameters()]
    opt = state.optimizer.state_dict()["state"]
    want_mu = state_dict_from_flax({"params": moments["mu"]})
    assert torch.equal(opt[names.index("stem0.conv0.in_proj.weight")]["exp_avg"],
                       want_mu["stem0.conv0.in_proj.weight"])

    best = cli.main(BASE + ["--mode", "train", "--checkpoint", path])
    assert "Mid-epoch resume: epoch 0 from batch 3" in log_lines
    assert _load(_files(run, 6)[1])["step"] == 8 and Path(best) == _files(run, 6)[0]


def _poison(monkeypatch, bad_calls):
    """Make the train step see NaN inputs at the given calls."""
    real = tworker.make_train_step

    def make(*a, **kw):
        step, calls = real(*a, **kw), itertools.count()

        def run(state, inputs, targets, rng):
            if next(calls) in bad_calls:
                inputs = inputs * float("nan")
            return step(state, inputs, targets, rng)

        return run

    monkeypatch.setattr(tworker, "make_train_step", make)


# 40 events: 32 train (64 with augmentation) -> 8 batches of 8.
ROLLBACK = [a if a != "30" else "40" for a in BASE] + ["--mode", "train", "--log-base"]


def test_three_non_finite_batches_roll_back_to_the_last_save(monkeypatch, tmp_path, log_lines):
    # Saves at 4 and 8; steps 1-3 are skipped. The guard's verdicts are read
    # two calls late, as the JAX worker reads them, so the third skip is
    # seen after step 5: the run rolls back to step 4's save (one applied
    # update), dropping the updates of steps 4 and 5; steps 6 and 7 apply.
    _poison(monkeypatch, {1, 2, 3})
    best = cli.main(ROLLBACK + [str(tmp_path), "--save-interval-steps", "4"])
    run = Path(best).parent.parent
    assert "Bad-update guard: 3 consecutive non-finite updates; rolling back to checkpoint step 4" \
        in log_lines
    losses = np.load(run / "train_losses.npy")
    assert np.isfinite(losses[[0, 4, 5, 6, 7]]).all() and not np.isfinite(losses[1:4]).any()
    assert _load(_files(run, 4)[1])["step"] == 1
    assert _load(_files(run, 8)[1])["step"] == 3  # 1 at the save, then steps 6 and 7


def test_non_finite_batches_without_a_save_raise(monkeypatch, tmp_path):
    _poison(monkeypatch, {1, 2, 3})
    with pytest.raises(RuntimeError, match="no checkpoint to roll back to"):
        cli.main(ROLLBACK + [str(tmp_path)])


def test_start_batch_skips_without_assembling(monkeypatch):
    seist_tpu_torch.load_all()
    args = cli.get_args(BASE)
    spec = tworker.taskspec.get_task_spec(MODEL)
    loader = tworker._build_loader(args, spec, "train")
    loader.set_epoch(2)
    full = list(loader)
    fetched = []
    real = pipeline.SeismicDataset.__getitem__
    monkeypatch.setattr(pipeline.SeismicDataset, "__getitem__",
                        lambda self, i: fetched.append(i) or real(self, i))
    loader.set_start_batch(4)
    tail = list(loader)
    assert len(tail) == 2 and len(fetched) == 2 * 8
    for a, b in zip(tail, full[4:]):
        np.testing.assert_array_equal(a.inputs, b.inputs)
    assert len(list(loader)) == 6  # one-shot
    loader.close()


def test_cli_train_test_then_test_reproduces_the_json(tmp_path):
    cmd = [sys.executable, "-m", "seist_tpu_torch", "train", *BASE, "--log-base", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (run,) = tmp_path.iterdir()
    weights = sorted((run / "checkpoints").glob("model_*.pt"))
    assert [w.name for w in weights] == ["model_6.pt"]
    rows = (run / "test_results_synthetic_test.csv").read_text().splitlines()
    assert len(rows) == 1 + 3  # the header and the 3 test events
    first = json.loads((run / "test_metrics_synthetic.json").read_text())
    assert first["model"] == MODEL and set(first["metrics"]) == {"det", "ppk", "spk"}
    assert cli.main(BASE + ["--mode", "test", "--checkpoint", str(weights[0])]) == str(weights[0])
    again = json.loads((run / "test_metrics_synthetic_new.json").read_text())
    assert again == first
