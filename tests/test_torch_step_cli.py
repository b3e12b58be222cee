"""``--steps-per-call`` and ``--grad-accum-steps`` through the port's train
command on the CPU, and the attention seed as a device tensor.

* ``train --device cpu --steps-per-call 2`` and ``--grad-accum-steps 2``
  run ``train_test`` to the end (tests/test_worker_e2e.py:192): the losses
  of each call, the update count, the test metrics; with two batches per
  call the run ends bitwise where the one-step run ends (the randomness of
  an update is keyed by its count, not by its call). A tail of fewer than
  k batches is dropped and logged; the flags exclude each other, and k may
  not exceed the epoch, with the JAX worker's messages.
* The seed of K1 and K2 as an int32 tensor gives the plain outputs of the
  int seed, and a source with a device seed buffer hands out its entries
  in call order.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.ops import pooled_attention as tpa
from seist_tpu_torch.utils.logger import logger

ROOT = Path(__file__).resolve().parent.parent
# 30 events: 24 train (48 with augmentation) -> 6 batches of 8; 3 val, 3 test.
BASE = ["--device", "cpu", "--model-name", "seist_s_dpk", "--dataset-name", "synthetic",
        "--synthetic-events", "30", "--in-samples", "256", "--batch-size", "8",
        "--epochs", "1", "--workers", "2", "--log-step", "1", "--seed", "0"]


@pytest.fixture
def log_lines():
    lines = []

    class _Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = _Lines()
    logger.addHandler(h)
    try:
        yield lines
    finally:
        logger.removeHandler(h)


def _run(tmp_path, name, extra, mode="train"):
    seist_tpu_torch.load_all()
    best = cli.main(BASE + ["--mode", mode, "--log-base", str(tmp_path / name)] + extra)
    run = Path(best).parent.parent
    state = torch.load(run / "checkpoints" / "state_6.pt", map_location="cpu", weights_only=True)
    weights = torch.load(best, map_location="cpu", weights_only=True)
    return run, np.load(run / "train_losses.npy"), state, weights


@pytest.fixture(scope="module")
def one_step_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("single"), "single", [])


@pytest.mark.parametrize("flag,calls,updates,message", [
    ("--steps-per-call", 3, 6, "steps_per_call=2: 2 updates per call"),
    ("--grad-accum-steps", 3, 3, "grad_accum_steps=2: effective batch 16, 3 updates/epoch"),
])
def test_train_test_runs_with_two_batches_per_call(tmp_path, log_lines, one_step_run, flag,
                                                   calls, updates, message):
    run, losses, state, weights = _run(tmp_path, "k2", [flag, "2"], mode="train_test")
    assert message in log_lines
    assert len(losses) == calls and np.isfinite(losses).all()
    assert state["step"] == updates
    with open(run / "test_metrics_synthetic.json") as f:
        assert np.isfinite(json.load(f)["loss"])
    if flag == "--steps-per-call":
        # Six updates in three calls: the one-step run's weights, bitwise.
        _, single_losses, single_state, single_weights = one_step_run
        assert single_state["step"] == 6
        np.testing.assert_array_equal(losses, single_losses.reshape(3, 2).mean(axis=1,
                                                                               dtype=np.float32))
        for k, v in single_weights.items():
            assert torch.equal(weights[k], v), k


def test_a_tail_short_of_a_call_is_dropped_and_logged(tmp_path, log_lines):
    _, losses, state, _ = _run(tmp_path, "k4", ["--steps-per-call", "4"])
    assert "steps_per_call=4 drops 2 trailing batch(es) per epoch (6 steps)" in log_lines
    assert len(losses) == 1 and state["step"] == 4


@pytest.mark.parametrize("extra,match", [
    (["--steps-per-call", "2", "--grad-accum-steps", "2"], "mutually exclusive"),
    (["--grad-accum-steps", "7"], "exceeds steps_per_epoch 6"),
    (["--steps-per-call", "7"], "exceeds steps_per_epoch 6"),
])
def test_call_geometry_errors(tmp_path, extra, match):
    seist_tpu_torch.load_all()
    with pytest.raises(ValueError, match=match):
        cli.main(BASE + ["--mode", "train", "--log-base", str(tmp_path)] + extra)


def test_the_command_line_takes_both_flags(tmp_path):
    for extra in (["--steps-per-call", "2"], ["--grad-accum-steps", "2"]):
        cmd = [sys.executable, "-m", "seist_tpu_torch", "train", *BASE, "--mode", "train",
               "--log-base", str(tmp_path), *extra]
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "not ported" not in proc.stdout + proc.stderr


def _qkvg(seed, n=2, l=40, m=10, h=2, e=8):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g) for s in ((n, l, h, e), (n, m, h, e), (n, m, h, e),
                                                    (n, l, h, e))]


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 2])
def test_a_seed_tensor_gives_the_int_seeds_plain_outputs(seed):
    q, k, v, g = _qkvg(seed % 97)
    s = torch.tensor(seed, dtype=torch.int32)
    o, lse = tpa._forward(q, k, v, 0.3, 0.25, s, True)
    o_p, lse_p = tpa.pooled_attention_plain(q, k, v, 0.3, 0.25, seed, return_lse=True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    got = tpa._backward(q, k, v, g, o, lse, 0.3, 0.25, s)
    want = tpa.pooled_attention_bwd_plain(q, k, v, g, o, lse, 0.3, 0.25, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # Through autograd: the tensor seed and the int seed give the same bits.
    grads = []
    for sd in (s, seed):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tpa.fused_pooled_attention(*leaves, 0.3, dropout_rate=0.25, dropout_seed=sd)
        grads.append([out] + list(torch.autograd.grad(out, leaves, g)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_a_seed_must_be_one_int32_on_qs_device():
    for bad in (torch.tensor(3, dtype=torch.int64), torch.tensor([1, 2], dtype=torch.int32)):
        with pytest.raises(ValueError, match="one int32"):
            tpa.seed_tensor(bad, "cpu")
    assert tpa.seed_tensor(5, "cpu").dtype == torch.int32


def test_a_seed_buffer_is_read_in_call_order():
    src = RandomSource.from_seed(3, "cpu")
    ref = RandomSource.from_seed(3, "cpu")
    draws = [src.attention_seed("cpu") for _ in range(3)]  # no buffer: drawn, then filled
    assert [int(d) for d in draws] == [ref.draw_attention_seed() for _ in range(3)]
    assert all(d.dtype == torch.int32 and d.dim() == 0 for d in draws)
    buf = RandomSource(seed_generator=None)
    buf.attention_seeds = torch.tensor([7, 8], dtype=torch.int32)
    assert [int(buf.attention_seed("cpu")) for _ in range(2)] == [7, 8]
    assert buf.attention_calls == 2
    with pytest.raises(RuntimeError, match="seed buffer holds 2"):
        buf.attention_seed("cpu")
