"""Fine-tuning from a weights file alone, against the JAX package's
params-only restore, on the CPU.

``seist_tpu/train/checkpoint.py::load_checkpoint`` restores a checkpoint
without optimizer state (``tools/import_pretrained.py`` writes one) into a
train state with a fresh optimizer and meta ``{epoch: -1, loss: inf, step:
0}``; ``seist_tpu/train/worker.py`` then trains from epoch 0, batch 0. The
port does the same with a ``.pt`` that has no ``state_<step>.pt`` beside
it. ``seist_s_dpk`` at window 256, batch 4, every drop rate 0, Adam: three
steps from the same weights on the same batches give losses within 1e-4
(relative) of the JAX package's (tests/test_torch_step_variants.py's
harness). Through the train command, the run starts at epoch 0, step 0,
in the directory named after the weights file, and logs that the file has
no optimizer state; a whole checkpoint pair still resumes
(tests/test_torch_resume.py).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import logging

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.models import api as japi
from seist_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from seist_tpu.train.checkpoint import restore_into_state
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.train import optim as toptim
from seist_tpu_torch.train import schedule as tsched
from seist_tpu_torch.train.checkpoint import load_checkpoint
from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source
from seist_tpu_torch.utils.logger import logger

from _torch_parity import random_flax_variables

MODEL, WINDOW, BATCH, STEPS, LR = "seist_s_dpk", 256, 4, 3, 1e-3
DROPS = dict(attn_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0, other_drop_rate=0.0,
             path_drop_rate=0.0)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jm = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **DROPS)
    variables = jax.device_get(random_flax_variables(
        japi.param_shapes(jm, in_samples=WINDOW), seed=6))
    root = tmp_path_factory.mktemp("finetune")
    orbax_dir = str(root / "imported" / MODEL)
    with ocp.StandardCheckpointer() as saver:  # as tools/import_pretrained.py writes it
        saver.save(orbax_dir, {"params": variables["params"],
                               "batch_stats": variables["batch_stats"],
                               "meta": {"epoch": -1, "loss": float("inf"), "step": 0}},
                   force=True)
    pt = root / f"{MODEL}.pt"
    torch.save(state_dict_from_flax(variables), pt)
    return jm, variables, orbax_dir, str(pt)


def _batches():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((STEPS, BATCH, WINDOW, 3)).astype(np.float32)
    y = rng.uniform(0.0, 1.0, (STEPS, BATCH, WINDOW, 3)).astype(np.float32)
    return x, y


def test_weights_only_fine_tune_matches_the_jax_params_only_restore(weights):
    jm, variables, orbax_dir, pt = weights
    x, y = _batches()

    # JAX: a train state from other weights, then the params-only restore.
    other = jax.device_get(random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW), 7))
    js = create_train_state(jm, other, j_build_optimizer("adam", LR))
    restored = j_load_checkpoint(orbax_dir, js)
    assert restored["meta"]["epoch"] == -1 and int(restored["meta"]["step"]) == 0
    js = restore_into_state(js, restored)
    jstep = jax.jit(j_make_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL),
                                      guard=True))
    jlosses = []
    for i in range(STEPS):
        js, loss, _, _ = jstep(js, x[i], y[i], jax.random.PRNGKey(i))
        jlosses.append(float(loss))

    # The port: a train state from other weights, then the weights file alone.
    model = tapi.create_model(MODEL, in_samples=WINDOW, seed=3, **DROPS)
    state = TrainState(model, toptim.build_optimizer("adam", model.parameters()),
                       tsched.constant(LR))
    record = load_checkpoint(pt, state)
    assert record["weights_only"] and record["meta"] == {"epoch": -1, "loss": float("inf"),
                                                         "step": 0}
    assert record["best_loss"] == float("inf") and state.step == 0
    assert not state.optimizer.state_dict()["state"]  # a fresh optimizer
    step = make_train_step(tts.make_loss(MODEL), guard=True)
    losses = [float(step(state, torch.from_numpy(x[i]), torch.from_numpy(y[i]),
                         step_random_source(0, 0, i, "cpu"))[0]) for i in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state.step == int(js.step) == STEPS


def test_the_train_command_fine_tunes_from_step_zero(weights, tmp_path):
    _, _, _, pt = weights
    seist_tpu_torch.load_all()
    lines = []

    class _Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = _Lines()
    logger.addHandler(handler)
    try:
        best = cli.main(["--device", "cpu", "--mode", "train", "--checkpoint", pt,
                         "--model-name", MODEL, "--dataset-name", "synthetic",
                         "--synthetic-events", "20", "--in-samples", str(WINDOW),
                         "--batch-size", "8", "--steps", "2", "--augmentation", "false",
                         "--workers", "2", "--use-tensorboard", "false",
                         "--log-base", str(tmp_path)])
    finally:
        logger.removeHandler(handler)
    run = pt[: -len(".pt")]
    assert best == f"{run}/checkpoints/model_2.pt"
    assert any(f"Checkpoint {pt} has no optimizer state; loading params only" in x
               for x in lines), lines
    assert any(x.startswith(f"Resumed from {pt} (epoch 0, batch offset 0, loss inf, "
                            "update step 0)") for x in lines), lines
    record = torch.load(f"{run}/checkpoints/state_2.pt", weights_only=True)
    assert record["step"] == 2 and record["meta"]["epoch"] == 0
    losses = np.load(f"{run}/train_losses.npy")
    assert losses.shape == (2,) and np.isfinite(losses).all()
