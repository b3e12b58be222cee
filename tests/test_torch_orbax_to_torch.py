"""``tools/orbax_to_torch.py``: a JAX package train checkpoint (orbax,
written here by its ``TrainCheckpointManager`` after two real Adam steps)
into the port's ``model_<step>.pt`` + ``state_<step>.pt``, from which the
port resumes at the checkpoint's data position and update count.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import logging
import sys
from pathlib import Path

import jax
import numpy as np
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.train.checkpoint import TrainCheckpointManager
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.train.checkpoint import load_checkpoint
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.step import TrainState
from seist_tpu_torch.utils.logger import logger

from _torch_parity import model_pair

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import orbax_to_torch  # noqa: E402  (tools/orbax_to_torch.py)

MODEL = "seist_s_dpk"
# tests/test_torch_resume.py's run: 30 events -> 6 batches of 8 a epoch.
BASE = ["--device", "cpu", "--model-name", MODEL, "--dataset-name", "synthetic",
        "--synthetic-events", "30", "--in-samples", "256", "--batch-size", "8",
        "--epochs", "1", "--workers", "2", "--log-step", "100", "--seed", "0",
        "--use-tensorboard", "false"]


def test_an_orbax_train_checkpoint_resumes_in_the_port(tmp_path):
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jm, variables, _ = model_pair(MODEL, 256, seed=3)
    jstate = create_train_state(jm, variables, j_build_optimizer("adam", lambda c: 1e-3))
    step = jax.jit(j_make_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL)))
    rng = np.random.default_rng(0)
    for i in range(2):  # real Adam moments and a count of 2
        x = rng.standard_normal((2, 256, 3)).astype(np.float32)
        y = rng.uniform(0, 1, (2, 256, 3)).astype(np.float32)
        jstate, *_ = step(jstate, x, y, jax.random.PRNGKey(i))
    run = tmp_path / "run"
    mgr = TrainCheckpointManager(str(run / "checkpoints"))
    orbax_path = mgr.save(2, jstate, epoch=0, data_epoch=0, data_batch_offset=2, loss=0.7,
                          seed=0, steps_per_epoch=6, batch_size=8, wait=True)
    mgr.close()

    weights = orbax_to_torch.main(["--checkpoint", orbax_path, "--model-name", MODEL,
                                   "--in-samples", "256"])
    assert Path(weights) == run / "checkpoints" / "model_2.pt"
    assert (run / "checkpoints" / "state_2.pt").exists()

    model = tapi.create_model(MODEL, in_samples=256)
    state = TrainState(model, build_optimizer("adam", model.parameters()))
    record = load_checkpoint(weights, state)
    assert not record["weights_only"] and state.step == 2
    assert record["meta"]["data_batch_offset"] == 2 and record["meta"]["batch_size"] == 8
    host = jax.device_get(jstate)
    want = state_dict_from_flax({"params": host.params, "batch_stats": host.batch_stats})
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    names = [n for n, _ in model.named_parameters()]
    mu = state_dict_from_flax({"params": host.opt_state[0].mu})
    opt = state.optimizer.state_dict()["state"]
    k = "stage1_block0.proj0.weight"
    assert torch.equal(opt[names.index(k)]["exp_avg"], mu[k])
    assert float(opt[names.index(k)]["step"]) == 2

    lines = []

    class _Lines(logging.Handler):
        def emit(self, r):
            lines.append(r.getMessage())

    h = _Lines()
    logger.addHandler(h)
    try:
        cli.main(BASE + ["--mode", "train", "--checkpoint", weights])
    finally:
        logger.removeHandler(h)
    assert "Mid-epoch resume: epoch 0 from batch 2" in lines
    record = torch.load(run / "checkpoints" / "state_6.pt", weights_only=True)
    assert record["step"] == 6
