"""The port's training trajectory against the JAX package's over 48 steps
(the north star's loss-curve convention, ``tools/train_dynamics.py``), on
the CPU.

Lanes ``phasenet`` and ``seist_s_dpk`` at window 256 (the tool's 512 cut
to fit the file's time), every drop rate 0, the reference's cyclic
schedule: the same initial weights (the JAX variables through
``state_dict_from_flax``), the same batches
(``tools/train_dynamics.py::make_data``) in the same order, the JAX side
through the JAX package's own jitted train and eval steps. Recorded: the
per-step train loss (before each update) and the per-epoch val loss (eval
mode, on BatchNorm's running statistics), relative to the loss.

* Under SGD both curves stay within the north star's 1e-4 over all 48
  steps: the model, the loss, BatchNorm's momentum and the schedule agree.
* Under Adam (the tool's optimizer) the curves are held to the JAX
  package's own Adam-trajectory limits (``tests/test_train_dynamics.py``:
  step 0 rtol 1e-5, the first quarter 1e-3, every step and the val loss
  5e-3), not to 1e-4: Adam divides each gradient by its own magnitude, so
  a coordinate whose gradient is float32 noise near its epsilon (PhaseNet's
  ``conv_in.bias``, ahead of a BatchNorm: 2e-8, the two sides 47% apart)
  moves by a learning-rate-sized step of either sign, and the curves part
  by 1e-4 to 1e-3 within 48 steps though the first step's gradients agree
  within 6e-6 of each leaf's largest and the two updates agree to one ulp
  on the same gradients.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.models import api as japi
from seist_tpu.train import (
    build_cyclic_schedule,
    build_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
)

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.train import optim as toptim
from seist_tpu_torch.train import schedule as tsched
from seist_tpu_torch.train.step import TrainState
from seist_tpu_torch.train.step import make_eval_step as t_make_eval_step
from seist_tpu_torch.train.step import make_train_step as t_make_train_step
from seist_tpu_torch.train.step import step_random_source

from _torch_parity import random_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools import train_dynamics as dyn  # noqa: E402  (the JAX package's harness)

TOL = 1e-4  # the north star's loss-curve limit over 48 steps (SGD)
#: Adam: tests/test_train_dynamics.py's (step 0, first quarter, every step, val).
ADAM_TOL = (1e-5, 1e-3, 5e-3, 5e-3)
#: tools/train_dynamics.py's CFG (48 steps: 6 epochs of 8) at window 256 and batch 4.
WINDOW = 256
BATCH = 4  # the tool's 8, cut to fit the file's time


def _cfg(model: str) -> dict:
    return dyn.lane_cfg(model, dict(dyn.CFG, model=model, in_samples=WINDOW, batch=BATCH))


def _data(cfg):
    """(train x, y), (val x, y), channels-last, as both sides train on them."""
    (xt, yt), (xv, yv), _ = dyn.make_data(cfg)
    return ((xt.transpose(0, 2, 1).copy(), yt.transpose(0, 2, 1).copy()),
            (xv.transpose(0, 2, 1).copy(), yv.transpose(0, 2, 1).copy()))


def _schedule_args(cfg):
    total = cfg["epochs"] * cfg["steps_per_epoch"]
    return (cfg["base_lr"], cfg["max_lr"]), dict(total_steps=total,
                                                warmup_steps=cfg["warmup_steps"],
                                                down_steps=cfg["down_steps"])


def _jax_run(model, variables, cfg, train, val, opt):
    jm = japi.create_model(model, in_channels=3, in_samples=WINDOW,
                           **dyn.MODELS[model]["zero_drop_kwargs"])
    lrs, kw = _schedule_args(cfg)
    state = create_train_state(jm, variables,
                               build_optimizer(opt, build_cyclic_schedule(*lrs, **kw)))
    spec, loss_fn = jts.get_task_spec(model), jts.make_loss(model)
    step = jax.jit(make_train_step(spec, loss_fn))
    evaluate = jax.jit(make_eval_step(spec, loss_fn))
    (xt, yt), (xv, yv) = train, val
    b, rng = cfg["batch"], jax.random.PRNGKey(0)
    vmask = jnp.ones((xv.shape[0],), jnp.float32)
    losses, vlosses = [], []
    for _ in range(cfg["epochs"]):
        for s in range(cfg["steps_per_epoch"]):
            state, loss, _ = step(state, jnp.asarray(xt[s * b:(s + 1) * b]),
                                  jnp.asarray(yt[s * b:(s + 1) * b]), rng)
            losses.append(float(loss))
        vlosses.append(float(evaluate(state, jnp.asarray(xv), jnp.asarray(yv), vmask)[0]))
    return np.asarray(losses), np.asarray(vlosses)


def _port_run(model, variables, cfg, train, val, opt):
    tm = tapi.create_model(model, in_samples=WINDOW, **dyn.MODELS[model]["zero_drop_kwargs"])
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    lrs, kw = _schedule_args(cfg)
    state = TrainState(tm, toptim.build_optimizer(opt, tm.parameters()),
                       tsched.build_cyclic_schedule(*lrs, **kw))
    loss_fn = tts.make_loss(model)
    step, evaluate = t_make_train_step(loss_fn), t_make_eval_step(loss_fn)
    (xt, yt), (xv, yv) = (tuple(torch.from_numpy(a) for a in pair) for pair in (train, val))
    b = cfg["batch"]
    losses, vlosses = [], []
    for epoch in range(cfg["epochs"]):
        for s in range(cfg["steps_per_epoch"]):
            loss, _, _ = step(state, xt[s * b:(s + 1) * b], yt[s * b:(s + 1) * b],
                              step_random_source(0, epoch, s, "cpu"))
            losses.append(float(loss))
        with torch.no_grad():
            vlosses.append(float(evaluate(state, xv, yv, torch.ones(xv.shape[0]))[0]))
    return np.asarray(losses), np.asarray(vlosses)


@pytest.fixture(scope="module", params=["phasenet", "seist_s_dpk"])
def trajectories(request):
    """{optimizer: (port (train, val), JAX (train, val))} of one lane."""
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    model = request.param
    cfg = _cfg(model)
    jm = japi.create_model(model, in_channels=3, in_samples=WINDOW,
                           **dyn.MODELS[model]["zero_drop_kwargs"])
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW),
                                      seed=cfg["init_seed"])
    train, val = _data(cfg)
    opts = ("sgd", "adam")
    # The JAX runs (mostly XLA's compiles of the two steps) on threads of
    # their own, beside the port's.
    with ThreadPoolExecutor(len(opts)) as pool:
        jax_runs = [pool.submit(_jax_run, model, variables, cfg, train, val, o) for o in opts]
        port_runs = [_port_run(model, variables, cfg, train, val, o) for o in opts]
        return model, {o: (p, j.result()) for o, p, j in zip(opts, port_runs, jax_runs)}


def _rel(got, want):
    return np.abs(got - want) / np.abs(want)


def test_sgd_trajectory_within_the_north_stars_limit(trajectories):
    model, runs = trajectories
    (port, port_val), (jax_losses, jax_val) = runs["sgd"]
    assert port.shape == jax_losses.shape == (48,) and port_val.shape == jax_val.shape == (6,)
    assert _rel(port, jax_losses).max() <= TOL, (model, _rel(port, jax_losses).max())
    assert _rel(port_val, jax_val).max() <= TOL, (model, _rel(port_val, jax_val).max())


def test_adam_trajectory_within_the_jax_packages_limits(trajectories):
    model, runs = trajectories
    (port, port_val), (jax_losses, jax_val) = runs["adam"]
    first, early, full, val = ADAM_TOL
    rel = _rel(port, jax_losses)
    assert port.shape == jax_losses.shape == (48,) and port_val.shape == jax_val.shape == (6,)
    assert rel[0] <= first and rel[:12].max() <= early and rel.max() <= full, (model, rel)
    assert _rel(port_val, jax_val).max() <= val, (model, _rel(port_val, jax_val))
    assert port[-8:].mean() < port[:8].mean() and jax_losses[-8:].mean() < jax_losses[:8].mean()
