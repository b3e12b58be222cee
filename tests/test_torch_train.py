"""The port's guarded train step against the JAX package's, on the CPU.

A small SeisT (``seist_s_dpk``, window 256, batch 2) with the same seeded
variables on both sides (tests/_torch_parity.py), element dropout at 0 and
DropPath fed the same injected uniforms (each row drops one of the two
samples, so every DropPath call acts). The JAX side is one jitted guarded
train step (compiled once for the module) whose optimizer is Adam chained
behind a transform that keeps the gradients in the optimizer state, so the
same program yields the gradients to compare.

Limits, the repo's train-mode parity conventions
(tests/test_golden_parity.py): loss rtol 1e-5; each gradient leaf at
cosine >= 0.9999 and max error <= 5e-3 of its max, the leaves that are zero
by construction (``SeismogramTransformer.zero_grad_parameters``) exempted
by name and asserted below 1e-6 of the largest gradient, and a pair that
is exactly zero on both sides (DropPath cut every path) skipped; BatchNorm running
statistics rtol 1e-4, atol 1e-5; Adam's moments after an update leaf by
leaf like the gradients they average. The updated parameters are not
compared element by element: Adam's first updates move each element by
about lr * sign(g), which flips where an element's gradient is at fp32
noise level.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.models import api as japi
from seist_tpu.models import common as jc
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.models.convert import state_dict_from_flax, train_state_from_optax
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.schedule import constant
from seist_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

from _torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parent.parent
MODEL, WINDOW, BATCH, LR = "seist_s_dpk", 256, 2, 1e-3
DROPS = dict(attn_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0, other_drop_rate=0.0)


def _keep_grads() -> optax.GradientTransformation:
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


@pytest.fixture(scope="module")
def jax_side():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jm = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **DROPS)
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW), seed=0)
    tx = optax.chain(_keep_grads(), j_build_optimizer("adam", LR))
    state = create_train_state(jm, variables, tx)
    step = j_make_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL), guard=True)

    def run(st, x, y, u):
        with jc.droppath_mask_injection(u):
            return step(st, x, y, jax.random.PRNGKey(0))

    return variables, state, jax.jit(run)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, WINDOW, 3)).astype(np.float32)
    y = rng.uniform(0.0, 1.0, (BATCH, WINDOW, 3)).astype(np.float32)
    u = np.zeros((64, BATCH), np.float32)
    u[:, 0] = np.where(np.arange(64) % 2 == 0, 0.999, 0.0)  # drop sample 0 ...
    u[:, 1] = np.where(np.arange(64) % 2 == 0, 0.0, 0.999)  # ... or sample 1
    return x, y, np.roll(u, seed, axis=0)


def _torch_state(variables):
    tm = tapi.create_model(MODEL, in_samples=WINDOW, **DROPS)
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    return TrainState(tm, build_optimizer("adam", tm.parameters()), constant(LR))


def _torch_step(state, x, y, u):
    rng = RandomSource()
    rng.inject_droppath(u)
    step = make_train_step(tts.make_loss(MODEL), guard=True)
    loss, out, diag = step(state, torch.from_numpy(x), torch.from_numpy(y), rng)
    return loss, diag, rng.droppath_calls


def _as_torch(tree):
    return state_dict_from_flax({"params": jax.device_get(tree)})


def _compare_grads(model, got, want):
    zero = set(model.zero_grad_parameters())
    gscale = max(float(w.abs().max()) for w in want.values())
    checked = 0
    for k, w in want.items():
        g = got[k].detach()
        if k in zero:
            assert max(float(g.abs().max()), float(w.abs().max())) < 1e-6 * gscale, k
            continue
        g, w = g.double().ravel(), w.double().ravel()
        if float(g.abs().max()) < 1e-20 and float(w.abs().max()) < 1e-20:
            continue  # exactly zero on both sides: DropPath cut every path this step
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.9999, f"{k}: grad cosine {cos}"
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel <= 5e-3, f"{k}: rel grad err {rel}"
        checked += 1
    assert checked > 100 and zero


def _compare_stats(model, batch_stats):
    sd = model.state_dict()
    for k, v in state_dict_from_flax({"batch_stats": jax.device_get(batch_stats)}).items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-5, msg=k)


def test_guarded_train_step_matches_jax(jax_side):
    variables, jstate, jrun = jax_side
    x, y, u = _batch(0)
    new, jloss, _, jdiag = jrun(jstate, x, y, u)
    state = _torch_state(variables)
    loss, diag, calls = _torch_step(state, x, y, u)
    assert calls > 0 and diag["applied"] and int(jdiag["applied"]) == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    model = state.model
    _compare_grads(model, {k: p.grad for k, p in model.named_parameters()},
                   _as_torch(new.opt_state[0]))
    _compare_stats(model, new.batch_stats)
    assert state.step == int(new.step) == 1


def test_train_state_from_optax_continues_like_jax(jax_side):
    """Two JAX steps, carried across, then one more step on both sides."""
    variables, jstate, jrun = jax_side
    for seed in (1, 2):
        x, y, u = _batch(seed)
        jstate, *_ = jrun(jstate, x, y, u)
    adam = jstate.opt_state[1][0]
    state = _torch_state(variables)  # the initial weights, overwritten below
    state.step = train_state_from_optax(
        state.model, state.optimizer,
        jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}),
        jax.device_get(adam.mu), jax.device_get(adam.nu), int(adam.count))
    assert state.step == int(jstate.step) == 2
    model = state.model
    names = [k for k, _ in model.named_parameters()]
    carried = {**_as_torch(jstate.params),
               **state_dict_from_flax({"batch_stats": jax.device_get(jstate.batch_stats)})}
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, carried[k], rtol=0, atol=0, msg=k)
    opt_state = state.optimizer.state_dict()["state"]
    for tree, slot in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        for k, v in _as_torch(tree).items():
            torch.testing.assert_close(opt_state[names.index(k)][slot], v, rtol=0, atol=0)

    x, y, u = _batch(3)
    new, jloss, _, _ = jrun(jstate, x, y, u)
    loss, diag, _ = _torch_step(state, x, y, u)
    assert diag["applied"]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _compare_grads(model, {k: p.grad for k, p in model.named_parameters()},
                   _as_torch(new.opt_state[0]))
    _compare_stats(model, new.batch_stats)
    opt_state = state.optimizer.state_dict()["state"]
    new_adam = new.opt_state[1][0]
    for tree, slot in ((new_adam.mu, "exp_avg"), (new_adam.nu, "exp_avg_sq")):
        _compare_grads(model, {k: opt_state[names.index(k)][slot] for k in names},
                       _as_torch(tree))
    assert float(opt_state[0]["step"]) == int(new_adam.count) == 3


def test_nan_batch_is_skipped_with_state_unchanged(jax_side):
    variables, jstate, jrun = jax_side
    x, y, u = _batch(4)
    x[1, 10, 0] = np.nan
    new, jloss, _, jdiag = jrun(jstate, x, y, u)
    assert not np.isfinite(float(jloss)) and int(jdiag["applied"]) == 0
    assert int(new.step) == int(jstate.step)

    state = _torch_state(variables)
    loss, _, _ = _torch_step(state, *_batch(5))  # one real update first: moments exist
    model, opt = state.model, state.optimizer
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {i: {s: t.clone() for s, t in st.items()}
               for i, st in opt.state_dict()["state"].items()}
    loss, diag, _ = _torch_step(state, x, y, u)
    assert not torch.isfinite(loss) and not diag["applied"]
    assert state.step == 1
    for k, v in model.state_dict().items():  # parameters and BatchNorm stats
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    for i, st in opt.state_dict()["state"].items():
        for s, t in st.items():
            torch.testing.assert_close(t, moments[i][s], rtol=0, atol=0)


def test_eval_step_recombines_per_sample_losses_like_jax(jax_side):
    variables, _, _ = jax_side
    state = _torch_state(variables)
    x, y, _ = _batch(6)
    mask = np.array([1.0, 0.0], np.float32)
    loss_fn = tts.make_loss(MODEL)
    loss, out = make_eval_step(loss_fn)(state, torch.from_numpy(x), torch.from_numpy(y),
                                        torch.from_numpy(mask))
    # The JAX eval step's recombination (seist_tpu/train/step.py:547-555)
    # on the same outputs: the mask-weighted mean of per-sample losses.
    jloss_fn = jts.make_loss(MODEL)
    per = jax.vmap(lambda o, t: jloss_fn(o[None], t[None]))(out.numpy(), y)
    want = float((per * mask).sum() / max(mask.sum(), 1.0))
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    assert not state.model.training


def test_use_checkpoint_and_unported_flags_raise():
    seist_tpu_torch.load_all()
    # Ported (tests/test_torch_remat.py): a model config field, as in the JAX package.
    assert tapi.create_model(MODEL, in_samples=WINDOW, use_checkpoint=True).cfg.use_checkpoint
    base = ["--dataset-name", "synthetic"]
    # Ported in the slice of several ranks (tests/test_torch_parallel.py):
    # accepted as given, the mesh checks it against the ranks at run time.
    assert cli.get_args(base + ["--seq-shards", "2"]).seq_shards == 2
    # Ported in the slice of device augmentation: the JAX CLI's flags,
    # names, choices and defaults.
    args = cli.get_args(base)
    assert (args.device_aug, args.device_aug_hbm_gb, args.ingest) == ("off", 0.0, "auto")
    for mode in ("step", "cached"):
        args = cli.get_args(base + ["--device-aug", mode, "--device-aug-hbm-gb", "2.5",
                                    "--ingest", "direct"])
        assert (args.device_aug, args.device_aug_hbm_gb, args.ingest) == (mode, 2.5, "direct")
    with pytest.raises(SystemExit):
        cli.get_args(base + ["--ingest", "bogus"])
    # Ported in the slice of the captured step: accepted as given.
    args = cli.get_args(base + ["--grad-accum-steps", "2"])
    assert (args.grad_accum_steps, args.steps_per_call) == (2, 0)
    assert cli.get_args(base + ["--steps-per-call", "4"]).steps_per_call == 4
    with pytest.raises(ValueError, match="train_test"):
        cli.get_args(base + ["--mode", "serve"])
    with pytest.raises(NotImplementedError, match="dataset-name.*tools.pack_dataset"):
        cli.get_args([])  # the JAX CLI's default dataset is HDF5: read as a pack
    args = cli.get_args(["--dataset-name", "packed", "--loader-processes", "2",
                         "--mixture-temperature", "1.0"])
    assert (args.loader_processes, args.mixture_temperature) == (2, 1.0)
    assert cli.get_args(base + ["--steps-per-call", "1"]).device == "cuda"


def test_cli_trains_two_steps_on_cpu_and_serve_loads_the_checkpoint(tmp_path):
    from seist_tpu_torch.serve.pool import load_model_entry

    cmd = [sys.executable, "-m", "seist_tpu_torch", "train", "--device", "cpu",
           "--model-name", MODEL, "--dataset-name", "synthetic", "--synthetic-events", "20",
           "--in-samples", str(WINDOW), "--batch-size", "8", "--steps", "2",
           "--augmentation", "false", "--workers", "2", "--log-step", "1",
           "--log-base", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (run,) = tmp_path.iterdir()
    losses = np.load(run / "train_losses.npy")
    assert losses.shape == (2,) and np.isfinite(losses).all()
    (ckpt,) = (run / "checkpoints").glob("model_*.pt")
    assert ckpt.name == "model_2.pt"
    entry = load_model_entry(MODEL, str(ckpt), window=WINDOW, device="cpu")
    out = entry.run(np.zeros((1, WINDOW, 3), np.float32))
    assert out.shape == (1, WINDOW, 3) and torch.isfinite(out).all()
