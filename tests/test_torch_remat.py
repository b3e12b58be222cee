"""``use_checkpoint`` (per-stage rematerialisation) on the CPU.

* The port with remat against the port without, every drop rate on
  (``seist_s_dpk``'s own: DropPath, MLP, key and output-projection
  dropout, attention dropout): the stage tape replays the forward's draws
  in the backward's recompute, so the loss, every gradient and the
  BatchNorm statistics are bitwise equal, the attention draws as many
  seeds, the recompute runs the attention again, and BatchNorm updates its
  statistics once. With injected DropPath rows, as many rows are used.
* The port with remat against the JAX package's ``nn.remat``
  (``seist_tpu/models/seist.py:888``), element dropouts at rate 0 and
  DropPath on through injected rows (``common.droppath_mask_injection``):
  one guarded Adam step, loss within 1e-5 and the gradients and statistics
  within tests/test_torch_train.py's limits.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
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
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models import common
from seist_tpu_torch.models.common import RandomSource, set_random_source
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.schedule import constant
from seist_tpu_torch.train.step import TrainState, make_train_step

from _torch_parity import random_flax_variables
from test_torch_train import _as_torch, _batch, _compare_grads, _compare_stats, _keep_grads

MODEL, WINDOW, BATCH, LR = "seist_s_dpk", 256, 2, 1e-3
DROPS = dict(attn_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0, other_drop_rate=0.0)


def _port_run(use_checkpoint, x, inject=None):
    """One train-mode forward and backward from seeded weights and a seeded
    source: (loss, grads, buffers, attention seeds drawn, DropPath rows
    used, attention calls, tape replays)."""
    seist_tpu_torch.load_all()
    model = tapi.create_model(MODEL, in_samples=WINDOW, seed=1,
                              use_checkpoint=use_checkpoint).train()
    src = RandomSource.from_seed(5, "cpu")
    if inject is not None:
        src.inject_droppath(inject)
    set_random_source(model, src)
    counts = {"attention": 0, "replayed": 0}
    plain, take = pa.pooled_attention_plain, common.StageTape.take

    def counted_plain(*a, **k):
        counts["attention"] += 1
        return plain(*a, **k)

    def counted_take(self, draw):
        counts["replayed"] += self.replaying
        return take(self, draw)

    pa.pooled_attention_plain, common.StageTape.take = counted_plain, counted_take
    try:
        loss = (model(x) - 0.25).square().mean()
        loss.backward()
    finally:
        pa.pooled_attention_plain, common.StageTape.take = plain, take
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    return loss, grads, buffers, src.attention_calls, src.droppath_calls, counts


@pytest.mark.parametrize("inject", [False, True], ids=["drawn", "injected"])
def test_remat_replays_the_forwards_draws(inject):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, WINDOW, 3)).astype(np.float32))
    rows = (torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (64, 4)).astype(np.float32))
            if inject else None)
    loss0, g0, b0, seeds0, rows0, c0 = _port_run(False, x, rows)
    loss1, g1, b1, seeds1, rows1, c1 = _port_run(True, x, rows)
    assert torch.equal(loss0, loss1)
    assert sorted(g0) == sorted(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)  # statistics moved once
    assert seeds0 == seeds1 > 0 and rows0 == rows1 and (rows0 > 0) == inject
    assert c0 == {"attention": seeds0, "replayed": 0}
    assert c1["attention"] == 2 * seeds0 and c1["replayed"] > seeds0


def test_remat_matches_jax_nn_remat():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jm = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, use_checkpoint=True, **DROPS)
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW), seed=0)
    tx = optax.chain(_keep_grads(), j_build_optimizer("adam", LR))
    jstate = create_train_state(jm, variables, tx)
    jstep = j_make_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL), guard=True)

    def run(st, x, y, u):
        with jc.droppath_mask_injection(u):
            return jstep(st, x, y, jax.random.PRNGKey(0))

    x, y, u = _batch(3)
    new, jloss, _, jdiag = jax.jit(run)(jstate, x, y, u)

    tm = tapi.create_model(MODEL, in_samples=WINDOW, use_checkpoint=True, **DROPS)
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    state = TrainState(tm, build_optimizer("adam", tm.parameters()), constant(LR))
    rng = RandomSource()
    rng.inject_droppath(u)
    loss, _, diag = make_train_step(tts.make_loss(MODEL), guard=True)(
        state, torch.from_numpy(x), torch.from_numpy(y), rng)
    assert rng.droppath_calls > 0 and diag["applied"] and int(jdiag["applied"]) == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _compare_grads(tm, {k: p.grad for k, p in tm.named_parameters()},
                   _as_torch(new.opt_state[0]))
    _compare_stats(tm, new.batch_stats)
