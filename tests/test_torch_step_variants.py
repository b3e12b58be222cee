"""The port's step variants against the JAX package's, on the CPU.

``seist_s_dpk`` at window 256, batch 4, every drop rate 0, the same seeded
variables on both sides (tests/_torch_parity.py). The JAX optimizer is
chained behind a transform that keeps the (last or mean) gradients in its
state, so the same program yields the gradients to compare. Limits, as in
tests/test_torch_train.py: loss rtol 1e-5; gradient leaves and Adam's
moments at cosine >= 0.9999 and max error <= 5e-3 of their max (the
leaves zero by construction exempted below 1e-6 of the largest); BatchNorm
statistics rtol 1e-4, atol 1e-5; parameters after SGD updates (linear in
the gradients, as tests/test_train.py compares scanned steps) rtol 1e-4,
atol 1e-5. What the port computes the same way on both of its paths is
held bitwise: a skipped update leaves every byte of the state.

* the sync-free guarded step (``make_train_step``) on a clean batch and on
  a NaN batch (tests/test_faults.py:167, :196);
* ``make_multi_train_step``: k = 3 with the middle batch NaN, against three
  single steps and against the JAX package's scanned step, with the
  ordered applied mask (tests/test_train.py:98, test_faults.py:209);
* ``make_accum_train_step``: one update from two micro-batches, clean and
  with a NaN micro-batch (tests/test_train.py:402, :471,
  test_faults.py:230);
* the tensor form of the schedules equal to the float form bit for bit;
* the optimizer's skipped update, and a state loaded in place;
* the randomness of a micro-batch: (seed, epoch, step, index).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.models import api as japi
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import make_accum_train_step as j_make_accum_train_step
from seist_tpu.train.step import make_multi_train_step as j_make_multi_train_step
from seist_tpu.train.step import make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.train import optim as toptim
from seist_tpu_torch.train import schedule as tsched
from seist_tpu_torch.train.step import (
    TrainState,
    make_accum_train_step,
    make_multi_train_step,
    make_train_step,
    step_random_source,
)

from _torch_parity import random_flax_variables

MODEL, WINDOW, BATCH = "seist_s_dpk", 256, 4
DROPS = dict(attn_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0, other_drop_rate=0.0,
             path_drop_rate=0.0)
LR = {"adam": 1e-3, "sgd": 1e-2}


def _keep_grads() -> optax.GradientTransformation:
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


@pytest.fixture(scope="module")
def setup():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jm = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **DROPS)
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW), seed=0)

    def jax_state(opt):
        tx = optax.chain(_keep_grads(), j_build_optimizer(opt, LR[opt]))
        return create_train_state(jm, variables, tx)

    return variables, jax_state


def _batches(seed, k):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, BATCH, WINDOW, 3)).astype(np.float32)
    y = rng.uniform(0.0, 1.0, (k, BATCH, WINDOW, 3)).astype(np.float32)
    return x, y


def _torch_state(variables, opt):
    tm = tapi.create_model(MODEL, in_samples=WINDOW, **DROPS)
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    return TrainState(tm, toptim.build_optimizer(opt, tm.parameters()),
                      tsched.constant(LR[opt]))


def _rngs(k, step=0):
    return [step_random_source(0, 0, step + j, "cpu") for j in range(k)]


def _as_torch(tree):
    return state_dict_from_flax({"params": jax.device_get(tree)})


def _compare_leaves(model, got, want):
    """Gradient-like leaves: cosine and max error against their max. With
    every drop rate 0, more leaves are zero in exact arithmetic than
    ``zero_grad_parameters`` lists for the rates it is built with (no
    DropPath scales a per-channel shift before a BatchNorm removes it):
    a leaf below 1e-6 of the largest on both sides is such rounding
    noise, held to that bar as the listed ones are."""
    zero = set(model.zero_grad_parameters())
    gscale = max(float(w.abs().max()) for w in want.values())
    checked = 0
    for k, w in want.items():
        g = got[k].detach()
        noise = max(float(g.abs().max()), float(w.abs().max())) < 1e-6 * gscale
        if k in zero or noise:
            assert noise, k
            continue
        checked += 1
        g, w = g.double().ravel(), w.double().ravel()
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.9999, f"{k}: cosine {cos}"
        assert float((g - w).abs().max() / w.abs().max()) <= 5e-3, k
    assert checked > 100


def _compare_stats(model, batch_stats):
    sd = model.state_dict()
    for k, v in state_dict_from_flax({"batch_stats": jax.device_get(batch_stats)}).items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-5, msg=k)


def _compare_params(model, params):
    sd = model.state_dict()
    for k, v in _as_torch(params).items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-5, msg=k)


def _snapshot(state):
    opt = state.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {s: t.clone() for s, t in st.items()} for i, st in opt.items()},
            int(state.count))


def _assert_unchanged(state, snap):
    params, moments, count = snap
    for k, v in state.model.state_dict().items():  # parameters and BatchNorm statistics
        assert torch.equal(v, params[k]), k
    for i, st in state.optimizer.state_dict()["state"].items():
        for s, t in st.items():
            assert torch.equal(t, moments[i][s]), (i, s)
    assert int(state.count) == count


@pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
def test_guarded_step_matches_jax(setup, nan):
    variables, jax_state = setup
    x, y = _batches(1, 1)
    x, y = x[0], y[0]
    jstep = jax.jit(j_make_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL),
                                      guard=True))
    js = jax_state("adam")
    state = _torch_state(variables, "adam")
    step = make_train_step(tts.make_loss(MODEL), guard=True)
    if nan:  # one real update first, so the moments and counters are not zero
        js, *_ = jstep(js, x, y, jax.random.PRNGKey(0))
        step(state, torch.from_numpy(x), torch.from_numpy(y), _rngs(1)[0])
        x = x.copy()
        x[1, 10, 0] = np.nan
    snap = _snapshot(state)
    new, jloss, _, jdiag = jstep(js, x, y, jax.random.PRNGKey(0))
    loss, out, diag = step(state, torch.from_numpy(x), torch.from_numpy(y), _rngs(1, 1)[0])
    assert set(diag) == {"applied", "grad_norm"}
    assert all(torch.is_tensor(v) and v.dim() == 0 for v in diag.values())
    assert bool(diag["applied"]) == (not nan) == bool(jdiag["applied"])
    if nan:
        assert not torch.isfinite(loss) and not np.isfinite(float(jloss))
        _assert_unchanged(state, snap)  # every byte, the count and Adam's counters
        assert int(new.step) == int(js.step) == state.step == 1
        return
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(diag["grad_norm"]), float(jdiag["grad_norm"]), rtol=1e-5)
    model = state.model
    _compare_leaves(model, {k: p.grad for k, p in model.named_parameters()},
                    _as_torch(new.opt_state[0]))
    _compare_stats(model, new.batch_stats)
    assert state.step == int(new.step) == 1
    assert all(float(st["step"]) == 1.0 for st in state.optimizer.state.values())


def test_guard_off_applies_the_same_update_on_clean_data(setup):
    """The guard changes nothing on clean data (tests/test_faults.py:196)."""
    variables, _ = setup
    x, y = (torch.from_numpy(a[0]) for a in _batches(2, 1))
    states = [_torch_state(variables, "adam") for _ in range(2)]
    out = [make_train_step(tts.make_loss(MODEL), guard=g)(s, x, y, _rngs(1)[0])
           for g, s in zip((True, False), states)]
    assert torch.equal(out[0][0], out[1][0]) and out[1][2] == {}
    for (k, a), b in zip(states[0].model.state_dict().items(),
                         states[1].model.state_dict().values()):
        assert torch.equal(a, b), k


def test_multi_step_equals_sequential_steps_and_jax(setup):
    variables, jax_state = setup
    k = 3
    x, y = _batches(3, k)
    x[1] = np.nan  # the middle update is skipped
    multi = make_multi_train_step(tts.make_loss(MODEL), k, guard=True)
    state = _torch_state(variables, "sgd")
    loss, out, diag = multi(state, torch.from_numpy(x), torch.from_numpy(y), _rngs(k))
    assert out is None and diag["applied"].dtype == torch.int32
    assert diag["applied"].tolist() == [1, 0, 1] and state.step == 2

    seq = _torch_state(variables, "sgd")
    step = make_train_step(tts.make_loss(MODEL), guard=True)
    losses = [step(seq, torch.from_numpy(x[j]), torch.from_numpy(y[j]), r)[0]
              for j, r in enumerate(_rngs(k))]
    assert torch.equal(loss, (losses[0] + losses[2]) / 2)
    for (name, a), b in zip(state.model.state_dict().items(), seq.model.state_dict().values()):
        assert torch.equal(a, b), name

    jmulti = jax.jit(j_make_multi_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL),
                                             steps_per_call=k, guard=True))
    new, jloss, _, jdiag = jmulti(jax_state("sgd"), x, y, jax.random.PRNGKey(7))
    np.testing.assert_array_equal(np.asarray(jdiag["applied"]), [1, 0, 1])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(new.step) == 2
    _compare_params(state.model, new.params)
    _compare_stats(state.model, new.batch_stats)
    # The last micro-step's gradients, which the port keeps in ``.grad``.
    _compare_leaves(state.model, {k: p.grad for k, p in state.model.named_parameters()},
                    _as_torch(new.opt_state[0]))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_accum_step_matches_jax(setup, opt):
    variables, jax_state = setup
    k = 2
    x, y = _batches(4, k)
    accum = make_accum_train_step(tts.make_loss(MODEL), k, guard=True)
    state = _torch_state(variables, opt)
    rngs = [step_random_source(0, 0, 0, "cpu", micro=i) for i in range(k)]
    loss, out, diag = accum(state, torch.from_numpy(x), torch.from_numpy(y), rngs)
    jaccum = jax.jit(j_make_accum_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL),
                                             accum_steps=k, guard=True))
    new, jloss, _, jdiag = jaccum(jax_state(opt), x, y, jax.random.PRNGKey(0))
    assert out is None and bool(diag["applied"]) and int(jdiag["applied"]) == 1
    assert state.step == int(new.step) == 1  # ONE update
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(diag["grad_norm"]), float(jdiag["grad_norm"]), rtol=1e-5)
    model = state.model
    _compare_leaves(model, {k: p.grad for k, p in model.named_parameters()},
                    _as_torch(new.opt_state[0]))  # the mean gradient
    _compare_stats(model, new.batch_stats)  # chained through both micro-batches
    if opt == "sgd":
        _compare_params(model, new.params)
    else:
        adam = new.opt_state[1][0]
        st = state.optimizer.state_dict()["state"]
        names = [n for n, _ in model.named_parameters()]
        for tree, slot in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            _compare_leaves(model, {n: st[names.index(n)][slot] for n in names},
                            _as_torch(tree))


def test_accum_nan_micro_batch_skips_the_whole_update(setup):
    variables, _ = setup
    x, y = _batches(5, 2)
    x[0] = np.nan
    state = _torch_state(variables, "adam")
    step = make_train_step(tts.make_loss(MODEL), guard=True)
    step(state, torch.from_numpy(x[1]), torch.from_numpy(y[1]), _rngs(1)[0])
    snap = _snapshot(state)
    rngs = [step_random_source(0, 0, 1, "cpu", micro=i) for i in range(2)]
    loss, _, diag = make_accum_train_step(tts.make_loss(MODEL), 2, guard=True)(
        state, torch.from_numpy(x), torch.from_numpy(y), rngs)
    assert not bool(diag["applied"]) and not torch.isfinite(loss)
    _assert_unchanged(state, snap)  # BatchNorm chained through the NaN, then restored


def test_accum_of_one_is_the_plain_step():
    fn = make_accum_train_step(tts.make_loss(MODEL), 1)
    assert fn.__name__ == "train_step"
    assert make_multi_train_step(tts.make_loss(MODEL), 1).__name__ == "train_step"


def test_micro_batch_randomness_folds_in_its_index():
    """Micro-batch i of the update at count s draws from (seed, epoch, s,
    i), as the JAX package folds i into the step key; update s alone from
    (seed, epoch, s)."""
    for micro in (None, 0, 3):
        got = step_random_source(7, 2, 5, "cpu", micro=micro)
        entropy = [7, 2, 5] + ([] if micro is None else [micro])
        word = int(np.random.SeedSequence(entropy).generate_state(1)[0])
        want = RandomSource.from_seed(word, "cpu")
        assert torch.equal(got.uniform((64,), "cpu"), want.uniform((64,), "cpu"))
        assert got.draw_attention_seed() == want.draw_attention_seed()
    a, b = (step_random_source(7, 2, 5, "cpu", micro=i) for i in (0, 1))
    assert not torch.equal(a.uniform((64,), "cpu"), b.uniform((64,), "cpu"))


@pytest.mark.parametrize("mode", ["triangular", "triangular2", "exp_range", "constant"])
def test_tensor_schedule_equals_the_float_form(mode):
    if mode == "constant":
        sched = tsched.constant(3e-4)
    else:
        sched = tsched.build_cyclic_schedule(8e-5, 1e-3, 100, warmup_steps=0.2,
                                             down_steps=0.3, mode=mode)
    for t in range(250):  # the step's count: an int64 scalar on the device
        got = sched.at(torch.tensor(t, dtype=torch.int64))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert torch.equal(got, torch.tensor(sched(t), dtype=torch.float32)), t


@pytest.mark.parametrize("name,wd", [("adam", 0.01), ("adamw", 0.05), ("sgd", 0.01)])
def test_a_skipped_update_leaves_the_optimizer_state(name, wd):
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(4, 5))
    opt = toptim.build_optimizer(name, [p], weight_decay=wd, momentum=0.9)
    lr = torch.tensor(1e-2)
    toptim.apply_update(opt, [p], [torch.randn(4, 5)], lr, torch.tensor(True))
    before = p.detach().clone(), {k: v.clone() for k, v in opt.state[p].items()}
    bad = torch.full((4, 5), float("nan"))
    toptim.apply_update(opt, [p], [bad], lr, torch.tensor(False))
    assert torch.equal(p.detach(), before[0])
    for k, v in opt.state[p].items():
        assert torch.equal(v, before[1][k]), k
    toptim.apply_update(opt, [p], [torch.randn(4, 5)], lr, torch.tensor(True))
    assert not torch.equal(p.detach(), before[0])


def test_loading_a_state_writes_in_place():
    """A rollback restores into the tensors a captured update reads."""
    p = torch.nn.Parameter(torch.randn(3))
    opt = toptim.build_optimizer("adam", [p])
    toptim.apply_update(opt, [p], [torch.ones(3)], torch.tensor(1e-3))
    saved = opt.state_dict()
    saved = {"state": {0: {k: v.clone() for k, v in saved["state"][0].items()}},
             "param_groups": saved["param_groups"]}
    live = dict(opt.state[p])
    toptim.apply_update(opt, [p], [torch.ones(3)], torch.tensor(1e-3))
    toptim.load_state(opt, saved)
    for k, t in opt.state[p].items():
        assert t is live[k] and torch.equal(t, saved["state"][0][k]), k
    assert float(opt.state[p]["step"]) == 1.0


def test_group_batches_keeps_each_batch_and_drops_the_tail():
    rng = np.random.default_rng(0)
    batches = [pipeline.Batch(rng.standard_normal((2, 8, 3)).astype(np.float32),
                              (rng.random((2, 8, 3)).astype(np.float32),
                               rng.random((2, 1)).astype(np.float32)), {}, [], None)
               for _ in range(5)]
    groups = list(pipeline.group_batches(iter(batches), 2))
    assert len(groups) == 2  # the fifth batch does not fill a group
    for g, (xs, ys) in enumerate(groups):
        assert xs.shape == (2, 2, 8, 3) and isinstance(ys, tuple)
        for j in range(2):
            b = batches[2 * g + j]
            assert xs[j].numpy().tobytes() == b.inputs.tobytes()
            assert all(t[j].numpy().tobytes() == u.tobytes() for t, u in zip(ys, b.loss_targets))
