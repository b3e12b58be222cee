"""One guarded Adam step of each trainable baseline family, the port's
against the JAX package's, on the CPU.

The five families with a task row (phasenet, eqtransformer, magnet,
baz_network, ditingmotion) at their published widths, window 512
(DiTingMotion 128), batch 2, drop rates 0, the JAX package's own initial
variables (``init_variables``, seed 1: flax's initialisers, zero biases)
converted for the port, and the loss of the row (baz's targets
through its (cos, sin) transform). Not the forward tests' variables
(tests/_torch_parity.py): their random biases put channel means far from
zero ahead of EQTransformer's train-mode BatchNorms, whose fp32 statistics
then decide the gradients to about 1e-1 in both packages alike (each is as
far from a float64 run as from the other; at the real init they agree to
1e-4). Not window 256: PhaseNet's bottleneck
is then one sample, its BatchNorm normalises two values, and the
amplified rounding flips a ReLU input of about 1e-5 between the packages. BAZNetwork takes JAX's eigen features
as its ``(x, features)`` input (tests/test_torch_baselines.py says why).
The JAX step's optimizer is Adam behind a transform that keeps the
gradients in the optimizer state, so the same program yields the
gradients to compare.

Limits, the repo's train-mode parity conventions (tests/test_torch_train.py):
loss rtol 1e-5; each gradient leaf at cosine >= 0.9999 and max error <=
5e-3 of its max, except a leaf below 1e-6 of the largest gradient on both
sides, which is fp32 noise: zero in exact arithmetic (a bias before a
train-mode BatchNorm, EQTransformer's score bias ``ba`` under the softmax's
max shift, a dead ReLU) or cancelled to that level; BatchNorm
running statistics rtol 1e-4, atol 1e-5; Adam's first moments after the
update like the gradients they average. With EQTransformer's two L1
alphas non-zero, the kept gradients are those after the L1 terms on both
sides.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.models import api as japi
from seist_tpu.models import eqtransformer as jeqt
from seist_tpu.models.baz_network import _cov_features
from seist_tpu.train.optim import l1_sign_decay as j_l1_sign_decay
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models import eqtransformer as teqt
from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.schedule import constant
from seist_tpu_torch.train.step import TrainState, make_train_step


BATCH, LR = 2, 1e-3
#: family -> (window, input channels)
FAMILIES = {
    "phasenet": (512, 3),
    "eqtransformer": (512, 3),
    "magnet": (512, 3),
    "baz_network": (512, 3),
    "ditingmotion": (128, 2),
}
L1 = {"conv_kernel_l1_alpha": 1e-3, "conv_bias_l1_alpha": 2e-3}


def _keep_grads() -> optax.GradientTransformation:
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def _batch(name, window, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, window, c)).astype(np.float32)
    if name in ("phasenet", "eqtransformer"):
        y = rng.uniform(0.0, 1.0, (BATCH, window, 3)).astype(np.float32)
    elif name == "magnet":
        y = rng.uniform(0.0, 6.0, (BATCH, 1)).astype(np.float32)
    elif name == "baz_network":
        y = rng.uniform(0.0, 360.0, (BATCH, 1)).astype(np.float32)
    else:
        y = tuple(np.eye(2, dtype=np.int64)[rng.integers(0, 2, BATCH)] for _ in "cp")
    return x, y


def _torch(tree):
    if isinstance(tree, tuple):
        return tuple(_torch(t) for t in tree)
    return torch.from_numpy(np.array(tree))


def _jax_step(name, window, c, variables, l1):
    seist_tpu.load_all()
    jm = japi.create_model(name, in_channels=c, in_samples=window, drop_rate=0.0)
    pre = []
    if l1:
        for alpha, kind in ((L1["conv_kernel_l1_alpha"], "kernel"),
                            (L1["conv_bias_l1_alpha"], "bias")):
            pre.append(j_l1_sign_decay(alpha, mask=lambda p, k=kind: jeqt.l1_param_mask(p, k)))
    tx = optax.chain(*pre, _keep_grads(), optax.adam(LR))
    state = create_train_state(jm, variables, tx)
    step = jax.jit(j_make_train_step(jts.get_task_spec(name), jts.make_loss(name), guard=True))
    return state, step


def _port_step(name, window, c, variables, l1):
    seist_tpu_torch.load_all()
    tm = tapi.create_model(name, in_channels=c, in_samples=window, drop_rate=0.0)
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    terms = [(L1["conv_kernel_l1_alpha"], teqt.l1_param_mask("kernel")),
             (L1["conv_bias_l1_alpha"], teqt.l1_param_mask("bias"))] if l1 else []
    state = TrainState(tm, build_optimizer("adam", tm.parameters()), constant(LR), l1=terms)
    return state, make_train_step(tts.make_loss(name), guard=True)


def _compare(got, want):
    """Gradient-like leaves (module docstring's limits)."""
    gscale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g, w = got[k].detach().double().ravel(), w.double().ravel()
        if max(float(g.abs().max()), float(w.abs().max())) < 1e-6 * gscale:
            continue  # noise on both sides: within 1e-6 of the largest gradient
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.9999, f"{k}: grad cosine {cos}"
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel <= 5e-3, f"{k}: rel grad err {rel}"
    assert set(got) == set(want)


CASES = [(n, False) for n in sorted(FAMILIES)] + [("eqtransformer", True)]


@pytest.mark.parametrize("name,l1", CASES, ids=[f"{n}{'-l1' if l1 else ''}" for n, l1 in CASES])
def test_one_adam_step_matches_jax(name, l1):
    window, c = FAMILIES[name]
    jm = japi.create_model(name, in_channels=c, in_samples=window)
    variables = jax.device_get(japi.init_variables(jm, seed=1, in_samples=window,
                                                   in_channels=c))
    jstate, jstep = _jax_step(name, window, c, variables, l1)
    x, y = _batch(name, window, c)
    new, jloss, _, jdiag = jstep(jstate, x, y, jax.random.PRNGKey(0))

    state, step = _port_step(name, window, c, variables, l1)
    xt = _torch(x)
    if name == "baz_network":
        xt = (xt, _torch(np.asarray(_cov_features(jnp.asarray(x)))))
    loss, _, diag = step(state, xt, _torch(y), RandomSource.from_seed(0, "cpu"))
    assert bool(diag["applied"]) and int(jdiag["applied"]) == 1 and state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    model = state.model
    as_torch = lambda tree: state_dict_from_flax({"params": jax.device_get(tree)})  # noqa: E731
    kept = new.opt_state[len(new.opt_state) - 2]  # _keep_grads's state
    _compare({k: p.grad for k, p in model.named_parameters()}, as_torch(kept))
    names = [k for k, _ in model.named_parameters()]
    opt = state.optimizer.state_dict()["state"]
    adam = new.opt_state[-1][0]
    _compare({k: opt[names.index(k)]["exp_avg"] for k in names}, as_torch(adam.mu))
    sd = model.state_dict()
    stats = state_dict_from_flax({"batch_stats": jax.device_get(new.batch_stats or {})})
    for k, v in stats.items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-5, msg=k)
    if l1:  # the L1 terms are a visible part of the selected gradients
        w = dict(model.named_parameters())["encoder.conv0.conv.weight"]
        raw = w.grad - L1["conv_kernel_l1_alpha"] * torch.sign(w)
        assert float((w.grad - raw).norm()) > 0.1 * float(w.grad.norm())
