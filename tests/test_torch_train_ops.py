"""The training slice's building blocks against the JAX package on the CPU.

* K2's plain version (from the forward's o and lse) and the
  recompute-everything reference against ``jax.vjp`` of the Pallas kernel
  (interpret mode), with an explicit seed, at dropout 0 and 0.2: atol 1e-5
  (fp32, the same formula, other summation order).
* The autograd function on CPU tensors against autograd through the plain
  forward: atol 1e-6.
* Train-mode BatchNorm and its running statistics against
  ``BatchNorm1dParity`` with mutable ``batch_stats``: atol 1e-5 / 1e-6.
* DropPath with injected uniforms against the JAX package's injection:
  exact.
* The cyclic schedule over 100 updates, all three modes: rtol 1e-6 (the
  same fp32 formula).
* Adam, AdamW and SGD updates against optax over three updates: atol 4e-7
  on O(0.3) parameters, a few fp32 ulps (optax rounds its bias corrections
  in fp32, torch in float64, and the two apply the update in another
  order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seist_tpu.models import common as jc
from seist_tpu.ops import pallas_attention as jpa
from seist_tpu.train import optim as joptim
from seist_tpu.train import schedule as jsched

from seist_tpu_torch.models import common as tc
from seist_tpu_torch.ops import pooled_attention as tpa
from seist_tpu_torch.train import optim as toptim
from seist_tpu_torch.train import schedule as tsched


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n,l,m,h,e", [(2, 64, 8, 3, 8), (1, 48, 48, 2, 16)])
def test_bwd_plain_matches_jax_vjp_of_pallas_kernel(n, l, m, h, e, rate):
    q, k, v, g = _arrays([(n, l, h, e), (n, m, h, e), (n, m, h, e), (n, l, h, e)], l + e)
    scale, seed = 1.0 / np.sqrt(e), 987

    def f(q_, k_, v_):
        return jpa.fused_pooled_attention(
            q_, k_, v_, scale, dropout_rate=rate,
            dropout_seed=jnp.asarray([seed], jnp.int32), interpret=True)

    _, vjp = jax.vjp(f, q, k, v)
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    o, lse = tpa.pooled_attention_plain(tq, tk, tv, scale, rate, seed, return_lse=True)
    for got in (tpa.pooled_attention_bwd_reference(tq, tk, tv, tg, scale, rate, seed),
                tpa.pooled_attention_bwd_plain(tq, tk, tv, tg, o, lse, scale, rate, seed)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_autograd_function_matches_autograd_through_plain(rate):
    q, k, v, g = (torch.from_numpy(t) for t in _arrays(
        [(2, 40, 3, 8), (2, 10, 3, 8), (2, 10, 3, 8), (2, 40, 3, 8)], 1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tpa.pooled_attention_plain(*leaves, 0.3, rate, 5), leaves, g)
    before = (tpa.launches, tpa.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tpa.fused_pooled_attention(*leaves, 0.3, dropout_rate=rate, dropout_seed=5)
    got = torch.autograd.grad(out, leaves, g)
    assert (tpa.launches, tpa.bwd_launches) == before  # CPU tensors: plain versions
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 37, 6), (2, 5, 3)])
def test_batchnorm_train_mode_matches_parity_bn(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    stats = {"mean": rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    bn = tc.BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    for _ in range(2):  # the running statistics accumulate over calls
        want, mutated = jc.BatchNorm1dParity(use_running_average=False).apply(
            {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, mutated["batch_stats"])
        got = bn(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=0, atol=1e-6)
    assert tc.BN_MOMENTUM == jc.BN_MOMENTUM


def test_droppath_consumes_injected_rows_in_call_order():
    x = _arrays([(3, 5, 2)], 4)[0]
    u = np.random.default_rng(5).uniform(size=(4, 3)).astype(np.float32)
    rates = [0.5, 0.0, 0.2, 0.7]  # the rate-0 call consumes no row
    src = tc.RandomSource()
    src.inject_droppath(u)
    got = []
    for r in rates:
        dp = tc.DropPath(r).train()
        dp.random = src
        got.append(dp(torch.from_numpy(x)).numpy())
    with jc.droppath_mask_injection(jnp.asarray(u)) as rec:
        want = [np.asarray(jc.DropPath(r).apply({}, x, True)) for r in rates]
    assert src.droppath_calls == rec["i"] == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dropout_draws_from_its_generator_and_keeps_scale():
    x = torch.ones(2000, 50)
    a, b = tc.Dropout(0.3).train(), tc.Dropout(0.3).train()
    a.random = tc.RandomSource(torch.Generator().manual_seed(1))
    b.random = tc.RandomSource(torch.Generator().manual_seed(1))
    ya, yb = a(x), b(x)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)  # the generator decides
    kept = float((ya > 0).float().mean())
    assert abs(kept - 0.7) < 0.01
    values = torch.unique(ya)
    assert len(values) == 2 and values[0] == 0.0
    assert float(values[1]) == pytest.approx(1 / 0.7)
    assert tc.Dropout(0.3).eval()(x) is x
    with pytest.raises(RuntimeError, match="RandomSource"):
        tc.Dropout(0.3).train()(x)


@pytest.mark.parametrize("mode", ["triangular", "triangular2", "exp_range"])
def test_cyclic_schedule_matches_jax_over_100_updates(mode):
    kw = dict(base_lr=8e-5, max_lr=1e-3, total_steps=100, warmup_steps=0.2,
              down_steps=0.3, mode=mode)
    ts, js = tsched.build_cyclic_schedule(**kw), jsched.build_cyclic_schedule(**kw)
    got = np.array([ts(t) for t in range(100)], np.float32)
    want = np.array([float(js(t)) for t in range(100)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tsched.reference_gamma(8e-5, 100) == jsched.reference_gamma(8e-5, 100)


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01), ("adamw", 0.05),
                                     ("sgd", 0.01)])
def test_optimizer_update_matches_optax(name, wd):
    rng = np.random.default_rng(3)
    p0 = (0.1 * rng.standard_normal((4, 5))).astype(np.float32)
    grads = [(0.01 * rng.standard_normal((4, 5))).astype(np.float32) for _ in range(3)]
    schedule = jsched.cyclic_lr(1e-3, 1e-2, 2)
    tx = joptim.build_optimizer(name, schedule, weight_decay=wd, momentum=0.9)
    jp_, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp_ = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = toptim.build_optimizer(name, [tp_], weight_decay=wd, momentum=0.9)
    tschedule = tsched.cyclic_lr(1e-3, 1e-2, 2)
    for t, g in enumerate(grads):
        upd, st = tx.update(jnp.asarray(g), st, jp_)
        jp_ = optax.apply_updates(jp_, upd)
        toptim.apply_update(opt, [tp_], [torch.from_numpy(g)], tschedule.at(torch.tensor(t)))
        np.testing.assert_allclose(tp_.detach().numpy(), np.asarray(jp_), rtol=0, atol=4e-7)


def test_l1_sign_decay_matches_optax_transform():
    p = np.array([[-0.5, 0.0, 0.3]], np.float32)
    g = np.array([[0.1, 0.2, -0.3]], np.float32)
    tx = joptim.l1_sign_decay(0.01)
    want, _ = tx.update(jnp.asarray(g), tx.init(p), jnp.asarray(p))
    param = torch.nn.Parameter(torch.from_numpy(p))
    param.grad = torch.from_numpy(g.copy())
    toptim.l1_sign_decay([("w", param)], 0.01)
    np.testing.assert_array_equal(param.grad.numpy(), np.asarray(want))
    toptim.l1_sign_decay([("w", param)], 0.01, mask=lambda n: n != "w")
    np.testing.assert_array_equal(param.grad.numpy(), np.asarray(want))
