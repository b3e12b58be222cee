"""The port's building blocks against ``seist_tpu.models.common``.

Tolerances: padding, pooling maxima, make_divisible and the BN statistics
path are exact or float-rounding only (1e-6 absolute); interpolation and
GELU are float32 formulas evaluated in another order (1e-6)."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seist_tpu.models import common as jc

from seist_tpu_torch.models import common as tc


def _x(n, l, c, seed=0):
    return np.random.default_rng(seed).standard_normal((n, l, c)).astype(np.float32)


def _close(got: torch.Tensor, want, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("l,k,s", [(16, 11, 2), (17, 11, 2), (9, 5, 1), (33, 7, 2), (8, 3, 1)])
def test_auto_pad(l, k, s):
    x = _x(2, l, 3)
    assert tc.auto_pad_amount(l, k, s) == jc.auto_pad_amount(l, k, s)
    _close(tc.auto_pad_1d(torch.from_numpy(x), k, s), jc.auto_pad_1d(x, k, s), atol=0)


@pytest.mark.parametrize("l,k", [(16, 2), (17, 2), (30, 8), (29, 4), (5, 8), (12, 1)])
def test_ceil_pools_with_ragged_last_window(l, k):
    x = _x(2, l, 5, seed=l)
    xt = torch.from_numpy(x)
    _close(tc.max_pool_1d_ceil(xt, k), jc.max_pool_1d_ceil(x, k), atol=0)
    _close(tc.avg_pool_1d_ceil(xt, k), jc.avg_pool_1d_ceil(x, k))


@pytest.mark.parametrize(
    "l_in,l_out",
    [(8, 16), (16, 64), (5, 40),  # integer factors: the JAX gather-free path
     (94, 188), (7, 10), (64, 500), (10, 7)],  # the general gather path
)
def test_interpolate_linear_both_paths(l_in, l_out):
    x = _x(2, l_in, 4, seed=l_out)
    _close(tc.interpolate_linear(torch.from_numpy(x), l_out), jc.interpolate_linear(x, l_out))


def test_batchnorm_eval_matches_parity_bn():
    rng = np.random.default_rng(3)
    c = 6
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    stats = {"mean": rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    x = _x(2, 10, c)
    want = jc.BatchNorm1dParity(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, x)
    bn = tc.BatchNorm(c).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        got = bn(torch.from_numpy(x))
    assert bn.eps == jc.BN_EPSILON
    _close(got, want)
    # Train mode: batch statistics, and the running ones updated in place.
    want, mutated = jc.BatchNorm1dParity(use_running_average=False).apply(
        {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
    got = bn.train()(torch.from_numpy(x))
    _close(got.detach(), want, atol=1e-5)
    _close(bn.running_mean, mutated["batch_stats"]["mean"])
    _close(bn.running_var, mutated["batch_stats"]["var"])


def test_gelu_is_exact_erf():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(tc.gelu(torch.from_numpy(x)), jc.gelu(jnp.asarray(x)))


@pytest.mark.parametrize("v,d", [(19, 8), (38, 16), (76, 32), (8, 8), (3, 8), (100, 7), (57, 4)])
def test_make_divisible(v, d):
    assert tc.make_divisible(v, d) == jc.make_divisible(v, d)


def test_global_avg_pool_and_droppath():
    x = _x(2, 9, 4)
    _close(tc.global_avg_pool(torch.from_numpy(x)), jc.global_avg_pool(x))
    dp = tc.DropPath(0.3).eval()
    xt = torch.from_numpy(x)
    assert dp(xt) is xt
    # Train mode with injected uniforms: the JAX package's DropPath on the
    # same rows drops the same samples.
    u = np.array([[0.1, 0.9], [0.8, 0.2]], np.float32)
    src = tc.RandomSource()
    src.inject_droppath(u)
    dp.train().random = src
    got = [dp(xt), dp(xt)]
    with jc.droppath_mask_injection(jnp.asarray(u)):
        want = [jc.DropPath(0.3).apply({}, x, True) for _ in range(2)]
    assert src.droppath_calls == 2
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("groups,k,s", [(1, 5, 1), (4, 3, 1), (8, 7, 2)])
def test_conv1d_matches_flax_conv_layout(groups, k, s):
    """(K, Cin/g, Cout) flax kernels permuted to (Cout, Cin/g, K)."""
    cin = cout = 8
    x = _x(2, 20, cin, seed=k)
    w = np.random.default_rng(k).standard_normal((k, cin // groups, cout)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (s,), "VALID", dimension_numbers=("NWC", "WIO", "NWC"),
        feature_group_count=groups)
    conv = tc.Conv1d(cin, cout, k, s, groups=groups)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(2, 1, 0)))
        got = conv(torch.from_numpy(x))
    _close(got, want, atol=1e-5)
