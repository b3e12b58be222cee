"""The bf16 attention kernels' arithmetic, pinned on the CPU.

``csrc/pooled_attention_fwd_bf16.cuh`` and ``csrc/pooled_attention_bwd_bf16.cuh``
run on the card only. What they compute differently from the fp32 plain
versions is rounding, which a torch emulation repeats here: the bf16 inputs
enter products as they are (a product of two bf16 values is exact in fp32),
every fp32 operand that a kernel computes (the probabilities P and Pd, and
dS) is split into a bf16 hi and a bf16 lo part, two products each, and the
scores are scaled after the product, in log2 units. The emulation is held
against the JAX package's Pallas kernel, run in interpret mode on the same
bf16 inputs (forward and ``jax.vjp``), at seist_l_dpk's attention shapes
with a small batch, within the card's bf16 limits: the output 2^-6
absolute (one bf16 rounding of an output below 2), each gradient
2^-7 * max(1, max |reference|) (one bf16 rounding of the largest). Before
the outputs' rounding, the split keeps the gradients near their fp32 values,
where one bf16 rounding of P and dS would not.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seist_tpu.ops import pallas_attention as jpa

from seist_tpu_torch.ops import _kernels as K
from seist_tpu_torch.ops import pooled_attention as tpa

BF16_TOL = 2.0 ** -6
BWD_BF16_TOL = 2.0 ** -7
LOG2E = np.float32(1.4426950408889634)


def _split(x: torch.Tensor):
    """fp32 x -> (hi, lo): hi = bf16(x), lo = bf16(x - hi), as fp32 values."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, split: bool = True) -> torch.Tensor:
    """A product with the fp32 operand ``a`` split (lo first, then hi) and
    the bf16-exact ``b`` as it is; ``split=False`` rounds ``a`` once."""
    hi, lo = _split(a)
    if not split:
        return torch.einsum(eq, hi, b)
    return torch.einsum(eq, lo, b) + torch.einsum(eq, hi, b)


def _scale2(scale: float) -> float:
    return float(np.float32(np.float32(scale) * LOG2E))


def emulate_fwd(q, k, v, scale, rate, seed, split=True):
    """K1 in bf16: o (bf16) and the fp32 lse, from bf16 (N, L, H, E) inputs;
    ``split=False`` rounds P once."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("nlhe,nmhe->nhlm", qf, kf) * _scale2(scale)  # log2 units
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - mx)
    total = p.sum(dim=-1)
    if rate > 0.0:
        p = torch.where(tpa._keep_mask(seed, *p.shape, rate, p.device), p, 0.0)
    out_scale = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    o = _product("nhlm,nmhe->nlhe", p, vf, split) * (out_scale / total).permute(0, 2, 1)[..., None]
    lse = (mx[..., 0] + torch.log2(total)) / LOG2E
    return o.to(torch.bfloat16), lse


def emulate_bwd(q, k, v, g, o, lse, scale, rate, seed, split=True, out_dtype=torch.bfloat16):
    """K2 in bf16: (dq, dk, dv) from K1's o and lse, rounded to ``out_dtype``."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("nlhe,nmhe->nhlm", qf, kf) * _scale2(scale)
    p = torch.exp2(s - (lse * LOG2E)[..., None])
    dpd = torch.einsum("nlhe,nmhe->nhlm", gf, vf)  # exact products
    pd, dp = tpa._drop_both(p, dpd, rate, seed)
    d = (gf * o.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - d)
    dv = _product("nhlm,nlhe->nmhe", pd, gf, split)
    dq = _product("nhlm,nmhe->nlhe", ds, kf, split) * scale
    dk = _product("nhlm,nlhe->nmhe", ds, qf, split) * scale
    return tuple(t.to(out_dtype) for t in (dq, dk, dv))


def _inputs(n, l, m, h, e, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((n, l, h, e), (n, m, h, e), (n, m, h, e), (n, l, h, e))]


def _jax_reference(q, k, v, g, scale, rate, seed):
    """The Pallas kernel (interpret mode) on bf16 inputs: its output and
    the gradients of <o, g> in q, k, v."""
    def f(q_, k_, v_):
        return jpa.fused_pooled_attention(
            q_, k_, v_, scale, dropout_rate=rate,
            dropout_seed=jnp.asarray([seed], jnp.int32), interpret=True)

    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)]
    o, vjp = jax.vjp(f, *bf[:3])
    grads = vjp(bf[3])
    return np.asarray(o.astype(jnp.float32)), [np.asarray(x.astype(jnp.float32)) for x in grads]


def _bwd_err(got, want) -> float:
    return max(float(np.abs(a.float().numpy() - b).max()) / max(1.0, float(np.abs(b).max()))
               for a, b in zip(got, want))


# seist_l_dpk's attention launches at window 8192 are (L, M, H, E) =
# (1024, 128, 3, 8), (512, 128, 3, 8), (256, 128, 3, 16) twice and
# (128, 128, 3, 32): the four distinct shapes, with a batch of 1 or 2.
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,l,m,h,e", [(1, 1024, 128, 3, 8), (2, 512, 128, 3, 8),
                                       (2, 256, 128, 3, 16), (2, 128, 128, 3, 32)])
def test_bf16_emulation_matches_the_pallas_kernel(n, l, m, h, e, rate):
    seed = 4321
    q, k, v, g = _inputs(n, l, m, h, e, l + e)
    scale = 1.0 / math.sqrt(e)
    want_o, want_grads = _jax_reference(q, k, v, g, scale, rate, seed)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))
    o, lse = emulate_fwd(tq, tk, tv, scale, rate, seed)
    assert float(np.abs(o.float().numpy() - want_o).max()) <= BF16_TOL
    np.testing.assert_array_equal(o.float().numpy() == 0, want_o == 0)
    # The row statistics in fp32, against the plain version's logsumexp.
    _, want_lse = tpa.pooled_attention_plain(tq, tk, tv, scale, rate, seed, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    grads = emulate_bwd(tq, tk, tv, tg, o, lse, scale, rate, seed)
    assert _bwd_err(grads, want_grads) <= BWD_BF16_TOL
    # The kernels' plain versions (what the card holds the kernels against)
    # stand as close to the reference.
    plain = tpa.pooled_attention_bwd_plain(tq, tk, tv, tg, o, lse, scale, rate, seed)
    assert _bwd_err(plain, want_grads) <= BWD_BF16_TOL


def test_the_split_keeps_sixteen_bits_of_the_probabilities():
    """Before the outputs' bf16 rounding, the split products stay within
    2^-15 (relative to the largest gradient) of the same function in fp32
    (the plain version), where P and dS rounded once to bf16 move the
    gradients by more than 2^-11: the split, not the output rounding, is
    what the kernels' error is made of."""
    n, l, m, h, e, rate, seed = 2, 128, 128, 3, 32, 0.3, 4321
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(n, l, m, h, e, 7))
    scale = 1.0 / math.sqrt(e)
    o, lse = emulate_fwd(tq, tk, tv, scale, rate, seed)
    want = [t.float() for t in tpa.pooled_attention_bwd_plain(
        tq.float(), tk.float(), tv.float(), tg.float(), o.float(), lse, scale, rate, seed)]

    def err(split):
        got = emulate_bwd(tq, tk, tv, tg, o, lse, scale, rate, seed, split, torch.float32)
        return max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))

    assert err(True) <= 2.0 ** -15 < 2.0 ** -11 < err(False)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3, 0.5, 1.0 - 2.0 ** -24, 2.0 ** -24, 1e-9])
def test_keep_threshold_equals_the_uniform_test(rate):
    """keep_threshold (csrc/attention_common.cuh): a counter hash x is kept
    when x >= ceil(rate 2^24) 2^8, exactly when its uniform (x >> 8) 2^-24
    is >= rate, for every x (sampled, and at the threshold's edges)."""
    r32 = np.float32(rate)
    thr = int(np.ceil(np.float64(r32) * 2 ** 24)) << 8
    assert thr < 2 ** 32
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64),
                        np.arange(max(thr - 600, 0), min(thr + 600, 2 ** 32), dtype=np.uint64),
                        np.array([0, 2 ** 32 - 1], dtype=np.uint64)])
    uniform = (x >> np.uint64(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    np.testing.assert_array_equal(x >= thr, uniform >= r32)
    src = (K.CSRC / "attention_common.cuh").read_text()
    assert "(uint32_t)ceilf(rate * 16777216.0f) << 8" in src
