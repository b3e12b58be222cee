"""The port's pooled attention against the JAX package's: the dropout
counter hash bit for bit, and the plain version against the Pallas kernel
(interpreter) and the einsum path.

Tolerance 1e-6 absolute: both sides are fp32 with the same formula; only
the summation order of the two contractions differs."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seist_tpu.ops import pallas_attention as jpa

from seist_tpu_torch.ops import pooled_attention as tpa


@pytest.mark.parametrize(
    "seed,pid,l,m",
    [
        (0, 0, 16, 8),
        (1234, 5, 64, 8),
        (2**31 - 1, 3, 33, 7),  # largest int32 seed, ragged dims
        (-5, 2, 16, 16),  # negative int32 seed bits
        (99, 70_000, 256, 256),  # pid*L*M = 4.59e9 wraps past 2^32
        (7, 2**31 - 1, 2, 3),  # pid at the int32 limit
    ],
)
def test_uniform01_bit_exact(seed, pid, l, m):
    want = np.asarray(
        jpa._uniform01(jnp.asarray(seed, jnp.int32), jnp.asarray(pid, jnp.int32), l, m)
    )
    got = tpa._uniform01(seed, torch.tensor([pid]), l, m)[0].numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _qkv(n, l, m, h, e, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((n, l, h, e), (n, m, h, e), (n, m, h, e))]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("m_div", [1, 8])
@pytest.mark.parametrize("h", [1, 3])
def test_plain_matches_pallas_kernel_and_einsum(h, m_div, rate):
    n, l, e, seed = 2, 64, 8, 4321
    q, k, v = _qkv(n, l, l // m_div, h, e, seed=h * 10 + m_div)
    scale = 1.0 / np.sqrt(e)
    jseed = jnp.asarray([seed], jnp.int32)
    kern = np.asarray(jpa.fused_pooled_attention(
        q, k, v, scale, dropout_rate=rate, dropout_seed=jseed, interpret=True))
    ein = np.asarray(jpa._einsum_attention(q, k, v, scale, rate, jseed))
    got = tpa.pooled_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), scale, rate, seed
    ).numpy()
    for want in (kern, ein):
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if rate > 0:
        # v = identity (M == E) makes the output the dropped probabilities.
        eye = np.broadcast_to(np.eye(l // m_div, e, dtype=np.float32)[None, :, None, :],
                              v.shape).copy()
        pj = np.asarray(jpa._einsum_attention(q, k, eye, scale, rate, jseed))
        pt = tpa.pooled_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(eye), scale,
            rate, seed).numpy()
        np.testing.assert_array_equal(pt == 0, pj == 0)


def test_wrapper_uses_plain_only_for_cpu_tensors():
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 32, 4, 3, 8, seed=0))
    want = tpa.pooled_attention_plain(q, k, v, 1.0 / np.sqrt(8))
    before = tpa.launches
    torch.testing.assert_close(tpa.fused_pooled_attention(q, k, v), want, rtol=0, atol=0)
    assert tpa.launches == before  # the plain version is no launch
    # A tensor on any other device is the kernel's or an error, never plain.
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.fused_pooled_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.fused_pooled_attention(q.to("meta").requires_grad_(), k.to("meta"), v.to("meta"))
    # A gradient through CPU tensors runs the plain backward: no launch.
    bwd_before = tpa.bwd_launches
    qg = q.clone().requires_grad_()
    tpa.fused_pooled_attention(qg, k, v).sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    assert tpa.launches == before and tpa.bwd_launches == bwd_before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from seist_tpu_torch.ops import _kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build("pooled_attention_fwd")
    assert _kernels.library_path("pooled_attention_fwd").name.startswith(
        "libpooled_attention_fwd-")


def test_plain_bf16_computes_in_fp32_and_returns_bf16():
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(1, 16, 4, 3, 8, seed=1))
    got = tpa.pooled_attention_plain(q, k, v, 0.35)
    assert got.dtype == torch.bfloat16
    want = tpa.pooled_attention_plain(q.float(), k.float(), v.float(), 0.35)
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
