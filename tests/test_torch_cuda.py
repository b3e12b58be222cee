"""The attention kernels on the card (marker ``cuda``; skips without one).

Imports no JAX: the machine with the card has none, so run this file
there with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``. Tolerances against the plain versions: the
forward 1e-5 absolute in fp32 (summation order only); the backward
``1e-5 * max(1, max|plain|)`` per output in fp32 (dK and dV sum over up to
L rows) and ``2^-7 * max(1, max|plain|)`` in bf16 (one bf16 rounding of
the largest output)."""

from __future__ import annotations

import math

import pytest
import torch

from seist_tpu_torch.ops import pooled_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _qkv(dev, n, l, m, h, e, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype)
            for s in ((n, l, h, e), (n, m, h, e), (n, m, h, e))]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n,l,m,h,e", [(2, 64, 8, 1, 8), (3, 130, 65, 3, 16),
                                       (1, 200, 200, 2, 33), (2, 50, 7, 3, 64)])
def test_kernel_matches_plain(dev, n, l, m, h, e, rate):
    q, k, v = _qkv(dev, n, l, m, h, e)
    before = pa.launches
    got = pa.fused_pooled_attention(q, k, v, dropout_rate=rate, dropout_seed=99)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.pooled_attention_plain(q, k, v, 1.0 / math.sqrt(e), rate, 99)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got == 0, want == 0)


def test_kernel_bf16_rounds_like_plain(dev):
    q, k, v = _qkv(dev, 2, 128, 16, 3, 8, torch.bfloat16)
    got = pa.fused_pooled_attention(q, k, v)
    want = pa.pooled_attention_plain(q, k, v, 1.0 / math.sqrt(8))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2.0 ** -6)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 16, 4, 2, 8)
    before = pa.bwd_launches
    pa.fused_pooled_attention(q.clone().requires_grad_(), k, v).sum().backward()
    assert pa.bwd_launches == before + 1  # a gradient launches the backward
    with pytest.raises(ValueError, match="head width"):
        q65, k65, v65 = (t.requires_grad_() for t in _qkv(dev, 1, 16, 4, 1, 65))
        pa.fused_pooled_attention(q65, k65, v65).sum().backward()
    with pytest.raises(TypeError):
        pa.fused_pooled_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        pa.fused_pooled_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head width"):
        pa.fused_pooled_attention(*_qkv(dev, 1, 16, 4, 1, 65))
    with pytest.raises(ValueError, match="CUDA device"):
        pa.fused_pooled_attention(q, k.cpu(), v)


def _bwd_limit(dtype, plain):
    scale = max(1.0, float(plain.float().abs().max()))
    return (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,l,m,h,e", [(2, 64, 8, 1, 8), (3, 130, 65, 3, 16),
                                       (2, 1000, 125, 3, 8), (1, 200, 200, 2, 33),
                                       (2, 50, 7, 3, 64), (4, 128, 128, 3, 32)])
def test_backward_kernel_matches_plain(dev, n, l, m, h, e, rate, dtype):
    q, k, v = _qkv(dev, n, l, m, h, e, dtype, seed=l + m)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(e)).to(dev, dtype)
    scale = 1.0 / math.sqrt(e)
    before = pa.bwd_launches
    got = pa._backward(q, k, v, g, scale, rate, 1234)
    torch.cuda.synchronize()
    assert pa.bwd_launches == before + 1
    want = pa.pooled_attention_bwd_plain(q, k, v, g, scale, rate, 1234)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= _bwd_limit(dtype, b)


def test_autograd_through_both_kernels_matches_plain_autograd(dev):
    q, k, v = _qkv(dev, 2, 256, 32, 3, 16, seed=5)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).to(dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        pa.pooled_attention_plain(*leaves, 0.25, 0.3, 9), leaves, g)
    fwd, bwd = pa.launches, pa.bwd_launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = pa.fused_pooled_attention(*leaves, 0.25, dropout_rate=0.3, dropout_seed=9)
    got = torch.autograd.grad(out, leaves, g.transpose(1, 2).contiguous().transpose(1, 2))
    assert (pa.launches, pa.bwd_launches) == (fwd + 1, bwd + 1)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= _bwd_limit(torch.float32, b)
