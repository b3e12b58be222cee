"""The attention kernel on the card (marker ``cuda``; skips without one).

Imports no JAX: the machine with the card has none, so run this file
there with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``. Tolerance 1e-5 absolute in fp32 against the
plain version (summation order only)."""

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
    with pytest.raises(NotImplementedError, match="training slice"):
        pa.fused_pooled_attention(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(TypeError):
        pa.fused_pooled_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        pa.fused_pooled_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head width"):
        pa.fused_pooled_attention(*_qkv(dev, 1, 16, 4, 1, 65))
    with pytest.raises(ValueError, match="CUDA device"):
        pa.fused_pooled_attention(q, k.cpu(), v)
