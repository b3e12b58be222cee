"""Pooled-KV multi-head attention: plain versions, kernel wrappers and
the autograd function that joins them.

Counterpart of ``seist_tpu/ops/pallas_attention.py``. SeisT attends a
full-length query to keys/values pooled by ``attn_aggr_ratio``, so scores
are (L x M) with M = L/r. ``fused_pooled_attention`` is a
``torch.autograd.Function`` whose forward launches the hand-written CUDA
kernel ``csrc/pooled_attention_fwd.cu`` and whose backward launches
``csrc/pooled_attention_bwd.cu`` (both built and bound by
``ops/_kernels.py``) on CUDA tensors; each takes its plain version only
for tensors that lie on the CPU. As in the JAX package's custom VJP, the
forward saves q, k, v and the seed, and the backward recomputes the
probabilities and the dropout mask from them.

Post-softmax dropout draws its uniforms from the counter hash of the JAX
package (``_mix_to_uniform`` / ``_uniform01``): murmur3's finalizer over
the element index ``pid*(L*M) + row*M + col`` with ``pid = b*H + h``. The
plain version computes it in int64, masked to 32 bits after every
multiply and add and shifted only while non-negative (so each shift is
logical); the kernel computes it in uint32. Both reproduce JAX's bits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

#: Launches of the forward kernel since import (or since a caller reset
#: it). Incremented in :func:`_forward` right where it launches.
launches = 0
#: Launches of the backward kernel, incremented in :func:`_backward`.
bwd_launches = 0

_M32 = 0xFFFFFFFF
E_MAX = 64  # largest head width the kernel takes (csrc/pooled_attention_fwd.cu)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant,
    split in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix_to_uniform(x: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3-finalizer hash of a uint32 counter (held in int64) -> U[0,1)."""
    x = x ^ ((int(seed) * 0x9E3779B9) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _uniform01(
    seed: int, pid: torch.Tensor, l: int, m: int, device=None
) -> torch.Tensor:
    """(P, L, M) uniforms in [0, 1) for the batch-head slices ``pid`` (P,)."""
    pid = pid.to(torch.int64).reshape(-1, 1, 1) & _M32
    row = torch.arange(l, dtype=torch.int64, device=device).reshape(1, l, 1)
    col = torch.arange(m, dtype=torch.int64, device=device).reshape(1, 1, m)
    x = (_mul32(pid, (l * m) & _M32) + _mul32(row, m & _M32)) & _M32
    x = (x + col) & _M32
    return _mix_to_uniform(x, seed)


def pooled_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
) -> torch.Tensor:
    """The math of ``_einsum_attention``: q (N, L, H, E), k/v (N, M, H, E).

    Computes in fp32 and returns the input dtype, as the kernel does."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    s = torch.einsum("nlhe,nmhe->nhlm", q * scale, k)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        n, h, l, m = p.shape
        pid = torch.arange(n * h, device=q.device)
        u = _uniform01(dropout_seed, pid, l, m, device=q.device)
        keep = u.reshape(n, h, l, m) >= torch.tensor(dropout_rate, dtype=torch.float32)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    return torch.einsum("nhlm,nmhe->nlhe", p, v).to(dtype)


def pooled_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The math of ``_bwd_kernel``: (dq, dk, dv) for the upstream gradient
    ``g`` (N, L, H, E) of :func:`pooled_attention_plain`'s output.

    Recomputes P, applies the forward's dropout mask to P (for dV) and to
    dPd = g v^T, then the softmax VJP ``dS = P (dP - rowsum(dP P))``. fp32
    throughout; the outputs take the input dtype."""
    dtype = q.dtype
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("nlhe,nmhe->nhlm", q * scale, k)
    p = torch.softmax(s, dim=-1)
    dpd = torch.einsum("nlhe,nmhe->nhlm", g, v)
    if dropout_rate > 0.0:
        n, h, l, m = p.shape
        pid = torch.arange(n * h, device=q.device)
        u = _uniform01(dropout_seed, pid, l, m, device=q.device)
        keep = u.reshape(n, h, l, m) >= torch.tensor(dropout_rate, dtype=torch.float32)
        inv_keep = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dpd * inv_keep, 0.0)
    else:
        pd, dp = p, dpd
    dv = torch.einsum("nhlm,nlhe->nmhe", pd, g)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("nhlm,nmhe->nlhe", ds, k) * scale
    dk = torch.einsum("nhlm,nlhe->nmhe", ds, q) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (N, L, H, E) / (N, M, H, E)")
    n, _, h, e = q.shape
    if k.shape != v.shape or k.shape[0] != n or k.shape[2:] != (h, e):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if not 1 <= e <= E_MAX:
        raise ValueError(f"head width E={e} outside the kernel's 1..{E_MAX}")
    if n * h > 65535:
        raise ValueError(f"N*H={n * h} exceeds the kernel grid's 65535")
    if min(q.shape[1], k.shape[1]) < 1:
        raise ValueError("L and M must be >= 1")


def _forward(q, k, v, scale, rate, seed) -> torch.Tensor:
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if q.device.type == "cpu":
        return pooled_attention_plain(q, k, v, scale, rate, seed)
    _check_kernel_inputs(q, k, v)
    from seist_tpu_torch.ops import _kernels

    o = torch.empty_like(q)
    _kernels.pooled_attention_fwd(q, k, v, o, scale, rate, seed)
    launches += 1
    return o


def _backward(q, k, v, g, scale, rate, seed):
    """K2 on CUDA tensors, the plain version on CPU tensors. The upstream
    gradient arrives strided from the reshape and ``out_proj`` backward:
    it is made contiguous here, since the kernel reads the (N, L, H*E)
    layout."""
    global bwd_launches
    if q.device.type == "cpu":
        return pooled_attention_bwd_plain(q, k, v, g, scale, rate, seed)
    g = g.to(q.dtype).contiguous()
    _check_kernel_inputs(q, k, v)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} must match q {tuple(q.shape)}")
    from seist_tpu_torch.ops import _kernels

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _kernels.pooled_attention_bwd(q, k, v, g, dq, dk, dv, scale, rate, seed)
    bwd_launches += 1
    return dq, dk, dv


class _PooledAttention(torch.autograd.Function):
    """Forward K1, backward K2; the residuals are q, k, v and the seed."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, rate: float, seed: int):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.rate, ctx.seed = scale, rate, seed
        return _forward(q, k, v, scale, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, g, ctx.scale, ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None


def fused_pooled_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
) -> torch.Tensor:
    """Attention for ``q (N, L, H, E)``, ``k/v (N, M, H, E)``, differentiable
    in q, k and v.

    On CUDA tensors: the hand-written kernels (forward, and backward when
    a gradient is asked for), or an exception. On CPU tensors: the plain
    versions. ``dropout_rate`` > 0 applies post-softmax probability
    dropout from the counter hash seeded by the int32 ``dropout_seed``.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    return _PooledAttention.apply(q, k, v, float(scale), float(dropout_rate), int(dropout_seed))
