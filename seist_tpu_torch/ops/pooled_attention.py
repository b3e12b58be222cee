"""Pooled-KV multi-head attention: plain versions, kernel wrappers and
the autograd function that joins them.

Counterpart of ``seist_tpu/ops/pallas_attention.py``. SeisT attends a
full-length query to keys/values pooled by ``attn_aggr_ratio``, so scores
are (L x M) with M = L/r. ``fused_pooled_attention`` is a
``torch.autograd.Function`` whose forward launches the hand-written CUDA
kernel ``csrc/pooled_attention_fwd.cu`` and whose backward launches
``csrc/pooled_attention_bwd.cu`` (both built and bound by
``ops/_kernels.py``; bf16 inputs go to their bf16 kernels,
``csrc/pooled_attention_fwd_bf16.cuh`` and ``..._bwd_bf16.cuh``, on the
bf16 tensor cores) on CUDA tensors; each takes its plain version only for
tensors that lie on the CPU. The forward also writes each row's
log-sum-exp when a gradient will be needed, and saves it with q, k, v, its
output and the seed; the backward rebuilds the probabilities from it in
one pass, and the dropout mask from the seed.

The dropout seed reaches the kernels as an int32 scalar tensor on q's
device, which they read from device memory, as the TPU kernel reads its
``seed_ref``: a step captured as a CUDA graph then draws new masks on each
replay from the seed written into that tensor before it. The plain
versions take an int; on CPU tensors the wrappers read the seed tensor's
value (``.item()``, no device sync there).

Post-softmax dropout draws its uniforms from the counter hash of the JAX
package (``_mix_to_uniform`` / ``_uniform01``): murmur3's finalizer over
the element index ``pid*(L*M) + row*M + col`` with ``pid = pid0 + b*H +
h``. ``pid0`` is 0 on one rank; a data-parallel rank whose rows start at
global batch row ``n0`` passes ``n0*H``, so its mask is its rows of the
global batch's, as the JAX package's step over the global batch draws it.
The plain version computes it in int64, masked to 32 bits after every
multiply and add and shifted only while non-negative (so each shift is
logical); the kernel computes it in uint32. Both reproduce JAX's bits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from seist_tpu_torch.obs import attribution
from seist_tpu_torch.ops import launch_counts

#: Launches of the forward kernel since import (or since a caller reset
#: it). Incremented in :func:`_forward` right where it launches (through
#: ``ops/launch_counts.py``, which diverts a graph capture's launches).
launches = 0
#: Launches of the backward kernel, incremented in :func:`_backward`.
bwd_launches = 0
#: The launches of the bf16 kernels (``csrc/pooled_attention_fwd_bf16.cuh``
#: and ``csrc/pooled_attention_bwd_bf16.cuh``, which take every bf16 call),
#: counted beside the totals above.
bf16_launches = 0
bf16_bwd_launches = 0

_M32 = 0xFFFFFFFF
E_MAX = 64  # largest head width the kernels take (csrc/pooled_attention_*.cu*)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant,
    split in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix_to_uniform(x: torch.Tensor, seed) -> torch.Tensor:
    """murmur3-finalizer hash of a uint32 counter (held in int64) -> U[0,1).
    ``seed`` is an int, or an int32 tensor on x's device (read there, with
    no host sync: what a captured step's ring passes)."""
    if torch.is_tensor(seed):
        x = x ^ _mul32(seed.reshape(()).to(torch.int64) & _M32, 0x9E3779B9)
    else:
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


def _keep_mask(seed: int, n: int, h: int, l: int, m: int, rate: float, device,
               pid0: int = 0) -> torch.Tensor:
    """(N, H, L, M) dropout keep mask: the counter hash's u >= rate, batch-head
    slices numbered from ``pid0``."""
    pid = torch.arange(n * h, device=device) + int(pid0)
    u = _uniform01(seed, pid, l, m, device=device)
    return u.reshape(n, h, l, m) >= torch.tensor(rate, dtype=torch.float32)


def _drop_both(p: torch.Tensor, dpd: torch.Tensor, rate: float, seed: int, pid0: int = 0):
    """The forward's dropout applied to P (for dV) and to dPd = g v^T."""
    if rate <= 0.0:
        return p, dpd
    keep = _keep_mask(seed, *p.shape, rate, p.device, pid0)
    inv_keep = 1.0 / (1.0 - rate)
    return torch.where(keep, p * inv_keep, 0.0), torch.where(keep, dpd * inv_keep, 0.0)


def pooled_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
    return_lse: bool = False,
    pid0: int = 0,
):
    """The math of ``_einsum_attention``: q (N, L, H, E), k/v (N, M, H, E).

    Computes in fp32 and returns the input dtype, as the kernel does. With
    ``return_lse`` also the fp32 (N, H, L) log-sum-exp of the scaled scores
    (K1's row statistics, which the backward reads). ``pid0`` numbers the
    dropout counter's batch-head slices from ``n0 * H``: the rows of a
    data-parallel rank whose batch starts at global row ``n0``."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    s = torch.einsum("nlhe,nmhe->nhlm", q * scale, k)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = _keep_mask(dropout_seed, *p.shape, dropout_rate, q.device, pid0)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.einsum("nhlm,nmhe->nlhe", p, v).to(dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def pooled_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
    pid0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function: (dq, dk, dv) for the upstream gradient ``g``
    (N, L, H, E) of the forward's output ``o``, from its row statistics
    ``lse`` (N, H, L), as the kernel computes them.

    P = exp(s - lse) needs no softmax walk, and D = rowsum(dP P) is
    rowsum(g o): with dropout both equal sum_j Pd_ij (g_i . v_j). The
    forward's dropout mask applies to P (for dV) and to dPd = g v^T; then
    ``dS = P (dP - D)``. fp32 throughout; the outputs take the input
    dtype."""
    dtype = q.dtype
    q, k, v, g, o = q.float(), k.float(), v.float(), g.float(), o.float()
    s = torch.einsum("nlhe,nmhe->nhlm", q * scale, k)
    p = torch.exp(s - lse.float().unsqueeze(-1))
    dpd = torch.einsum("nlhe,nmhe->nhlm", g, v)
    pd, dp = _drop_both(p, dpd, dropout_rate, dropout_seed, pid0)
    d = (g * o).sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)  # (N, H, L, 1)
    dv = torch.einsum("nhlm,nlhe->nmhe", pd, g)
    ds = p * (dp - d)
    dq = torch.einsum("nhlm,nmhe->nlhe", ds, k) * scale
    dk = torch.einsum("nhlm,nlhe->nmhe", ds, q) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def pooled_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The math of the JAX package's ``_bwd_kernel``, which recomputes
    everything from q, k, v: the softmax, and D = rowsum(dP P). The parity
    reference for :func:`pooled_attention_bwd_plain`."""
    dtype = q.dtype
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("nlhe,nmhe->nhlm", q * scale, k)
    p = torch.softmax(s, dim=-1)
    dpd = torch.einsum("nlhe,nmhe->nhlm", g, v)
    pd, dp = _drop_both(p, dpd, dropout_rate, dropout_seed)
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
    if min(q.shape[1], k.shape[1]) < 1:
        raise ValueError("L and M must be >= 1")


def seed_tensor(seed, device) -> torch.Tensor:
    """The dropout seed as the int32 scalar tensor on ``device`` that the
    kernels read: a tensor is checked and returned as it is; an int is
    written by a fill on the device (no host-to-device copy, so a graph
    capture may make one)."""
    if torch.is_tensor(seed):
        if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != torch.device(device):
            raise ValueError(f"the dropout seed must be one int32 on {device}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return seed.reshape(())
    return torch.full((), int(seed), dtype=torch.int32, device=device)


def _seed_int(seed) -> int:
    return int(seed.item()) if torch.is_tensor(seed) else int(seed)


def counts() -> Tuple[int, int, int, int]:
    """(launches, bwd_launches, bf16_launches, bf16_bwd_launches)."""
    return launches, bwd_launches, bf16_launches, bf16_bwd_launches


def set_counts(values: Tuple[int, int, int, int]) -> None:
    global launches, bwd_launches, bf16_launches, bf16_bwd_launches
    launches, bwd_launches, bf16_launches, bf16_bwd_launches = values


def kernel_costs(q: torch.Tensor, k: torch.Tensor) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(FLOPs, bytes) of one K1 and one K2 launch at q (N, L, H, E) and k
    (N, M, H, E), the bound formulas of ``PERF.md`` §6: K1 ``4·N·H·L·M·E``
    (two products) over q, k, v read and o written once; K2
    ``10·N·H·L·M·E`` (the scores' recompute, dP, dV, dQ, dK) over q, k,
    v, g, o read and dq, dk, dv written once, and the fp32 lse."""
    n, l, h, e = q.shape
    m, s = k.shape[1], q.element_size()
    return ((4 * n * h * l * m * e, s * n * h * e * (2 * l + 2 * m)),
            (10 * n * h * l * m * e, s * n * h * e * (4 * l + 4 * m) + 4 * n * h * l))


def _charge(name: str, cost: Tuple[int, int], q: torch.Tensor, k: torch.Tensor) -> None:
    """A launch's cost to an active step recording (``obs/attribution.py``)."""
    attribution.charge(name, *cost, f"{attribution.shape_str(q)} {attribution.shape_str(k)} "
                                    f"-> {attribution.shape_str(q)}")


def _forward(q, k, v, scale, rate, seed, with_lse: bool, pid0: int = 0):
    """K1 on CUDA tensors, the plain version on CPU tensors: o, and the
    fp32 (N, H, L) row statistics when ``with_lse`` (else None). ``seed``
    is an int or the int32 seed tensor on q's device; ``pid0`` the dropout
    counter's first batch-head slice."""
    if q.device.type == "cpu":
        seed = _seed_int(seed)
        if with_lse:
            return pooled_attention_plain(q, k, v, scale, rate, seed, return_lse=True, pid0=pid0)
        return pooled_attention_plain(q, k, v, scale, rate, seed, pid0=pid0), None
    _check_kernel_inputs(q, k, v)
    from seist_tpu_torch.ops import _kernels

    o = torch.empty_like(q)
    n, l, h, _ = q.shape
    lse = torch.empty(n, h, l, dtype=torch.float32, device=q.device) if with_lse else None
    _kernels.pooled_attention_fwd(q, k, v, o, lse, scale, rate, seed_tensor(seed, q.device), pid0)
    launch_counts.bump(__name__, q.device, *(("launches", "bf16_launches")
                                             if q.dtype == torch.bfloat16 else ("launches",)))
    _charge("pooled_attention_fwd", kernel_costs(q, k)[0], q, k)
    return o, lse


def _backward(q, k, v, g, o, lse, scale, rate, seed, pid0: int = 0):
    """K2 on CUDA tensors, the plain version on CPU tensors. The upstream
    gradient arrives strided from the reshape and ``out_proj`` backward:
    it is made contiguous here, since the kernel reads the (N, L, H*E)
    layout."""
    if q.device.type == "cpu":
        return pooled_attention_bwd_plain(q, k, v, g, o, lse, scale, rate, _seed_int(seed), pid0)
    g = g.to(q.dtype).contiguous()
    _check_kernel_inputs(q, k, v)
    n, l, h, _ = q.shape
    for name, t in (("g", g), ("o", o)):
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} must "
                             f"match q {tuple(q.shape)} {q.dtype}")
    if (lse.shape != (n, h, l) or lse.dtype != torch.float32 or lse.device != q.device
            or not (o.is_contiguous() and lse.is_contiguous())):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} must be contiguous fp32 "
                         f"({n}, {h}, {l}) beside a contiguous o")
    from seist_tpu_torch.ops import _kernels

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _kernels.pooled_attention_bwd(q, k, v, g, o, lse, dq, dk, dv, scale, rate,
                                  seed_tensor(seed, q.device), pid0)
    launch_counts.bump(__name__, q.device, *(("bwd_launches", "bf16_bwd_launches")
                                             if q.dtype == torch.bfloat16 else ("bwd_launches",)))
    _charge("pooled_attention_bwd", kernel_costs(q, k)[1], q, k)
    return dq, dk, dv


class _PooledAttention(torch.autograd.Function):
    """Forward K1, backward K2. The residuals are q, k, v, the output o and
    its row statistics lse (written by K1 only when a gradient will be
    asked for), and the int32 seed tensor. Saving o costs no memory:
    ``out_proj`` already saves a view of the same storage."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, rate: float, seed: torch.Tensor, pid0: int):
        o, lse = _forward(q, k, v, scale, rate, seed, any(ctx.needs_input_grad[:3]), pid0)
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.scale, ctx.rate, ctx.pid0 = scale, rate, pid0
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, seed = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, g, o, lse, ctx.scale, ctx.rate, seed, ctx.pid0)
        return dq, dk, dv, None, None, None, None


def fused_pooled_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seed=0,
    batch_offset: int = 0,
) -> torch.Tensor:
    """Attention for ``q (N, L, H, E)``, ``k/v (N, M, H, E)``, differentiable
    in q, k and v.

    On CUDA tensors: the hand-written kernels (forward, and backward when
    a gradient is asked for), or an exception. On CPU tensors: the plain
    versions. ``dropout_rate`` > 0 applies post-softmax probability
    dropout from the counter hash seeded by ``dropout_seed``: an int32
    scalar tensor on q's device (what a captured step passes), or an int.
    ``batch_offset`` is the global index of q's first batch row (a
    data-parallel rank's ``n0``): the mask is then that rank's rows of the
    global batch's mask (the kernels' ``pid0 = n0 * H``).
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    return _PooledAttention.apply(q, k, v, float(scale), float(dropout_rate),
                                  seed_tensor(dropout_seed, q.device),
                                  int(batch_offset) * q.shape[2])
