"""Ring attention: exact attention with the sequence split over the ranks
of the mesh's ``seq`` axis (counterpart of ``seist_tpu/ops/ring_attention.py``).

Each rank keeps its block of query rows and its block of K/V rows, and
the K/V blocks travel round the ring (``parallel/comm.py::Rotate``, whose
backward rotates the gradient the other way) while the softmax
accumulates online:

    m' = max(m, max_j s_ij);  corr = exp(m - m')
    l' = l * corr + sum_j exp(s_ij - m')
    o' = o * corr + exp(s - m') v

``o / l`` after ``S`` blocks is softmax attention over the whole
sequence. The local block comes first, then ``S - 1`` rotations to the
next rank; after ``t`` of them a rank holds the block that started on
ring position ``(my - t) mod S``. The running maximum carries no gradient
(the result does not depend on it).

Post-softmax dropout is exact too: the mask multiplies each block's
numerator contribution and ``l`` stays unmasked, since the dense path
divides by the full softmax denominator. The mask is the counter hash of
``ops/pooled_attention.py`` over the global (batch, head, row, column)
index, so each rank regenerates its slice of the dense mask: the batch
offset ``n0`` is the data rank's first row, the row offset this rank's
first query row, the column offset the block's first key. The counters
wrap modulo 2^32, as the JAX package's int32 counters do.

The block products are fp32 ``torch.einsum``, as the JAX package's are
XLA einsums outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.parallel import comm

_M32 = 0xFFFFFFFF


def _block_dropout_mult(seed, rate: float, n: int, h: int, lq: int, mk: int, n0: int,
                        row0: int, col0: int, l_total: int, m_total: int,
                        device) -> torch.Tensor:
    """(n, h, lq, mk) multiplier, 0 where dropped and 1/(1 - rate) where
    kept: the dense mask's slice at global offsets (n0, row0, col0). The
    dense counter is ``(b*H + h) * (L*M) + row*M + col`` mod 2^32; the
    heads are never split (the model axis is 1), so ``h`` is global."""
    ni = torch.arange(n, dtype=torch.int64, device=device).view(n, 1, 1, 1) + n0
    hi = torch.arange(h, dtype=torch.int64, device=device).view(1, h, 1, 1)
    ri = torch.arange(lq, dtype=torch.int64, device=device).view(1, 1, lq, 1) + row0
    ci = torch.arange(mk, dtype=torch.int64, device=device).view(1, 1, 1, mk) + col0
    pid = (ni * h + hi) & _M32
    x = (pa._mul32(pid, (l_total * m_total) & _M32) + pa._mul32(ri & _M32, m_total & _M32)) & _M32
    x = (x + ci) & _M32
    keep = pa._mix_to_uniform(x, seed) >= torch.tensor(rate, dtype=torch.float32)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0)


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    batch_offset: int = 0,
) -> torch.Tensor:
    """One rank's part: its blocks ``q (N, Lq, H, E)``, ``k/v (N, Mk, H,
    E)`` of a sequence split over ``group`` in rank order. Returns its
    ``(N, Lq, H, E)`` rows of exact attention over the whole sequence, in
    q's dtype. ``batch_offset`` is the global index of this rank's first
    batch row (the dropout mask's ``n0``)."""
    n, lq, h, e = q.shape
    mk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(e)
    size, me = comm.group_size(group), comm.group_rank(group)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    qs = q.float() * scale

    def accumulate(o, m, l, k_blk, v_blk, src: int):
        s = torch.einsum("nlhe,nmhe->nhlm", qs, k_blk)
        m_new = torch.maximum(m, s.amax(dim=-1)).detach()
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        if dropout_rate > 0.0:
            # The numerator only: l stays unmasked (module docstring).
            p = p * _block_dropout_mult(dropout_seed, float(dropout_rate), n, h, lq, mk,
                                        batch_offset, me * lq, src * mk, lq * size,
                                        mk * size, q.device)
        o_new = o * corr[..., None] + torch.einsum("nhlm,nmhe->nhle", p, v_blk)
        return o_new, m_new, l_new

    o = q.new_zeros((n, h, lq, e), dtype=torch.float32)
    m = q.new_full((n, h, lq), float("-inf"), dtype=torch.float32)
    l = q.new_zeros((n, h, lq), dtype=torch.float32)
    k_blk, v_blk = k.float(), v.float()
    o, m, l = accumulate(o, m, l, k_blk, v_blk, me)
    for t in range(1, size):
        k_blk = comm.Rotate.apply(k_blk, group)
        v_blk = comm.Rotate.apply(v_blk, group)
        o, m, l = accumulate(o, m, l, k_blk, v_blk, (me - t) % size)
    out = o / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    batch_offset: int = 0,
) -> torch.Tensor:
    """Exact attention for ``q (N, L, H, E)``, ``k/v (N, M, H, E)``, which
    every rank of ``group`` holds whole (as SeisT's seq ranks hold their
    activations): each rank takes its block of the query rows and of the
    K/V rows, runs the ring, and the output blocks are gathered back. The
    slice's backward gathers the gradients and the gather's backward
    takes this rank's slice, so everything outside the attention stays
    identical on the group's ranks. L and M must divide by the group's
    size. ``dropout_rate`` > 0 needs ``dropout_seed`` (an int or the
    kernels' int32 seed tensor): the same mask as ``fused_pooled_attention``."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    size = comm.group_size(group)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[1] % size:
            raise ValueError(f"{name}'s sequence length {t.shape[1]} is not divisible by the "
                             f"{size} ranks of the seq axis")
    q_blk = comm.SeqSlice.apply(q, 1, group)
    k_blk = comm.SeqSlice.apply(k, 1, group)
    v_blk = comm.SeqSlice.apply(v, 1, group)
    out = ring_attention_local(q_blk, k_blk, v_blk, group, scale, dropout_rate,
                               dropout_seed, batch_offset)
    return comm.SeqGather.apply(out, 1, group)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed: int = 0) -> torch.Tensor:
    """The one-rank reference: softmax attention over (N, L, H, E), the
    plain version of ``ops/pooled_attention.py``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return pa.pooled_attention_plain(q, k, v, scale, dropout_rate, dropout_seed)
