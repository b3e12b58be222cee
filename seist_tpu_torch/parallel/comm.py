"""The collectives of multi-rank training: a sum or mean all-reduce, an
all-gather along an axis, an all-to-all and a ring rotation, plus the
autograd functions built on them.

Under NCCL a collective runs on the tensor where it lies, on the current
stream, so it can sit inside a captured CUDA graph. gloo moves host
memory only (it cannot send a CUDA tensor point to point), so a CUDA
tensor under gloo is staged through pinned host buffers here, and only
here: copied out, reduced or moved on the host, copied back. That path
synchronises with the host, so a step that takes it cannot be captured
(``train/graph.py`` refuses to). A CPU tensor under NCCL travels through
this rank's card the other way round.

``group`` is a process subgroup (``parallel/mesh.py``) or None for every
rank.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as tdist

from seist_tpu_torch.parallel import dist


def group_size(group=None) -> int:
    return tdist.get_world_size(group) if dist.is_dist_avail_and_initialized() else 1


def group_rank(group=None) -> int:
    return tdist.get_rank(group) if dist.is_dist_avail_and_initialized() else 0


def staged(t: torch.Tensor) -> bool:
    """True when ``t`` must travel through host buffers (gloo, CUDA)."""
    return dist.backend() == "gloo" and t.device.type == "cuda"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can move it: pinned host memory under gloo
    for a CUDA tensor, this rank's card under NCCL for a CPU tensor, else
    ``t`` itself (contiguous)."""
    if staged(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    if dist.backend() == "nccl" and t.device.type == "cpu":
        return t.to(dist.rank_device("cuda"))
    return t.contiguous()


def _back(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return wire if wire.device == like.device else wire.to(like.device)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The sum (or ``mean``) of ``t`` over ``group``, as a new tensor on
    ``t``'s device. One rank: a copy."""
    size = group_size(group)
    w = _wire(t)
    if w is t:
        w = t.clone()
    if dist.is_dist_avail_and_initialized():  # one rank too: its copy
        tdist.all_reduce(w, group=group)
    out = _back(w, t)
    if op == "mean" and size > 1:
        out = out / size
    elif op not in ("sum", "mean"):
        raise ValueError(f"op must be sum or mean, got {op!r}")
    return out


def all_gather(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in rank
    order."""
    size = group_size(group)
    if size == 1:
        return t.clone()
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(size)]
    tdist.all_gather(parts, w, group=group)
    return _back(torch.cat(parts, dim=dim), t)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Slice ``t[j]`` of the leading axis (one per rank of ``group``) sent
    to rank j; returns the slices received, ``out[i]`` from rank i (the
    device-aug cache's row exchange, ``data/pipeline.py::exchange_rows``).
    One rank: its copy."""
    size = group_size(group)
    if t.shape[0] != size:
        raise ValueError(f"leading axis {t.shape[0]} != {size} ranks")
    if not dist.is_dist_avail_and_initialized():
        return t.clone()
    w = _wire(t)
    out = torch.empty_like(w)
    tdist.all_to_all_single(out, w, group=group)
    return _back(out, t)


def rotate(t: torch.Tensor, group=None, step: int = 1) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on in ``group``'s ring and
    return what arrived from the rank ``step`` places back."""
    size = group_size(group)
    if size == 1 or step % size == 0:
        return t.clone()
    ranks = _global_ranks(group)
    me = group_rank(group)
    dst, src = ranks[(me + step) % size], ranks[(me - step) % size]
    w = _wire(t)
    recv = torch.empty_like(w)
    ops = [tdist.P2POp(tdist.isend, w, dst, group), tdist.P2POp(tdist.irecv, recv, src, group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return _back(recv, t)


def _global_ranks(group) -> List[int]:
    if group is None:
        return list(range(tdist.get_world_size()))
    return tdist.get_process_group_ranks(group)


class AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the incoming gradients over
    the group too (each rank's output feeds its own loss, and the global
    loss is their sum): SyncBatchNorm's statistics."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


class Rotate(torch.autograd.Function):
    """:func:`rotate` one place on; its backward rotates the gradient one
    place back (the transpose of a permutation: ``lax.ppermute``'s)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return rotate(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return rotate(g.contiguous(), ctx.group, -1), None


class SeqSlice(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim`` (``group``'s ranks split
    it in order). Its backward all-gathers the blocks' gradients: each
    rank then holds the whole gradient, as each held the whole ``x``."""

    @staticmethod
    def forward(ctx, x, dim, group):
        size, me = group_size(group), group_rank(group)
        if x.shape[dim] % size:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} not divisible by {size} ranks")
        ctx.dim, ctx.group = dim, group
        b = x.shape[dim] // size
        return x.narrow(dim, me * b, b).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


class SeqGather(torch.autograd.Function):
    """The blocks of ``group``'s ranks concatenated along ``dim``. Its
    backward is this rank's slice of the gradient, not a sum: every rank
    holds the same downstream gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.b = dim, group, x.shape[dim]
        return all_gather(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        me = group_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.b, ctx.b).contiguous(), None, None

