"""Train and eval steps (counterpart of ``seist_tpu/train/step.py``).

The JAX package's step is one jitted program over an immutable
``TrainState``; here it is eager PyTorch over a mutable
:class:`TrainState` that holds the model (parameters and BatchNorm
running statistics), the optimizer (its moments) and the count of applied
updates. The learning rate of update ``t`` is ``schedule(t)``.

The guard (``_guarded_update``): a non-finite loss or global gradient norm
leaves the parameters, the optimizer moments and the BatchNorm running
statistics untouched and does not advance the update count. Torch's
BatchNorm updates its buffers during the forward (JAX's are functional),
so the step snapshots them first and restores them on a skip. Deciding
costs one host sync per step (one boolean read back from the device).

Scanned multi-step, gradient accumulation and device-augmentation
variants are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from seist_tpu_torch.models.common import RandomSource, set_random_source
from seist_tpu_torch.train.optim import set_lr
from seist_tpu_torch.train.schedule import Schedule


@dataclass
class TrainState:
    """What one run trains: ``step`` counts applied updates."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0


def _bn_buffers(model: torch.nn.Module):
    return [b for name, b in model.named_buffers() if name.endswith(("running_mean", "running_var"))]


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over every leaf."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )


def make_train_step(loss_fn: Callable, guard: bool = True) -> Callable:
    """Build ``train_step(state, inputs, targets, rng) -> (loss, outputs,
    diag)``: a train-mode forward with randomness from ``rng`` (a
    :class:`RandomSource`), backward, and the optimizer update at
    ``schedule(state.step)``. ``diag`` is ``{"applied": bool, "grad_norm":
    float}``; ``loss`` is the raw (possibly non-finite) value. With
    ``guard=False`` every update is applied and ``diag`` holds no host
    values (no sync)."""

    def train_step(state: TrainState, inputs, targets, rng: RandomSource):
        model, opt = state.model, state.optimizer
        saved = [b.clone() for b in _bn_buffers(model)] if guard else None
        model.train()
        set_random_source(model, rng)
        try:
            outputs = model(inputs)
            loss = loss_fn(outputs, targets)
        finally:
            set_random_source(model, None)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        diag: Dict[str, Any] = {}
        if guard:
            grad_norm = global_norm([p.grad for p in params])
            host = torch.stack([loss.detach().float(), grad_norm]).cpu()  # the one sync
            finite = bool(torch.isfinite(host).all())
            diag = {"applied": finite, "grad_norm": float(host[1])}
            if not finite:
                with torch.no_grad():
                    for buf, old in zip(_bn_buffers(model), saved):
                        buf.copy_(old)
                opt.zero_grad(set_to_none=True)
                return loss.detach(), outputs.detach(), diag
        set_lr(opt, state.schedule(state.step))
        opt.step()
        state.step += 1
        return loss.detach(), outputs.detach(), diag

    return train_step


def make_eval_step(loss_fn: Callable) -> Callable:
    """Build ``eval_step(state, inputs, targets, mask) -> (loss, outputs)``.

    ``mask`` (float, shape (N,)) zeroes padded tail rows: the loss is
    recombined from per-sample losses (the loss of each sample as a batch
    of one) — a mask-weighted mean for mean-reduced losses, a masked sum
    for sum-reduced ones (``loss_fn.reduction == 'sum'``)."""
    sum_reduced = getattr(loss_fn, "reduction", "mean") == "sum"

    def one(o1, t1):
        return loss_fn(o1[None], t1[None])

    per_sample_fn = torch.vmap(one)

    @torch.no_grad()
    def eval_step(state: TrainState, inputs, targets, mask) -> Tuple[torch.Tensor, Any]:
        model = state.model
        model.eval()
        outputs = model(inputs)
        per_sample = per_sample_fn(outputs, targets)
        w = mask.to(per_sample.dtype)
        masked = (per_sample * w).sum()
        loss = masked if sum_reduced else masked / torch.clamp(w.sum(), min=1.0)
        return loss, outputs

    return eval_step


def step_random_source(seed: int, epoch: int, step: int, device) -> RandomSource:
    """The randomness of one train step, a pure function of (seed, epoch,
    step) as the JAX package folds the step into the epoch key."""
    word = np.random.SeedSequence([int(seed), int(epoch), int(step)]).generate_state(1)[0]
    return RandomSource.from_seed(int(word), device)


def move_batch(x, device: torch.device):
    """numpy arrays (or tuples of them) -> tensors on ``device``."""
    if isinstance(x, (tuple, list)):
        return tuple(move_batch(t, device) for t in x)
    return torch.as_tensor(x).to(device)
