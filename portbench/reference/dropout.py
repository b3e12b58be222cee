"""Dropout for the reference, with the masks redrawn from the step's seed.

The program under test documents how a train step draws its randomness,
as a pure function of (seed, epoch, update); this is a frozen copy of that
scheme, so that the reference applies the same masks without reading
anything the program made:

* the step's word is ``SeedSequence([seed, epoch, update])``'s first
  32-bit word; ``SeedSequence(word)`` gives two 64-bit words;
* the first seeds a ``torch.Generator`` on the activations' device, from
  which every element dropout and DropPath draws its uniforms
  (``torch.rand``), in the forward's call order: element dropout one per
  element, kept where ``u < 1 - rate`` and scaled by ``1 / (1 - rate)``;
  DropPath one per sample, the same rule;
* the second seeds a CPU generator that draws one int32 seed in
  ``[0, 2**31 - 1)`` per attention call, in call order; the post-softmax
  probabilities are kept where the counter hash of that seed and the
  element's index reads at least ``rate`` (:func:`attention_keep`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

M32 = 0xFFFFFFFF
#: Batch-head slices hashed at a time (bounds the int64 temporaries).
HASH_BLOCK = 64


class StepDraws:
    """The randomness of one train step (module docstring)."""

    def __init__(self, seed: int, update: int, device, epoch: int = 0):
        word = np.random.SeedSequence([int(seed), int(epoch), int(update)]).generate_state(1)[0]
        words = np.random.SeedSequence(int(word)).generate_state(2, np.uint64)
        self.device = torch.device(device)
        self.uniforms = torch.Generator(device=self.device).manual_seed(int(words[0]))
        self.seeds = torch.Generator().manual_seed(int(words[1]))

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.uniforms, device=self.device)

    def attention_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.seeds))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): two 16-bit halves of
    ``c``, so that no int64 product overflows."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash_uniform(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3's 32-bit finalizer over ``counter ^ (seed * 0x9E3779B9)``,
    its top 24 bits as a float32 in [0, 1). ``counter`` is int64 in
    [0, 2**32); every shift acts on a non-negative value, so it is logical."""
    x = counter ^ ((int(seed) * 0x9E3779B9) & M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def attention_keep(seed: int, n: int, h: int, length: int, m: int, rate: float,
                   device) -> torch.Tensor:
    """(N, H, L, M) keep mask of the post-softmax dropout: element (b, j, l,
    c) is counted ``(b*H + j) * (L*M) + l*M + c`` mod 2**32 and kept where
    its hash's uniform is at least ``rate`` (both float32)."""
    rate32 = torch.tensor(rate, dtype=torch.float32, device=device)
    inner = (torch.arange(length, dtype=torch.int64, device=device).view(length, 1) * m
             + torch.arange(m, dtype=torch.int64, device=device).view(1, m))
    out = torch.empty(n * h, length, m, dtype=torch.bool, device=device)
    for lo in range(0, n * h, HASH_BLOCK):
        pid = torch.arange(lo, min(lo + HASH_BLOCK, n * h), dtype=torch.int64, device=device)
        counter = (_mul32(pid.view(-1, 1, 1), (length * m) & M32) + inner) & M32
        out[lo:lo + pid.numel()] = hash_uniform(counter, seed) >= rate32
    return out.view(n, h, length, m)


class Dropout(nn.Module):
    """Element dropout from the attached :class:`StepDraws`; the identity in
    eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.draws: Optional[StepDraws] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        u = need_draws(self).uniform(x.shape)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Stochastic depth, one uniform per sample from the attached
    :class:`StepDraws`; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.draws: Optional[StepDraws] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        u = need_draws(self).uniform((x.shape[0],))
        mask = (u < keep).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def need_draws(module: nn.Module) -> StepDraws:
    if module.draws is None:
        raise RuntimeError(f"{type(module).__name__} in training mode needs the step's draws: "
                           "set_draws(model, StepDraws(...)) before the forward")
    return module.draws


def set_draws(model: nn.Module, draws: Optional[StepDraws]) -> None:
    """Attach ``draws`` to every module of ``model`` that draws in training
    mode (each has a ``draws`` attribute)."""
    for mod in model.modules():
        if hasattr(mod, "draws"):
            mod.draws = draws
