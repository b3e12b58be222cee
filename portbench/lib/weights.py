"""Seeded weights, made on the device in one draw and handed to both the
program and the reference.

The reference model gives the names and shapes. Every kernel is drawn
normal with std ``1 / sqrt(fan_in)`` (fan-in: a linear layer's inputs, a
convolution's inputs per group times its width, a transposed
convolution's inputs times its width over its stride), so activations keep
their scale through the depth; BatchNorm scales are ``1 + 0.1 z``, and
shifts and biases ``0.02 z``. Running statistics start at 0 and 1. The
published initialisation (a truncated normal at 0.02) makes SeisT's
picking head give 0.5 everywhere, which no comparison can tell from a
broken program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from portbench.reference import phasenet as ref_phasenet
from portbench.reference import seist as ref_seist


def _fan_in(module: nn.Module, name: str, w: torch.Tensor) -> float:
    if isinstance(module, ref_phasenet.ConvTranspose):
        return w.shape[0] * w.shape[2] / module.stride
    return float(w[0].numel())


def make_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``model``'s names, in float32 on ``device``."""
    params = list(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=g, device=device)
    owners = {f"{mn}.{pn}" if mn else pn: m for mn, m in model.named_modules()
              for pn, _ in m.named_parameters(recurse=False)}
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, p in params:
        chunk = z[at:at + p.numel()].view(p.shape)
        at += p.numel()
        owner = owners[name]
        if p.ndim >= 2:
            out[name] = chunk / math.sqrt(_fan_in(owner, name, p))
        elif isinstance(owner, ref_seist.BatchNorm) and name.endswith("weight"):
            out[name] = 1.0 + 0.1 * chunk
        else:
            out[name] = 0.02 * chunk
    for name, b in model.named_buffers():
        out[name] = (torch.ones if name.endswith("running_var") else torch.zeros)(
            b.shape, device=device)
    return out
