"""Model construction and seeded initialization (counterpart of
``seist_tpu/models/api.py``)."""

from __future__ import annotations

import torch
from torch import nn

from seist_tpu_torch.models import common
from seist_tpu_torch.models.common import INIT_STD
from seist_tpu_torch.registry import MODELS


def create_model(
    model_name: str,
    in_channels: int = 3,
    in_samples: int = 8192,
    *,
    seed: int = 0,
    **kwargs,
) -> nn.Module:
    """Instantiate a registered model on the CPU, in eval mode, with
    weights drawn by :func:`init_weights` from ``seed``."""
    import seist_tpu_torch

    seist_tpu_torch.load_all()
    model = MODELS.create(
        model_name, in_channels=in_channels, in_samples=in_samples, **kwargs
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``generator`` in
    registration order.

    SeisT (``model.trunc_normal_init``): every kernel (Linear and conv
    weights, ndim >= 2) truncated normal with std 0.02 cut at 2 std, every
    bias zero, BatchNorm scale one. The baseline families: flax's defaults
    by module (:func:`_flax_init`). BatchNorm running statistics stay
    0 / 1."""
    if not getattr(model, "trunc_normal_init", False):
        _flax_init(model, generator)
        return
    for name, p in model.named_parameters():
        if p.ndim >= 2:
            nn.init.trunc_normal_(
                p, std=INIT_STD, a=-2 * INIT_STD, b=2 * INIT_STD, generator=generator
            )
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)


def _flax_init(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers: ``lecun_normal`` kernels of Dense,
    Conv and ConvTranspose (fan-in = input channels x kernel width), zero
    biases, norm scales one; a module with a ``flax_init`` method
    (EQTransformer's xavier_uniform layers, the LSTM's orthogonal
    recurrent kernels) initialises itself and what it holds."""
    own = getattr(module, "flax_init", None)
    if own is not None:
        own(generator)
        return
    if isinstance(module, (nn.Linear, common.Conv1d, common.ConvTranspose1d)):
        w = module.weight
        fan_in = w.shape[0] * w.shape[2] if isinstance(module, common.ConvTranspose1d) else (
            w[0].numel())
        common.lecun_normal_(w, fan_in, generator)
        if getattr(module, "bias", None) is not None:
            module.bias.zero_()
    elif isinstance(module, (common.BatchNorm, nn.LayerNorm)):
        module.weight.fill_(1.0)
        module.bias.zero_()
    elif any(True for _ in module.parameters(recurse=False)):
        raise TypeError(f"no initialiser for the parameters of {type(module).__name__}")
    for child in module.children():
        _flax_init(child, generator)
