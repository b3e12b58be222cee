"""Model construction and seeded initialization (counterpart of
``seist_tpu/models/api.py``)."""

from __future__ import annotations

import torch
from torch import nn

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
    """The JAX package's SeisT init: every kernel (Linear and conv weights,
    ndim >= 2) truncated normal with std 0.02 cut at 2 std, every bias
    zero, BatchNorm scale one (its running statistics stay 0 / 1).
    Parameters are drawn in registration order from ``generator``."""
    for name, p in model.named_parameters():
        if p.ndim >= 2:
            nn.init.trunc_normal_(
                p, std=INIT_STD, a=-2 * INIT_STD, b=2 * INIT_STD, generator=generator
            )
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
