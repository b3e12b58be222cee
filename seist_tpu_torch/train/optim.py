"""Optimizer construction (counterpart of ``seist_tpu/train/optim.py``).

The JAX package builds optax chains; the port uses ``torch.optim``, whose
update rules are optax's:

* Adam: ``weight_decay`` is L2 added to the gradient (optax
  ``add_decayed_weights`` before ``adam``, which is torch Adam's rule);
* AdamW: decoupled decay ``p -= lr * wd * p`` beside the Adam update;
* SGD: heavy-ball momentum on the L2-decayed gradient (optax ``trace``
  starts from zero, torch's buffer from the first gradient: the same).

The learning rate of update ``t`` is set by the train step from the
schedule before each ``step()``; :func:`set_lr` does it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch


def l1_sign_decay(
    named_params: Iterable, alpha: float, mask: Optional[Callable[[str], bool]] = None
) -> None:
    """L1 regularization in gradient space: ``g += alpha * sign(w)`` on the
    parameters ``mask(name)`` selects (all when None). Call between
    ``backward()`` and the optimizer step, as the JAX package chains
    ``l1_sign_decay`` before its optimizer."""
    with torch.no_grad():
        for name, p in named_params:
            if p.grad is None or (mask is not None and not mask(name)):
                continue
            p.grad.add_(torch.sign(p), alpha=alpha)


def build_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    weight_decay: float = 0.0,
    momentum: float = 0.9,
) -> torch.optim.Optimizer:
    """Adam / AdamW / SGD by name (case-insensitive). The learning rate
    starts at 0 and is set per update from the schedule."""
    name = name.lower()
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               weight_decay=weight_decay)
    raise NotImplementedError(f"Unsupported optimizer: '{name}' (adam/adamw/sgd)")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
