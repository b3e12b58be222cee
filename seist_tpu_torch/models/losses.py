"""Loss library (8 losses), channels-last, in torch.

Counterpart of ``seist_tpu/models/losses.py``: losses consume
**probabilities** (models end in softmax/sigmoid) with eps 1e-6 inside
logs; dense outputs are ``(N, L, C)`` and class outputs ``(N, Classes)``,
so the class/channel axis is always ``-1``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

_EPS = 1e-6


def _as_weight(weight) -> Optional[torch.Tensor]:
    """A reference-style weight spec (possibly nested lists like
    ``[[0.5], [1], [1]]``) as a flat per-channel vector; None for 1."""
    if weight is None:
        return None
    return torch.from_numpy(np.asarray(weight, dtype=np.float32).reshape(-1))


def _weighted(loss: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    return loss if weight is None else loss * weight.to(loss.device)


class CELoss:
    """Cross entropy on probability outputs; ``(N, L, C)`` or ``(N, Classes)``."""

    def __init__(self, weight=None):
        self.weight = _as_weight(weight)

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss = _weighted(-targets * torch.log(preds + _EPS), self.weight)
        return loss.sum(dim=-1).mean()


class BCELoss:
    """Binary cross entropy on probability outputs."""

    def __init__(self, weight=None):
        self.weight = _as_weight(weight)

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss = -(
            targets * torch.log(preds + _EPS)
            + (1.0 - targets) * torch.log(1.0 - preds + _EPS)
        )
        return _weighted(loss, self.weight).mean()


class FocalLoss:
    """Focal loss; ``has_softmax`` applies softmax over the class axis."""

    def __init__(self, gamma: float = 2.0, weight=None, has_softmax: bool = True):
        self.gamma = gamma
        self.weight = _as_weight(weight)
        self.has_softmax = has_softmax

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if self.has_softmax:
            preds = torch.exp(preds - preds.amax(dim=-1, keepdim=True))
            preds = preds / preds.sum(dim=-1, keepdim=True)
        loss = -targets * torch.log(preds + _EPS)
        loss = loss * torch.pow(1.0 - preds, self.gamma)
        return _weighted(loss, self.weight).sum(dim=-1).mean()


class BinaryFocalLoss:
    """Binary focal loss on sigmoid outputs."""

    def __init__(self, gamma: float = 2.0, alpha: float = 1.0, weight=None):
        self.gamma = gamma
        self.alpha = alpha
        self.weight = _as_weight(weight)

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss = -(
            self.alpha * torch.pow(1.0 - preds, self.gamma) * targets
            * torch.log(preds + _EPS)
            + (1.0 - self.alpha) * torch.pow(preds, self.gamma) * (1.0 - targets)
            * torch.log(1.0 - preds + _EPS)
        )
        return _weighted(loss, self.weight).mean()


class MSELoss:
    """Mean squared error."""

    def __init__(self, weight=None):
        self.weight = _as_weight(weight)

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return _weighted((preds - targets) ** 2, self.weight).mean()


class HuberLoss:
    """Huber loss, delta 1, mean reduction (``torch.nn.HuberLoss``)."""

    def __init__(self, delta: float = 1.0):
        self.delta = delta

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        abs_err = (preds - targets).abs()
        quad = torch.clamp(abs_err, max=self.delta)
        lin = abs_err - quad
        return (0.5 * quad**2 + self.delta * lin).mean()


class CombinationLoss:
    """Weighted sum of per-output losses for multi-task models."""

    def __init__(
        self,
        losses: Sequence[Callable],
        losses_weights: Optional[Sequence[float]] = None,
    ):
        if len(losses) < 2:
            raise ValueError(
                "CombinationLoss requires at least two loss modules; use the "
                "one loss directly instead."
            )
        if losses_weights is not None and len(losses_weights) != len(losses):
            raise ValueError("losses and losses_weights differ in length")
        self.losses_weights = (
            list(losses_weights) if losses_weights is not None else [1.0] * len(losses)
        )
        self.losses = [make() for make in losses]

    @property
    def reduction(self) -> str:
        """'sum' if any component is sum-reduced, else 'mean'."""
        return (
            "sum"
            if any(getattr(fn, "reduction", "mean") == "sum" for fn in self.losses)
            else "mean"
        )

    def __call__(
        self, preds: Tuple[torch.Tensor, ...], targets: Tuple[torch.Tensor, ...]
    ) -> torch.Tensor:
        total = 0.0
        for pred, target, loss_fn, w in zip(preds, targets, self.losses, self.losses_weights):
            total = total + loss_fn(pred, target) * w
        return total


class MousaviLoss:
    """Heteroscedastic regression loss; ``preds`` is ``(N, 2)``:
    (y_hat, log sigma^2). Sum-reduced over the batch."""

    reduction = "sum"

    def __call__(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        y_hat = preds[:, 0].reshape(-1, 1)
        s = preds[:, 1].reshape(-1, 1)
        return torch.sum(0.5 * torch.exp(-s) * (targets - y_hat).abs().square() + 0.5 * s)


__all__ = [
    "CELoss",
    "BCELoss",
    "FocalLoss",
    "BinaryFocalLoss",
    "MSELoss",
    "HuberLoss",
    "CombinationLoss",
    "MousaviLoss",
]
