"""BAZ network in torch, channels-last ``(N, L, C)``: back-azimuth from one
station's waveforms, a conv stack beside covariance and eigen features,
to a (cos, sin) pair (counterpart of ``seist_tpu/models/baz_network.py``).

The features (:func:`cov_features`) are a function of the input alone,
outside the gradient. On CUDA ``torch.linalg.eigh`` synchronises the
device with the host, which a CUDA graph cannot hold, so a captured step
computes them before its replay (:meth:`BAZNetwork.captured_inputs`,
called by ``train/graph.py``) and passes ``(x, features)`` as the input;
the eager forward, which serving and the CPU run, computes them itself.
Eigenvector signs are the solver's (LAPACK on the CPU, cuSOLVER on the
card), as the JAX package takes ``eigh``'s.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from seist_tpu_torch.models.common import Conv1d, Dropout, ceil_len, max_pool_1d_ceil
from seist_tpu_torch.registry import register_model


@torch.no_grad()
def cov_features(x: torch.Tensor) -> torch.Tensor:
    """Covariance and eigen features, (N, L, C) -> (N, 2C+1, C)
    (``baz_network.py:27``): the channel covariance scaled by its largest
    magnitude, the eigenvalues by the largest, and the eigenvectors, in
    fp32 whatever the input's dtype (eigh has no bf16)."""
    xf = x.float()
    diff = xf - xf.mean(dim=1, keepdim=True)
    cov = torch.einsum("nlc,nld->ncd", diff, diff) / (x.shape[1] - 1)
    values, vectors = torch.linalg.eigh(cov)
    values = values[..., None]
    values = values / values.amax(dim=(-2, -1), keepdim=True)
    cov = cov / cov.abs().amax(dim=(-2, -1), keepdim=True)
    feat = torch.cat([cov, values, vectors], dim=-1)  # (N, C, 2C+1)
    return feat.transpose(-1, -2).contiguous().to(x.dtype)


class BAZNetwork(nn.Module):
    """(N, L, C) -> ((N, 1) cos, (N, 1) sin) (``baz_network.py:41``)."""

    def __init__(self, in_channels: int = 3, in_samples: int = 8192,
                 conv_channels: Sequence[int] = (20, 32, 64, 20), kernel_size: int = 3,
                 pool_size: int = 2, lin_hidden_dim: int = 100, drop_rate: float = 0.3):
        super().__init__()
        self.pad, self.pool_size = (kernel_size - 1) // 2, pool_size
        self.num_conv = len(conv_channels)
        c, length = in_channels, in_samples
        for i, outc in enumerate(conv_channels):
            self.add_module(f"wave_conv{i}", Conv1d(c, outc, kernel_size, bias=True))
            self.add_module(f"drop{i}", Dropout(drop_rate))
            c, length = outc, ceil_len(length + 2 * self.pad - kernel_size + 1, pool_size)
        self.conv1 = nn.Linear(in_channels, conv_channels[-1])  # 1x1 conv on the features
        self.lin0 = nn.Linear(c * length + (2 * in_channels + 1) * conv_channels[-1],
                              lin_hidden_dim)
        self.drop = Dropout(drop_rate)
        self.lin1 = nn.Linear(lin_hidden_dim, 2)

    def captured_inputs(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The input of a captured step: ``(x, cov_features(x))``."""
        return x, cov_features(x)

    def forward(self, x: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, x1 = x if isinstance(x, (tuple, list)) else (x, cov_features(x))
        for i in range(self.num_conv):
            x = nn.functional.pad(x, (0, 0, self.pad, self.pad))
            x = getattr(self, f"drop{i}")(torch.relu(getattr(self, f"wave_conv{i}")(x)))
            x = max_pool_1d_ceil(x, self.pool_size)
        x = x.reshape(x.shape[0], -1)
        x1 = torch.relu(self.conv1(x1)).reshape(x1.shape[0], -1)
        x = self.drop(torch.relu(self.lin0(torch.cat([x, x1], dim=-1))))
        x = self.lin1(x)
        return x[:, :1], x[:, 1:]


@register_model
def baz_network(**kwargs) -> BAZNetwork:
    return BAZNetwork(**kwargs)
