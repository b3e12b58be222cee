"""MagNet in torch, channels-last ``(N, L, C)``: two conv-pool blocks, one
BiLSTM and a linear head giving (magnitude, log-variance) for
``MousaviLoss`` (counterpart of ``seist_tpu/models/magnet.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from seist_tpu_torch.models.common import LSTM, Conv1d, Dropout, auto_pad_1d, max_pool_1d_ceil
from seist_tpu_torch.registry import register_model


class ConvBlock(nn.Module):
    """conv -> dropout -> ceil-mode max-pool (``magnet.py:21``)."""

    def __init__(self, in_channels: int, out_channels: int, conv_kernel_size: int,
                 pool_kernel_size: int, drop_rate: float):
        super().__init__()
        self.conv_kernel_size, self.pool_kernel_size = conv_kernel_size, pool_kernel_size
        self.conv = Conv1d(in_channels, out_channels, conv_kernel_size, bias=True)
        self.drop = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(self.conv(auto_pad_1d(x, self.conv_kernel_size)))
        return max_pool_1d_ceil(x, self.pool_kernel_size)


class MagNet(nn.Module):
    """(N, L, C) -> (N, 2): (y_hat, log sigma^2) (``magnet.py:40``). The
    head reads the BiLSTM's final h, ``concat(fwd_h, bwd_h)``."""

    def __init__(self, in_channels: int = 3, conv_channels: Sequence[int] = (64, 32),
                 lstm_dim: int = 100, drop_rate: float = 0.2):
        super().__init__()
        self.num_conv = len(conv_channels)
        c = in_channels
        for i, outc in enumerate(conv_channels):
            self.add_module(f"conv{i}", ConvBlock(c, outc, 3, 4, drop_rate))
            c = outc
        self.bilstm = LSTM(c, lstm_dim, bidirectional=True)
        self.lin = nn.Linear(2 * lstm_dim, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_conv):
            x = getattr(self, f"conv{i}")(x)
        _, h = self.bilstm(x)
        return self.lin(h)


@register_model
def magnet(**kwargs) -> MagNet:
    kwargs.pop("in_samples", None)
    return MagNet(**kwargs)
