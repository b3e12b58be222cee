"""dist-PT network in torch, channels-last ``(N, L, C)``: a causal dilated
TCN for epicentral distance and P travel time (counterpart of
``seist_tpu/models/distpt_network.py``). Registered as in the JAX package,
which gives it no task row."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from seist_tpu_torch.models.common import BatchNorm, Conv1d, Dropout, causal_pad_1d
from seist_tpu_torch.registry import register_model


class ResBlock(nn.Module):
    """Two causal dilated convs with channel dropout + a 1x1 residual
    (``distpt_network.py:22``); returns (residual_out, pre_residual)."""

    def __init__(self, channels: int, kernel_size: int, dilation: int, drop_rate: float):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        for i in range(2):
            self.add_module(f"conv{i}", Conv1d(channels, channels, kernel_size, bias=True,
                                               dilation=dilation))
            self.add_module(f"bn{i}", BatchNorm(channels))
            self.add_module(f"drop{i}", Dropout(drop_rate, channel=True))
        self.conv_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(2):
            x = getattr(self, f"conv{i}")(causal_pad_1d(x, self.kernel_size, self.dilation))
            x = getattr(self, f"drop{i}")(torch.relu(getattr(self, f"bn{i}")(x)))
        return x + self.conv_out(x), x


class TemporalConvLayer(nn.Module):
    """1x1 in-projection + dilated ResBlocks, their pre-residual outputs
    summed, at the last time step (``distpt_network.py:52``; the JAX
    package's ``return_sequences`` is False wherever it is built)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_conv_blocks: int, dilations: Sequence[int], drop_rate: float):
        super().__init__()
        self.conv_in = nn.Linear(in_channels, out_channels)
        self.num_blocks = len(dilations) * num_conv_blocks
        for b, dilation in enumerate(list(dilations) * num_conv_blocks):
            self.add_module(f"block{b}", ResBlock(out_channels, kernel_size, dilation, drop_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        total = None
        for b in range(self.num_blocks):
            x, sc = getattr(self, f"block{b}")(x)
            total = sc if total is None else total + sc
        return total[:, -1, :]


class DistPTNetwork(nn.Module):
    """(N, L, C) -> ((N, 2) distance, (N, 2) P travel time)
    (``distpt_network.py:82``)."""

    def __init__(self, in_channels: int = 3, tcn_channels: int = 20, kernel_size: int = 6,
                 num_conv_blocks: int = 1,
                 dilations: Sequence[int] = tuple(2**i for i in range(11)),
                 drop_rate: float = 0.1):
        super().__init__()
        self.tcn = TemporalConvLayer(in_channels, tcn_channels, kernel_size, num_conv_blocks,
                                     dilations, drop_rate)
        self.lin_dist = nn.Linear(tcn_channels, 2)
        self.lin_ptrvl = nn.Linear(tcn_channels, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.tcn(x)
        return self.lin_dist(x), self.lin_ptrvl(x)


@register_model
def distpt_network(**kwargs) -> DistPTNetwork:
    kwargs.pop("in_samples", None)
    return DistPTNetwork(**kwargs)
