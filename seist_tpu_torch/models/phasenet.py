"""PhaseNet in torch, channels-last ``(N, L, C)``: a 1-D U-Net for phase
picking (counterpart of ``seist_tpu/models/phasenet.py``).

Stride-4 convolutions down and transposed convolutions up, five levels,
each skip concatenated after cropping the transposed conv's overhang,
then a softmax over the three classes (non, ppk, spk). Submodules carry
the flax module names (``down1.conv0``, ``up2.convt``, ...) for
``models/convert.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from seist_tpu_torch.models.common import (
    BatchNorm,
    Conv1d,
    ConvTranspose1d,
    Dropout,
    auto_pad_1d,
    auto_pad_amount,
    same_pad_1d,
)
from seist_tpu_torch.registry import register_model


class ConvBlock(nn.Module):
    """Optional stride conv + same conv (``phasenet.py:23``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 drop_rate: float, has_stride_conv: bool = True):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.has_stride_conv = has_stride_conv
        if has_stride_conv:
            self.conv0 = Conv1d(in_channels, in_channels, kernel_size, stride=stride)
            self.bn0 = BatchNorm(in_channels)
            self.drop0 = Dropout(drop_rate)
        self.conv1 = Conv1d(in_channels, out_channels, kernel_size)
        self.bn1 = BatchNorm(out_channels)
        self.drop1 = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.has_stride_conv:
            x = auto_pad_1d(x, self.kernel_size, self.stride)
            x = self.drop0(torch.relu(self.bn0(self.conv0(x))))
        x = self.conv1(same_pad_1d(x, self.kernel_size))
        return self.drop1(torch.relu(self.bn1(x)))


class ConvTransBlock(nn.Module):
    """Optional same conv (on the concat) + transposed conv
    (``phasenet.py:64``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 drop_rate: float, has_conv_same: bool = True, has_conv_trans: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.has_conv_same, self.has_conv_trans = has_conv_same, has_conv_trans
        if has_conv_same:
            self.conv0 = Conv1d(2 * in_channels, in_channels, kernel_size)
            self.bn0 = BatchNorm(in_channels)
            self.drop1 = Dropout(drop_rate)
        if has_conv_trans:
            self.drop0 = Dropout(drop_rate)
            self.convt = ConvTranspose1d(in_channels, out_channels, kernel_size, stride)
            self.bn1 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.has_conv_same:
            x = torch.relu(self.bn0(self.conv0(same_pad_1d(x, self.kernel_size))))
        if self.has_conv_trans:
            x = torch.relu(self.bn1(self.convt(self.drop0(x))))
        if self.has_conv_same:
            x = self.drop1(x)
        return x


class PhaseNet(nn.Module):
    """(N, L, C) -> (N, L, 3) probabilities (``phasenet.py:108``)."""

    def __init__(self, in_channels: int = 3, kernel_size: int = 7, stride: int = 4,
                 conv_channels: Sequence[int] = (8, 16, 32, 64, 128), drop_rate: float = 0.1):
        super().__init__()
        ch = list(conv_channels)
        depth = len(ch)
        self.kernel_size, self.stride, self.depth = kernel_size, stride, depth
        self.conv_in = Conv1d(in_channels, ch[0], kernel_size, bias=True)
        self.bn_in = BatchNorm(ch[0])
        self.drop_in = Dropout(drop_rate)
        down_in = ch[:1] + ch[:-1]
        for i in range(depth):
            self.add_module(f"down{i}", ConvBlock(down_in[i], ch[i], kernel_size, stride,
                                                  drop_rate, has_stride_conv=i != 0))
        up_in = ch[::-1]
        up_out = ch[-2::-1] + [ch[0]]  # the last block has no transposed conv
        for j in range(depth):
            rev = depth - 1 - j
            self.add_module(f"up{j}", ConvTransBlock(
                up_in[j], up_out[j], kernel_size, stride, drop_rate,
                has_conv_same=rev < depth - 1, has_conv_trans=rev > 0))
        self.conv_out = Conv1d(ch[0], 3, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(same_pad_1d(x, self.kernel_size))
        x = self.drop_in(torch.relu(self.bn_in(x)))
        shortcuts = []
        for i in range(self.depth):
            x = getattr(self, f"down{i}")(x)
            if i < self.depth - 1:
                shortcuts.append(x)
        for j in range(self.depth):
            x = getattr(self, f"up{j}")(x)
            if j == self.depth - 1:
                break
            shortcut = shortcuts[-(j + 1)]
            # Crop the transposed conv's overhang, then concat the skip
            # (phasenet.py:169-175).
            lp, rp = auto_pad_amount(shortcut.shape[-2], self.kernel_size, self.stride)
            x = torch.cat([shortcut, x[:, lp : x.shape[-2] - rp]], dim=-1)
        return torch.softmax(self.conv_out(x), dim=-1)


@register_model
def phasenet(**kwargs) -> PhaseNet:
    kwargs.pop("in_samples", None)
    return PhaseNet(**kwargs)
