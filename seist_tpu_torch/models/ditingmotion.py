"""DiTingMotion in torch, channels-last ``(N, L, C)``: dense multi-branch
convolutions with side outputs for clarity and polarity, fused, the final
outputs the mean of every side output and the fused one (counterpart of
``seist_tpu/models/ditingmotion.py``). The input is ``(N, L, 2)``: the
vertical channel and its first difference."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from seist_tpu_torch.models.common import (
    Conv1d,
    Dropout,
    auto_pad_1d,
    interpolate_nearest,
    max_pool_1d,
)
from seist_tpu_torch.registry import register_model


class CombConvLayer(nn.Module):
    """Parallel convs at several kernel sizes, concatenated with the input,
    then an out conv (``ditingmotion.py:25``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_sizes: Sequence[int],
                 out_kernel_size: int, drop_rate: float):
        super().__init__()
        self.kernel_sizes, self.out_kernel_size = tuple(kernel_sizes), out_kernel_size
        for i, kers in enumerate(self.kernel_sizes):
            self.add_module(f"conv{i}", Conv1d(in_channels, out_channels, kers, bias=True))
        self.drop = Dropout(drop_rate)
        self.out_conv = Conv1d(in_channels + len(self.kernel_sizes) * out_channels, out_channels,
                               out_kernel_size, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        for i, kers in enumerate(self.kernel_sizes):
            outs.append(torch.relu(getattr(self, f"conv{i}")(auto_pad_1d(x, kers))))
        x = self.drop(torch.cat(outs, dim=-1))
        return torch.relu(self.out_conv(auto_pad_1d(x, self.out_kernel_size)))


class BasicBlock(nn.Module):
    """CombConv stack, concatenated with the input, then a floor-mode
    max-pool (``ditingmotion.py:50``)."""

    def __init__(self, in_channels: int, layer_channels: Sequence[int],
                 comb_kernel_sizes: Sequence[int], comb_out_kernel_size: int, drop_rate: float,
                 pool_size: int):
        super().__init__()
        self.pool_size, self.num_layers = pool_size, len(layer_channels)
        c = in_channels
        for i, outc in enumerate(layer_channels):
            self.add_module(f"comb{i}", CombConvLayer(c, outc, comb_kernel_sizes,
                                                      comb_out_kernel_size, drop_rate))
            c = outc
        self.out_channels = in_channels + c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = x
        for i in range(self.num_layers):
            x1 = getattr(self, f"comb{i}")(x1)
        return max_pool_1d(torch.cat([x, x1], dim=-1), self.pool_size)


class SideLayer(nn.Module):
    """CombConv -> channel-major flatten -> two Dense with a sigmoid
    (``ditingmotion.py:75``); returns (features, hidden, probabilities)."""

    def __init__(self, in_channels: int, conv_out_channels: int,
                 comb_kernel_sizes: Sequence[int], comb_out_kernel_size: int, drop_rate: float,
                 linear_in_dim: int, linear_hidden_dim: int, linear_out_dim: int):
        super().__init__()
        self.conv_out_channels, self.linear_in_dim = conv_out_channels, linear_in_dim
        self.conv_layer = CombConvLayer(in_channels, conv_out_channels, comb_kernel_sizes,
                                        comb_out_kernel_size, drop_rate)
        self.lin0 = nn.Linear(linear_in_dim, linear_hidden_dim)
        self.lin1 = nn.Linear(linear_hidden_dim, linear_out_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.conv_layer(x)
        n, length, c = x.shape
        if c * length != self.linear_in_dim:
            # The official model takes 128 samples; other lengths are
            # resampled to its feature size (ditingmotion.py:97-101).
            x = interpolate_nearest(x, self.linear_in_dim // self.conv_out_channels)
        # Channel-major, as torch's Flatten over (N, C, L) (ditingmotion.py:102-107).
        x1 = x.transpose(1, 2).reshape(n, -1)
        x2 = torch.relu(self.lin0(x1))
        return x1, x2, torch.sigmoid(self.lin1(x2))


class DiTingMotion(nn.Module):
    """(N, L, 2) -> ((N, 2) clarity, (N, 2) polarity) (``ditingmotion.py:113``)."""

    def __init__(self, in_channels: int = 2,
                 blocks_layer_channels: Sequence[Sequence[int]] = (
                     (8, 8), (8, 8), (8, 8, 8), (8, 8, 8), (8, 8, 8)),
                 side_layer_conv_channels: int = 2,
                 blocks_sidelayer_linear_in_dims: Sequence[Optional[int]] = (
                     None, None, 32, 16, 16),
                 blocks_sidelayer_linear_hidden_dims: Sequence[Optional[int]] = (
                     None, None, 8, 8, 8),
                 comb_kernel_sizes: Sequence[int] = (3, 3, 5, 5), comb_out_kernel_size: int = 3,
                 pool_size: int = 2, drop_rate: float = 0.2, fuse_hidden_dim: int = 8,
                 num_polarity_classes: int = 2, num_clarity_classes: int = 2):
        super().__init__()
        self.sides: List[int] = []
        c = in_channels
        fuse_c = fuse_p = 0
        for b, (layers, lin_in, lin_hidden) in enumerate(zip(
                blocks_layer_channels, blocks_sidelayer_linear_in_dims,
                blocks_sidelayer_linear_hidden_dims)):
            block = BasicBlock(c, layers, comb_kernel_sizes, comb_out_kernel_size, drop_rate,
                               pool_size)
            self.add_module(f"block{b}", block)
            c = block.out_channels
            if lin_in is not None:
                for kind, classes in (("clarity", num_clarity_classes),
                                      ("polarity", num_polarity_classes)):
                    self.add_module(f"{kind}_side{b}", SideLayer(
                        c, side_layer_conv_channels, comb_kernel_sizes, comb_out_kernel_size,
                        drop_rate, lin_in, lin_hidden, classes))
                self.sides.append(b)
                fuse_c += lin_in
                fuse_p += lin_hidden
        self.num_blocks = len(blocks_layer_channels)
        self.fuse_clarity0 = nn.Linear(fuse_c, fuse_hidden_dim)
        self.fuse_clarity1 = nn.Linear(fuse_hidden_dim, num_clarity_classes)
        self.fuse_polarity0 = nn.Linear(fuse_p, fuse_hidden_dim)
        self.fuse_polarity1 = nn.Linear(fuse_hidden_dim, num_polarity_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c_fuse, p_fuse, c_outs, p_outs = [], [], [], []
        for b in range(self.num_blocks):
            x = getattr(self, f"block{b}")(x)
            if b in self.sides:
                c0, _, c2 = getattr(self, f"clarity_side{b}")(x)
                _, p1, p2 = getattr(self, f"polarity_side{b}")(x)
                c_fuse.append(c0)
                c_outs.append(c2)
                p_fuse.append(p1)
                p_outs.append(p2)
        c = self.fuse_clarity1(self.fuse_clarity0(torch.cat(c_fuse, dim=-1)))
        c_outs.append(torch.sigmoid(c))
        p = self.fuse_polarity1(self.fuse_polarity0(torch.cat(p_fuse, dim=-1)))
        p_outs.append(torch.sigmoid(p))
        return sum(c_outs) / len(c_outs), sum(p_outs) / len(p_outs)


@register_model
def ditingmotion(**kwargs) -> DiTingMotion:
    kwargs.pop("in_samples", None)
    return DiTingMotion(**kwargs)
