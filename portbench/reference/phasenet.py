"""PhaseNet (Zhu & Beroza 2019) in plain PyTorch, as SeisT's paper runs it
as a baseline: the benchmark's reference for the ``phasenet``
configuration.

A 1-D U-Net on channels-last ``(N, L, C)`` waveforms: a k = 7 input
convolution, ``depth`` levels down (stride-4 convolutions after the
first), transposed convolutions up with the skips concatenated after
cropping the overhang, a 1x1 output convolution and a softmax over (non,
ppk, spk). ReLU after every BatchNorm. In training mode, element dropout
at the configuration's ``drop_rate`` after the input layer and after each
convolution's activation, and before each transposed convolution, its
masks redrawn from the step's seed (``reference/dropout.py``) in the
order the forward meets them. Names follow the program's module tree, so
one state dict loads into both.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.dropout import Dropout
from portbench.reference.seist import BatchNorm, Conv, pad_amount, pad_same


def pad_static(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 'same' padding: (k - 1) // 2 left, the rest right."""
    lp = (k - 1) // 2
    return F.pad(x, (0, 0, lp, k - 1 - lp))


class ConvTranspose(nn.Module):
    """Transposed convolution, weight (in, out, k), no padding or bias:
    output length (L - 1) * stride + k."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cin, cout, k))

    def forward(self, x):
        return F.conv_transpose1d(x.transpose(1, 2), self.weight, None, self.stride).transpose(1, 2)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, strided: bool, drop: float):
        super().__init__()
        self.k, self.stride, self.strided = k, stride, strided
        if strided:
            self.conv0 = Conv(cin, cin, k, stride)
            self.bn0 = BatchNorm(cin)
            self.drop0 = Dropout(drop)
        self.conv1 = Conv(cin, cout, k)
        self.bn1 = BatchNorm(cout)
        self.drop1 = Dropout(drop)

    def forward(self, x):
        if self.strided:
            x = self.drop0(torch.relu(self.bn0(self.conv0(pad_same(x, self.k, self.stride)))))
        return self.drop1(torch.relu(self.bn1(self.conv1(pad_static(x, self.k)))))


class Up(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, same: bool, trans: bool,
                 drop: float):
        super().__init__()
        self.k, self.same, self.trans = k, same, trans
        if same:
            self.conv0 = Conv(2 * cin, cin, k)
            self.bn0 = BatchNorm(cin)
            self.drop1 = Dropout(drop)
        if trans:
            self.drop0 = Dropout(drop)
            self.convt = ConvTranspose(cin, cout, k, stride)
            self.bn1 = BatchNorm(cout)

    def forward(self, x):
        if self.same:
            x = torch.relu(self.bn0(self.conv0(pad_static(x, self.k))))
        if self.trans:
            x = torch.relu(self.bn1(self.convt(self.drop0(x))))
        if self.same:
            x = self.drop1(x)
        return x


class PhaseNet(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        ch = list(cfg["conv_channels"])
        k, s, drop = cfg["kernel_size"], cfg["stride"], float(cfg["drop_rate"])
        self.k, self.s, self.depth = k, s, len(ch)
        self.conv_in = Conv(cfg["in_channels"], ch[0], k, bias=True)
        self.bn_in = BatchNorm(ch[0])
        self.drop_in = Dropout(drop)
        down_in = ch[:1] + ch[:-1]
        for i in range(self.depth):
            self.add_module(f"down{i}", Down(down_in[i], ch[i], k, s, i != 0, drop))
        up_in, up_out = ch[::-1], ch[-2::-1] + [ch[0]]
        for j in range(self.depth):
            rev = self.depth - 1 - j
            self.add_module(f"up{j}", Up(up_in[j], up_out[j], k, s, rev < self.depth - 1,
                                         rev > 0, drop))
        self.conv_out = Conv(ch[0], 3, 1, bias=True)

    def forward(self, x):
        x = self.drop_in(torch.relu(self.bn_in(self.conv_in(pad_static(x, self.k)))))
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"down{i}")(x)
            if i < self.depth - 1:
                skips.append(x)
        for j in range(self.depth):
            x = getattr(self, f"up{j}")(x)
            if j == self.depth - 1:
                break
            skip = skips[-(j + 1)]
            lp, rp = pad_amount(skip.shape[1], self.k, self.s)
            x = torch.cat([skip, x[:, lp:x.shape[1] - rp]], -1)
        return torch.softmax(self.conv_out(x), -1)
