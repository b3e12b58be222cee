"""EQTransformer in torch, channels-last ``(N, L, C)``: convolutions,
residual convolutions, BiLSTMs and two transformer layers encode; three
upsampling decoders (det, P, S) decode (counterpart of
``seist_tpu/models/eqtransformer.py``).

The reference's L1 regularisation of the encoder and decoder convolutions
(gradient hooks) is ``train/optim.py::l1_sign_decay`` over the parameters
:func:`l1_param_mask` selects, switched on by ``--conv-kernel-l1-alpha``
and ``--conv-bias-l1-alpha``. The additive attention is plain torch, as
the JAX package's is plain XLA (no kernel of its own).
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from seist_tpu_torch.models.common import (
    LSTM,
    BatchNorm,
    Conv1d,
    Dropout,
    LayerNorm,
    max_pool_1d,
    same_pad_1d,
    upsample_x2,
)
from seist_tpu_torch.registry import register_model

_EPS = 1e-6


class ConvBlock(nn.Module):
    """same conv -> relu -> an odd length padded with -1/EPS -> floor
    max-pool by 2 (``eqtransformer.py:33``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = Conv1d(in_channels, out_channels, kernel_size, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv(same_pad_1d(x, self.kernel_size)))
        if x.shape[-2] % 2:
            x = nn.functional.pad(x, (0, 0, 0, 1), value=-1.0 / _EPS)
        return max_pool_1d(x, 2)


class ResConvBlock(nn.Module):
    """Pre-norm residual conv pair with channel dropout (``eqtransformer.py:52``)."""

    def __init__(self, channels: int, kernel_size: int, drop_rate: float):
        super().__init__()
        self.kernel_size = kernel_size
        for i in range(2):
            self.add_module(f"bn{i}", BatchNorm(channels))
            self.add_module(f"drop{i}", Dropout(drop_rate, channel=True))
            self.add_module(f"conv{i}", Conv1d(channels, channels, kernel_size, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = x
        for i in range(2):
            x1 = getattr(self, f"drop{i}")(torch.relu(getattr(self, f"bn{i}")(x1)))
            x1 = getattr(self, f"conv{i}")(same_pad_1d(x1, self.kernel_size))
        return x + x1


class BiLSTMBlock(nn.Module):
    """BiLSTM -> dropout -> 1x1 conv -> BN (``eqtransformer.py:74``)."""

    def __init__(self, in_channels: int, out_channels: int, drop_rate: float):
        super().__init__()
        self.bilstm = LSTM(in_channels, out_channels, bidirectional=True)
        self.drop = Dropout(drop_rate)
        self.conv = nn.Linear(2 * out_channels, out_channels)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = self.bilstm(x)
        return self.bn(self.conv(self.drop(x)))


def band_mask(length: int, width: int, device=None) -> torch.Tensor:
    """The local attention's band (``eqtransformer.py:112-121``):
    ``-(-w)//2 <= j - i <= w//2 - 1``, whose lower bound is the floor of
    the negated width, so an odd w = 3 keeps j - i in [-2, 0]."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    return (j - i <= width // 2 - 1) & (j - i >= (-width) // 2)


class AttentionLayer(nn.Module):
    """Additive single-head attention with an optional banded mask
    (``eqtransformer.py:89``): ``tanh(x·Wt + x·Wx + bh)·Wa + ba`` scores
    over every (row, key) pair, an (N, L, L, d) tensor, then the
    reference's softmax (exp after a max shift, the band, a sum plus
    EPS). The parameters keep the flax names and layouts."""

    def __init__(self, channels: int, d_model: int, attn_width: Optional[int] = None):
        super().__init__()
        self.attn_width = attn_width
        self.Wx = nn.Parameter(torch.zeros(channels, d_model))
        self.Wt = nn.Parameter(torch.zeros(channels, d_model))
        self.bh = nn.Parameter(torch.zeros(d_model))
        self.Wa = nn.Parameter(torch.zeros(d_model, 1))
        self.ba = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        q = (x @ self.Wt)[:, :, None, :]
        k = (x @ self.Wx)[:, None, :, :]
        h = torch.tanh(q + k + self.bh)  # (N, L, L, d)
        e = (h @ self.Wa)[..., 0] + self.ba
        e = torch.exp(e - e.amax(dim=-1, keepdim=True))
        if self.attn_width is not None:
            e = torch.where(band_mask(x.shape[1], self.attn_width, x.device), e,
                            torch.zeros((), dtype=e.dtype, device=e.device))
        a = e / (e.sum(dim=-1, keepdim=True) + _EPS)
        return torch.einsum("nlm,nmc->nlc", a, x), a

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """xavier_uniform weights, zero biases (``eqtransformer.py:100-103``)."""
        for w in (self.Wx, self.Wt, self.Wa):
            nn.init.xavier_uniform_(w, generator=generator)
        self.bh.zero_()
        self.ba.zero_()


class FeedForward(nn.Module):
    """Two-layer MLP (``eqtransformer.py:139``)."""

    def __init__(self, channels: int, feedforward_dim: int, drop_rate: float):
        super().__init__()
        self.lin0 = nn.Linear(channels, feedforward_dim)
        self.drop = Dropout(drop_rate)
        self.lin1 = nn.Linear(feedforward_dim, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin1(self.drop(torch.relu(self.lin0(x))))

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """xavier_uniform kernels, zero biases (``eqtransformer.py:139-146``)."""
        for lin in (self.lin0, self.lin1):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            lin.bias.zero_()


class TransformerLayer(nn.Module):
    """attention + LN + FF + LN (``eqtransformer.py:150``)."""

    def __init__(self, channels: int, d_model: int, feedforward_dim: int, drop_rate: float,
                 attn_width: Optional[int] = None):
        super().__init__()
        self.attn = AttentionLayer(channels, d_model, attn_width)
        self.ln0 = LayerNorm(channels)
        self.ff = FeedForward(channels, feedforward_dim, drop_rate)
        self.ln1 = LayerNorm(channels)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x1, w = self.attn(x)
        x2 = self.ln0(x1 + x)
        return self.ln1(self.ff(x2) + x2), w


class Encoder(nn.Module):
    """Conv x7 + ResConv x5 + BiLSTM x3 + Transformer x2 (``eqtransformer.py:173``)."""

    def __init__(self, in_channels: int, conv_channels: Sequence[int],
                 conv_kernels: Sequence[int], resconv_kernels: Sequence[int],
                 num_lstm_blocks: int, num_transformer_layers: int,
                 transformer_io_channels: int, transformer_d_model: int,
                 feedforward_dim: int, drop_rate: float):
        super().__init__()
        blocks = []
        c = in_channels
        for i, (outc, kers) in enumerate(zip(conv_channels, conv_kernels)):
            self.add_module(f"conv{i}", ConvBlock(c, outc, kers))
            blocks.append(f"conv{i}")
            c = outc
        for i, kers in enumerate(resconv_kernels):
            self.add_module(f"resconv{i}", ResConvBlock(c, kers, drop_rate))
            blocks.append(f"resconv{i}")
        for i in range(num_lstm_blocks):
            self.add_module(f"bilstm{i}", BiLSTMBlock(c, transformer_io_channels, drop_rate))
            blocks.append(f"bilstm{i}")
            c = transformer_io_channels
        self.blocks = blocks
        self.num_transformer_layers = num_transformer_layers
        for i in range(num_transformer_layers):
            self.add_module(f"transformer{i}", TransformerLayer(
                c, transformer_d_model, feedforward_dim, drop_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.blocks:
            x = getattr(self, name)(x)
        for i in range(self.num_transformer_layers):
            x, _ = getattr(self, f"transformer{i}")(x)
        return x


class UpSamplingBlock(nn.Module):
    """x2 nearest upsample -> crop -> same conv -> relu (``eqtransformer.py:202``)."""

    def __init__(self, in_channels: int, out_channels: int, out_samples: int, kernel_size: int):
        super().__init__()
        self.out_samples, self.kernel_size = out_samples, kernel_size
        self.conv = Conv1d(in_channels, out_channels, kernel_size, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_x2(x)[:, : self.out_samples]
        return torch.relu(self.conv(same_pad_1d(x, self.kernel_size)))


class Decoder(nn.Module):
    """Optional LSTM + local-attention transformer, then the upsampling
    blocks, to one sigmoid channel (``eqtransformer.py:218``)."""

    def __init__(self, conv_channels: Sequence[int], conv_kernels: Sequence[int],
                 transformer_io_channels: int, transformer_d_model: int, feedforward_dim: int,
                 drop_rate: float, out_samples: int, has_lstm: bool = True,
                 has_local_attn: bool = True, local_attn_width: int = 3):
        super().__init__()
        c = transformer_io_channels
        self.has_lstm, self.has_local_attn = has_lstm, has_local_attn
        if has_lstm:
            self.lstm = LSTM(c, transformer_io_channels)
            self.drop = Dropout(drop_rate)
        if has_local_attn:
            self.transformer = TransformerLayer(c, transformer_d_model, feedforward_dim,
                                                drop_rate, attn_width=local_attn_width)
        crop_sizes = [out_samples]
        for _ in range(len(conv_kernels) - 1):
            crop_sizes.insert(0, math.ceil(crop_sizes[0] / 2))
        self.num_up = len(conv_channels)
        for i, (outc, crop, kers) in enumerate(zip(conv_channels, crop_sizes, conv_kernels)):
            self.add_module(f"up{i}", UpSamplingBlock(c, outc, crop, kers))
            c = outc
        self.conv_out = Conv1d(c, 1, 11, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.has_lstm:
            x = self.drop(self.lstm(x)[0])
        if self.has_local_attn:
            x, _ = self.transformer(x)
        for i in range(self.num_up):
            x = getattr(self, f"up{i}")(x)
        x = self.conv_out(nn.functional.pad(x, (0, 0, 5, 5)))
        return torch.sigmoid(x)


class EQTransformer(nn.Module):
    """(N, L, 3) -> (N, L, 3) probabilities [det, ppk, spk]
    (``eqtransformer.py:260``)."""

    def __init__(self, in_channels: int = 3, in_samples: int = 8192,
                 conv_channels: Sequence[int] = (8, 16, 16, 32, 32, 64, 64),
                 conv_kernels: Sequence[int] = (11, 9, 7, 7, 5, 5, 3),
                 resconv_kernels: Sequence[int] = (3, 3, 3, 2, 2),
                 num_lstm_blocks: int = 3, num_transformer_layers: int = 2,
                 transformer_io_channels: int = 16, transformer_d_model: int = 32,
                 feedforward_dim: int = 128, local_attention_width: int = 3,
                 drop_rate: float = 0.1,
                 decoder_with_attn_lstm: Sequence[bool] = (False, True, True)):
        super().__init__()
        self.encoder = Encoder(in_channels, conv_channels, conv_kernels, resconv_kernels,
                               num_lstm_blocks, num_transformer_layers,
                               transformer_io_channels, transformer_d_model, feedforward_dim,
                               drop_rate)
        self.num_decoders = len(decoder_with_attn_lstm)
        for d, has_attn_lstm in enumerate(decoder_with_attn_lstm):
            self.add_module(f"decoder{d}", Decoder(
                tuple(conv_channels)[::-1], tuple(conv_kernels)[::-1], transformer_io_channels,
                transformer_d_model, feedforward_dim, drop_rate, in_samples,
                has_lstm=has_attn_lstm, has_local_attn=has_attn_lstm,
                local_attn_width=local_attention_width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feature = self.encoder(x)
        return torch.cat([getattr(self, f"decoder{d}")(feature)
                          for d in range(self.num_decoders)], dim=-1)


_L1_PATTERN = re.compile(r"^(encoder\.conv\d+|decoder\d+\.up\d+)\.conv\.(weight|bias)$")


def l1_param_mask(kind: str):
    """``name -> bool`` over the port's parameter names, selecting what the
    reference L1-regularises through gradient hooks
    (``eqtransformer.py:313``): the encoder ConvBlock convs
    (``encoder.conv{i}.conv``) and the decoders' upsampling convs
    (``decoder{d}.up{i}.conv``); ``kind`` 'kernel' (their weights) or
    'bias'."""
    if kind not in ("kernel", "bias"):
        raise ValueError(f"kind must be 'kernel' or 'bias', got {kind!r}")
    leaf = "weight" if kind == "kernel" else "bias"

    def sel(name: str) -> bool:
        m = _L1_PATTERN.match(name)
        return bool(m) and m.group(2) == leaf

    return sel


@register_model
def eqtransformer(**kwargs) -> EQTransformer:
    return EQTransformer(**kwargs)
