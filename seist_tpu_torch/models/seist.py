"""Seismogram Transformer (SeisT) in torch, channels-last ``(N, L, C)``.

Counterpart of ``seist_tpu/models/seist.py``. Submodules carry the flax
module names (``stem0.conv1.dconv``, ``stage2_block1.attention.q_proj``,
``out_head.conv3``, ...), so a flax variable tree maps onto this model's
``state_dict`` leaf by leaf (models/convert.py). 1x1 convolutions are
``nn.Linear`` on the channel axis, as flax ``Dense``; the stem and the
depthwise-separable convs port the literal 'paths' math (in_proj ->
depthwise -> pconv). The JAX package's XLA lowerings of the same math
('composed', 'merged', 'fused', SEIST_*_IMPL) are not ported.

Attention runs through ``fused_pooled_attention``: the hand-written CUDA
kernels on the card, forward and backward. In training mode (``train()``)
the model applies MLP, key and output-projection dropout, DropPath and
post-softmax attention dropout, drawn from the :class:`RandomSource`
attached with :func:`common.set_random_source`; the attention seed is
drawn per call from its CPU generator. With ``use_checkpoint`` each
stage (its aggregation and blocks) is rematerialised, as the JAX package's
``nn.remat`` does: its activations are recomputed in the backward pass,
which replays the stage's draws (``common.remat``), so K1 runs twice per
attention call of a train step, once in the forward and once in the
recompute. Sequence-parallel ring attention is not ported.

Under the bf16 precision policy (``train/precision.py``) every tensor the
forward creates takes the activation's dtype (pooling counts, pad fills,
interpolation weights, dropout zeros) and BatchNorm casts its output to
the policy dtype, so q, k and v reach the attention kernels as bf16 and
no fp32 tensor promotes the products after it (``tests/
test_torch_precision.py`` counts the bf16 share of the product FLOPs).

15 registered variants: seist_{s,m,l}_{dpk,pmp,emg,baz,dis}.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields, replace
from typing import List, Sequence, Tuple

import torch
from torch import nn

from seist_tpu_torch.models import common
from seist_tpu_torch.models.common import (
    BatchNorm,
    Conv1d,
    Dropout,
    DropPath,
    auto_pad_1d,
    ceil_len,
    gelu,
    make_divisible,
)
from seist_tpu_torch.ops.pooled_attention import fused_pooled_attention
from seist_tpu_torch.ops.ring_attention import ring_attention
from seist_tpu_torch.parallel import mesh as mesh_lib
from seist_tpu_torch.registry import register_model


class LocalAwareAggregationBlock(nn.Module):
    """(avg+max pool, ceil mode) -> 1x1 proj -> norm (ref seist.py:73-96)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.proj = nn.Linear(in_dim, out_dim, bias=False)
        self.norm = BatchNorm(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_size > 1:
            x = common.avg_pool_1d_ceil(x, self.kernel_size) + common.max_pool_1d_ceil(
                x, self.kernel_size
            )
        return self.norm(self.proj(x))


class MLP(nn.Module):
    """1x1-conv feedforward with output dropout (ref seist.py:99-121)."""

    def __init__(self, in_dim: int, out_dim: int, mlp_ratio: float, bias: bool,
                 drop_rate: float = 0.0):
        super().__init__()
        ffwd = int(in_dim * mlp_ratio)
        self.lin0 = nn.Linear(in_dim, ffwd, bias=bias)
        self.lin1 = nn.Linear(ffwd, out_dim, bias=bias)
        self.drop = Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.lin1(gelu(self.lin0(x))))


class DSConvNormAct(nn.Module):
    """Depthwise-separable conv (ref seist.py:124-155), the literal pipeline:
    1x1 in-proj -> depthwise k (stride s) -> 1x1 pconv -> BN -> GELU."""

    def __init__(self, prev_dim: int, in_dim: int, out_dim: int, kernel_size: int, stride: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.in_proj = nn.Linear(prev_dim, in_dim, bias=False)
        self.dconv = Conv1d(in_dim, in_dim, kernel_size, stride, groups=in_dim)
        self.pconv = nn.Linear(in_dim, out_dim, bias=False)
        self.norm = BatchNorm(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(x)
        x = auto_pad_1d(x, self.kernel_size, self.stride)
        x = self.pconv(self.dconv(x))
        return gelu(self.norm(x))


class StemBlock(nn.Module):
    """3 parallel DSConv paths with kernels k, k+4, k+8 (ref seist.py:158-195)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int, npath: int = 3):
        super().__init__()
        self.npath = npath
        for dk in range(npath):
            self.add_module(
                f"conv{dk}",
                DSConvNormAct(in_dim, in_dim, out_dim, kernel_size + 4 * dk, stride),
            )
        self.out_proj = nn.Linear(npath * out_dim, out_dim, bias=False)
        self.norm = BatchNorm(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [getattr(self, f"conv{dk}")(x) for dk in range(self.npath)]
        return self.norm(self.out_proj(torch.cat(outs, dim=-1)))


class GroupConvBlock(nn.Module):
    """Grouped conv + MLP, both with residual DropPath (ref seist.py:198-256)."""

    def __init__(self, io_dim: int, groups: int, kernel_size: int, path_drop_rate: float,
                 mlp_ratio: float, mlp_bias: bool, mlp_drop_rate: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = Conv1d(io_dim, io_dim, kernel_size, groups=groups)
        self.norm0 = BatchNorm(io_dim)
        self.proj = nn.Linear(io_dim, io_dim, bias=False)
        self.norm1 = BatchNorm(io_dim)
        self.mlp = MLP(io_dim, io_dim, mlp_ratio, mlp_bias, mlp_drop_rate)
        self.drop_path = DropPath(path_drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv(auto_pad_1d(x, self.kernel_size, 1))
        x1 = self.proj(gelu(self.norm0(x1)))
        x = x + self.drop_path(x1)
        return x + self.drop_path(self.mlp(self.norm1(x)))


class MultiScaleMixedConv(nn.Module):
    """Channel-split parallel GroupConvBlocks at different kernel sizes
    (ref seist.py:259-318)."""

    def __init__(self, in_dim: int, io_dim: int, groups: int, kernel_sizes: Sequence[int],
                 path_drop_rate: float, mlp_ratio: float, mlp_bias: bool,
                 mlp_drop_rate: float = 0.0):
        super().__init__()
        group_size = io_dim // groups
        dims: List[int] = []
        for i, kernel_size in enumerate(kernel_sizes):
            dim = make_divisible(
                (io_dim - sum(dims)) // (len(kernel_sizes) - len(dims)), group_size
            )
            if dim <= 0:
                raise ValueError(f"MultiScaleMixedConv: path {i} has no channels")
            dims.append(dim)
            self.add_module(f"proj{i}", nn.Linear(in_dim, dim, bias=False))
            self.add_module(f"norm{i}", BatchNorm(dim))
            self.add_module(
                f"conv{i}",
                GroupConvBlock(dim, dim // group_size, kernel_size, path_drop_rate,
                               mlp_ratio, mlp_bias, mlp_drop_rate),
            )
        self.npath = len(kernel_sizes)
        self.out_dim = sum(dims)
        self.out_norm = BatchNorm(self.out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i in range(self.npath):
            xi = getattr(self, f"norm{i}")(getattr(self, f"proj{i}")(x))
            outs.append(xi + getattr(self, f"conv{i}")(xi))
        return self.out_norm(torch.cat(outs, dim=-1))


class AttentionBlock(nn.Module):
    """MHA with K/V from a pooled sequence: full-length Q attends to L/r
    keys, cost L x (L/r) (ref seist.py:321-393). In training mode: key
    dropout, post-softmax probability dropout inside the kernel (its int32
    seed drawn per call from the source's CPU generator, or read from the
    source's device buffer of the step's seeds, and handed to the kernel as
    a device tensor) and output projection dropout.

    Under an active mesh (``parallel/mesh.py``) whose ``seq`` axis has more
    than one rank (``--seq-shards``), the attention runs as a ring over
    that axis (``ops/ring_attention.py``) on the rank's blocks of the full
    q, k and v, and the output is gathered back: each seq rank holds the
    whole sequence outside attention (``seist_tpu/models/seist.py:554``).
    With data ranks only, the kernels number the dropout mask from the
    rank's first global batch row."""

    def __init__(self, io_dim: int, head_dim: int, qkv_bias: bool, attn_aggr_ratio: int,
                 attn_drop_rate: float = 0.0, key_drop_rate: float = 0.0,
                 proj_drop_rate: float = 0.0):
        super().__init__()
        self.num_heads = io_dim // head_dim
        self.attn_aggr_ratio = attn_aggr_ratio
        self.attn_drop_rate = attn_drop_rate
        self.random = None  # the RandomSource of train-mode forwards
        self.key_drop = Dropout(key_drop_rate)
        self.proj_drop = Dropout(proj_drop_rate)
        self.q_proj = nn.Linear(io_dim, io_dim, bias=qkv_bias)
        if attn_aggr_ratio > 1:
            self.aggr = LocalAwareAggregationBlock(io_dim, io_dim, attn_aggr_ratio)
            self.norm = BatchNorm(io_dim)
        self.k_proj = nn.Linear(io_dim, io_dim, bias=qkv_bias)
        self.v_proj = nn.Linear(io_dim, io_dim, bias=qkv_bias)
        self.out_proj = nn.Linear(io_dim, io_dim, bias=qkv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, c = x.shape
        heads = self.num_heads
        e = c // heads
        q = self.q_proj(x).view(n, length, heads, e)
        if self.attn_aggr_ratio > 1:
            x = self.norm(self.aggr(x))
        m = x.shape[1]
        k = self.key_drop(self.k_proj(x).view(n, m, heads, e))
        v = self.v_proj(x).view(n, m, heads, e)
        rate = self.attn_drop_rate if self.training else 0.0
        seed = common.need_source(self).attention_seed(q.device) if rate > 0.0 else 0
        mesh = mesh_lib.active_mesh()
        n0 = mesh.data_index * n if mesh_lib.data_parallel(mesh) else 0
        if mesh_lib.seq_parallel(mesh):
            out = ring_attention(q, k, v, mesh.seq_group, 1.0 / math.sqrt(e), rate, seed, n0)
        else:
            out = fused_pooled_attention(
                q, k, v, 1.0 / math.sqrt(e), dropout_rate=rate, dropout_seed=seed,
                batch_offset=n0,
            )
        return self.proj_drop(self.out_proj(out.reshape(n, length, c)))


def _attn_out_dim(io_dim: int, attn_ratio: float, head_dim: int) -> int:
    if not 0 <= attn_ratio <= 1:
        raise ValueError(f"attn_ratio must be in [0, 1], got {attn_ratio}")
    return make_divisible(int(io_dim * attn_ratio), head_dim) if attn_ratio > 0 else 0


class MultiPathTransformerLayer(nn.Module):
    """Channel-split dual path: attention on ~attn_ratio of the channels,
    grouped conv on the rest; shared MLP (ref seist.py:396-504)."""

    def __init__(self, in_dim: int, io_dim: int, path_drop_rate: float, attn_aggr_ratio: int,
                 attn_ratio: float, head_dim: int, qkv_bias: bool, mlp_ratio: float,
                 mlp_bias: bool, attn_drop_rate: float = 0.0, key_drop_rate: float = 0.0,
                 attn_out_drop_rate: float = 0.0, mlp_drop_rate: float = 0.0):
        super().__init__()
        attn_out_dim = _attn_out_dim(io_dim, attn_ratio, head_dim)
        conv_out_dim = max(io_dim - attn_out_dim, 0)
        self.has_attn = attn_out_dim > 0
        self.has_conv = conv_out_dim > 0
        if self.has_attn:
            self.attn_proj = nn.Linear(in_dim, attn_out_dim, bias=False)
            self.norm0 = BatchNorm(attn_out_dim)
            self.attention = AttentionBlock(attn_out_dim, head_dim, qkv_bias, attn_aggr_ratio,
                                            attn_drop_rate, key_drop_rate, attn_out_drop_rate)
            self.attn_drop_path = DropPath(path_drop_rate * attn_ratio)
        if self.has_conv:
            self.conv_proj = nn.Linear(in_dim, conv_out_dim, bias=False)
            self.norm1 = BatchNorm(conv_out_dim)
            self.gconv = GroupConvBlock(conv_out_dim, conv_out_dim // head_dim, 3,
                                        path_drop_rate, mlp_ratio, mlp_bias, mlp_drop_rate)
            self.conv_drop_path = DropPath(path_drop_rate * (1 - attn_ratio))
        cat_dim = attn_out_dim + conv_out_dim
        self.norm2 = BatchNorm(cat_dim)
        self.mlp = MLP(cat_dim, io_dim, mlp_ratio, mlp_bias, mlp_drop_rate)
        self.drop_path = DropPath(path_drop_rate)
        self.out_dim = cat_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        if self.has_attn:
            x1 = self.norm0(self.attn_proj(x))
            outs.append(x1 + self.attn_drop_path(self.attention(x1)))
        if self.has_conv:
            x2 = self.norm1(self.conv_proj(x))
            outs.append(x2 + self.conv_drop_path(self.gconv(x2)))
        x = self.norm2(torch.cat(outs, dim=-1))
        return x + self.drop_path(self.mlp(x))


class HeadDetectionPicking(nn.Module):
    """Interpolate+conv upsampling ladder back to the input length, then a
    k=7 output conv and a sigmoid (ref seist.py:507-572)."""

    def __init__(self, in_dim: int, layer_channels: Sequence[int],
                 layer_kernel_sizes: Sequence[int], out_channels: int):
        super().__init__()
        if len(layer_channels) != len(layer_kernel_sizes):
            raise ValueError("layer_channels and layer_kernel_sizes differ in length")
        out_chs = list(layer_channels[:-1]) + [out_channels * 2]
        self.kernel_sizes = list(layer_kernel_sizes)
        prev = in_dim
        for i, (outc, kers) in enumerate(zip(out_chs, layer_kernel_sizes)):
            self.add_module(f"conv{i}", Conv1d(prev, outc, kers, bias=True))
            self.add_module(f"norm{i}", BatchNorm(outc))
            prev = outc
        self.out_conv = Conv1d(prev, out_channels, 7, bias=True)

    def _upsampling_sizes(self, in_size: int, out_size: int) -> List[int]:
        depth = len(self.kernel_sizes)
        sizes = [out_size] * depth
        factor = (out_size / in_size) ** (1 / depth)
        for i in range(depth - 2, -1, -1):
            sizes[i] = int(sizes[i + 1] / factor)
        return sizes

    def forward(self, x: torch.Tensor, out_size: int) -> torch.Tensor:
        up_sizes = self._upsampling_sizes(x.shape[-2], out_size)
        for i, kers in enumerate(self.kernel_sizes):
            x = common.interpolate_linear(x, up_sizes[i])
            x = getattr(self, f"conv{i}")(auto_pad_1d(x, kers, 1))
            x = gelu(getattr(self, f"norm{i}")(x))
        x = self.out_conv(torch.nn.functional.pad(x, (0, 0, 3, 3)))
        return torch.sigmoid(x)


class HeadClassification(nn.Module):
    """GAP -> linear -> softmax (ref seist.py:575-591)."""

    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.lin = nn.Linear(in_dim, num_classes)

    def forward(self, x: torch.Tensor, out_size: int) -> torch.Tensor:
        return torch.softmax(self.lin(common.global_avg_pool(x)), dim=-1)


class HeadRegression(nn.Module):
    """GAP -> linear -> scaled sigmoid (ref seist.py:594-610)."""

    def __init__(self, in_dim: int, scale: float):
        super().__init__()
        self.scale = scale
        self.lin = nn.Linear(in_dim, 1)

    def forward(self, x: torch.Tensor, out_size: int) -> torch.Tensor:
        return torch.sigmoid(self.lin(common.global_avg_pool(x))) * self.scale


@dataclass(frozen=True)
class SeisTConfig:
    """Architecture of one SeisT variant (the flax module's fields)."""

    in_channels: int = 3
    stem_channels: Tuple[int, ...] = (16, 8, 16, 16)
    stem_kernel_sizes: Tuple[int, ...] = (11, 5, 5, 7)
    stem_strides: Tuple[int, ...] = (2, 1, 1, 2)
    layer_blocks: Tuple[int, ...] = (2, 3, 6, 2)
    layer_channels: Tuple[int, ...] = (24, 32, 64, 96)
    attn_blocks: Tuple[int, ...] = (1, 1, 2, 1)
    stage_aggr_ratios: Tuple[int, ...] = (2, 2, 2, 2)
    attn_aggr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    head_dims: Tuple[int, ...] = (8, 8, 16, 32)
    msmc_kernel_sizes: Tuple[int, ...] = (3, 5)
    path_drop_rate: float = 0.2
    attn_drop_rate: float = 0.1
    key_drop_rate: float = 0.1
    mlp_drop_rate: float = 0.2
    other_drop_rate: float = 0.1
    attn_ratio: float = 0.6
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    mlp_bias: bool = True
    use_checkpoint: bool = False
    head_type: str = "dpk"  # dpk | cls | reg
    head_out_channels: int = 3
    head_num_classes: int = 2
    head_scale: float = 1.0


class SeismogramTransformer(nn.Module):
    """Stem -> 4 stages (aggregation + MSMC/MPTL blocks) -> task head
    (ref seist.py:613-852). ``forward(x)`` maps (N, L, C) waveforms to the
    head's output; :meth:`backbone` and :meth:`head` split it at the trunk."""

    #: ``models/api.py::init_weights``: SeisT's truncated normal at 0.02.
    trunc_normal_init = True

    def __init__(self, cfg: SeisTConfig):
        super().__init__()
        self.cfg = cfg
        if not (len(cfg.stem_channels) == len(cfg.stem_kernel_sizes) == len(cfg.stem_strides)):
            raise ValueError("stem_* lengths differ")
        n_stages = len(cfg.layer_blocks)
        if any(
            len(t) != n_stages
            for t in (cfg.layer_channels, cfg.stage_aggr_ratios, cfg.attn_aggr_ratios,
                      cfg.attn_blocks, cfg.head_dims)
        ):
            raise ValueError("per-stage config lengths differ")

        ch = cfg.in_channels
        for i, (outc, kers, strd) in enumerate(
            zip(cfg.stem_channels, cfg.stem_kernel_sizes, cfg.stem_strides)
        ):
            self.add_module(f"stem{i}", StemBlock(ch, outc, kers, strd))
            ch = outc

        total = sum(cfg.layer_blocks)
        pdprs = [cfg.path_drop_rate * i / max(total - 1, 1) for i in range(total)]
        self.stage_blocks: List[List[str]] = []
        for i, num_blocks in enumerate(cfg.layer_blocks):
            lc = cfg.layer_channels[i]
            self.add_module(
                f"stage{i}_aggr",
                LocalAwareAggregationBlock(ch, lc, cfg.stage_aggr_ratios[i]),
            )
            ch = lc
            names = []
            for j in range(num_blocks):
                pdpr = pdprs[sum(cfg.layer_blocks[:i]) + j]
                if j >= num_blocks - cfg.attn_blocks[i]:
                    block = MultiPathTransformerLayer(
                        ch, lc, pdpr, cfg.attn_aggr_ratios[i], cfg.attn_ratio,
                        cfg.head_dims[i], cfg.qkv_bias, cfg.mlp_ratio, cfg.mlp_bias,
                        cfg.attn_drop_rate, cfg.key_drop_rate, cfg.other_drop_rate,
                        cfg.mlp_drop_rate,
                    )
                else:
                    block = MultiScaleMixedConv(
                        ch, lc, lc // cfg.head_dims[i], cfg.msmc_kernel_sizes, pdpr,
                        cfg.mlp_ratio, cfg.mlp_bias, cfg.mlp_drop_rate,
                    )
                self.add_module(f"stage{i}_block{j}", block)
                names.append(f"stage{i}_block{j}")
                ch = block.out_dim
            self.stage_blocks.append(names)

        if cfg.head_type == "dpk":
            chans, kerns = [], []
            for channel, kernel, stride in zip(
                [cfg.in_channels] + list(cfg.stem_channels) + list(cfg.layer_channels[:-1]),
                list(cfg.stem_kernel_sizes)
                + [max(cfg.msmc_kernel_sizes)] * len(cfg.layer_channels),
                list(cfg.stem_strides) + list(cfg.stage_aggr_ratios),
            ):
                if stride > 1:
                    chans.insert(0, channel)
                    kerns.insert(0, kernel)
            self.out_head = HeadDetectionPicking(ch, chans, kerns, cfg.head_out_channels)
        elif cfg.head_type == "cls":
            self.out_head = HeadClassification(ch, cfg.head_num_classes)
        elif cfg.head_type == "reg":
            self.out_head = HeadRegression(ch, cfg.head_scale)
        else:
            raise NotImplementedError(f"Unknown head_type '{cfg.head_type}'")

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """Stem + stages: (N, L, C) waveforms -> (N, L/64, C') features."""
        for i in range(len(self.cfg.stem_channels)):
            x = getattr(self, f"stem{i}")(x)
        for i in range(len(self.stage_blocks)):
            if self.cfg.use_checkpoint and torch.is_grad_enabled():
                x = common.remat(functools.partial(self._stage, i), x)
            else:
                x = self._stage(i, x)
        return x

    def _stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"stage{i}_aggr")(x)
        for name in self.stage_blocks[i]:
            x = getattr(self, name)(x)
        return x

    def head(self, features: torch.Tensor, in_samples: int) -> torch.Tensor:
        """The task head on trunk ``features``; the dpk ladder rebuilds
        ``in_samples`` (the original input length)."""
        return self.out_head(features, in_samples)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(x), x.shape[-2])

    def zero_grad_parameters(self) -> List[str]:
        """Names of the parameters whose train-mode gradient is zero in exact
        arithmetic under this model's drop rates, so that a computed value
        is rounding noise (parity checks exempt them by name and assert
        them ~0). A per-channel constant added to a tensor that reaches a
        BatchNorm only through pooling, bias-free projections or
        concatenation is removed by the batch mean, unless a DropPath or an
        element dropout on the way scales it per sample or per element; a
        shift of every key of a row is removed by the softmax. Also listed:
        the scale of the BatchNorm that feeds the attention's BatchNorm
        directly, which the second one normalises away but for its eps, so
        its gradient is ~1e-7 of the largest and fp32 cannot resolve it."""
        names = [f"stem{len(self.cfg.stem_channels) - 1}.norm.bias"]
        last = self.stage_blocks[-1][-1]
        for i, blocks in enumerate(self.stage_blocks):
            names.append(f"stage{i}_aggr.norm.bias")
            for b in blocks:
                blk = getattr(self, b)
                if isinstance(blk, MultiScaleMixedConv):
                    if b != last:
                        names.append(f"{b}.out_norm.bias")
                    for j in range(blk.npath):
                        gc = getattr(blk, f"conv{j}")
                        if gc.mlp.drop.rate == 0 and gc.drop_path.rate == 0:
                            names.append(f"{b}.conv{j}.mlp.lin1.bias")
                    continue
                if blk.has_attn:
                    att = blk.attention
                    if att.key_drop.rate == 0 and att.k_proj.bias is not None:
                        names.append(f"{b}.attention.k_proj.bias")
                    if att.attn_aggr_ratio > 1:
                        names += [f"{b}.attention.aggr.norm.bias",
                                  f"{b}.attention.aggr.norm.weight"]
                    if (att.proj_drop.rate == 0 and blk.attn_drop_path.rate == 0
                            and att.out_proj.bias is not None):
                        names.append(f"{b}.attention.out_proj.bias")
                if blk.has_conv:
                    gc = blk.gconv
                    if gc.mlp.drop.rate == 0 and gc.drop_path.rate == 0 and (
                            blk.conv_drop_path.rate == 0):
                        names.append(f"{b}.gconv.mlp.lin1.bias")
                if b != last and blk.mlp.drop.rate == 0 and blk.drop_path.rate == 0:
                    names.append(f"{b}.mlp.lin1.bias")
        if self.cfg.head_type == "dpk":
            names += [f"out_head.conv{i}.bias" for i in range(len(self.out_head.kernel_sizes))]
        params = dict(self.named_parameters())
        return [n for n in names if n in params]

    def attention_shapes(self, in_samples: int) -> List[Tuple[int, int, int, int]]:
        """(L, M, H, E) of every attention launch of one forward at
        ``in_samples``, in call order, from the configuration alone."""
        cfg = self.cfg
        length = in_samples
        for s in cfg.stem_strides:
            length = ceil_len(length, s)
        shapes = []
        for i in range(len(cfg.layer_blocks)):
            length = ceil_len(length, cfg.stage_aggr_ratios[i])
            attn_dim = _attn_out_dim(cfg.layer_channels[i], cfg.attn_ratio, cfg.head_dims[i])
            if attn_dim == 0:
                continue
            heads = attn_dim // cfg.head_dims[i]
            m = ceil_len(length, cfg.attn_aggr_ratios[i])
            n_attn = min(cfg.attn_blocks[i], cfg.layer_blocks[i])
            shapes += [(length, m, heads, attn_dim // heads)] * n_attn
        return shapes


# ---------------------------------------------------------------- size presets
_PRESET_S = dict(
    stem_channels=(16, 8, 16, 16),
    stem_kernel_sizes=(11, 5, 5, 7),
    stem_strides=(2, 1, 1, 2),
    layer_blocks=(2, 2, 3, 2),
    layer_channels=(16, 24, 32, 64),
    attn_blocks=(1, 1, 1, 1),
    stage_aggr_ratios=(2, 2, 2, 2),
    attn_aggr_ratios=(8, 4, 2, 1),
    head_dims=(8, 8, 8, 16),
    msmc_kernel_sizes=(5, 7),
    path_drop_rate=0.1,
    attn_drop_rate=0.1,
    key_drop_rate=0.1,
    mlp_drop_rate=0.1,
    other_drop_rate=0.1,
    attn_ratio=0.6,
    mlp_ratio=2.0,
)

_PRESET_M = dict(
    stem_channels=(16, 8, 16, 16),
    stem_kernel_sizes=(11, 5, 5, 7),
    stem_strides=(2, 1, 1, 2),
    layer_blocks=(2, 3, 6, 2),
    layer_channels=(24, 32, 64, 96),
    attn_blocks=(1, 1, 1, 1),
    stage_aggr_ratios=(2, 2, 2, 2),
    attn_aggr_ratios=(8, 4, 2, 1),
    head_dims=(8, 8, 16, 32),
    msmc_kernel_sizes=(5, 7),
    path_drop_rate=0.1,
    attn_drop_rate=0.1,
    key_drop_rate=0.1,
    mlp_drop_rate=0.1,
    other_drop_rate=0.1,
    attn_ratio=0.6,
    mlp_ratio=2.0,
)

_PRESET_L = dict(
    stem_channels=(16, 8, 16, 16),
    stem_kernel_sizes=(11, 5, 5, 7),
    stem_strides=(2, 1, 1, 2),
    layer_blocks=(2, 3, 6, 3),
    layer_channels=(32, 32, 64, 128),
    attn_blocks=(1, 1, 2, 1),
    stage_aggr_ratios=(2, 2, 2, 2),
    attn_aggr_ratios=(8, 4, 2, 1),
    head_dims=(8, 8, 16, 32),
    msmc_kernel_sizes=(3, 5, 7, 11),
    path_drop_rate=0.2,
    attn_drop_rate=0.2,
    key_drop_rate=0.1,
    mlp_drop_rate=0.2,
    other_drop_rate=0.1,
    attn_ratio=0.6,
    mlp_ratio=3.0,
)

_PRESETS = {"s": _PRESET_S, "m": _PRESET_M, "l": _PRESET_L}
_CONFIG_FIELDS = {f.name for f in fields(SeisTConfig)}


def _drops(rate: float) -> dict:
    return dict(
        path_drop_rate=rate,
        attn_drop_rate=rate,
        key_drop_rate=rate,
        mlp_drop_rate=rate,
        other_drop_rate=rate,
    )


def _build(size: str, head: dict, overrides: dict, **kwargs) -> SeismogramTransformer:
    """Preset + per-task overrides + caller kwargs (unknown keys such as
    ``in_samples`` are ignored, as the JAX package's ``_build`` does)."""
    args = dict(_PRESETS[size])
    args.update(overrides)
    args.update(head)
    args.update({k: v for k, v in kwargs.items() if k in _CONFIG_FIELDS})
    args = {k: tuple(v) if isinstance(v, list) else v for k, v in args.items()}
    return SeismogramTransformer(replace(SeisTConfig(), **args))


_HEAD_DPK = dict(head_type="dpk", head_out_channels=3)
_HEAD_PMP = dict(head_type="cls", head_num_classes=2)


def _head_reg(scale: float) -> dict:
    return dict(head_type="reg", head_scale=scale)


# Per-task drop-rate overrides mirror the registered ctors (ref seist.py:940-1170).
@register_model
def seist_s_dpk(**kw):
    """Detection and phase picking (small)."""
    return _build("s", _HEAD_DPK, {}, **kw)


@register_model
def seist_m_dpk(**kw):
    """Detection and phase picking (medium)."""
    return _build("m", _HEAD_DPK, _drops(0.2), **kw)


@register_model
def seist_l_dpk(**kw):
    """Detection and phase picking (large)."""
    return _build("l", _HEAD_DPK, _drops(0.3), **kw)


@register_model
def seist_s_pmp(**kw):
    """First-motion polarity classification (small)."""
    return _build("s", _HEAD_PMP, _drops(0.2), **kw)


@register_model
def seist_m_pmp(**kw):
    """First-motion polarity classification (medium)."""
    return _build("m", _HEAD_PMP, _drops(0.25), **kw)


@register_model
def seist_l_pmp(**kw):
    """First-motion polarity classification (large)."""
    return _build("l", _HEAD_PMP, _drops(0.3), **kw)


@register_model
def seist_s_emg(**kw):
    """Magnitude estimation (small): sigmoid x 8."""
    return _build("s", _head_reg(8.0), {}, **kw)


@register_model
def seist_m_emg(**kw):
    """Magnitude estimation (medium)."""
    return _build("m", _head_reg(8.0), {}, **kw)


@register_model
def seist_l_emg(**kw):
    """Magnitude estimation (large)."""
    return _build("l", _head_reg(8.0), {}, **kw)


@register_model
def seist_s_baz(**kw):
    """Back-azimuth estimation (small): sigmoid x 360."""
    return _build("s", _head_reg(360.0), {}, **kw)


@register_model
def seist_m_baz(**kw):
    """Back-azimuth estimation (medium)."""
    return _build("m", _head_reg(360.0), {}, **kw)


@register_model
def seist_l_baz(**kw):
    """Back-azimuth estimation (large)."""
    return _build("l", _head_reg(360.0), {}, **kw)


@register_model
def seist_s_dis(**kw):
    """Epicentral distance estimation (small): sigmoid x 500."""
    return _build("s", _head_reg(500.0), {}, **kw)


@register_model
def seist_m_dis(**kw):
    """Epicentral distance estimation (medium)."""
    return _build("m", _head_reg(500.0), {}, **kw)


@register_model
def seist_l_dis(**kw):
    """Epicentral distance estimation (large)."""
    return _build("l", _head_reg(500.0), {}, **kw)
