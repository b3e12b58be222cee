"""SeisT (Li et al., IEEE TGRS 2024) in plain PyTorch: the benchmark's
reference for the ``seist_*_dpk`` configurations.

Channels-last ``(N, L, C)`` activations, float32. Only ``torch`` and
``torch.nn.functional`` operations: ``F.conv1d``, ``F.batch_norm``,
``F.interpolate``, ``F.gelu`` and attention as two ``einsum`` products
around a softmax. Autograd gives the backward; nothing is recomputed.
In training mode the published dropout runs at the configuration's rates:
MLP, key and output-projection dropout, DropPath on every residual branch
(rising linearly over the blocks) and post-softmax attention dropout, each
mask redrawn from the step's seed (``reference/dropout.py``) in the order
the forward meets them.

Parameter and buffer names follow the published model's module tree
(``stem0.conv1.dconv.weight``, ``stage2_block1.attention.q_proj.bias``,
``out_head.conv3.weight``), so one state dict made by the benchmark loads
into both this reference and the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.dropout import DropPath, Dropout, attention_keep, need_draws


def pad_amount(length: int, kernel: int, stride: int = 1) -> Tuple[int, int]:
    """'same' padding so that the output length is ceil(L / stride)."""
    total = (stride - length % stride) % stride + kernel - stride
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    lp, rp = pad_amount(x.shape[1], kernel, stride)
    return F.pad(x, (0, 0, lp, rp))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def conv(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
         groups: int = 1) -> torch.Tensor:
    return F.conv1d(x.transpose(1, 2), weight, bias, stride, 0, 1, groups).transpose(1, 2)


def pool_ceil(x: torch.Tensor, k: int) -> torch.Tensor:
    """AvgPool1d(k, ceil_mode) + MaxPool1d(k, ceil_mode): the ragged last
    window averages its valid samples only."""
    xt = x.transpose(1, 2)
    avg = F.avg_pool1d(xt, k, k, ceil_mode=True, count_include_pad=False)
    mx = F.max_pool1d(xt, k, k, ceil_mode=True)
    return (avg + mx).transpose(1, 2)


def make_divisible(v: int, divisor: int) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class BatchNorm(nn.Module):
    """BatchNorm1d over the last axis: batch statistics in training (running
    statistics updated with torch's momentum 0.1, the unbiased variance),
    running statistics in eval; eps 1e-5."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.momentum = 0.1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.transpose(1, 2), self.running_mean, self.running_var, self.weight,
                         self.bias, self.training, self.momentum, 1e-5)
        return y.transpose(1, 2)


class Conv(nn.Module):
    """A VALID 1-D convolution, weight (out, in / groups, k)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(x, self.weight, self.bias, self.stride, self.groups)


class Aggregation(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.proj = nn.Linear(cin, cout, bias=False)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        if self.k > 1:
            x = pool_ceil(x, self.k)
        return self.norm(self.proj(x))


class MLP(nn.Module):
    def __init__(self, cin: int, cout: int, ratio: float, bias: bool, drop: float):
        super().__init__()
        self.lin0 = nn.Linear(cin, int(cin * ratio), bias=bias)
        self.lin1 = nn.Linear(int(cin * ratio), cout, bias=bias)
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.lin1(F.gelu(self.lin0(x))))


class DSConv(nn.Module):
    def __init__(self, prev: int, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.k, self.stride = k, stride
        self.in_proj = nn.Linear(prev, cin, bias=False)
        self.dconv = Conv(cin, cin, k, stride, groups=cin)
        self.pconv = nn.Linear(cin, cout, bias=False)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        x = pad_same(self.in_proj(x), self.k, self.stride)
        return F.gelu(self.norm(self.pconv(self.dconv(x))))


class Stem(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.paths = 3
        for i in range(3):
            self.add_module(f"conv{i}", DSConv(cin, cin, cout, k + 4 * i, stride))
        self.out_proj = nn.Linear(3 * cout, cout, bias=False)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        outs = [getattr(self, f"conv{i}")(x) for i in range(self.paths)]
        return self.norm(self.out_proj(torch.cat(outs, -1)))


class GroupConv(nn.Module):
    def __init__(self, c: int, groups: int, k: int, ratio: float, bias: bool, path_drop: float,
                 mlp_drop: float):
        super().__init__()
        self.k = k
        self.conv = Conv(c, c, k, groups=groups)
        self.norm0 = BatchNorm(c)
        self.proj = nn.Linear(c, c, bias=False)
        self.norm1 = BatchNorm(c)
        self.mlp = MLP(c, c, ratio, bias, mlp_drop)
        self.drop_path = DropPath(path_drop)

    def forward(self, x):
        y = self.proj(F.gelu(self.norm0(self.conv(pad_same(x, self.k)))))
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm1(x)))


class MultiScaleConv(nn.Module):
    def __init__(self, cin: int, c: int, groups: int, kernels: Sequence[int], ratio: float,
                 bias: bool, path_drop: float, mlp_drop: float):
        super().__init__()
        gsize = c // groups
        dims: List[int] = []
        for i, k in enumerate(kernels):
            d = make_divisible((c - sum(dims)) // (len(kernels) - len(dims)), gsize)
            dims.append(d)
            self.add_module(f"proj{i}", nn.Linear(cin, d, bias=False))
            self.add_module(f"norm{i}", BatchNorm(d))
            self.add_module(f"conv{i}", GroupConv(d, d // gsize, k, ratio, bias, path_drop,
                                                  mlp_drop))
        self.paths = len(kernels)
        self.out_dim = sum(dims)
        self.out_norm = BatchNorm(self.out_dim)

    def forward(self, x):
        outs = []
        for i in range(self.paths):
            xi = getattr(self, f"norm{i}")(getattr(self, f"proj{i}")(x))
            outs.append(xi + getattr(self, f"conv{i}")(xi))
        return self.out_norm(torch.cat(outs, -1))


#: (L, M, H, E) of every attention call of the last forward, when a list
#: (``attention_shapes`` fills it).
ATTENTION_LOG: List[Tuple[int, int, int, int]] = []


def attention(q, k, v, scale: float, rate: float = 0.0, seed: int = 0):
    """softmax(q k^T * scale) v, q (N, L, H, E), k and v (N, M, H, E); with
    ``rate``, the probabilities dropped by the counter hash of ``seed``."""
    ATTENTION_LOG.append((q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
    s = torch.einsum("nlhe,nmhe->nhlm", q, k) * scale
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = attention_keep(seed, *p.shape, rate, p.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    return torch.einsum("nhlm,nmhe->nlhe", p, v)


class Attention(nn.Module):
    def __init__(self, c: int, head_dim: int, bias: bool, aggr: int, attn_drop: float,
                 key_drop: float, proj_drop: float):
        super().__init__()
        self.heads, self.aggr_ratio = c // head_dim, aggr
        self.attn_drop = attn_drop
        self.key_drop = Dropout(key_drop)
        self.proj_drop = Dropout(proj_drop)
        self.draws = None
        self.q_proj = nn.Linear(c, c, bias=bias)
        if aggr > 1:
            self.aggr = Aggregation(c, c, aggr)
            self.norm = BatchNorm(c)
        self.k_proj = nn.Linear(c, c, bias=bias)
        self.v_proj = nn.Linear(c, c, bias=bias)
        self.out_proj = nn.Linear(c, c, bias=bias)

    def forward(self, x):
        n, length, c = x.shape
        h = self.heads
        e = c // h
        q = self.q_proj(x).view(n, length, h, e)
        if self.aggr_ratio > 1:
            x = self.norm(self.aggr(x))
        m = x.shape[1]
        k = self.key_drop(self.k_proj(x).view(n, m, h, e))
        v = self.v_proj(x).view(n, m, h, e)
        rate = self.attn_drop if self.training else 0.0
        seed = need_draws(self).attention_seed() if rate > 0.0 else 0
        out = attention(q, k, v, 1.0 / math.sqrt(e), rate, seed)
        return self.proj_drop(self.out_proj(out.reshape(n, length, c)))


class TransformerLayer(nn.Module):
    def __init__(self, cin: int, c: int, aggr: int, attn_ratio: float, head_dim: int,
                 qkv_bias: bool, ratio: float, mlp_bias: bool, path_drop: float,
                 drops: Dict[str, float]):
        super().__init__()
        a = make_divisible(int(c * attn_ratio), head_dim) if attn_ratio > 0 else 0
        b = max(c - a, 0)
        self.has_attn, self.has_conv = a > 0, b > 0
        if self.has_attn:
            self.attn_proj = nn.Linear(cin, a, bias=False)
            self.norm0 = BatchNorm(a)
            self.attention = Attention(a, head_dim, qkv_bias, aggr, drops["attn_drop_rate"],
                                       drops["key_drop_rate"], drops["other_drop_rate"])
            self.attn_drop_path = DropPath(path_drop * attn_ratio)
        if self.has_conv:
            self.conv_proj = nn.Linear(cin, b, bias=False)
            self.norm1 = BatchNorm(b)
            self.gconv = GroupConv(b, b // head_dim, 3, ratio, mlp_bias, path_drop,
                                   drops["mlp_drop_rate"])
            self.conv_drop_path = DropPath(path_drop * (1 - attn_ratio))
        self.norm2 = BatchNorm(a + b)
        self.mlp = MLP(a + b, c, ratio, mlp_bias, drops["mlp_drop_rate"])
        self.drop_path = DropPath(path_drop)
        self.out_dim = a + b

    def forward(self, x):
        outs = []
        if self.has_attn:
            x1 = self.norm0(self.attn_proj(x))
            outs.append(x1 + self.attn_drop_path(self.attention(x1)))
        if self.has_conv:
            x2 = self.norm1(self.conv_proj(x))
            outs.append(x2 + self.conv_drop_path(self.gconv(x2)))
        x = self.norm2(torch.cat(outs, -1))
        return x + self.drop_path(self.mlp(x))


class PickingHead(nn.Module):
    """Linear interpolation and convolution back up to the input length,
    then a k = 7 convolution and a sigmoid per channel (det, ppk, spk)."""

    def __init__(self, cin: int, chans: Sequence[int], kernels: Sequence[int], out: int):
        super().__init__()
        outs = list(chans[:-1]) + [out * 2]
        self.kernels = list(kernels)
        prev = cin
        for i, (c, k) in enumerate(zip(outs, kernels)):
            self.add_module(f"conv{i}", Conv(prev, c, k, bias=True))
            self.add_module(f"norm{i}", BatchNorm(c))
            prev = c
        self.out_conv = Conv(prev, out, 7, bias=True)

    def forward(self, x, out_size: int):
        depth = len(self.kernels)
        sizes = [out_size] * depth
        factor = (out_size / x.shape[1]) ** (1 / depth)
        for i in range(depth - 2, -1, -1):
            sizes[i] = int(sizes[i + 1] / factor)
        for i, k in enumerate(self.kernels):
            x = F.interpolate(x.transpose(1, 2), size=sizes[i], mode="linear",
                              align_corners=False).transpose(1, 2)
            x = F.gelu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(pad_same(x, k))))
        return torch.sigmoid(self.out_conv(F.pad(x, (0, 0, 3, 3))))


#: The configuration's drop rates (the published SeisT-L's are all 0.3).
DROP_KEYS = ("path_drop_rate", "attn_drop_rate", "key_drop_rate", "mlp_drop_rate",
             "other_drop_rate")


class SeisT(nn.Module):
    """Stem, four stages of aggregation and blocks, the picking head. Block
    ``i`` of ``T`` (counted over every stage) has the DropPath rate
    ``path_drop_rate * i / (T - 1)``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg["in_channels"]
        self.n_stem = len(cfg["stem_channels"])
        for i, (c, k, s) in enumerate(zip(cfg["stem_channels"], cfg["stem_kernel_sizes"],
                                          cfg["stem_strides"])):
            self.add_module(f"stem{i}", Stem(ch, c, k, s))
            ch = c
        drops = {k: float(cfg[k]) for k in DROP_KEYS}
        total = sum(cfg["layer_blocks"])
        path_drops = [drops["path_drop_rate"] * i / max(total - 1, 1) for i in range(total)]
        self.stages: List[List[str]] = []
        for i, nb in enumerate(cfg["layer_blocks"]):
            lc = cfg["layer_channels"][i]
            self.add_module(f"stage{i}_aggr", Aggregation(ch, lc, cfg["stage_aggr_ratios"][i]))
            ch = lc
            names = []
            for j in range(nb):
                path_drop = path_drops[sum(cfg["layer_blocks"][:i]) + j]
                if j >= nb - cfg["attn_blocks"][i]:
                    blk = TransformerLayer(ch, lc, cfg["attn_aggr_ratios"][i], cfg["attn_ratio"],
                                           cfg["head_dims"][i], cfg["qkv_bias"],
                                           cfg["mlp_ratio"], cfg["mlp_bias"], path_drop, drops)
                else:
                    blk = MultiScaleConv(ch, lc, lc // cfg["head_dims"][i],
                                         cfg["msmc_kernel_sizes"], cfg["mlp_ratio"],
                                         cfg["mlp_bias"], path_drop, drops["mlp_drop_rate"])
                self.add_module(f"stage{i}_block{j}", blk)
                names.append(f"stage{i}_block{j}")
                ch = blk.out_dim
            self.stages.append(names)
        chans, kerns = [], []
        for c, k, s in zip([cfg["in_channels"]] + list(cfg["stem_channels"])
                           + list(cfg["layer_channels"][:-1]),
                           list(cfg["stem_kernel_sizes"])
                           + [max(cfg["msmc_kernel_sizes"])] * len(cfg["layer_channels"]),
                           list(cfg["stem_strides"]) + list(cfg["stage_aggr_ratios"])):
            if s > 1:
                chans.insert(0, c)
                kerns.insert(0, k)
        self.out_head = PickingHead(ch, chans, kerns, cfg["head_out_channels"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        length = x.shape[1]
        for i in range(self.n_stem):
            x = getattr(self, f"stem{i}")(x)
        for i, names in enumerate(self.stages):
            x = getattr(self, f"stage{i}_aggr")(x)
            for name in names:
                x = getattr(self, name)(x)
        return self.out_head(x, length)
