"""Shared building blocks (channels-last ``(N, L, C)``, torch).

Counterparts of ``seist_tpu/models/common.py``: ``auto_pad_1d`` with the
reference's asymmetric 'same' padding, ceil-mode pooling (the avg divisor
is the count of valid elements), ``interpolate_linear``
(``align_corners=False``), ``make_divisible``, exact-erf ``gelu``,
BatchNorm with eps 1e-5, ``global_avg_pool`` and ``DropPath``.

Activations stay channels-last at every public function, as in the JAX
package; convolutions transpose to ``(N, C, L)`` around ``F.conv1d``.

Training mode: BatchNorm normalises with the batch statistics and
updates its running ones (``BatchNorm1dParity``); ``Dropout`` and
``DropPath`` draw their uniforms from the explicit generator of a
:class:`RandomSource` that the model's owner attaches before a train-mode
forward (``F.dropout`` would read the global RNG). DropPath can instead
consume injected uniform rows in call order, as
``seist_tpu/models/common.py::droppath_mask_injection`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

#: torch BatchNorm1d's epsilon, as ``seist_tpu/models/common.py:498``.
BN_EPSILON = 1e-5
#: Running-statistics momentum in the flax convention (new = m*old +
#: (1-m)*batch), torch's 0.1 (``seist_tpu/models/common.py:497``).
BN_MOMENTUM = 0.9
#: Std of the truncated-normal weight init (``seist_tpu/models/common.py:30``).
INIT_STD = 0.02


# --------------------------------------------------------------------- padding
def auto_pad_amount(length: int, kernel_size: int, stride: int = 1) -> Tuple[int, int]:
    """'same'-style asymmetric padding so L_out = ceil(L/stride)."""
    if kernel_size < stride:
        raise ValueError(
            f"`kernel_size` must be >= `stride`, got {kernel_size}, {stride}"
        )
    pds = (stride - (length % stride)) % stride + kernel_size - stride
    return pds // 2, pds - pds // 2


def auto_pad_1d(
    x: torch.Tensor, kernel_size: int, stride: int = 1, padding_value: float = 0.0
) -> torch.Tensor:
    """Pad the length axis (-2) of an (N, L, C) tensor."""
    lp, rp = auto_pad_amount(x.shape[-2], kernel_size, stride)
    return F.pad(x, (0, 0, lp, rp), value=padding_value)


# --------------------------------------------------------------------- pooling
def ceil_len(length: int, stride: int) -> int:
    return -(-length // stride)


def _windows(x: torch.Tensor, kernel_size: int, fill: float) -> torch.Tensor:
    """(N, L, C) -> (N, ceil(L/k), k, C), the ragged last window filled."""
    n, length, c = x.shape
    n_out = ceil_len(length, kernel_size)
    x = F.pad(x, (0, 0, 0, n_out * kernel_size - length), value=fill)
    return x.reshape(n, n_out, kernel_size, c)


def max_pool_1d_ceil(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """MaxPool1d(k, ceil_mode=True): stride k, ragged window padded with -inf."""
    return _windows(x, kernel_size, float("-inf")).amax(dim=2)


def avg_pool_1d_ceil(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """AvgPool1d(k, ceil_mode=True): the ragged last window divides by the
    count of its valid elements."""
    length = x.shape[-2]
    sums = _windows(x, kernel_size, 0.0).sum(dim=2)
    n_out = sums.shape[1]
    counts = torch.full((n_out,), float(kernel_size), dtype=x.dtype, device=x.device)
    counts[-1] = float(length - (n_out - 1) * kernel_size)
    return sums / counts[None, :, None]


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool1d(1) + flatten: (N, L, C) -> (N, C)."""
    return x.mean(dim=-2)


# ---------------------------------------------------------------- interpolate
def interpolate_linear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) on (N, L, C).

    Source index ``(dst + 0.5) * L_in/L_out - 0.5`` clamped to [0, L_in-1],
    blending the two nearest samples; computed in float32 as the JAX
    package computes it (``F.interpolate`` rounds the source index
    differently, by up to 4e-6 at L_in = 64). The JAX package's
    gather-free path for integer factors is a TPU lowering of the same
    formula."""
    l_in = x.shape[-2]
    if l_in == out_size:
        return x
    dst = torch.arange(out_size, dtype=torch.float32, device=x.device)
    src = ((dst + 0.5) * (l_in / out_size) - 0.5).clamp(0.0, l_in - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=l_in - 1)
    w = (src - lo.float())[None, :, None].to(x.dtype)
    return x.index_select(1, lo) * (1.0 - w) + x.index_select(1, hi) * w


# --------------------------------------------------------------------- helpers
def make_divisible(v: int, divisor: int) -> int:
    """Channel rounding (ref seist.py:51-60)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch ``nn.GELU()``."""
    return F.gelu(x)


# --------------------------------------------------------------------- modules
class Conv1d(nn.Module):
    """Channels-last conv1d: (N, L, Cin) -> (N, L_out, Cout), VALID padding.
    ``groups`` > 1 covers the depthwise and grouped convs of the JAX
    package (their lowering choices are XLA's and are not ported)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        groups: int = 1,
        bias: bool = False,
    ):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(
                f"channels {in_channels}->{out_channels} not divisible by "
                f"{groups} groups"
            )
        self.stride = stride
        self.groups = groups
        # Values come from models/api.py::init_weights or a state_dict.
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels // groups, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(
            x.transpose(1, 2), self.weight, self.bias, self.stride, 0, 1, self.groups
        )
        return y.transpose(1, 2)


class RandomSource:
    """The randomness of train-mode forwards.

    ``generator`` draws the element-dropout and DropPath uniforms on the
    activations' device. ``seed_generator`` is a CPU generator that draws
    the attention-dropout seeds: the seed is a host integer handed to the
    kernel, so drawing it costs no device sync, and a step on the card and
    the same step on the CPU use the same attention masks.
    :meth:`inject_droppath` routes DropPath to given uniform rows instead,
    one row per train-mode call with a positive rate, in call order.
    """

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        seed_generator: Optional[torch.Generator] = None,
    ):
        self.generator = generator
        self.seed_generator = seed_generator
        self.droppath_uniforms: Optional[torch.Tensor] = None
        self.droppath_calls = 0

    @classmethod
    def from_seed(cls, seed: int, device) -> "RandomSource":
        """Both generators seeded from one integer (the device one on
        ``device``)."""
        words = np.random.SeedSequence(int(seed)).generate_state(2, np.uint64)
        gen = torch.Generator(device=device).manual_seed(int(words[0]))
        return cls(gen, torch.Generator().manual_seed(int(words[1])))

    def inject_droppath(self, uniforms) -> None:
        """Every later DropPath call consumes the next row of ``uniforms``
        (max_calls, batch); :attr:`droppath_calls` counts the rows used."""
        self.droppath_uniforms = torch.as_tensor(uniforms, dtype=torch.float32)
        self.droppath_calls = 0

    def uniform(self, shape, device) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError("this RandomSource has no generator for dropout")
        return torch.rand(shape, generator=self.generator, device=device)

    def attention_seed(self) -> int:
        """An int32 seed in [0, 2^31 - 1), as ``jax.random.randint(key,
        (1,), 0, iinfo(int32).max)`` draws it (``seist.py:545-551``)."""
        if self.seed_generator is None:
            raise RuntimeError("this RandomSource has no seed generator")
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.seed_generator))


def need_source(module: nn.Module) -> RandomSource:
    """The RandomSource attached to ``module``; raises when there is none."""
    src = getattr(module, "random", None)
    if src is None:
        raise RuntimeError(
            f"{type(module).__name__} in training mode needs a RandomSource: "
            "call set_random_source(model, source) before the forward"
        )
    return src


def set_random_source(model: nn.Module, source: Optional[RandomSource]) -> None:
    """Attach ``source`` to every module of ``model`` that draws randomness
    in training mode (anything with a ``random`` attribute)."""
    for m in model.modules():
        if hasattr(m, "random"):
            m.random = source


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of (N, L, C), torch ``BatchNorm1d``
    semantics with eps 1e-5, statistics in fp32.

    Training mode (``BatchNorm1dParity``): normalise with the biased
    variance over (N, L), update the running variance with the unbiased
    one (n = N*L), momentum 0.9 in the flax convention (torch's 0.1). The
    running statistics are updated in place, as torch's BatchNorm does;
    the train step restores them when it skips an update."""

    def __init__(self, features: int, eps: float = BN_EPSILON):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
            n = math.prod(x.shape[:-1])
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * inv + self.bias
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Element dropout (flax ``nn.Dropout``): keep with probability
    1 - rate, scale the kept by 1/(1 - rate); the identity in eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.random: Optional[RandomSource] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        u = need_source(self).uniform(x.shape, x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath, ``scale_by_keep``); the
    identity in eval or at rate 0. One uniform per sample, from the
    source's generator or its injected rows."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.random: Optional[RandomSource] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        src = need_source(self)
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        if src.droppath_uniforms is not None:
            u = src.droppath_uniforms[src.droppath_calls].to(x.device)
            src.droppath_calls += 1
        else:
            u = src.uniform((x.shape[0],), x.device)
        mask = (u < keep).reshape(shape)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
