"""Shared building blocks (channels-last ``(N, L, C)``, torch).

Counterparts of ``seist_tpu/models/common.py``: ``auto_pad_1d`` with the
reference's asymmetric 'same' padding, the static ``same_pad_1d`` and the
left-only ``causal_pad_1d``, ceil-mode pooling (the avg divisor is the
count of valid elements) and floor-mode ``max_pool_1d``,
``interpolate_linear`` (``align_corners=False``), ``interpolate_nearest``
and ``upsample_x2``, ``make_divisible``, exact-erf ``gelu``, BatchNorm
with eps 1e-5, flax's ``LayerNorm`` (eps 1e-6), ``global_avg_pool``,
``DropPath``, element and channel ``Dropout``, a transposed convolution
and the ``LSTM`` of the baseline families (``nn.LSTM``, cuDNN on the card).

Activations stay channels-last at every public function, as in the JAX
package; convolutions transpose to ``(N, C, L)`` around ``F.conv1d``.

Training mode: BatchNorm normalises with the batch statistics and
updates its running ones (``BatchNorm1dParity``), both in fp32 under any
precision policy; ``Dropout`` and
``DropPath`` draw their uniforms from the explicit generator of a
:class:`RandomSource` that the model's owner attaches before a train-mode
forward (``F.dropout`` would read the global RNG). DropPath can instead
consume injected uniform rows in call order, as
``seist_tpu/models/common.py::droppath_mask_injection`` does.

Rematerialisation (:func:`remat`, SeisT's ``use_checkpoint``): a stage
runs under ``torch.utils.checkpoint`` with a :class:`StageTape`, which
records every draw of the stage's first forward (uniforms, DropPath rows,
attention seeds) and hands them back, in order, to the recompute of the
backward pass, where BatchNorm leaves its running statistics alone.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from seist_tpu_torch.parallel import comm
from seist_tpu_torch.parallel import mesh as mesh_lib
from seist_tpu_torch.train.precision import policy_dtype, precision_policy

#: torch BatchNorm1d's epsilon, as ``seist_tpu/models/common.py:498``.
BN_EPSILON = 1e-5
#: Running-statistics momentum in the flax convention (new = m*old +
#: (1-m)*batch), torch's 0.1 (``seist_tpu/models/common.py:497``).
BN_MOMENTUM = 0.9
#: Std of the truncated-normal weight init (``seist_tpu/models/common.py:30``).
INIT_STD = 0.02
#: flax ``nn.LayerNorm``'s epsilon (torch's default is 1e-5).
LN_EPSILON = 1e-6


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


def same_pad_1d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Static 'same' padding of a stride-1 conv: (k-1)//2 left, the rest
    right (``seist_tpu/models/common.py:60``)."""
    lp = (kernel_size - 1) // 2
    return F.pad(x, (0, 0, lp, kernel_size - 1 - lp))


def causal_pad_1d(x: torch.Tensor, kernel_size: int, dilation: int = 1) -> torch.Tensor:
    """Left-only padding of a causal dilated conv (``common.py:67``)."""
    return F.pad(x, (0, 0, (kernel_size - 1) * dilation, 0))


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
    counts[-1:].fill_(float(length - (n_out - 1) * kernel_size))  # a fill: no host copy
    return sums / counts[None, :, None]


def max_pool_1d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """MaxPool1d(k), floor mode: the trailing partial window is dropped
    (``common.py:140``)."""
    n, length, c = x.shape
    n_out = length // kernel_size
    return x[:, : n_out * kernel_size].reshape(n, n_out, kernel_size, c).amax(dim=2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool1d(1) + flatten: (N, L, C) -> (N, C)."""
    return x.mean(dim=-2)


# ---------------------------------------------------------------- interpolate
#: (l_in, out_size, kind, dtype, device) -> the fixed-order gather table of
#: a resampling's backward (:func:`_gather_table`), filled by eager calls.
_GATHER_TABLES: dict = {}


def _linear_taps(l_in: int, out_size: int, device, dtype):
    """The two source samples and the blend weight of each output sample."""
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    src = ((dst + 0.5) * (l_in / out_size) - 0.5).clamp(0.0, l_in - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=l_in - 1)
    return lo, hi, (src - lo.float()).to(dtype)


def _nearest_taps(l_in: int, out_size: int, device):
    src = torch.arange(out_size, dtype=torch.float32, device=device) * (l_in / out_size)
    return torch.floor(src).long()


def _gather_table(l_in: int, out_size: int, kind: str, dtype, device):
    """For each source sample, the output samples it fed, in ascending
    order (the linear kind's ``lo`` taps before its ``hi`` taps), and the
    weight of each: ``(dst, coef)``, both ``(l_in, K)``. Empty slots point
    at output ``out_size`` (a zero row the backward appends) with weight 0.
    ``coef`` is None for the nearest kind (every weight 1).

    The contributions are sorted by source (a stable sort), so every
    source's lie in one run; ``K`` is the longest run, read once on the
    host in an eager call and cached, and inside a graph capture the bound
    ``2·(ceil(1.5·out/l_in) + 2)`` (nothing is cached there: a tensor made
    during a capture holds its values only once the graph replays)."""
    key = (l_in, out_size, kind, dtype, str(device))
    hit = _GATHER_TABLES.get(key)
    if hit is not None:
        return hit
    dest = torch.arange(out_size, device=device)
    if kind == "linear":
        lo, hi, w = _linear_taps(l_in, out_size, device, dtype)
        keys, dest, coefs = torch.cat([lo, hi]), torch.cat([dest, dest]), torch.cat([1.0 - w, w])
    else:
        keys, coefs = _nearest_taps(l_in, out_size, device), None
    order = torch.sort(keys, stable=True)[1]
    sorted_keys = keys[order]
    sources = torch.arange(l_in, device=device)
    start = torch.searchsorted(sorted_keys, sources)
    stop = torch.searchsorted(sorted_keys, sources, right=True)
    capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if capturing:
        k = (2 if kind == "linear" else 1) * (math.ceil(1.5 * out_size / l_in) + 2)
    else:
        k = max(1, int((stop - start).max()))
    slot = start[:, None] + torch.arange(k, device=device)[None, :]
    valid = slot < stop[:, None]
    taken = order[slot.clamp(max=keys.numel() - 1)]
    table = (torch.where(valid, dest[taken], out_size),
             None if coefs is None else torch.where(valid, coefs[taken], 0.0))
    if not capturing:
        _GATHER_TABLES[key] = table
    return table


def _fixed_order_backward(g: torch.Tensor, l_in: int, kind: str) -> torch.Tensor:
    """The input gradient of a resampling along axis 1: each source sums
    what its outputs send back in one fixed order (a gather and a sum over
    the table's slots), where autograd's ``index_select`` backward adds
    them with atomics in whatever order the card's threads arrive."""
    dst, coef = _gather_table(l_in, g.shape[1], kind, g.dtype, g.device)
    taps = F.pad(g, (0, 0, 0, 1))[:, dst]  # (N, l_in, K, C)
    if coef is not None:
        taps = taps * coef[None, :, :, None]
    return taps.sum(dim=2)


class _LinearResample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, w):
        ctx.l_in = x.shape[1]
        return x.index_select(1, lo) * (1.0 - w) + x.index_select(1, hi) * w

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _fixed_order_backward(g, ctx.l_in, "linear"), None, None, None


class _NearestResample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.l_in = x.shape[1]
        return x.index_select(1, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _fixed_order_backward(g, ctx.l_in, "nearest"), None


def interpolate_linear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) on (N, L, C).

    Source index ``(dst + 0.5) * L_in/L_out - 0.5`` clamped to [0, L_in-1],
    blending the two nearest samples; computed in float32 as the JAX
    package computes it (``F.interpolate`` rounds the source index
    differently, by up to 4e-6 at L_in = 64). The JAX package's
    gather-free path for integer factors is a TPU lowering of the same
    formula. The backward sums each source's contributions in a fixed
    order (:func:`_fixed_order_backward`), so a train step repeats bit
    for bit on the card."""
    l_in = x.shape[-2]
    if l_in == out_size:
        return x
    lo, hi, w = _linear_taps(l_in, out_size, x.device, x.dtype)
    return _LinearResample.apply(x, lo, hi, w[None, :, None])


def interpolate_nearest(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') on (N, L, C): source index
    ``floor(d * L_in/L_out)`` in float32, as the JAX package computes it
    (``common.py:211``); an integer upscale repeats each sample. The
    gather's backward sums in a fixed order, as ``interpolate_linear``'s."""
    l_in = x.shape[-2]
    if l_in == out_size:
        return x
    if out_size % l_in == 0:
        return x.repeat_interleave(out_size // l_in, dim=-2)
    return _NearestResample.apply(x, _nearest_taps(l_in, out_size, x.device))


def upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2), nearest (``common.py:227``)."""
    return x.repeat_interleave(2, dim=-2)


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
    package (their lowering choices are XLA's and are not ported);
    ``dilation`` the causal TCN's. The forward is ``F.conv1d``. A
    one-group convolution's backward sums in a fixed order
    (:func:`conv_input_grad`, :func:`conv_weight_grad`), so a train step
    repeats bit for bit on the card, where cuDNN's default weight and input
    gradients of these long, narrow convolutions add with atomics; a
    depthwise one keeps torch's own kernels, which repeat."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        groups: int = 1,
        bias: bool = False,
        dilation: int = 1,
    ):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(
                f"channels {in_channels}->{out_channels} not divisible by "
                f"{groups} groups"
            )
        self.stride = stride
        self.groups = groups
        self.dilation = dilation
        # Values come from models/api.py::init_weights or a state_dict.
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels // groups, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.groups == 1:
            return _FixedOrderConv.apply(x, self.weight, self.bias, self.stride, self.dilation)
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias, self.stride, 0, self.dilation,
                     self.groups)
        return y.transpose(1, 2)


def conv_weight_grad(g: torch.Tensor, x: torch.Tensor, kernel_size: int, stride: int,
                     dilation: int) -> torch.Tensor:
    """The weight gradient of a channels-last one-group conv1d in a fixed
    order: ``g`` (N, L_out, Cout), ``x`` the conv's input (N, L, Cin) ->
    (Cout, Cin, K). The input's windows are unfolded into one (N·L_out,
    Cin·K) matrix and multiplied by ``g``: one product, whose sums cuBLAS
    orders the same way on every call."""
    n, l_out, c_out = g.shape
    cols = x.unfold(1, (kernel_size - 1) * dilation + 1, stride)[:, :l_out]
    if dilation > 1:
        cols = cols[..., ::dilation]
    cols = cols.reshape(n * l_out, -1)  # (N·L_out, Cin·K), the weight's layout
    return (g.reshape(n * l_out, c_out).t() @ cols).view(c_out, -1, kernel_size)


def conv_input_grad(g: torch.Tensor, weight: torch.Tensor, l_in: int, stride: int,
                    dilation: int) -> torch.Tensor:
    """The input gradient of a channels-last one-group conv1d as a forward
    convolution: ``g`` (N, L_out, Cout), spread over the stride and padded
    by the kernel's reach, correlated with the flipped, transposed kernel
    -> (N, l_in, Cin). A forward convolution adds no atomics on the card,
    where cuDNN's input-gradient kernels may."""
    n, l_out, c_out = g.shape
    gt = g.transpose(1, 2)
    if stride > 1:
        spread = gt.new_zeros(n, c_out, (l_out - 1) * stride + 1)
        spread[..., ::stride] = gt
        gt = spread
    reach = (weight.shape[2] - 1) * dilation
    gx = F.conv1d(gt, weight.transpose(0, 1).flip(-1), None, 1, reach, dilation)
    if gx.shape[-1] < l_in:  # input samples no window reached
        gx = F.pad(gx, (0, l_in - gx.shape[-1]))
    return gx.transpose(1, 2)


class _FixedOrderConv(torch.autograd.Function):
    """A one-group channels-last conv1d whose backward sums in a fixed order."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, dilation):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, dilation)
        return F.conv1d(x.transpose(1, 2), weight, bias, stride, 0, dilation).transpose(1, 2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, dilation = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx = conv_input_grad(g, weight, x.shape[1], stride, dilation) if need_x else None
        gw = conv_weight_grad(g, x, weight.shape[2], stride, dilation) if need_w else None
        gb = g.sum(dim=(0, 1)) if need_b else None
        return gx, gw, gb, None, None


class ConvTranspose1d(nn.Module):
    """Channels-last transposed conv1d, no padding or bias: L_out = (L-1)*s + k.

    ``weight`` has torch's ``ConvTranspose1d`` layout (Cin, Cout, k). A
    flax ``ConvTranspose`` (``padding="VALID"``, no kernel transpose)
    correlates the dilated input with its kernel as stored, while torch
    flips it, so ``models/convert.py`` stores ``kernel[k-1-t, i, o]`` at
    ``weight[i, o, t]``; both lengths are (L-1)*s + k for k >= s
    (``seist_tpu/models/phasenet.py:92-94``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__()
        if kernel_size < stride:
            raise ValueError(f"kernel {kernel_size} < stride {stride}: the lengths differ")
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(in_channels, out_channels, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, None, self.stride)
        return y.transpose(1, 2)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the channel axis: eps 1e-6, scale and bias."""

    def __init__(self, features: int):
        super().__init__(features, eps=LN_EPSILON)


class LSTM(nn.LSTM):
    """One LSTM layer over (N, L, C), batch first, returning ``(outputs,
    final_h)`` as ``seist_tpu/models/common.py::LSTM`` (:603) does; with
    ``bidirectional`` the ``BiLSTM`` (:637): outputs ``(N, L, 2H)`` and the
    final h ``concat(fwd_h, bwd_h)``. The backward direction runs over the
    reversed sequence without masking, which is what flax's ``bwd`` cell
    computes on ``x[:, ::-1]``.

    The gates are torch's (i, f, g, o), flax ``OptimizedLSTMCell``'s order.
    flax has one bias per gate (on the hidden product) where torch has two:
    ``bias_ih`` is a zero buffer, outside the ``state_dict`` and the
    optimizer, so an update moves the effective bias once. The forward
    calls the cuDNN LSTM on the card with every weight cast to the input's
    dtype (a no-op in fp32, where the weights stay views of cuDNN's flat
    buffer: ``nn.LSTM`` flattens them after ``.to()``; loads and the
    optimizer write into them in place), so under the bf16 policy the
    recurrence and its carry are bf16, as the JAX package pins them."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool = False):
        super().__init__(input_size, hidden, batch_first=True, bidirectional=bidirectional)
        for name in self._flat_weights_names:
            if name.startswith("bias_ih"):
                p = self._parameters.pop(name)
                self.register_buffer(name, torch.zeros_like(p.data), persistent=False)
        self._init_flat_weights()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dirs = 2 if self.bidirectional else 1
        h0 = x.new_zeros(dirs, x.shape[0], self.hidden_size)
        # getattr, not _flat_weights: functional_call swaps the parameters.
        weights = [getattr(self, n).to(x.dtype) for n in self._flat_weights_names]
        out, h, _ = torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0, self.training,
                                   self.bidirectional, True)
        return out, (torch.cat([h[0], h[1]], dim=-1) if self.bidirectional else h[0])

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """flax ``OptimizedLSTMCell``'s initialisers, gate by gate: input
        kernels lecun_normal, recurrent kernels orthogonal, biases zero."""
        h = self.hidden_size
        for name, p in self.named_parameters(recurse=False):
            if name.startswith("bias"):
                p.zero_()
                continue
            for gate in p.split(h, dim=0):
                if name.startswith("weight_ih"):
                    lecun_normal_(gate, gate.shape[1], generator)
                else:
                    nn.init.orthogonal_(gate, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at 2 of its std,
    scaled so the std is 1/sqrt(fan_in)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class RandomSource:
    """The randomness of train-mode forwards.

    ``generator`` draws the element-dropout and DropPath uniforms on the
    activations' device. ``seed_generator`` is a CPU generator that draws
    the attention-dropout seeds: drawing one costs no device sync, and a
    step on the card and the same step on the CPU use the same attention
    masks. The kernels read the seed from an int32 tensor on the device:
    :meth:`attention_seed` writes each draw into one by a fill or, when
    ``attention_seeds`` holds a device buffer of the step's seeds (a
    captured step's, written before each replay from the same draws),
    returns its next entry, in call order; ``attention_calls`` counts
    the calls. :meth:`inject_droppath` routes DropPath to given uniform rows
    instead, one row per train-mode call with a positive rate, in call
    order.

    Under data parallelism (an active mesh with data ranks) every draw is
    the global batch's, of which a rank keeps its own rows (and an
    injected row of the global batch's length is cut the same way): a run
    over W ranks draws what one process stepping on the global batch
    draws, as the JAX package's step over the global array does. Every
    rank seeds its generators alike.
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
        self.attention_seeds: Optional[torch.Tensor] = None
        self.attention_calls = 0

    @classmethod
    def from_seed(cls, seed: int, device) -> "RandomSource":
        """Both generators seeded from one integer (the device one on
        ``device``). A captured step re-seeds the default CUDA generator
        with ``generator.initial_seed()``, which then draws the same
        uniforms."""
        words = np.random.SeedSequence(int(seed)).generate_state(2, np.uint64)
        gen = torch.Generator(device=device).manual_seed(int(words[0]))
        return cls(gen, torch.Generator().manual_seed(int(words[1])))

    def inject_droppath(self, uniforms) -> None:
        """Every later DropPath call consumes the next row of ``uniforms``
        (max_calls, batch); :attr:`droppath_calls` counts the rows used."""
        self.droppath_uniforms = torch.as_tensor(uniforms, dtype=torch.float32)
        self.droppath_calls = 0

    def uniform(self, shape, device) -> torch.Tensor:
        def draw():
            if self.generator is None:
                raise RuntimeError("this RandomSource has no generator for dropout")
            mesh = mesh_lib.data_parallel()
            if mesh is None:
                return torch.rand(shape, generator=self.generator, device=device)
            full = (shape[0] * mesh.data,) + tuple(shape[1:])
            return mesh_lib.shard_batch(mesh, torch.rand(full, generator=self.generator,
                                                         device=device))

        return _taped(draw)

    def droppath_uniform(self, n: int, device) -> torch.Tensor:
        """DropPath's (n,) uniforms: the next injected row, or a draw."""
        if self.droppath_uniforms is None:
            return self.uniform((n,), device)

        def draw():
            u = self.droppath_uniforms[self.droppath_calls].to(device)
            self.droppath_calls += 1
            mesh = mesh_lib.data_parallel()
            return mesh_lib.shard_batch(mesh, u) if mesh and u.shape[0] != n else u

        return _taped(draw)

    def draw_attention_seed(self) -> int:
        """An int32 seed in [0, 2^31 - 1), as ``jax.random.randint(key,
        (1,), 0, iinfo(int32).max)`` draws it (``seist.py:545-551``)."""
        if self.seed_generator is None:
            raise RuntimeError("this RandomSource has no seed generator")
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.seed_generator))

    def attention_seed(self, device) -> torch.Tensor:
        """The next attention call's seed: an int32 scalar tensor on
        ``device`` (class docstring)."""
        return _taped(lambda: self._next_attention_seed(device))

    def _next_attention_seed(self, device) -> torch.Tensor:
        i = self.attention_calls
        if self.attention_seeds is not None:
            if i >= self.attention_seeds.numel():
                raise RuntimeError(
                    f"attention call {i + 1} of a step whose seed buffer holds "
                    f"{self.attention_seeds.numel()}"
                )
            seed = self.attention_seeds[i]
        else:
            seed = torch.full((), self.draw_attention_seed(), dtype=torch.int32, device=device)
        self.attention_calls = i + 1
        return seed


class StageTape:
    """The draws of one rematerialised stage. Its first forward records
    each draw of the stage (a uniform tensor, a DropPath row, an attention
    seed) in call order, with the precision policy it ran under; the
    recompute in the backward pass reads them back in the same order, so
    it applies the same dropout masks, DropPath decisions and attention
    seeds, and makes no draw of its own. Replaying tensors rather than
    generator states keeps this working inside a captured CUDA graph, where
    a generator's state can be neither read nor set."""

    def __init__(self):
        self.draws: list = []
        self.replaying = False
        self.at = 0
        self.dtype: Optional[torch.dtype] = None

    def take(self, draw):
        if not self.replaying:
            value = draw()
            self.draws.append(value)
            return value
        if self.at >= len(self.draws):
            raise RuntimeError(f"the recompute of a stage drew {self.at + 1} times; its "
                               f"forward drew {len(self.draws)} times")
        value = self.draws[self.at]
        self.at += 1
        return value


#: The tape of the stage running now (None outside :func:`remat`). A plain
#: global, not a thread-local: on the card the recompute runs on autograd's
#: device thread while the caller waits in ``backward``.
_TAPE: Optional[StageTape] = None


def _taped(draw):
    return draw() if _TAPE is None else _TAPE.take(draw)


def recomputing() -> bool:
    """True inside the backward pass's recompute of a stage."""
    return _TAPE is not None and _TAPE.replaying


def remat(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` without keeping its activations: they are recomputed in
    the backward pass (``torch.utils.checkpoint``, non-reentrant), which
    replays the forward's draws from a :class:`StageTape` (flax
    ``nn.remat`` of the JAX package, ``seist_tpu/models/seist.py:888``)."""
    from torch.utils.checkpoint import checkpoint

    tape = StageTape()

    def body(t: torch.Tensor) -> torch.Tensor:
        global _TAPE
        outer = _TAPE
        _TAPE = tape
        try:
            if not tape.replaying:
                tape.dtype = policy_dtype()
                return fn(t)
            tape.at = 0
            with precision_policy(tape.dtype):
                return fn(t)
        finally:
            _TAPE = outer
            tape.replaying = True

    return checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)


def need_source(module: nn.Module) -> RandomSource:
    """The RandomSource attached to ``module``; raises when there is none.
    A stage's recompute needs none (the train step detaches its source
    after the forward): every draw there comes from the stage's tape."""
    src = getattr(module, "random", None)
    if src is None and recomputing():
        return RandomSource()
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
    the train step restores them when it skips an update. Under a bf16
    precision policy (``train/precision.py``) only the output is cast
    down: the fp32 statistics would otherwise promote every activation
    after it back to fp32.

    Under data parallelism (an active mesh with data ranks) the statistics
    are the global batch's: ``(sum x, sum x^2)`` over the rank's rows are
    summed over the data group (``parallel/comm.py::AllReduceSum``, whose
    backward sums the gradients too), with n the global count: SyncBatchNorm,
    what ``seist_tpu/models/common.py:519`` gets from its global batch. The
    running statistics then follow the one-process run's."""

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
            n = math.prod(x.shape[:-1])
            mesh = mesh_lib.data_parallel()
            if mesh is None:
                mean = xf.mean(dims)
                var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
            else:
                sums = torch.stack([xf.sum(dims), xf.square().sum(dims)])
                sums = comm.AllReduceSum.apply(sums, mesh.data_group)
                n *= mesh.data
                mean = sums[0] / n
                var = (sums[1] / n - mean.square()).clamp_min(0.0)
            # A stage's recompute (remat) must not move the statistics again.
            if not recomputing():
                with torch.no_grad():
                    unbiased = var * (n / max(n - 1, 1))
                    m = BN_MOMENTUM
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * inv + self.bias
        return y.to(policy_dtype() or x.dtype)


class Dropout(nn.Module):
    """Element dropout (flax ``nn.Dropout``): keep with probability
    1 - rate, scale the kept by 1/(1 - rate); the identity in eval. With
    ``channel``, flax's ``Dropout(broadcast_dims=(1,))`` (torch's
    ``Dropout1d``): one draw per (sample, channel), the mask (N, 1, C)."""

    def __init__(self, rate: float, channel: bool = False):
        super().__init__()
        self.rate = rate
        self.channel = channel
        self.random: Optional[RandomSource] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0], 1, x.shape[2]) if self.channel else x.shape
        u = need_source(self).uniform(shape, x.device)
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
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = need_source(self).droppath_uniform(x.shape[0], x.device)
        mask = (u < keep).reshape(shape)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
