"""The train and stitch paths without atomic floating-point sums
(``seist_tpu_torch/models/common.py``, ``seist_tpu_torch/ops/stream.py``),
held against the forms they replace and against the JAX package on the CPU.

* ``interpolate_linear`` and ``interpolate_nearest``: the forward is
  bitwise the ``index_select`` form's; the fixed-order backward is within
  1e-6 of max(1, max|g|) of autograd through that form and of ``jax.vjp``
  of ``seist_tpu/models/common.py``'s (:160, :211), at the dpk head's
  up-sizes at windows 256, 3000 (its non-integer ratios) and 8192, the
  integer ratios 4 and 3 (against JAX at 3: the forwards' 1e-5, since
  JAX's integer path weighs in float64), a downsampling and
  ``l_in == out_size``.
* The ``mean`` stitch: bitwise the sum in ascending offset order that
  ``stream/session.py`` accumulates, within 1e-6 of
  ``seist_tpu/ops/stream.py``'s and of the ``index_add_`` form.
* ``Conv1d``'s fixed-order backward (the input's gradient as a forward
  convolution, the weight's as one unfolded product): forward bitwise,
  every gradient within the train-step row's limits of autograd's, and
  within 1e-6 of max(1, max|g|), at strides and dilations.
* One ``seist_s_dpk`` train step, recorded op by op: no ``index_add``, no
  accumulating ``index_put``, no ``scatter_add`` over colliding indices,
  and no one-group convolution's gradient left to ``convolution_backward``
  (the depthwise ones keep torch's kernels, which repeat on the card).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from seist_tpu.models import common as jcommon
from seist_tpu.ops import stream as jstream

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models import common
from seist_tpu_torch.ops import stream as tstream
from seist_tpu_torch.train import optim as toptim
from seist_tpu_torch.train import schedule as tsched
from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source

GRAD_TOL = 1e-6  # of max(1, max|g|): the sums add in another order
FORWARD_TOL = 1e-5  # the forwards' limit, port against JAX
STITCH_TOL = 1e-6  # tests/test_torch_stream.py's limit for the mean stitch
GRAD_COS, GRAD_REL = 0.9999, 5e-3  # the train-step row's limits (PERF.md §2)


# --------------------------------------------------------------- the old forms
def _linear_index_select(x, out_size):
    """``interpolate_linear`` as it was: two ``index_select``s, whose
    backward is an atomic ``index_add`` on the card."""
    l_in = x.shape[-2]
    dst = torch.arange(out_size, dtype=torch.float32)
    src = ((dst + 0.5) * (l_in / out_size) - 0.5).clamp(0.0, l_in - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=l_in - 1)
    w = (src - lo.float())[None, :, None].to(x.dtype)
    return x.index_select(1, lo) * (1.0 - w) + x.index_select(1, hi) * w


def _nearest_index_select(x, out_size):
    l_in = x.shape[-2]
    src = torch.arange(out_size, dtype=torch.float32) * (l_in / out_size)
    return x.index_select(1, torch.floor(src).long())


def _stitch_index_add(probs, offsets, total_len):
    """The ``mean`` stitch as it was: ``index_add_`` of values and counts."""
    n, window, c = probs.shape
    offsets = torch.as_tensor(np.asarray(offsets), dtype=torch.long)
    flat_pos = (offsets[:, None] + torch.arange(window)[None, :]).reshape(-1)
    out = torch.zeros((total_len, c), dtype=probs.dtype)
    out.index_add_(0, flat_pos, probs.reshape(-1, c))
    hits = torch.zeros((total_len,), dtype=probs.dtype)
    hits.index_add_(0, flat_pos, torch.ones_like(flat_pos, dtype=probs.dtype))
    return out / torch.clamp(hits, min=1.0)[:, None]


# ------------------------------------------------------------- interpolation
@functools.lru_cache(maxsize=None)
def _head_sizes(window: int):
    """(l_in, out) of each of seist_s_dpk's head interpolations at ``window``."""
    seist_tpu_torch.load_all()
    model = tapi.create_model("seist_s_dpk", in_samples=window).eval()
    seen = []
    model.out_head.register_forward_pre_hook(lambda mod, args: seen.append(args[0].shape[-2]))
    with torch.no_grad():
        model(torch.zeros(1, window, 3))
    sizes = model.out_head._upsampling_sizes(seen[0], window)
    return tuple(zip([seen[0]] + sizes[:-1], sizes))


def _pairs():
    pairs = [pytest.param(l_in, out, id=f"head{w}-{l_in}-{out}")
             for w in (256, 3000, 8192) for l_in, out in _head_sizes(w)]
    return pairs + [pytest.param(40, 160, id="integer-4"), pytest.param(40, 120, id="integer-3"),
                    pytest.param(96, 64, id="down"), pytest.param(50, 50, id="same")]


def _grad_gap(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("kind", ["linear", "nearest"])
@pytest.mark.parametrize("l_in,out", _pairs())
def test_resampling_backward_equals_index_select_and_jax(kind, l_in, out):
    rng = np.random.default_rng(l_in * 7 + out)
    x = rng.standard_normal((2, l_in, 5)).astype(np.float32)
    g = rng.standard_normal((2, out, 5)).astype(np.float32)
    new, old, jfn = {"linear": (common.interpolate_linear, _linear_index_select,
                                jcommon.interpolate_linear),
                     "nearest": (common.interpolate_nearest, _nearest_index_select,
                                 jcommon.interpolate_nearest)}[kind]
    tx = torch.from_numpy(x).requires_grad_(True)
    y = new(tx, out)
    (gx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    if l_in == out:
        assert y is tx
    else:
        tx0 = torch.from_numpy(x).requires_grad_(True)
        y0 = old(tx0, out)
        (gx0,) = torch.autograd.grad(y0, tx0, torch.from_numpy(g))
        if kind == "linear" or out % l_in:  # the integer nearest path repeats, as before
            assert torch.equal(y, y0)
        assert _grad_gap(gx, gx0) <= GRAD_TOL
    jy, vjp = jax.vjp(lambda a: jfn(a, out), jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    # JAX's integer path weighs by (j + 0.5 - r/2)/r in float64: at r = 3
    # those weights differ from the float32 source index's in the last
    # bits, so there the forward's limit (1e-5) holds, as before this form.
    tol = FORWARD_TOL if kind == "linear" and out % l_in == 0 and (out // l_in) % 2 else GRAD_TOL
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=tol)
    assert _grad_gap(gx, torch.from_numpy(np.array(jgx))) <= tol


def test_resampling_backward_reads_no_gradient_it_does_not_own():
    """An empty slot of the gather table reads the appended zero row: a NaN
    in one output's gradient reaches only the sources that fed it."""
    x = torch.randn(1, 10, 2, requires_grad=True)
    g = torch.zeros(1, 37, 2)
    g[0, 36] = float("nan")
    (gx,) = torch.autograd.grad(common.interpolate_linear(x, 37), x, g)
    assert torch.isnan(gx[0, 9]).all() and not torch.isnan(gx[0, :9]).any()


# -------------------------------------------------------------------- stitch
@pytest.mark.parametrize("length,window,stride", [
    (3000, 256, 128), (3001, 256, 100), (256, 256, 128), (1000, 256, 256), (5000, 512, 64),
    (700, 256, 300), (8192 * 3 + 5, 8192, 4096)])
def test_mean_stitch_adds_in_ascending_offset_order(length, window, stride):
    offs = tstream.window_offsets(length, window, stride)
    probs = np.random.default_rng(length).random((len(offs), window, 3)).astype(np.float32)
    got = tstream.stitch_probs(torch.from_numpy(probs), offs, length).numpy()
    acc = np.zeros((length, 3), np.float32)
    hits = np.zeros(length, np.float32)
    for o, p in zip(offs, probs):  # stream/session.py's accumulation
        acc[o:o + window] += p
        hits[o:o + window] += 1.0
    np.testing.assert_array_equal(got, acc / np.maximum(hits, 1.0)[:, None])
    want = np.asarray(jstream.stitch_probs(jnp.asarray(probs), jnp.asarray(offs), length))
    np.testing.assert_allclose(got, want, rtol=0, atol=STITCH_TOL)
    old = _stitch_index_add(torch.from_numpy(probs), offs, length).numpy()
    np.testing.assert_allclose(got, old, rtol=0, atol=STITCH_TOL)


# -------------------------------------------------------------- convolutions
class _AutogradConv1d(common.Conv1d):
    """The same convolution with autograd's backward (cuDNN's on the card)."""

    def forward(self, x):
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups).transpose(1, 2)


@pytest.mark.parametrize("cin,cout,k,stride,dilation,groups,bias", [
    (16, 6, 11, 1, 1, 1, True), (16, 16, 7, 1, 1, 1, True), (8, 8, 3, 2, 1, 1, False),
    (4, 8, 5, 1, 2, 1, True), (6, 5, 4, 3, 2, 1, True)])
def test_fixed_order_conv_gradients_equal_autograd(cin, cout, k, stride, dilation, groups, bias):
    convs = [cls(cin, cout, k, stride=stride, groups=groups, bias=bias, dilation=dilation)
             for cls in (common.Conv1d, _AutogradConv1d)]
    for m in convs:
        torch.manual_seed(1)
        torch.nn.init.normal_(m.weight, std=0.3)
        if bias:
            torch.nn.init.normal_(m.bias, std=0.1)
    x = torch.randn(3, 257, cin)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    ys = [m(a) for m, a in zip(convs, xs)]
    assert torch.equal(ys[0], ys[1])
    g = torch.randn_like(ys[0])
    for y in ys:
        y.backward(g)
    pairs = [(xs[0].grad, xs[1].grad), (convs[0].weight.grad, convs[1].weight.grad)]
    if bias:
        pairs.append((convs[0].bias.grad, convs[1].bias.grad))
    for got, want in pairs:
        assert got.shape == want.shape
        cos = F.cosine_similarity(got.flatten(), want.flatten(), dim=0)
        assert cos >= GRAD_COS
        assert float((got - want).abs().max()) <= GRAD_REL * float(want.abs().max())
        assert _grad_gap(got, want) <= GRAD_TOL


# ------------------------------------------------- a train step, op by op
class _AtomicSums(TorchDispatchMode):
    """Records every op of a call that sums with atomics on the card."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("index_add", "index_add_", "embedding_dense_backward", "put_"):
            self.found.append(name)
        elif name in ("index_put", "index_put_", "_index_put_impl_", "_unsafe_index_put"):
            accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            if accumulate:
                self.found.append(f"{name}(accumulate)")
        elif name in ("scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_"):
            dim, index = args[1], args[2]
            keys = index.movedim(dim, -1).reshape(-1, index.shape[dim])
            if any(len(set(r.tolist())) < len(r) for r in keys):
                self.found.append(f"{name}(colliding)")
        elif name == "convolution_backward" and args[9] == 1:
            self.found.append("convolution_backward(one group)")
        return func(*args, **kwargs)


def test_one_train_step_sums_no_gradient_with_atomics():
    seist_tpu_torch.load_all()
    torch.manual_seed(0)
    model = tapi.create_model("seist_s_dpk", in_samples=256)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 256, 3)).astype(np.float32))
    y = torch.from_numpy(rng.random((2, 256, 3)).astype(np.float32))
    state = TrainState(model, toptim.build_optimizer("adam", model.parameters()),
                       tsched.constant(1e-3))
    step = make_train_step(tts.make_loss("seist_s_dpk"), guard=True)
    with _AtomicSums() as rec:
        step(state, x, y, step_random_source(0, 0, 0, "cpu"))
    assert rec.found == [], sorted(set(rec.found))
