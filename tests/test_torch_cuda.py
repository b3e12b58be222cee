"""The attention kernels on the card (marker ``cuda``; skips without one).

Imports no JAX: the machine with the card has none, so run this file
there with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py``. Tolerances against the plain versions: the
forward and its row statistics (lse) 1e-5 absolute in fp32 (summation
order only; 3xTF32 on the tensor cores keeps fp32-level error), 2^-6 in
bf16 (one bf16 rounding of the output); the backward
``1e-5 * max(1, max|plain|)`` per output in fp32 (dK and dV sum over up to
L rows) and ``2^-7 * max(1, max|plain|)`` in bf16 (one bf16 rounding of
the largest output)."""

from __future__ import annotations

import math
import os

import pytest
import torch

from seist_tpu_torch.ops import pooled_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _qkv(dev, n, l, m, h, e, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype)
            for s in ((n, l, h, e), (n, m, h, e), (n, m, h, e))]


# M over several 128-key tiles (200, 512, 1024), E from 1 to 64, L not a
# multiple of 16 or 64.
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n,l,m,h,e", [(2, 64, 8, 1, 8), (3, 130, 65, 3, 16),
                                       (1, 200, 200, 2, 33), (2, 50, 7, 3, 64),
                                       (1, 300, 512, 2, 1), (1, 1000, 1024, 1, 20),
                                       (2, 77, 200, 3, 8)])
def test_kernel_matches_plain(dev, n, l, m, h, e, rate):
    q, k, v = _qkv(dev, n, l, m, h, e)
    scale = 1.0 / math.sqrt(e)
    before = pa.launches
    got = pa.fused_pooled_attention(q, k, v, dropout_rate=rate, dropout_seed=99)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want, want_lse = pa.pooled_attention_plain(q, k, v, scale, rate, 99, return_lse=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got == 0, want == 0)
    # The row statistics the backward reads; writing them changes no output bit.
    o, lse = pa._forward(q, k, v, scale, rate, 99, True)
    assert torch.equal(o, got)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,l,m,h,e", [(2, 128, 16, 3, 8), (1, 130, 200, 2, 20),
                                       (8, 128, 128, 3, 32)])
def test_kernel_bf16_rounds_like_plain(dev, n, l, m, h, e):
    q, k, v = _qkv(dev, n, l, m, h, e, torch.bfloat16)
    got, lse = pa._forward(q, k, v, 1.0 / math.sqrt(e), 0.0, 0, True)
    want, want_lse = pa.pooled_attention_plain(q, k, v, 1.0 / math.sqrt(e), return_lse=True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2.0 ** -6)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 16, 4, 2, 8)
    before = pa.bwd_launches
    pa.fused_pooled_attention(q.clone().requires_grad_(), k, v).sum().backward()
    assert pa.bwd_launches == before + 1  # a gradient launches the backward
    with pytest.raises(ValueError, match="head width"):
        q65, k65, v65 = (t.requires_grad_() for t in _qkv(dev, 1, 16, 4, 1, 65))
        pa.fused_pooled_attention(q65, k65, v65).sum().backward()
    with pytest.raises(TypeError):
        pa.fused_pooled_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        pa.fused_pooled_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head width"):
        pa.fused_pooled_attention(*_qkv(dev, 1, 16, 4, 1, 65))
    with pytest.raises(ValueError, match="CUDA device"):
        pa.fused_pooled_attention(q, k.cpu(), v)


def _bwd_limit(dtype, plain):
    scale = max(1.0, float(plain.float().abs().max()))
    return (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale


def _qkvg_o_lse(dev, n, l, m, h, e, dtype, rate, seed):
    """Inputs of K2 with K1's o and lse (one forward launch)."""
    q, k, v = _qkv(dev, n, l, m, h, e, dtype, seed=l + m)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(e)).to(dev, dtype)
    o, lse = pa._forward(q, k, v, 1.0 / math.sqrt(e), rate, seed, True)
    return q, k, v, g, o, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,l,m,h,e", [(2, 64, 8, 1, 8), (3, 130, 65, 3, 16),
                                       (2, 1000, 125, 3, 8), (1, 200, 200, 2, 33),
                                       (2, 50, 7, 3, 64), (4, 128, 128, 3, 32),
                                       (1, 300, 512, 2, 1), (1, 1000, 1024, 1, 20),
                                       (2, 77, 200, 3, 8)])
def test_backward_kernel_matches_plain(dev, n, l, m, h, e, rate, dtype):
    q, k, v, g, o, lse = _qkvg_o_lse(dev, n, l, m, h, e, dtype, rate, 1234)
    scale = 1.0 / math.sqrt(e)
    before = pa.bwd_launches
    got = pa._backward(q, k, v, g, o, lse, scale, rate, 1234)
    torch.cuda.synchronize()
    assert pa.bwd_launches == before + 1
    want = pa.pooled_attention_bwd_plain(q, k, v, g, o, lse, scale, rate, 1234)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= _bwd_limit(dtype, b)


@pytest.mark.parametrize("n,l,m,h,e", [(64, 128, 128, 3, 32), (2, 1000, 125, 3, 8),
                                       (1, 300, 512, 2, 20)])
def test_backward_kernel_gives_the_same_bits_twice(dev, n, l, m, h, e):
    """No atomics: the key-tile and row-range parts are summed in order."""
    q, k, v, g, o, lse = _qkvg_o_lse(dev, n, l, m, h, e, torch.float32, 0.3, 7)
    scale = 1.0 / math.sqrt(e)
    first = pa._backward(q, k, v, g, o, lse, scale, 0.3, 7)
    second = pa._backward(q, k, v, g, o, lse, scale, 0.3, 7)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_autograd_through_both_kernels_matches_plain_autograd(dev):
    q, k, v = _qkv(dev, 2, 256, 32, 3, 16, seed=5)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).to(dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        pa.pooled_attention_plain(*leaves, 0.25, 0.3, 9), leaves, g)
    fwd, bwd = pa.launches, pa.bwd_launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = pa.fused_pooled_attention(*leaves, 0.25, dropout_rate=0.3, dropout_seed=9)
    got = torch.autograd.grad(out, leaves, g.transpose(1, 2).contiguous().transpose(1, 2))
    assert (pa.launches, pa.bwd_launches) == (fwd + 1, bwd + 1)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= _bwd_limit(torch.float32, b)


# ------------------------------------------- the bf16 kernels (K1 and K2)
# fwd_kernel_bf16 and bwd_kernel_bf16 against the plain versions at the
# bf16 limits above: ragged L and M, M = 1024 (several key tiles: K1's
# double buffer, K2's dQ parts summed by the reduce launch), rows split
# (K2's dK/dV parts: batch 2 at L = 1000 and the main path's b64 at
# L = 1024), E = 20 and E = 1 (scalar staging), E = 64, and seist_l_dpk's
# five shapes.
BF16_SHAPES = [(2, 64, 8, 1, 8), (3, 130, 65, 3, 16), (1, 200, 200, 2, 33),
               (2, 50, 7, 3, 64), (1, 300, 512, 2, 1), (1, 1000, 1024, 1, 20),
               (2, 1000, 125, 3, 8), (2, 77, 200, 3, 8), (64, 1024, 128, 3, 8),
               (64, 512, 128, 3, 8), (64, 256, 128, 3, 16), (64, 128, 128, 3, 32)]


def _misaligned(t):
    """A contiguous copy of ``t`` one element into a larger buffer: not
    16-byte aligned, so the kernels take their scalar staging."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,l,m,h,e", BF16_SHAPES)
def test_bf16_forward_kernel_matches_plain(dev, n, l, m, h, e, rate):
    q, k, v = _qkv(dev, n, l, m, h, e, torch.bfloat16, seed=l + m)
    scale = 1.0 / math.sqrt(e)
    before = pa.counts()
    got, lse = pa._forward(q, k, v, scale, rate, 99, True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and pa.counts()[2] == before[2] + 1
    want, want_lse = pa.pooled_attention_plain(q, k, v, scale, rate, 99, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2.0 ** -6)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    assert torch.equal(pa._forward(q, k, v, scale, rate, 99, False)[0], got)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,l,m,h,e", BF16_SHAPES)
def test_bf16_backward_kernel_matches_plain(dev, n, l, m, h, e, rate):
    q, k, v, g, o, lse = _qkvg_o_lse(dev, n, l, m, h, e, torch.bfloat16, rate, 1234)
    scale = 1.0 / math.sqrt(e)
    before = pa.counts()
    got = pa._backward(q, k, v, g, o, lse, scale, rate, 1234)
    torch.cuda.synchronize()
    assert pa.counts()[3] == before[3] + 1
    want = pa.pooled_attention_bwd_plain(q, k, v, g, o, lse, scale, rate, 1234)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= _bwd_limit(torch.bfloat16, b)
    again = pa._backward(q, k, v, g, o, lse, scale, rate, 1234)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("n,l,m,h,e", [(2, 130, 65, 3, 16), (1, 300, 200, 2, 8)])
def test_bf16_kernels_take_misaligned_pointers(dev, n, l, m, h, e):
    q, k, v, g, o, lse = _qkvg_o_lse(dev, n, l, m, h, e, torch.bfloat16, 0.3, 5)
    scale = 1.0 / math.sqrt(e)
    q1, k1, v1, g1, o1 = (_misaligned(t) for t in (q, k, v, g, o))
    assert q1.data_ptr() % 16 != 0 and q1.is_contiguous()
    got_o, got_lse = pa._forward(q1, k1, v1, scale, 0.3, 5, True)
    want_o, want_lse = pa.pooled_attention_plain(q, k, v, scale, 0.3, 5, return_lse=True)
    torch.testing.assert_close(got_o.float(), want_o.float(), rtol=0, atol=2.0 ** -6)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=1e-5)
    got = pa._backward(q1, k1, v1, g1, o1, lse, scale, 0.3, 5)
    want = pa.pooled_attention_bwd_plain(q, k, v, g, o, lse, scale, 0.3, 5)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= _bwd_limit(torch.bfloat16, b)


def test_bf16_kernels_drop_the_plain_versions_elements(dev):
    """Rate 0.3. The forward with V the identity (M <= E) writes the dropped
    probabilities themselves, so its zeros are the mask; the backward with
    g the identity (L <= E) writes dV = Pd^T, whose zeros are the mask too."""
    n, l, m, h, e = 2, 32, 32, 3, 32
    q, k, _ = _qkv(dev, n, l, m, h, e, torch.bfloat16, seed=8)
    eye = torch.eye(32, device=dev, dtype=torch.bfloat16).reshape(1, 32, 1, 32)
    eye = eye.expand(n, 32, h, 32).contiguous()
    scale = 1.0 / math.sqrt(e)
    o, lse = pa._forward(q, k, eye, scale, 0.3, 77, True)
    want = pa.pooled_attention_plain(q, k, eye, scale, 0.3, 77)
    assert torch.equal(o == 0, want == 0)
    frac = float((want == 0).float().mean())
    assert 0.2 < frac < 0.4
    _, _, dv = pa._backward(q, k, eye, eye, o, lse, scale, 0.3, 77)
    _, _, want_dv = pa.pooled_attention_bwd_plain(q, k, eye, eye, o, lse, scale, 0.3, 77)
    assert torch.equal(dv == 0, want_dv == 0)
    assert torch.equal(dv.permute(0, 2, 3, 1) == 0, want.permute(0, 2, 1, 3) == 0)


def test_a_captured_kernel_reads_the_seed_written_before_each_replay(dev):
    """K1 and K2 read the dropout seed from device memory: one captured
    forward and backward, replayed with another seed written into the same
    tensor, gives that seed's masks (the plain versions')."""
    q, k, v = _qkv(dev, 2, 130, 65, 3, 16, seed=4)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(dev)
    seed = torch.zeros((), dtype=torch.int32, device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm-up: builds and loads both kernels
        out = pa.fused_pooled_attention(*leaves, 0.25, dropout_rate=0.3, dropout_seed=seed)
        torch.autograd.grad(out, leaves, g)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.fused_pooled_attention(*leaves, 0.25, dropout_rate=0.3, dropout_seed=seed)
        grads = torch.autograd.grad(out, leaves, g)
    for s in (7, 123456):
        seed.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        want_o = pa.pooled_attention_plain(*ref, 0.25, 0.3, s)
        want = torch.autograd.grad(want_o, ref, g)
        assert torch.equal(out == 0, want_o == 0)
        torch.testing.assert_close(out, want_o, rtol=0, atol=1e-5)
        for a, b in zip(grads, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_the_captured_train_step_matches_the_eager_one(dev, dtype):
    """Three captured steps of a small SeisT (drop rates 0.3) against three
    eager ones from the same weights, batches and (seed, epoch, step):
    losses within 1e-4 relative (cuDNN promises no bits), the count
    advanced; K1 and K2 counted at every replay; then a NaN batch through
    the graph changes no parameter."""
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.models import api
    from seist_tpu_torch.train.graph import capture_train_step
    from seist_tpu_torch.train.optim import build_optimizer
    from seist_tpu_torch.train.schedule import constant
    from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seist_model = api.create_model("seist_s_dpk", in_samples=1024, seed=0)
    init = {k: v.clone() for k, v in seist_model.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(8, 1024, 3, generator=g).to(dev) for _ in range(3)]
    ys = [torch.rand(8, 1024, 3, generator=g).to(dev) for _ in range(3)]
    losses, launches = {}, {}
    for mode in ("eager", "captured"):
        model = api.create_model("seist_s_dpk", in_samples=1024)
        model.load_state_dict(init)
        state = TrainState(model.to(dev), build_optimizer("adam", model.parameters()),
                           constant(1e-4))
        step = make_train_step(taskspec.make_loss("seist_s_dpk"), compute_dtype=dtype)
        if mode == "captured":
            step = capture_train_step(step)
        before = pa.counts()
        losses[mode] = [float(step(state, xs[t], ys[t], step_random_source(0, 0, t, dev))[0])
                        for t in range(3)]
        launches[mode] = tuple(b - a for a, b in zip(before, pa.counts()))
        assert state.step == 3
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["captured"], losses["eager"]))
    assert rel <= 1e-4, losses
    assert launches["captured"] == launches["eager"] and launches["eager"][1] > 0
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, _, diag = step(state, xs[0] * float("nan"), ys[0], step_random_source(0, 0, 3, dev))
    assert not bool(diag["applied"]) and state.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k


def test_a_captured_steps_copied_outputs_match_the_eager_steps(dev):
    """The outputs a captured step copies on a log-step call (the train
    worker's task metrics) against the eager step's, within the loss
    limit above; a later replay leaves the copy as it was."""
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.models import api
    from seist_tpu_torch.train.graph import capture_train_step
    from seist_tpu_torch.train.optim import build_optimizer
    from seist_tpu_torch.train.schedule import constant
    from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init = api.create_model("seist_s_dpk", in_samples=1024, seed=0).state_dict()
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn(8, 1024, 3, generator=g).to(dev) for _ in range(3)]
    ys = [torch.rand(8, 1024, 3, generator=g).to(dev) for _ in range(3)]
    outs = {}
    for mode in ("eager", "captured"):
        model = api.create_model("seist_s_dpk", in_samples=1024)
        model.load_state_dict(init)
        state = TrainState(model.to(dev), build_optimizer("adam", model.parameters()),
                           constant(1e-4))
        step = make_train_step(taskspec.make_loss("seist_s_dpk"))
        if mode == "captured":
            step = capture_train_step(step)
        kept = []
        for t in range(3):
            kw = {"keep_outputs": t == 1} if mode == "captured" else {}
            _, out, _ = step(state, xs[t], ys[t], step_random_source(0, 0, t, dev), **kw)
            if mode == "captured":
                assert (out is None) == (t != 1)
            if t == 1:
                kept = out.clone() if mode == "eager" else out
                snapshot = kept.clone()
        torch.cuda.synchronize()
        assert torch.equal(kept, snapshot)  # step 2's replay did not overwrite the copy
        outs[mode] = kept
    err = float((outs["captured"] - outs["eager"]).abs().max())
    assert err <= 1e-4 * max(1.0, float(outs["eager"].abs().max())), err


def test_no_profiler_capture_starts_during_a_graph_capture(dev, tmp_path):
    from seist_tpu_torch.utils import profiling

    x = torch.ones(1024, device=dev)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)  # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
            profiling.trace_start(str(tmp_path / "p"))
        x.add_(1.0)
    assert not profiling.active()
    profiling.trace_start(str(tmp_path / "p"))  # after the capture: a replay is traced
    graph.replay()
    path = profiling.trace_stop()
    assert path and os.path.getsize(path) > 0


# ------------------------------------------------- the baseline families
#: Each baseline family at its published widths, the window cut to keep the
#: file quick (DiTingMotion's own window is 128), and the loss of its task
#: row; DistPTNetwork has none in the JAX package, so its case sums the MSE
#: of both heads against zero targets.
BASELINES = {"phasenet": 1024, "eqtransformer": 1024, "magnet": 1024,
             "baz_network": 1024, "ditingmotion": 128, "distpt_network": 1024}


def _baseline_batch(name, window, n, seed):
    from seist_tpu_torch import taskspec

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, window, 2 if name == "ditingmotion" else 3, generator=g)
    if name in ("phasenet", "eqtransformer"):
        y = torch.rand(n, window, 3, generator=g)
    elif name == "magnet":
        y = 4.0 * torch.rand(n, 1, generator=g)
    elif name == "baz_network":
        y = 360.0 * torch.rand(n, 1, generator=g)
    elif name == "ditingmotion":
        y = tuple(torch.eye(2)[torch.randint(0, 2, (n,), generator=g)].long() for _ in "cp")
    else:
        y = (torch.zeros(n, 2), torch.zeros(n, 2))
    loss = (taskspec.make_loss(name) if name != "distpt_network" else
            (lambda o, t: sum(((a - b) ** 2).mean() for a, b in zip(o, t))))
    return x, y, loss


def _to(tree, dev):
    return type(tree)(_to(t, dev) for t in tree) if isinstance(tree, tuple) else tree.to(dev)


@pytest.mark.parametrize("name,dtype", [(n, "fp32") for n in sorted(BASELINES)]
                         + [("eqtransformer", "bf16"), ("magnet", "bf16")])
def test_a_baseline_captured_step_matches_the_eager_one(dev, name, dtype):
    """Three captured steps of each baseline family (its drop rates) against
    three eager ones from the same weights, batches and (seed, epoch, step):
    losses within 1e-4 relative (cuDNN promises no bits), no attention
    kernel launched, the LSTM weights still views of cuDNN's flat buffer.
    The two families with recurrences also in bf16."""
    from seist_tpu_torch.models import api
    from seist_tpu_torch.models.common import LSTM
    from seist_tpu_torch.train.graph import capture_train_step
    from seist_tpu_torch.train.optim import build_optimizer
    from seist_tpu_torch.train.schedule import constant
    from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    window = BASELINES[name]
    batches = [_baseline_batch(name, window, 8, seed) for seed in range(3)]
    c = batches[0][0].shape[-1]
    init = api.create_model(name, in_channels=c, in_samples=window, seed=0).state_dict()
    losses = {}
    for mode in ("eager", "captured"):
        model = api.create_model(name, in_channels=c, in_samples=window)
        model.load_state_dict(init)
        state = TrainState(model.to(dev), build_optimizer("adam", model.parameters()),
                           constant(1e-4))
        step = make_train_step(batches[0][2], compute_dtype=dtype)
        if mode == "captured":
            step = capture_train_step(step)
        before = pa.counts()
        losses[mode] = [float(step(state, _to(x, dev), _to(y, dev),
                                   step_random_source(0, 0, t, dev))[0])
                        for t, (x, y, _) in enumerate(batches)]
        assert pa.counts() == before and state.step == 3
        for m in model.modules():
            if isinstance(m, LSTM):
                ptrs = {w.untyped_storage().data_ptr() for w in m._flat_weights}
                assert len(ptrs) == 1, "LSTM weights left cuDNN's flat buffer"
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["captured"], losses["eager"]))
    assert rel <= 1e-4, losses


@pytest.mark.parametrize("bidirectional", [False, True])
def test_the_lstm_runs_in_bf16_on_the_card(dev, bidirectional):
    """cuDNN's LSTM in bf16 (outputs, final h and the gradients bf16)
    against the fp32 one from the same weights, within 0.05."""
    from seist_tpu_torch.models.common import LSTM

    lstm = LSTM(32, 100, bidirectional=bidirectional)
    lstm.flax_init(torch.Generator().manual_seed(0))
    lstm.to(dev)
    x = torch.randn(8, 512, 32, generator=torch.Generator().manual_seed(1)).to(dev)
    out32, h32 = lstm(x)
    params = {n: p.to(torch.bfloat16) for n, p in lstm.named_parameters()}
    out16, h16 = torch.func.functional_call(lstm, params, (x.to(torch.bfloat16),))
    assert out16.dtype == h16.dtype == torch.bfloat16
    torch.testing.assert_close(out16.float(), out32, rtol=0, atol=0.05)
    torch.testing.assert_close(h16.float(), h32, rtol=0, atol=0.05)
    grads = torch.autograd.grad(out16.float().sum(), list(params.values()))
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in grads)


# ------------------------------------------- device augmentation (K3)
def _aug_setup(window=512, raw_len=1200, n_events=16):
    """A small synthetic train split with every augmentation rate > 0, its
    RawStore and the row processor of seist_s_dpk."""
    import seist_tpu_torch
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.data import device_aug as da
    from seist_tpu_torch.data import pipeline

    seist_tpu_torch.load_all()
    rates = dict(add_event_rate=0.5, max_event_num=2, shift_event_rate=0.5, add_noise_rate=0.5,
                 add_gap_rate=0.5, drop_channel_rate=0.5, scale_amplitude_rate=0.5,
                 pre_emphasis_rate=0.5, generate_noise_rate=0.2)
    sds = pipeline.from_task_spec(
        taskspec.get_task_spec("seist_s_dpk"), "synthetic", "train", seed=0,
        in_samples=window, augmentation=True, data_split=False,
        dataset_kwargs={"num_events": n_events, "trace_samples": raw_len}, **rates)
    store = pipeline.RawStore.build(sds)
    cfg = da.AugConfig.from_preprocessor(sds.preprocessor, seed=0, raw_len=store.raw_len,
                                         phase_slots=store.phase_slots)
    return sds, store, cfg


_K3_SLOTS = [(1, 0), (3, 0), (3, 1), (11, 0), (11, 1), (17, 2), (23, 0)]


@pytest.mark.parametrize("b,field_len,tags,n_slots", [
    (64, 36000, [2, 18], 7), (3, 7, [2, 18], 7), (5, 1, [2, 18], 7),
    (4, 36001, [2, 18], 7),   # ragged tiles, rows misaligned from row 1: scalar stores
    (3, 36000, [18], 7),      # one field
    (6, 12000, [2, 18], 0),   # no slots
    (5, 4099, [2, 18], 128),  # every slot of the table, a ragged tail
])
def test_k3_matches_plain(dev, b, field_len, tags, n_slots):
    """Uniforms bit for bit, normal fields within 1e-6 (log1p's rounding),
    one launch counted; epoch and indices read on the device."""
    from seist_tpu_torch.ops import threefry as tf

    idx = torch.arange(b, dtype=torch.int32) * 977 + 2**31 - 1 - 977 * b
    epoch = torch.tensor(7, dtype=torch.int32)
    slots = _K3_SLOTS[:n_slots] if n_slots <= len(_K3_SLOTS) else [
        (t * 7 + 1, p) for t in range(32) for p in range(4)][:n_slots]
    before = tf.launches
    u, f = tf.aug_draws(5, epoch.to(dev), idx.to(dev), slots, tags, field_len)
    torch.cuda.synchronize()
    assert tf.launches == before + 1
    want_u, want_f = tf.aug_draws_plain(5, epoch.to(dev), idx.to(dev), slots, tags, field_len)
    assert torch.equal(u, want_u)
    torch.testing.assert_close(f, want_f, rtol=0, atol=1e-6)
    cpu_u, cpu_f = tf.aug_draws_plain(5, epoch, idx, slots, tags, field_len)
    assert torch.equal(u.cpu(), cpu_u)
    torch.testing.assert_close(f.cpu(), cpu_f, rtol=0, atol=1e-6)


def test_k3_refuses_what_it_does_not_take(dev):
    from seist_tpu_torch.ops import threefry as tf

    epoch = torch.zeros((), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        tf.aug_draws(0, epoch, torch.zeros(4, dtype=torch.int64, device=dev), [(1, 0)], [], 0)
    with pytest.raises(ValueError, match="slots"):
        tf.aug_draws(0, epoch, torch.zeros(4, dtype=torch.int32, device=dev),
                     [(1, 0)] * (tf.MAX_SLOTS + 1), [], 0)


def test_the_processed_batch_on_the_card_matches_the_cpu(dev):
    """The row processor on the card (K3 and the ops) against the port on
    the CPU, same rows: outputs within 1e-5; then its captured graph,
    replayed for new indices, against the eager one."""
    from seist_tpu_torch.data import device_aug as da
    from seist_tpu_torch.data import pipeline
    from seist_tpu_torch.ops import threefry as tf
    from seist_tpu_torch.train.graph import capture_processor

    sds, store, cfg = _aug_setup()
    proc = da.make_row_processor(cfg, sds.input_names, sds.label_names)
    captured = capture_processor(proc, dev)
    epoch = torch.tensor(3, dtype=torch.int32)
    for start in (0, 8, 16):
        idx = torch.arange(start, start + 8, dtype=torch.int32)
        rows, idx_t, aug = pipeline.raw_batch_tensors(
            (store.row_batch(idx.numpy() % store.n_raw), idx.numpy(), idx.numpy() >= store.n_raw))
        want = proc(rows, idx_t, aug, epoch)
        on_dev = pipeline._tree_map(lambda t: t.to(dev), rows)
        got = proc(on_dev, idx_t.to(dev), aug.to(dev), epoch.to(dev))
        before = tf.launches
        replayed = captured(rows, idx_t, aug, epoch)
        assert tf.launches == before + 1
        for w, g, r in zip(want, got, replayed):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5)
            torch.testing.assert_close(r, g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["step", "cached"])
def test_the_captured_device_aug_step_matches_the_eager_one(dev, mode):
    """Three captured device-aug steps (processor graph, then step graph)
    against three eager ones from the same weights and indices: losses
    within 1e-4 relative; K3 counted once per step at every replay."""
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.data import device_aug as da
    from seist_tpu_torch.data import pipeline
    from seist_tpu_torch.models import api
    from seist_tpu_torch.ops import threefry as tf
    from seist_tpu_torch.train.graph import capture_processor, capture_train_step
    from seist_tpu_torch.train.optim import build_optimizer
    from seist_tpu_torch.train.schedule import constant
    from seist_tpu_torch.train.step import (TrainState, make_cached_train_call,
                                            make_device_aug_train_step, make_train_step,
                                            step_random_source)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sds, store, cfg = _aug_setup()
    loss_fn = taskspec.make_loss("seist_s_dpk")
    init = api.create_model("seist_s_dpk", in_samples=cfg.window, seed=0).state_dict()
    cache = pipeline.DeviceEpochCache(store, dev)
    epoch = torch.tensor(1, dtype=torch.int32)
    orders = [torch.arange(8 * t, 8 * t + 8, dtype=torch.int32) for t in range(3)]
    losses, k3 = {}, {}
    for run in ("eager", "captured"):
        model = api.create_model("seist_s_dpk", in_samples=cfg.window)
        model.load_state_dict(init)
        state = TrainState(model.to(dev), build_optimizer("adam", model.parameters()),
                           constant(1e-4))
        step = make_train_step(loss_fn)
        if mode == "step":
            proc = da.make_row_processor(cfg, sds.input_names, sds.label_names)
            if run == "captured":
                proc, step = capture_processor(proc, dev), capture_train_step(step)
            call = make_device_aug_train_step(loss_fn, proc, step=step)
        else:
            proc = da.make_cache_processor(cfg, sds.input_names, sds.label_names,
                                           store.n_raw, store.augmentation)
            if run == "captured":
                proc, step = capture_processor(proc, dev, resident=1), capture_train_step(step)
            call = make_cached_train_call(loss_fn, proc, step=step)
        before = tf.launches
        out = []
        for t, idx in enumerate(orders):
            rng = step_random_source(0, 1, t, dev)
            if mode == "step":
                rows, idx_t, aug = pipeline.raw_batch_tensors(
                    (store.row_batch(idx.numpy() % store.n_raw), idx.numpy(),
                     idx.numpy() >= store.n_raw), pin=True)
                if run == "eager":
                    rows = pipeline._tree_map(lambda x: x.to(dev), rows)
                    idx_t, aug = idx_t.to(dev), aug.to(dev)
                out.append(float(call(state, rows, idx_t, aug,
                                      epoch if run == "captured" else epoch.to(dev), rng)[0]))
            else:
                idx_k = idx[None] if run == "captured" else idx[None].to(dev)
                out.append(float(call(state, cache.arrays, idx_k,
                                      epoch if run == "captured" else epoch.to(dev), rng)[0]))
        losses[run], k3[run] = out, tf.launches - before
        assert state.step == 3
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["captured"], losses["eager"]))
    assert rel <= 1e-4, losses
    assert k3 == {"eager": 3, "captured": 3}


# ------------------------------------------------------- serving programs
SERVE_WINDOW = 1024


@pytest.fixture(scope="module")
def serving_pool():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from seist_tpu_torch.serve.pool import ModelPool

    pool = ModelPool([("seist_s_dpk", "")], groups=[("seist_s", [("dpk", ""), ("emg", "")])],
                     window=SERVE_WINDOW, variants=("fp32", "bf16", "int8"), device="cuda")
    pool.warmup((1, 2, 4))
    return pool


def _program_input(entry, key, b, dev):
    x = torch.randn(b, SERVE_WINDOW, 3, generator=torch.Generator().manual_seed(b)).to(dev)
    if "/head:" not in key:
        return x
    variant = key.rsplit("/", 1)[1]
    return entry.programs[(variant, "trunk", b)](x).clone()


@pytest.mark.parametrize("variant", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b", [1, 2, 4])
def test_a_replayed_program_matches_its_eager_run(serving_pool, variant, b):
    """Every program of the (variant, bucket) against the same function run
    eagerly on the card: 1e-4 of max(1, max|eager|)."""
    dev = torch.device("cuda", 0)
    for entry in serving_pool.entries().values():
        for prog in entry.all_programs():
            if not prog.key.endswith(f"/b{b}/{variant}"):
                continue
            x = _program_input(entry, prog.key, b, dev)
            with torch.inference_mode():
                got = prog(x)
                got = got.clone() if torch.is_tensor(got) else got
                want = prog.fn(x)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                err = float((g.float() - w.float()).abs().max())
                assert err <= 1e-4 * max(1.0, float(w.float().abs().max())), (prog.key, err)


def test_each_replay_adds_its_captured_attention_launches(serving_pool):
    """A replay launches K1 without the wrapper: the program adds the
    launches its capture recorded, fp32 and bf16, and the capture itself
    counted none."""
    dev = torch.device("cuda", 0)
    model = serving_pool.get("seist_s_dpk").model
    n_shapes = len(model.attention_shapes(SERVE_WINDOW))
    for entry in serving_pool.entries().values():
        for prog in entry.all_programs():
            variant, kind = prog.key.rsplit("/", 1)[1], prog.key.split("/")[1]
            want = (0, 0) if kind.startswith("head:") else (
                n_shapes, n_shapes if variant == "bf16" else 0)
            assert prog.launches == want, prog.key
            b = int(prog.key.rsplit("/", 2)[1][1:])
            x = _program_input(entry, prog.key, b, dev)
            before = pa.launches, pa.bf16_launches
            prog(x)
            assert (pa.launches - before[0], pa.bf16_launches - before[1]) == want, prog.key
    # a fallback (no program at batch 3) runs eagerly through the wrapper
    entry = serving_pool.get("seist_s_dpk")
    before = pa.launches, entry.fallback_runs
    entry.run(torch.randn(3, SERVE_WINDOW, 3))
    assert (pa.launches - before[0], entry.fallback_runs - before[1]) == (n_shapes, 1)


def test_graphs_of_a_variant_share_one_pool_and_gates_pass(serving_pool):
    entry = serving_pool.get("seist_s")
    assert entry.variant_tasks["bf16"] == ("dpk", "emg")
    assert entry.variant_tasks["int8"] == ("dpk", "emg")
    single = serving_pool.get("seist_s_dpk")
    assert single.variant_ok == {"bf16": True, "int8": True}
    assert all(p.graph is not None for e in serving_pool.entries().values()
               for p in e.all_programs())
