"""The port's bf16 precision policy against the JAX package's
``compute_dtype="bf16"`` steps (``seist_tpu/train/step.py``), on the CPU.

``seist_s_dpk`` at window 256, batch 2, every drop rate 0 so both sides run
the same function, the same seeded weights (tests/_torch_parity.py). The
limits are the JAX package's own bf16 limits (tests/test_train.py): loss
rtol 0.05 and atol 5e-3, and in eval mode dpk outputs within 0.05 abs.
Port and JAX round to bf16 in different places (XLA fuses and reorders;
torch rounds after every op), so the gap between them is about the gap
between bf16 and fp32; each test prints it. In train mode, BatchNorm
normalises the last stage over batch statistics of 2 x 4 values, and the
JAX package's own bf16 outputs lie 0.145 from its fp32 ones at these
weights (its tests hold the train step to the loss alone): there the
port's bf16 outputs are held no farther from fp32 than JAX's, and within
twice that of JAX's bf16 outputs.

Coverage: under the policy, at least 90% of the FLOPs of ``aten.mm``,
``bmm``, ``addmm`` and ``convolution`` in one ``seist_l_dpk`` forward run
in bf16, the JAX repo's irlint floor (``bf16_coverage_min >= 0.9``). The
attention's products are K1's on the card, not aten products, and its
plain CPU stand-in computes in fp32 as K1 does; they are left out of the
count, and the test asserts that q, k and v reach the attention in bf16.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import make_eval_step as j_make_eval_step
from seist_tpu.train.step import make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.precision import precision_policy, resolve_dtype
from seist_tpu_torch.train.schedule import constant
from seist_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

from _torch_parity import model_pair

MODEL, WINDOW, BATCH, LR = "seist_s_dpk", 256, 2, 1e-3
NO_DROP = dict(path_drop_rate=0.0, attn_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0,
               other_drop_rate=0.0)
LOSS_RTOL, LOSS_ATOL, OUT_ATOL = 0.05, 5e-3, 0.05


@pytest.fixture(scope="module")
def pair():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jm, variables, _ = model_pair(MODEL, WINDOW, seed=2, **NO_DROP)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((BATCH, WINDOW, 3)).astype(np.float32)
    y = rng.uniform(0.0, 1.0, (BATCH, WINDOW, 3)).astype(np.float32)
    return jm, variables, x, y


def _torch_state(variables) -> TrainState:
    from seist_tpu_torch.models.convert import state_dict_from_flax

    tm = tapi.create_model(MODEL, in_samples=WINDOW, **NO_DROP)
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    return TrainState(tm, build_optimizer("adam", tm.parameters()), constant(LR))


def _jax_state(jm, variables):
    return create_train_state(jm, variables, j_build_optimizer("adam", LR))


def test_bf16_eval_step_matches_jax(pair):
    jm, variables, x, y = pair
    spec, jloss_fn = jts.get_task_spec(MODEL), jts.make_loss(MODEL)
    jstate = _jax_state(jm, variables)
    mask = np.ones(BATCH, np.float32)
    jl16, jo16 = jax.jit(j_make_eval_step(spec, jloss_fn, compute_dtype="bf16"))(
        jstate, x, y, mask)
    state = _torch_state(variables)
    loss_fn = tts.make_loss(MODEL)
    args = (state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    l16, o16 = make_eval_step(loss_fn, compute_dtype="bf16")(*args)
    l32, o32 = make_eval_step(loss_fn)(*args)
    assert o16.dtype == torch.float32 and l16.dtype == torch.float32
    gap_out = float(np.abs(o16.numpy() - np.asarray(jo16)).max())
    print(f"bf16 eval, port vs JAX: loss {float(l16):.6f} vs {float(jl16):.6f}, outputs max "
          f"abs gap {gap_out:.2e}; port bf16 vs port fp32 outputs "
          f"{float((o16 - o32).abs().max()):.2e}")
    np.testing.assert_allclose(float(l16), float(jl16), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert gap_out < OUT_ATOL
    np.testing.assert_allclose(float(l16), float(l32), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert float((o16 - o32).abs().max()) < OUT_ATOL
    assert not torch.equal(o16, o32)  # the bf16 path really ran


def test_bf16_guarded_train_step_matches_jax(pair):
    jm, variables, x, y = pair
    spec, jloss_fn = jts.get_task_spec(MODEL), jts.make_loss(MODEL)
    jstep = jax.jit(j_make_train_step(spec, jloss_fn, compute_dtype="bf16", guard=True))
    new, jloss, jout, jdiag = jstep(_jax_state(jm, variables), x, y, jax.random.PRNGKey(0))
    assert int(jdiag["applied"]) == 1

    state = _torch_state(variables)
    step = make_train_step(tts.make_loss(MODEL), guard=True, compute_dtype="bf16")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    _, out32, _ = make_train_step(tts.make_loss(MODEL), guard=True)(
        _torch_state(variables), xt, yt, RandomSource())
    loss, out, diag = step(state, xt, yt, RandomSource())
    assert diag["applied"] and state.step == 1
    assert out.dtype == torch.float32 and loss.dtype == torch.float32
    jout = np.asarray(jout)
    gap = float(np.abs(out.numpy() - jout).max())
    # The port's fp32 train step is the JAX package's within 4e-6
    # (tests/test_torch_train.py), so |JAX bf16 - port fp32| is JAX's own
    # bf16 error in train mode.
    jax_err = float(np.abs(jout - out32.numpy()).max())
    port_err = float((out - out32).abs().max())
    print(f"bf16 guarded train step, port vs JAX: loss {float(loss):.6f} vs "
          f"{float(jloss):.6f}, outputs max abs gap {gap:.2e}; bf16 vs fp32 outputs: "
          f"JAX {jax_err:.2e}, port {port_err:.2e}")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert port_err <= jax_err and gap <= 2 * jax_err
    # fp32 master state: parameters, Adam's moments, BatchNorm statistics.
    model = state.model
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    for st in state.optimizer.state_dict()["state"].values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert all(leaf.dtype == np.float32 for leaf in jax.tree_util.tree_leaves(new.batch_stats))
    # The running statistics moved like the JAX package's (bf16 activations).
    from seist_tpu_torch.models.convert import state_dict_from_flax

    sd = model.state_dict()
    for k, v in state_dict_from_flax({"batch_stats": jax.device_get(new.batch_stats)}).items():
        torch.testing.assert_close(sd[k], v, rtol=0.05, atol=0.05, msg=k)

    # Three more bf16 steps on the batch lower its loss.
    first = float(loss)
    for _ in range(3):
        loss, _, diag = step(state, xt, yt, RandomSource())
        assert diag["applied"]
    assert float(loss) < first and state.step == 4


def test_resolve_dtype():
    assert resolve_dtype(None) is None
    assert resolve_dtype("fp32") is None
    assert resolve_dtype("bf16") is torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype("fp16")


_PRODUCTS = {"mm", "bmm", "addmm", "convolution"}


class _FlopCounter(TorchDispatchMode):
    """FLOPs of the product ops, by dtype, outside ``paused`` stretches."""

    def __init__(self):
        super().__init__()
        self.flops = {}
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _PRODUCTS and not self.paused:
            if name == "convolution":
                x, w = args[0], args[1]
                flops = 2 * out.numel() * w.shape[1] * int(np.prod(w.shape[2:]))
            else:
                a, b = args[-2], args[-1]
                flops = 2 * a.numel() * b.shape[-1]
            dt = args[1].dtype if name == "convolution" else args[-1].dtype
            self.flops[dt] = self.flops.get(dt, 0) + flops
        return out


def test_bf16_covers_nine_tenths_of_the_products(monkeypatch):
    seist_tpu_torch.load_all()
    model = tapi.create_model("seist_l_dpk", in_samples=1024)
    counter = _FlopCounter()
    seen = []
    real = pa.pooled_attention_plain

    def attention(q, k, v, *a, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        counter.paused = True
        try:
            return real(q, k, v, *a, **kw)
        finally:
            counter.paused = False

    monkeypatch.setattr(pa, "pooled_attention_plain", attention)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1024, 3)).astype(np.float32))
    params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
    with torch.no_grad(), counter, precision_policy(torch.bfloat16):
        out = torch.func.functional_call(model, params, (x.to(torch.bfloat16),))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert len(seen) == 5 and all(d == (torch.bfloat16,) * 3 for d in seen)
    total = sum(counter.flops.values())
    coverage = counter.flops.get(torch.bfloat16, 0) / total
    print(f"bf16 coverage of the product FLOPs: {coverage:.4f} of {total:.3e}")
    assert coverage >= 0.9, counter.flops
