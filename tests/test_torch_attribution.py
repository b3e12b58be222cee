"""The port's step attribution (``seist_tpu_torch/obs/attribution.py``)
against the JAX package's walk (``seist_tpu/obs/attribution.py``), on the
CPU.

* Eval forwards of every family (``model_pair``, window 512, batch 2; the
  same seeded variables on both sides): the matmul class's FLOPs equal the
  JAX walk's integer for integer, LSTMs and transposed convolutions
  included.
* One train step (drop rates 0, Adam, the guard; the setup of
  tests/test_torch_step_variants.py) of seist_s_dpk, phasenet and magnet:
  the matmul class equals JAX's plus exactly ``2·N·H·L·M·E`` per attention
  call (the scores' recompute that K2 and the plain backward make and
  JAX's einsum autodiff does not), and, for SeisT, one named difference:
  ``seist_tpu/models/seist.py:706`` pads ``out_conv`` inside the
  convolution, the port before it, so the input's gradient spans
  ``L + 6`` positions in the port: ``2·N·6·weight`` more, under 0.1% of the
  class. Every class is present on both sides.
* The kernels' charges: K1's and K2's formulas equal the plain versions'
  recorded ``bmm`` FLOPs, forward and backward, and through the autograd
  function with the wrappers charging as on the card; the cuDNN LSTM rule
  equals what the CPU's LSTM records.
* A served program's FLOPs (``serve/aot.py``) equal the JAX walk's matmul
  class for PhaseNet and MagNet.
* ``tests/test_obs.py``'s attribution cases on the port's functions.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.models import api as japi
from seist_tpu.obs import attribution as jattr
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.common import LSTM
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.obs import attribution as attr
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.serve.pool import load_model_entry
from seist_tpu_torch.train import optim as toptim
from seist_tpu_torch.train import schedule as tsched
from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source

from _torch_parity import model_pair, random_flax_variables

WINDOW, BATCH = 512, 2
FORWARD = {
    "seist_s_dpk": {},
    "seist_l_dpk": {"layer_blocks": (2, 1, 2, 1)},
    "phasenet": {},
    "eqtransformer": {},
    "magnet": {},
    "ditingmotion": {},
    "baz_network": {},
    "distpt_network": {},
}
TRAIN = ("seist_s_dpk", "phasenet", "magnet")
SEIST_DROPS = dict(attn_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0, other_drop_rate=0.0,
                   path_drop_rate=0.0)
#: seist_tpu/models/seist.py:706 pads out_conv by (3, 3) inside the conv.
OUT_CONV_PAD = 6


def _matmul(ops) -> int:
    return sum(r["flops"] for r in ops if r["class"] == "matmul")


def _classes(ops) -> set:
    return {r["class"] for r in ops if r["count"]}


def _attention_recompute(model: torch.nn.Module) -> int:
    shapes = getattr(model, "attention_shapes", None)
    return sum(2 * BATCH * l * m * h * e for l, m, h, e in shapes(WINDOW)) if shapes else 0


def _forward(name: str):
    """(JAX's records, the port's records) of one eval forward."""
    jm, variables, tm = model_pair(name, WINDOW, **FORWARD[name])
    x = np.random.default_rng(0).standard_normal((BATCH, WINDOW, 3)).astype(np.float32)
    jops = jattr.jaxpr_op_costs(
        jax.make_jaxpr(lambda v, a: jm.apply(v, a, train=False))(variables, x))

    def fn(a):
        with torch.no_grad():
            return tm(a)

    return jops, attr.op_costs(fn, (torch.from_numpy(x),))


@pytest.fixture(scope="module")
def forward():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    return functools.lru_cache(maxsize=None)(_forward)


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_eval_forward_matmul_flops_equal_the_jax_walk(forward, name):
    jops, tops = forward(name)
    assert _matmul(tops) == _matmul(jops) > 0


@pytest.fixture(scope="module", params=TRAIN)
def train_pair(request):
    """(JAX's records, the port's records, the port's model) of one train
    step from the same variables, batch and targets."""
    name = request.param
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    drops = SEIST_DROPS if name.startswith("seist") else {"drop_rate": 0.0}
    jm = japi.create_model(name, in_channels=3, in_samples=WINDOW, **drops)
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW), seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, WINDOW, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda v, a: jm.apply(v, a, train=False), variables, x)
    y = jax.tree.map(lambda s: rng.uniform(0.0, 1.0, s.shape).astype(np.float32), shapes)
    jstep = j_make_train_step(jts.get_task_spec(name), jts.make_loss(name), guard=True)
    jstate = create_train_state(jm, variables, j_build_optimizer("adam", 1e-3))
    jops = jattr.jaxpr_op_costs(jax.make_jaxpr(jstep)(jstate, x, y, jax.random.PRNGKey(0)))

    tm = tapi.create_model(name, in_channels=3, in_samples=WINDOW, **drops)
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    state = TrainState(tm, toptim.build_optimizer("adam", tm.parameters()),
                       tsched.constant(1e-3))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ty = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), y)
    tops = attr.op_costs(make_train_step(tts.make_loss(name), guard=True),
                         (state, torch.from_numpy(x), ty, step_random_source(0, 0, 0, "cpu")))
    for k, v in tm.state_dict().items():  # the recording stepped a copy
        assert torch.equal(v, before[k]), k
    return name, jops, tops, tm


def _out_conv_difference(name: str, model: torch.nn.Module) -> int:
    """The one op the JAX walk charges in a form the ATen op's shapes
    cannot reproduce: SeisT's out_conv input gradient over L + 6 positions
    (the port's explicit pad) instead of L (JAX's padding inside the conv):
    ``2·N·6·Cout·Cin·K``."""
    if not name.startswith("seist"):
        return 0
    (conv,) = [m for n, m in model.named_modules() if n.endswith("out_conv")]
    return 2 * BATCH * OUT_CONV_PAD * conv.weight.numel()


def test_train_step_matmul_flops_equal_the_jax_walk_plus_the_recompute(train_pair):
    name, jops, tops, tm = train_pair
    jax_mm, port_mm = _matmul(jops), _matmul(tops)
    recompute = _attention_recompute(tm)
    exception = _out_conv_difference(name, tm)
    assert (recompute > 0) == name.startswith("seist")
    assert port_mm == jax_mm + recompute + exception, (port_mm - jax_mm, recompute, exception)
    assert exception < 1e-3 * jax_mm
    assert _classes(tops) == _classes(jops) == {"matmul", "reduce", "elementwise",
                                                "data_movement"}


# ----------------------------------------------------------- kernel charges
def _qkv(rate_seed: int = 0):
    g = torch.Generator().manual_seed(rate_seed)
    n, l, m, h, e = 2, 16, 4, 3, 8
    q = torch.randn(n, l, h, e, generator=g)
    k = torch.randn(n, m, h, e, generator=g)
    v = torch.randn(n, m, h, e, generator=g)
    return q, k, v, torch.randn(n, l, h, e, generator=g)


def _bmm(ops) -> int:
    return sum(r["flops"] for r in ops if r["op"] == "bmm")


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_kernel_formulas_equal_the_plain_versions_bmm_flops(rate):
    q, k, v, g = _qkv()
    (fwd, fwd_bytes), (bwd, bwd_bytes) = pa.kernel_costs(q, k)
    plain = attr.op_costs(lambda *a: pa.pooled_attention_plain(*a, 0.5, rate, 3), (q, k, v))
    assert _bmm(plain) == _matmul(plain) == fwd
    o, lse = pa.pooled_attention_plain(q, k, v, 0.5, rate, 3, return_lse=True)
    back = attr.op_costs(lambda *a: pa.pooled_attention_bwd_plain(*a, 0.5, rate, 3),
                         (q, k, v, g, o, lse))
    assert _bmm(back) == _matmul(back) == bwd == 10 * 2 * 16 * 4 * 3 * 8
    n, l, h, e = q.shape
    assert fwd_bytes == 4 * n * h * e * (2 * l + 2 * k.shape[1])
    assert bwd_bytes == 4 * n * h * e * (4 * l + 4 * k.shape[1]) + 4 * n * h * l


def test_wrappers_charging_as_on_the_card_record_the_plain_count(monkeypatch):
    """The autograd function's forward and backward with the wrappers
    emulating the card: the plain version runs out of the recording's
    sight and the launch is charged, also from the backward."""
    q, k, v, g = _qkv(1)

    def grads(q, k, v, g):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = pa.fused_pooled_attention(q, k, v)
        return torch.autograd.grad(out, (q, k, v), g)

    plain = attr.op_costs(grads, (q, k, v, g))
    forward, backward = pa._forward, pa._backward

    def card_forward(q, k, v, *a, **kw):
        with _disable_current_modes():
            out = forward(q, k, v, *a, **kw)
        pa._charge("pooled_attention_fwd", pa.kernel_costs(q, k)[0], q, k)
        return out

    def card_backward(q, k, *a, **kw):
        with _disable_current_modes():
            out = backward(q, k, *a, **kw)
        pa._charge("pooled_attention_bwd", pa.kernel_costs(q, k)[1], q, k)
        return out

    monkeypatch.setattr(pa, "_forward", card_forward)
    monkeypatch.setattr(pa, "_backward", card_backward)
    charged = attr.op_costs(grads, (q, k, v, g))
    names = {r["op"]: r for r in charged}
    assert names["pooled_attention_fwd"]["count"] == names["pooled_attention_bwd"]["count"] == 1
    assert "bmm" not in names
    assert _matmul(charged) == _matmul(plain) == _bmm(plain)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_cudnn_lstm_rule_equals_the_cpu_lstm_record(bidirectional):
    """``_cudnn_rnn``'s rule, fed the weights cuDNN gets for the port's
    LSTM, against what the CPU's LSTM op records: forward, and forward and
    backward with every gradient asked for."""
    lstm = LSTM(5, 4, bidirectional=bidirectional)
    x = torch.randn(2, 7, 5)
    fwd = _matmul(attr.op_costs(lambda a: lstm(a), (x,)))

    def train(a):
        a = a.requires_grad_()
        out, h = lstm(a)
        torch.autograd.grad(out.sum() + h.sum(), [a] + list(lstm.parameters()))

    both = _matmul(attr.op_costs(train, (x,)))
    call = {"input": x.transpose(0, 1), "weight": [getattr(lstm, n) for n in
                                                   lstm._flat_weights_names],
            "weight_stride0": 4, "bidirectional": bidirectional}
    assert attr._cudnn_rnn_flops(call, False) == fwd > 0
    assert fwd + attr._cudnn_rnn_flops(dict(call, output_mask=[True, True, True, True]),
                                       True) == both == 3 * fwd


@pytest.mark.parametrize("name", ["phasenet", "magnet"])
def test_served_program_flops_equal_the_jax_walk(forward, name):
    jops, _ = forward(name)
    entry = load_model_entry(name, window=WINDOW, device="cpu")
    entry.build_programs([BATCH], [])
    assert entry.programs["fp32"][BATCH].flops == _matmul(jops)


# ------------------------------------------ tests/test_obs.py's cases
def test_attribution_dot_flops_exact():
    out = attr.attribute_step(torch.mm, (torch.ones(4, 8), torch.ones(8, 16)))
    dot = next(o for o in out["top_ops"] if o["op"] == "mm")
    assert dot["flops"] == 2 * 4 * 16 * 8
    assert dot["class"] == "matmul"
    assert dot["bytes_accessed"] == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    assert dot["example"] == "f32[4,8] f32[8,16] -> f32[4,16]"


def test_attribution_loop_counts_each_call():
    def f(x):
        for _ in range(5):
            x = torch.tanh(x)
        return x

    out = attr.attribute_step(f, (torch.ones(8),))
    tanh = next(o for o in out["top_ops"] if o["op"] == "tanh")
    assert tanh["count"] == 5
    assert tanh["flops"] == 5 * 8


def test_attribution_conv_flops_exact():
    out = attr.attribute_step(torch.nn.functional.conv1d,
                              (torch.ones(2, 3, 32), torch.ones(4, 3, 5)))
    conv = next(o for o in out["top_ops"] if o["op"] == "convolution")
    assert conv["flops"] == 2 * (2 * 28 * 4 * 3 * 5)


def test_attribution_measured_shares():
    def f(a, b):
        return torch.tanh(a @ b).sum()

    out = attr.attribute_step(f, (torch.ones(16, 16), torch.ones(16, 16)),
                              measured_step_ms=10.0, peak_flops=1e12)
    fracs = [o["time_frac"] for o in out["top_ops"]]
    assert out["n_op_kinds"] >= 3
    assert abs(sum(d["time_frac"] for d in out["mfu_decomposition"].values()) - 1.0) < 1e-3
    assert all(o["est_ms"] is not None for o in out["top_ops"])
    assert fracs == sorted(fracs, reverse=True)
    assert "mfu_model" in out and "mfu_matmul_attributed" in out
    assert out["roofline_basis"] == {"peak_flops": 1e12, "hbm_bw": 1e11, "generic": False}


def test_attribution_top_k_limit_and_the_generic_basis():
    def f(a):
        return torch.tanh(torch.exp(a) + torch.log(a) * a - a / 3).sum()

    out = attr.attribute_step(f, (torch.ones(8) + 1,), top_k=2)
    assert len(out["top_ops"]) == 2
    assert out["n_op_kinds"] > 2
    assert out["roofline_basis"]["generic"] is True
    assert "mfu_model" not in out and all(o["est_ms"] is None for o in out["top_ops"])


def test_attribute_step_keys_are_the_jax_packages():
    import jax.numpy as jnp

    a, b = np.ones((4, 8), np.float32), np.ones((8, 16), np.float32)
    kw = dict(peak_flops=1e12, hbm_bw=1e11, measured_step_ms=1.0)
    want = jattr.attribute_step(lambda x, y: jnp.tanh(x @ y), (a, b), **kw)
    got = attr.attribute_step(lambda x, y: torch.tanh(x @ y),
                              (torch.from_numpy(a), torch.from_numpy(b)), **kw)
    assert set(got) == set(want)
    assert set(got["top_ops"][0]) == set(want["top_ops"][0])
    assert set(got["mfu_decomposition"]["matmul"]) == set(want["mfu_decomposition"]["matmul"])
    assert got["mfu_decomposition"]["matmul"]["flops"] == \
        want["mfu_decomposition"]["matmul"]["flops"]


def test_an_unmodelled_layout_falls_back_to_the_element_count():
    rec = attr.OpRecorder()
    with rec:
        torch.mm(torch.ones(2, 3), torch.ones(3, 4))
    assert rec.ops["mm"]["flops"] == 48
    attr.charge("outside", 1, 1, "")  # no recording active: nothing happens
    with rec:
        attr.charge("kernel", 7, 9, "x")
    assert rec.ops["kernel"] == {"op": "kernel", "class": "elementwise", "count": 1,
                                 "flops": 7, "bytes": 9, "example": "x"}
    assert attr.op_flops("convolution", None, (), {}, [torch.ones(3)], [torch.ones(5)]) == 5
