"""The port's serving variants (``seist_tpu_torch/serve/aot.py``) against the
JAX package's (``seist_tpu/serve/aot.py``) on the CPU, with weights drawn
by ``tests/_torch_parity.py`` (std 0.5/sqrt(fan_in), random BatchNorm
statistics) and converted for the port.

* ``quantize_int8``: q and the scales bit for bit after conversion, the
  scale axis taken from ``convert.flax_last_axis`` (SeisT's Dense and
  Conv kernels, PhaseNet's flipped ConvTranspose);
* ``make_variant_apply``: fp32 and int8 outputs within 1e-5 of JAX's, bf16
  within the repo's bf16 limit (0.05);
* ``variant_parity`` / ``parity_kind``: the same decisions and errors on the
  inputs of ``tests/test_multitask.py::test_variant_parity_gate_decisions``.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_pair

from seist_tpu import taskspec as jtaskspec
from seist_tpu.serve import aot as jaot

from seist_tpu_torch import taskspec as ttaskspec
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.serve import aot as taot

WINDOW = 512
FP32_TOL = 1e-5
BF16_TOL = 0.05  # the repo's bf16 output limit (tests/test_train.py)


def _jax_quantized_as_torch(variables):
    """JAX's ``quantize_int8`` of the params, converted leaf by leaf to the
    port's layout: (q as float32, the scale broadcast over the kernel),
    each keyed like the port's state dict."""
    packed = jaot.quantize_int8(jax.device_get(variables["params"]))

    def split(tree, pick):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and "__int8__" in v:
                q = np.asarray(v["__int8__"], np.float32)
                out[k] = q if pick == "q" else np.broadcast_to(
                    np.asarray(v["scale"], np.float32), q.shape).copy()
            elif isinstance(v, dict):
                out[k] = split(v, pick)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    return (state_dict_from_flax({"params": split(packed, "q")}),
            state_dict_from_flax({"params": split(packed, "scale")}))


@pytest.mark.parametrize("name,window", [("seist_s_dpk", WINDOW), ("phasenet", WINDOW)])
def test_quantize_int8_bitwise_like_jax(name, window):
    _, variables, tm = model_pair(name, window, seed=3)
    want_q, want_scale = _jax_quantized_as_torch(variables)
    got = taot.quantize_int8(dict(tm.named_parameters()))
    quantized = {k for k, v in got.items() if isinstance(v, taot.Int8Leaf)}
    assert quantized == {k for k, v in tm.named_parameters() if v.dim() >= 2}
    if name == "phasenet":
        assert any(k.endswith("convt.weight") for k in quantized)
    for key in quantized:
        leaf = got[key]
        assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == torch.float32
        torch.testing.assert_close(leaf.q.float(), want_q[key], rtol=0, atol=0)
        torch.testing.assert_close(leaf.scale_view().expand(leaf.q.shape), want_scale[key],
                                   rtol=0, atol=0)
        # one quantization step at most, per output channel
        w = dict(tm.named_parameters())[key].detach()
        assert float((taot.dequantize(leaf) - w).abs().max()) <= float(leaf.scale.max()) / 2 + 1e-7


@pytest.mark.parametrize("variant,tol", [("fp32", FP32_TOL), ("int8", FP32_TOL),
                                         ("bf16", BF16_TOL)])
def test_make_variant_apply_matches_jax(variant, tol):
    jm, variables, tm = model_pair("seist_s_dpk", WINDOW, seed=4)
    x = np.random.default_rng(1).standard_normal((2, WINDOW, 3)).astype(np.float32)
    want = jax.jit(jaot.make_variant_apply(
        lambda v, a: jm.apply(v, a, train=False), variables, variant))(x)
    fn = taot.make_variant_apply(lambda m, a: m(a), tm, variant)
    with torch.inference_mode():
        got = fn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - np.asarray(want, np.float32)).max())
    assert err <= tol, (variant, err)
    if variant == "int8":  # int8 at rest, the fp32 weights only inside a call
        qmodel = taot.transform_variables(tm, "int8")
        held = qmodel.int8_weights
        assert held and all(getattr(m, a) is None for m, a, _ in held)
        assert all(leaf.q.dtype == torch.int8 for _, _, leaf in held)


def test_bf16_variant_casts_statistics_and_runs_bf16():
    _, _, tm = model_pair("seist_s_dpk", 256, seed=5)
    m16 = taot.transform_variables(tm, "bf16")
    assert all(t.dtype == torch.bfloat16 for t in m16.state_dict().values())
    assert all(t.dtype == torch.float32 for t in tm.state_dict().values())  # untouched
    with pytest.raises(ValueError, match="unknown variant"):
        taot.transform_variables(tm, "fp8")


def _parity_cases():
    a = np.zeros((1, 32, 3), np.float32)
    a[0, :, 0] = 0.9
    flipped = a.copy()
    flipped[0, :, 1] = 1.5
    c = np.asarray([[0.2, 0.8]], np.float32)
    v = np.asarray([[180.0]], np.float32)
    return [
        (a, a + 1e-3, "bf16", "soft", 1.0),
        (a, flipped, "bf16", "soft", 1.0),
        (a, a + 0.5, "bf16", "soft", 1.0),
        (a, a + 0.03, "int8", "soft", 1.0),
        (c, c + 1e-4, "int8", "onehot", 1.0),
        (c, c[:, ::-1].copy(), "int8", "onehot", 1.0),
        (v, v + 1.0, "bf16", "value", 360.0),
        (v, v + 30.0, "bf16", "value", 360.0),
        (v, v + 5.0, "int8", "value", 360.0),
    ]


@pytest.mark.parametrize("case", range(len(_parity_cases())))
def test_variant_parity_decisions_like_jax(case):
    ref, out, variant, kind, scale = _parity_cases()[case]
    want = jaot.variant_parity(ref, out, variant, kind=kind, scale=scale)
    got = taot.variant_parity(torch.from_numpy(ref), torch.from_numpy(out), variant,
                              kind=kind, scale=scale)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], rel=1e-6)


@pytest.mark.parametrize("name", ["seist_s_dpk", "seist_s_pmp", "seist_s_emg", "seist_s_baz",
                                  "phasenet", "magnet", "ditingmotion", "baz_network"])
def test_parity_kind_like_jax(name):
    assert taot.parity_kind(ttaskspec.get_task_spec(name)) == jaot.parity_kind(
        jtaskspec.get_task_spec(name))


def test_outputs_finite_and_f32():
    good = (torch.ones(2, 3, dtype=torch.bfloat16), torch.zeros(1))
    assert taot.outputs_finite(good)
    assert not taot.outputs_finite((torch.tensor([1.0, float("nan")]),))
    assert all(t.dtype == torch.float32 for t in taot.outputs_to_f32(good))
