"""The port's SeisT against the JAX package's: the same seeded flax
variables, converted by ``state_dict_from_flax``, run through both on the
CPU (the port's attention takes its plain version on CPU tensors).

Tolerance 1e-5 absolute on the outputs (sigmoid probabilities / softmax
scores): both sides are fp32; convolutions and matmuls sum in another
order. Models are cut to window 512 (and seist_l to fewer blocks per
stage) to stay within the CPU test budget; widths are the presets'.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_pair

from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models import seist as tseist
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.registry import MODELS

WINDOW = 512
ATOL = 1e-5

CASES = {
    "seist_s_dpk": {},
    # Every stage keeps its attention blocks and stage 0 keeps an MSMC block.
    "seist_l_dpk": {"layer_blocks": (2, 1, 2, 1)},
    "seist_s_pmp": {},
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    name = request.param
    jm, variables, tm = model_pair(name, WINDOW, seed=0, **CASES[name])
    return name, jm, variables, tm


def _x(n=2, seed=1):
    return np.random.default_rng(seed).standard_normal((n, WINDOW, 3)).astype(np.float32)


def test_forward_matches_jax(pair):
    name, jm, variables, tm = pair
    x = _x()
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert want.std() > 1e-3  # a live signal, not a saturated constant
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_backbone_then_head_equals_full(pair):
    _, _, _, tm = pair
    x = torch.from_numpy(_x(seed=2))
    with torch.no_grad():
        full = tm(x)
        split = tm.head(tm.backbone(x), x.shape[1])
    torch.testing.assert_close(split, full, rtol=0, atol=0)


def test_attention_launches_follow_the_shape_log(pair, monkeypatch):
    """attention_shapes (no forward) names every launch a forward makes."""
    _, _, _, tm = pair
    seen = []
    real = tseist.fused_pooled_attention

    def record(q, k, v, scale=None, **kw):
        seen.append((q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
        return real(q, k, v, scale, **kw)

    monkeypatch.setattr(tseist, "fused_pooled_attention", record)
    with torch.no_grad():
        tm(torch.from_numpy(_x(n=1)))
    assert seen == tm.attention_shapes(WINDOW)


def test_seist_l_dpk_attention_table_at_window_8192():
    """The five launches of one serving forward, worked out from the preset
    (stem /4, one /2 per stage, M = L / attn_aggr_ratio,
    H*E = make_divisible(int(0.6*C), head_dim))."""
    model = tapi.create_model("seist_l_dpk", in_samples=8192)
    assert model.attention_shapes(8192) == [
        (1024, 128, 3, 8),
        (512, 128, 3, 8),
        (256, 128, 3, 16),
        (256, 128, 3, 16),
        (128, 128, 3, 32),
    ]


def test_all_fifteen_names_register_and_build():
    names = [f"seist_{s}_{t}" for s in "sml" for t in ("dpk", "pmp", "emg", "baz", "dis")]
    assert sorted(n for n in MODELS.names() if n.startswith("seist_")) == sorted(names)
    for name in names:
        model = tapi.create_model(name, in_samples=WINDOW)
        assert not model.training
    reg = tapi.create_model("seist_m_baz", in_samples=WINDOW)
    assert reg.cfg.head_scale == 360.0 and reg.cfg.path_drop_rate == 0.1
    assert tapi.create_model("seist_l_pmp").cfg.attn_drop_rate == 0.3


def test_seeded_init_is_reproducible_and_truncated():
    a = tapi.create_model("seist_s_dpk", seed=3).state_dict()
    b = tapi.create_model("seist_s_dpk", seed=3).state_dict()
    c = tapi.create_model("seist_s_dpk", seed=4).state_dict()
    w = "stage1_block1.attention.q_proj.weight"
    assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
    assert float(a[w].abs().max()) <= 0.04 and 0.01 < float(a[w].std()) < 0.03
    assert torch.equal(a["stem0.norm.weight"], torch.ones(16))
    assert torch.equal(a["stem0.norm.running_var"], torch.ones(16))


def test_convert_raises_on_unmapped_leaves():
    with pytest.raises(KeyError, match="no rule maps param"):
        state_dict_from_flax({"params": {"m": {"embedding": np.zeros((3, 4))}}})
    with pytest.raises(KeyError, match="batch_stats"):
        state_dict_from_flax({"batch_stats": {"m": {"count": np.zeros(3)}}})
    with pytest.raises(KeyError, match="collections"):
        state_dict_from_flax({"params": {}, "cache": {}})


def test_taskspec_table_and_transforms_match_jax():
    import jax.numpy as jnp

    from seist_tpu import taskspec as jts

    from seist_tpu_torch import taskspec as tts

    for name in (n for n in MODELS.names() if n.startswith("seist_")):
        a, b = tts.get_task_spec(name), jts.get_task_spec(name)
        assert (a.inputs, a.labels, a.eval) == (b.inputs, b.labels, b.eval)
        assert tts.get_num_inchannels(name) == jts.get_num_inchannels(name) == 3
    assert {k: (v.kind, v.metrics, v.num_classes) for k, v in tts.IO_ITEMS.items()} == {
        k: (v.kind, v.metrics, v.num_classes) for k, v in jts.IO_ITEMS.items()}
    rng = np.random.default_rng(0)
    deg = rng.uniform(0, 360, 16).astype(np.float32)
    for got, want in zip(tts.baz_targets_to_cos_sin(torch.from_numpy(deg)),
                         jts._baz_targets_to_cos_sin(jnp.asarray(deg))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    pair = rng.standard_normal((2, 16)).astype(np.float32)
    # Degrees up to 180: fp32 atan2 rounding is ~2e-5 there.
    np.testing.assert_allclose(
        tts.baz_outputs_to_deg(torch.from_numpy(pair)).numpy(),
        np.asarray(jts._baz_outputs_to_deg(jnp.asarray(pair))), atol=1e-4)
    mag = rng.standard_normal((4, 2)).astype(np.float32)
    np.testing.assert_array_equal(tts.magnet_results(torch.from_numpy(mag)).numpy(),
                                  np.asarray(jts._magnet_results(jnp.asarray(mag))))
    logits = [rng.standard_normal((3, 2)).astype(np.float32) for _ in range(2)]
    for got, want in zip(tts.softmax_each([torch.from_numpy(x) for x in logits]),
                         jts._softmax_each([jnp.asarray(x) for x in logits])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
