"""The port's device augmentation (``seist_tpu_torch/data/device_aug.py``)
against the JAX package's, on the CPU.

The same numpy events go through both. The JAX functions are written for
one sample and run under ``jax.vmap``; the port's take the batch axis.
Each op gets the JAX package's own draws on both sides, so it is held
alone; the composed processor draws its own (``ops/threefry.py``).
Limits: phase arrays, counts and gates exactly; waveforms and labels
within 1e-5 absolute (float32 sums in another order; the normal fields
differ from XLA's by up to 4.8e-7, tests/test_torch_threefry.py).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.data import device_aug as jda
from seist_tpu.data.preprocess import DataPreprocessor as JPre

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.data import device_aug as tda
from seist_tpu_torch.data.preprocess import DataPreprocessor as TPre

C, L, W, B, P = 3, 600, 512, 6, 4
ATOL = 1e-5
CHANNELS = ("z", "n", "e")


def _pre_kwargs(**over):
    kw = dict(data_channels=list(CHANNELS), sampling_rate=50, in_samples=W, coda_ratio=1.4,
              norm_mode="std", add_event_rate=0.9, max_event_num=2, shift_event_rate=0.9,
              add_noise_rate=0.9, add_gap_rate=0.9, drop_channel_rate=0.9,
              scale_amplitude_rate=0.9, pre_emphasis_rate=0.9, generate_noise_rate=0.3,
              min_event_gap_sec=0.1, soft_label_shape="gaussian", soft_label_width=40)
    kw.update(over)
    return kw


def _cfgs(raw_len=L, seed=0, **over):
    kw = _pre_kwargs(**over)
    jpre, tpre = JPre(**kw), TPre(**kw)
    return (jda.AugConfig.from_preprocessor(jpre, seed=seed, raw_len=raw_len, phase_slots=P),
            tda.AugConfig.from_preprocessor(tpre, seed=seed, raw_len=raw_len, phase_slots=P),
            jpre, tpre)


def _events(seed, n=B, length=L, noise_every=4):
    """Events with one or two P/S pairs; every ``noise_every``-th has none
    (a noise trace), one has an unmatched leading S."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p1 = int(rng.integers(20, length // 3))
        s1 = p1 + int(rng.integers(10, 60))
        ppks, spks = [p1], [s1]
        if i % 3 == 1:
            p2 = int(rng.integers(length // 2, length - 80))
            ppks, spks = [p1, p2], [s1, p2 + int(rng.integers(5, 40))]
        if i % 5 == 2:
            ppks = ppks[1:] if len(ppks) > 1 else []
        if noise_every and i % noise_every == 3:
            ppks, spks = [], []
        out.append({
            "data": (rng.standard_normal((C, length)) * rng.uniform(0.5, 3.0)).astype(np.float32),
            "ppks": ppks, "spks": spks,
            "emg": [float(rng.uniform(1, 5))], "baz": [float(rng.uniform(0, 360))],
            "pmp": [int(rng.integers(0, 2))], "clr": [int(rng.integers(0, 2))],
            "snr": np.full(C, 20.0, np.float32),
        })
    return out


def _rows(jpre, tpre, events):
    """Stacked host rows from both packages' host_prepare (held equal)."""
    jr = [jda.host_prepare(jpre, e, P) for e in events]
    tr = [tda.host_prepare(tpre, e, P) for e in events]
    for a, b in zip(jr, tr):
        assert a["is_noise"] == b["is_noise"]
        for k in ("data", "ppks", "np_p", "spks", "np_s"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    return {k: np.stack([np.asarray(r[k]) for r in jr]) for k in ("data", "ppks", "np_p", "spks",
                                                                     "np_s")}


def _jdraws(cfg, epoch, idx):
    keys = jax.vmap(lambda i: jda.sample_key(cfg.seed, jnp.int32(epoch), i))(
        jnp.asarray(idx, jnp.int32))
    return {k: np.asarray(v) for k, v in jax.vmap(lambda k: jda.draw_all(cfg, k))(keys).items()}


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind in "iu" else x.copy())


def _phases(rows):
    return [_t(rows[k]) for k in ("ppks", "np_p", "spks", "np_s")]


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64), err_msg=msg)


def _close(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jcfg, tcfg, jpre, tpre = _cfgs()
    rows = _rows(jpre, tpre, _events(0))
    idx = np.arange(B, dtype=np.int32) * 7 + 3
    return dict(jcfg=jcfg, tcfg=tcfg, jpre=jpre, tpre=tpre, rows=rows, idx=idx,
                draws=_jdraws(jcfg, 2, idx))


def test_draws_match_jax(setup):
    """Every named draw: uniforms bit for bit, the two normal fields
    within 1e-6 (the exact share is printed)."""
    draws = setup["draws"]
    got = tda.draw_all(setup["tcfg"], torch.tensor(2, dtype=torch.int32),
                       torch.from_numpy(setup["idx"]))
    assert set(got) == set(draws)
    for k, want in draws.items():
        g = got[k].numpy()
        assert g.shape == want.shape and g.dtype == np.float32, k
        if k.endswith("_field"):
            d = np.abs(g - want)
            print(f"{k}: {float((d == 0).mean()):.4f} exact, max abs {float(d.max()):.3g}")
            assert d.max() <= 1e-6, k
        else:
            np.testing.assert_array_equal(g, want, err_msg=k)


def test_u2i_matches(setup):
    u = setup["draws"]["add_pos"].reshape(-1)
    n = np.array([1, 2, 7, 40, 12000, 2**30 - 5] * 2, np.int32)[: u.size]
    want = jax.vmap(jda._u2i)(jnp.asarray(u), jnp.asarray(n))
    _eq(tda._u2i(torch.from_numpy(u), torch.from_numpy(n)), want)
    _eq(tda._u2i(torch.from_numpy(u), 12000), jax.vmap(lambda x: jda._u2i(x, 12000))(u))


@pytest.mark.parametrize("mode", ["std", "max", ""])
def test_normalize(setup, mode):
    data = setup["rows"]["data"] * 3.0
    _close(tda.normalize(_t(data), mode), jax.vmap(lambda d: jda.normalize(d, mode))(data))


def test_generate_noise(setup):
    cfg, rows, d = setup["jcfg"], setup["rows"], setup["draws"]
    want = jax.vmap(lambda *a: jda.generate_noise(cfg, *a))(
        rows["data"], rows["ppks"], rows["np_p"], rows["spks"], rows["np_s"], d["gen_field"])
    got = tda.generate_noise(setup["tcfg"], _t(rows["data"]), *_phases(rows),
                             _t(d["gen_field"]))
    _close(got, want)


@pytest.mark.parametrize("gap", [0, 5])
def test_add_event_once(setup, gap):
    rows, d = setup["rows"], setup["draws"]
    jcfg, tcfg, _, _ = _cfgs(min_event_gap_sec=gap / 50)
    active = np.array([True, True, False, True, True, True])
    for i in range(2):
        want = jax.vmap(lambda *a: jda.add_event_once(jcfg, *a))(
            rows["data"], rows["ppks"], rows["np_p"], rows["spks"], rows["np_s"],
            d["add_target"][:, i], d["add_pos"][:, i], d["add_scale"][:, i], active)
        got = tda.add_event_once(tcfg, _t(rows["data"]), *_phases(rows),
                                 _t(d["add_target"][:, i]), _t(d["add_pos"][:, i]),
                                 _t(d["add_scale"][:, i]), torch.from_numpy(active))
        _close(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            _eq(g, w)


def test_shift_event(setup):
    rows = setup["rows"]
    shift = np.array([0, 1, 217, 599, 300, 45], np.int32)
    want = jax.vmap(jda.shift_event)(rows["data"], rows["ppks"], rows["np_p"], rows["spks"],
                                     rows["np_s"], shift)
    got = tda.shift_event(_t(rows["data"]), *_phases(rows), _t(shift))
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_drop_channel_and_adjust(setup, channels):
    d = setup["draws"]
    data = setup["rows"]["data"][:, :channels]
    want = jax.vmap(jda.drop_channel)(data, d["drop_num_u"], d["drop_ch_u"])
    got = tda.drop_channel(_t(data), _t(d["drop_num_u"]), _t(d["drop_ch_u"]))
    _close(got, want)
    _close(tda.adjust_amplitude(got), jax.vmap(jda.adjust_amplitude)(want))


def test_amplitude_emphasis_noise(setup):
    data, d = setup["rows"]["data"], setup["draws"]
    _close(tda.scale_amplitude(_t(data), _t(d["scale_flip"]), _t(d["scale_factor_u"])),
           jax.vmap(jda.scale_amplitude)(data, d["scale_flip"], d["scale_factor_u"]))
    _close(tda.pre_emphasis(_t(data), 0.97),
           jax.vmap(lambda x: jda.pre_emphasis(x, 0.97))(data))
    _close(tda.add_noise(_t(data), _t(d["snr_u"]), _t(d["noise_field"])),
           jax.vmap(jda.add_noise)(data, d["snr_u"], d["noise_field"]))


def test_add_gaps(setup):
    rows, d = setup["rows"], setup["draws"]
    want = jax.vmap(jda.add_gaps)(rows["data"], rows["ppks"], rows["np_p"], rows["spks"],
                                  rows["np_s"], d["gap_pos_u"], d["gap_start_u"],
                                  d["gap_end_u"])
    got = tda.add_gaps(_t(rows["data"]), *_phases(rows), _t(d["gap_pos_u"]),
                       _t(d["gap_start_u"]), _t(d["gap_end_u"]))
    _close(got, want)


@pytest.mark.parametrize("raw_len", [L, W, 400], ids=["crop", "equal", "pad"])
def test_cut_window_branches(setup, raw_len):
    jcfg, tcfg, jpre, tpre = _cfgs(raw_len=raw_len)
    rows = _rows(jpre, tpre, _events(1, length=raw_len))
    u = setup["draws"]["crop_u"]
    want = jax.vmap(lambda *a: jda.cut_window(jcfg, *a))(
        rows["data"], rows["ppks"], rows["np_p"], rows["spks"], rows["np_s"], u)
    got = tda.cut_window(tcfg, _t(rows["data"]), *_phases(rows), _t(u))
    assert tuple(got[0].shape) == (B, C, W)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)


def test_pad_phases_and_labels(setup):
    jcfg, tcfg, rows = setup["jcfg"], setup["tcfg"], setup["rows"]
    # Window-relative phases, some outside the window.
    ppks = np.where(rows["ppks"] < jda._BIG, rows["ppks"] - 60, rows["ppks"]).astype(np.int32)
    spks = np.where(rows["spks"] < jda._BIG, rows["spks"] - 60, rows["spks"]).astype(np.int32)
    ph = (ppks, rows["np_p"], spks, rows["np_s"])
    tph = [_t(x) for x in ph]
    want = jax.vmap(lambda *a: jda.pad_phases_dev(*a, 40, W))(*ph)
    got = tda.pad_phases_dev(*tph, 40, W)
    for g, w in zip(got, want):
        _eq(g, w)
    window = np.asarray(jda.make_soft_window(40, "gaussian"), np.float32)
    tw = torch.from_numpy(window)
    _close(tda.label_pick(tcfg, tph[0], tph[1], tw),
           jax.vmap(lambda v, n: jda.label_pick(jcfg, v, n, window))(ppks, rows["np_p"]))
    _close(tda.label_non(tcfg, *tph, tw),
           jax.vmap(lambda *a: jda.label_non(jcfg, *a, window))(*ph))
    _close(tda.label_det(tcfg, *tph, tw),
           jax.vmap(lambda *a: jda.label_det(jcfg, *a, window))(*ph))
    idxs = np.array([[-5, 0, 3], [511, 512, 200], [20, 20, 30], [0, 0, 0], [100, -1, 509],
                     [250, 260, 270]], np.int32)
    valid = np.array([[1, 1, 1], [1, 1, 1], [1, 0, 1], [0, 0, 0], [1, 1, 1], [1, 1, 0]], bool)
    _close(tda.soft_label_place(_t(idxs), torch.from_numpy(valid), tw, W),
           jax.vmap(lambda i, v: jda.soft_label_place(i, v, window, W))(idxs, valid))


def _processed(model, events, epoch=1, aug=None, **over):
    """Both processors on the same rows: (JAX out, port out, the JAX
    process_event dict, the port's)."""
    jcfg, tcfg, jpre, tpre = _cfgs(**over)
    spec_j, spec_t = jts.get_task_spec(model), tts.get_task_spec(model)
    rows = _rows(jpre, tpre, events)
    rows["values"] = {n: np.array([[e[n][0]] for e in events], np.float32)
                      for n in ("emg", "baz")}
    rows["onehots"] = {n: np.array([e[n][0] for e in events], np.int32) for n in ("pmp", "clr")}
    idx = np.arange(len(events), dtype=np.int32) * 5 + 1
    aug = np.ones(len(events), bool) if aug is None else aug
    jproc = jax.jit(jda.make_row_processor(jcfg, spec_j.inputs, spec_j.labels))
    want = jproc(rows, jnp.asarray(idx), jnp.asarray(aug), jnp.int32(epoch))
    trows = {k: ({n: _t(x) for n, x in v.items()} if isinstance(v, dict) else _t(v))
             for k, v in rows.items()}
    tproc = tda.make_row_processor(tcfg, spec_t.inputs, spec_t.labels)
    got = tproc(trows, torch.from_numpy(idx), torch.from_numpy(aug),
                torch.tensor(epoch, dtype=torch.int32))
    # The process_event state both sides reached, from their own draws.
    jd = _jdraws(jcfg, epoch, idx)
    jev = jax.vmap(lambda d, pp, n_p, ss, n_s, dr, a: jda.process_event(
        jcfg, d, pp, n_p, ss, n_s, dr, a))(rows["data"], rows["ppks"], rows["np_p"],
                                           rows["spks"], rows["np_s"], jd, aug)
    tev = tda.process_event(tcfg, trows["data"], *[trows[k] for k in ("ppks", "np_p", "spks",
                                                                     "np_s")],
                            tda.draw_all(tcfg, torch.tensor(epoch, dtype=torch.int32),
                                         torch.from_numpy(idx)), torch.from_numpy(aug))
    return want, got, jev, tev


def _check_processed(want, got, jev, tev):
    for k in ("ppks", "np_p", "spks", "np_s", "gen_fired"):
        _eq(tev[k], jev[k], k)
    _close(tev["win"], jev["win"], "win")
    for w, g in zip(jax.tree.leaves(want), _leaves(got)):
        assert tuple(g.shape) == tuple(w.shape)
        if np.asarray(w).dtype.kind in "iu":
            _eq(g, w)
        else:
            _close(g, w)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_process_dpk_row(setup, seed):
    """seist_s_dpk (waveform group in, det/ppk/spk group out) with every
    rate > 0, add_event with max_event_num 2, coda_ratio 1.4."""
    _check_processed(*_processed("seist_s_dpk", _events(seed + 10, n=8), epoch=seed))


def test_process_phasenet_non_label(setup):
    _check_processed(*_processed("phasenet", _events(20, n=8)))


@pytest.mark.parametrize("model", ["seist_s_emg", "seist_s_baz", "seist_s_pmp",
                                   "ditingmotion"])
def test_process_value_and_onehot_rows(setup, model):
    """VALUE (emg, baz) and ONEHOT (pmp, ditingmotion's clr/pmp and its
    'dz' input) rows: generate_noise off, as the device path requires."""
    assert tda.unsupported_reasons(TPre(**_pre_kwargs()), ["emg"], ["emg"]) == \
        jda.unsupported_reasons(JPre(**_pre_kwargs()), ["emg"], ["emg"])
    _check_processed(*_processed(model, _events(30, n=8, noise_every=0),
                                 generate_noise_rate=0.0))


def test_no_augmentation_path(setup):
    """Samples not augmented pass every gate untouched: cut and normalised
    only, whatever the rates."""
    aug = np.array([False, True, False, False, True, False, False, False])
    want, got, jev, tev = _processed("seist_s_dpk", _events(40, n=8), aug=aug)
    _check_processed(want, got, jev, tev)
    assert not tev["gen_fired"][~torch.from_numpy(aug)].any()


def test_cache_processor_gathers_rows(setup):
    jcfg, tcfg, jpre, tpre = _cfgs()
    rows = _rows(jpre, tpre, _events(50, n=4))
    idx = np.array([5, 0, 7, 2], np.int32)  # n_raw 4: 5 and 7 are augmented copies
    spec = jts.get_task_spec("seist_s_dpk")
    want = jax.jit(jda.make_cache_processor(jcfg, spec.inputs, spec.labels, 4, True))(
        rows, jnp.asarray(idx), jnp.int32(3))
    got = tda.make_cache_processor(tcfg, spec.inputs, spec.labels, 4, True)(
        {k: _t(v) for k, v in rows.items()}, torch.from_numpy(idx),
        torch.tensor(3, dtype=torch.int32))
    for w, g in zip(_leaves(want), _leaves(got)):
        _close(g, w)


def test_mode_selection_matches_jax():
    for args in [("off", 0, 1, []), ("step", 0, 1, []), ("cached", 10, 5, []),
                 ("cached", 1, 5, []), ("cached", 1, 5, ["x"]), ("step", 0, 1, ["y", "z"])]:
        assert tda.select_device_aug_mode(*args) == jda.select_device_aug_mode(*args)
    with pytest.raises(ValueError):
        tda.select_device_aug_mode("bogus", 0, 1, [])
    assert tda.hbm_budget_bytes(1.5) == jda.hbm_budget_bytes(1.5)
    assert tda.hbm_budget_bytes(0.0, "cpu") == 4 << 30
    for kw, names in [(dict(mask_percent=10), ["ppk"]), (dict(p_position_ratio=0.5), ["ppk"]),
                      (dict(norm_mode="absmax"), ["ppk"]), ({}, ["emg", "pmp", "ppk+"])]:
        assert (tda.unsupported_reasons(TPre(**_pre_kwargs(**kw)), [CHANNELS], names)
                == jda.unsupported_reasons(JPre(**_pre_kwargs(**kw)), [CHANNELS], names))
