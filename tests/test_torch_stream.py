"""The port's continuous-record annotation (``seist_tpu_torch/ops/stream.py``)
against the JAX package's (``seist_tpu/ops/stream.py``) on the CPU.

Limits: window offsets equal; ``stitch_probs`` under ``max`` exact and
under ``mean`` within 1e-6 (the sums of overlapping windows may add in
another order); ``annotate`` with one numpy picker as both packages'
``apply_fn``: picks equal and ``prob`` within 1e-6; through converted
weights of a small PhaseNet and ``seist_s_dpk`` at window 256: ``prob``
within 1e-5 (the forwards' limit) and picks equal."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_pair

from seist_tpu.ops import stream as jstream

from seist_tpu_torch.ops import stream as tstream

WINDOW = 64


def _picker(x):
    """A numpy picker, one window at a time: P from the normalized |z|
    envelope, S from |n|, both packages' ``apply_fn``."""
    x = np.asarray(x)
    a = np.abs(x[..., 0])
    p = a / (a.max(axis=1, keepdims=True) + np.float32(1e-9))
    s = np.clip(np.abs(x[..., 1]) / np.float32(3.0), 0.0, 1.0)
    return np.stack([1.0 - p, p, s], axis=-1).astype(np.float32)


def _det_picker(x):
    """The 'det' convention: channel 0 is the event probability."""
    p = _picker(x)
    d = np.clip(p[..., 1] * np.float32(1.5), 0.0, 1.0)
    return np.stack([d, p[..., 1], p[..., 2]], axis=-1).astype(np.float32)


def _record(length, seed=0, events=(40, 150, 260)):
    rng = np.random.default_rng(seed)
    rec = (rng.standard_normal((length, 3)) * 0.1).astype(np.float32)
    for e in events:
        if e + 4 < length:
            rec[e : e + 4, 0] += 40.0
            rec[min(e + 30, length - 1), 1] += 6.0
    return rec


@pytest.mark.parametrize("length,window,stride", [
    (64, 64, 32), (65, 64, 32), (300, 64, 32), (301, 64, 17), (8192 * 5 + 3, 8192, 4096)])
def test_window_offsets_equal_jax(length, window, stride):
    np.testing.assert_array_equal(tstream.window_offsets(length, window, stride),
                                  jstream.window_offsets(length, window, stride))
    rec = _record(length)
    tw, toff = tstream.sliding_windows(rec, window, stride)
    jw, joff = jstream.sliding_windows(rec, window, stride)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(toff, joff)


def test_window_offsets_refuse_a_short_record():
    with pytest.raises(ValueError, match="< window"):
        tstream.window_offsets(10, 64, 32)


@pytest.mark.parametrize("combine,tol", [("max", 0.0), ("mean", 1e-6)])
@pytest.mark.parametrize("stride", [32, 21, 64])
def test_stitch_probs_equals_jax(combine, tol, stride):
    length = 301
    rng = np.random.default_rng(stride)
    offsets = jstream.window_offsets(length, WINDOW, stride)
    probs = rng.uniform(0, 1, (len(offsets), WINDOW, 3)).astype(np.float32)
    want = np.asarray(jstream.stitch_probs(jax.numpy.asarray(probs), jax.numpy.asarray(offsets),
                                           length, combine=combine))
    got = tstream.stitch_probs(torch.from_numpy(probs), offsets, length, combine=combine).numpy()
    assert got.shape == want.shape == (length, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    with pytest.raises(ValueError, match="combine"):
        tstream.stitch_probs(torch.from_numpy(probs), offsets, length, combine="median")


def _both(apply_fn, rec, **kw):
    want = jstream.annotate(apply_fn, rec, jitted=True, **kw)
    got = tstream.annotate(apply_fn, rec, **kw)
    return got, want


def _assert_same(got, want, prob_tol):
    np.testing.assert_array_equal(np.sort(got["ppk"]), np.sort(np.asarray(want["ppk"])))
    np.testing.assert_array_equal(np.sort(got["spk"]), np.sort(np.asarray(want["spk"])))
    assert sorted(map(tuple, got["det"].tolist())) == sorted(
        map(tuple, np.asarray(want["det"]).tolist()))
    assert got["prob"].shape == np.asarray(want["prob"]).shape
    np.testing.assert_allclose(got["prob"], np.asarray(want["prob"]), rtol=0, atol=prob_tol)


@pytest.mark.parametrize("combine", ["max", "mean"])
@pytest.mark.parametrize("channel0", ["non", "det"])
@pytest.mark.parametrize("length", [331, 320])  # 331: the tail is not a multiple of the stride
def test_annotate_with_one_picker_equals_jax(combine, channel0, length):
    rec = _record(length, seed=length)
    fn = _picker if channel0 == "non" else _det_picker
    got, want = _both(fn, rec, window=WINDOW, stride=32, batch_size=4, sampling_rate=50,
                      ppk_threshold=0.3, spk_threshold=0.3, det_threshold=0.5,
                      min_peak_dist=0.1, combine=combine, channel0=channel0)
    assert len(got["ppk"]) >= 2 and len(got["det"]) >= 1
    _assert_same(got, want, 1e-6)


@pytest.mark.parametrize("length", [40, 63, 64])
def test_annotate_pads_and_trims_a_short_record_as_jax(length):
    rec = _record(length, seed=3, events=(10,))
    got, want = _both(_picker, rec, window=WINDOW, batch_size=2, min_peak_dist=0.1,
                      channel0="non", combine="max")
    assert got["prob"].shape == (length, 3)
    assert all(p < length for p in got["ppk"]) and (got["det"] < length).all()
    _assert_same(got, want, 1e-6)


def test_annotate_refuses_a_bad_channel0_and_an_empty_record():
    with pytest.raises(ValueError, match="channel0"):
        tstream.annotate(_picker, _record(100), window=WINDOW, channel0="noise")
    with pytest.raises(ValueError, match="empty"):
        tstream.annotate(_picker, np.zeros((0, 3), np.float32), window=WINDOW, channel0="non")


@pytest.mark.parametrize("name,combine", [("phasenet", "max"), ("seist_s_dpk", "mean")])
def test_annotate_through_a_model_equals_jax(name, combine):
    """Converted weights of the same seeded flax variables: the port's
    forward on the CPU against the JAX forward, over a record of 3.3
    windows with injected bursts."""
    window = 256
    jm, variables, tm = model_pair(name, window, seed=5)
    tm.eval()
    jfwd = jax.jit(lambda x: jm.apply(variables, x, train=False))

    def tfwd(x):
        with torch.inference_mode():
            return tm(torch.from_numpy(x))

    rec = _record(850, seed=11, events=(100, 420, 700))
    kw = dict(window=window, stride=128, batch_size=4, sampling_rate=50, ppk_threshold=0.3,
              spk_threshold=0.3, det_threshold=0.5, min_peak_dist=0.5, combine=combine,
              channel0="non" if name == "phasenet" else "det")
    want = jstream.annotate(jfwd, rec, jitted=True, **kw)
    got = tstream.annotate(tfwd, rec, **kw)
    _assert_same(got, want, 1e-5)
