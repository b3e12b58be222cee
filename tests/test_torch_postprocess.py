"""The port's peak picking and event detection equal the JAX package's
exactly (integer results), including ties and plateaus: inputs are
quantized so equal heights, equal run lengths and flat tops are common."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import numpy as np
import pytest
import torch

from seist_tpu.ops import postprocess as jpp

from seist_tpu_torch.ops import postprocess as tpp


def _probs(n, length, seed, levels=8):
    """Smooth-ish random probabilities rounded to ``levels`` steps."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, length))
    x = np.convolve(x.reshape(-1), np.ones(3) / 3, mode="same").reshape(n, length)
    return (np.round(x * levels) / levels).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr,mpd,topk", [(0.3, 1, 1), (0.3, 5, 4), (0.5, 20, 8), (0.0, 3, 16)])
def test_pick_peaks_exact(seed, thr, mpd, topk):
    x = _probs(4, 200, seed)
    want = np.asarray(jpp.pick_peaks(x, thr, mpd, topk))
    got = tpp.pick_peaks(torch.from_numpy(x), thr, mpd, topk).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pick_peaks_ties_break_toward_the_earlier_peak():
    x = np.zeros((1, 40), np.float32)
    for i in (5, 15, 25, 35):  # four equal peaks
        x[0, i] = 0.9
    x[0, 20:23] = 0.9  # a plateau: its rising edge (20) is the candidate
    for topk in (1, 2, 3, 5):
        want = np.asarray(jpp.pick_peaks(x, 0.3, 1, topk))
        got = tpp.pick_peaks(torch.from_numpy(x), 0.3, 1, topk).numpy()
        np.testing.assert_array_equal(got, want)
    assert tpp.pick_peaks(torch.from_numpy(x), 0.3, 1, 2).tolist() == [[5, 15]]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr,topk", [(0.5, 1), (0.4, 3), (0.6, 8)])
def test_detect_events_exact(seed, thr, topk):
    x = _probs(4, 120, seed, levels=4)
    x[0] = 0.0  # no run at all
    x[1, :] = 1.0  # one run over the whole trace
    want = np.asarray(jpp.detect_events(x, thr, topk))
    got = tpp.detect_events(torch.from_numpy(x), thr, topk).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_process_outputs_matches():
    x = _probs(2, 300, 7, levels=16).reshape(2, 100, 3)
    labels = (("det", "ppk", "spk"),)
    kw = dict(ppk_threshold=0.4, spk_threshold=0.3, det_threshold=0.5,
              min_peak_dist=0.2, max_detect_event_num=3)
    want = jpp.process_outputs(x, labels, 50, **kw)
    got = tpp.process_outputs(torch.from_numpy(x), labels, 50, **kw)
    assert sorted(got) == sorted(want) == ["det", "ppk", "spk"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
