"""The port's data plane against ``seist_tpu.data``: the seeded split, the
epoch order and the Loader's batches, byte for byte.

The JAX package routes normalisation and soft labels through its optional
native wavekit library when it is built; the port keeps only the numpy
path, so the JAX side is pinned to its numpy path here (the library's
float order is its own)."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import numpy as np
import pytest

import seist_tpu
from seist_tpu import native
from seist_tpu import taskspec as jts
from seist_tpu.data import pipeline as jp
from seist_tpu.data import preprocess as jpre

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.data import pipeline as tp
from seist_tpu_torch.data import preprocess as tpre
from seist_tpu_torch.registry import DATASETS


@pytest.fixture(autouse=True)
def _numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    seist_tpu.load_all()
    seist_tpu_torch.load_all()


AUG = dict(augmentation=True, shift_event_rate=0.3, add_noise_rate=0.4, add_gap_rate=0.4,
           drop_channel_rate=0.4, scale_amplitude_rate=0.4, pre_emphasis_rate=0.4,
           generate_noise_rate=0.1, add_event_rate=0.3, max_event_num=2, min_event_gap_sec=0.5)


def _pair(mode, seed=3, events=40, **kw):
    common = dict(seed=seed, in_samples=768, dataset_kwargs={"num_events": events,
                                                             "trace_samples": 1500})
    common.update(kw)
    jd = jp.from_task_spec(jts.get_task_spec("seist_s_dpk"), "synthetic", mode, **common)
    td = tp.from_task_spec(tts.get_task_spec("seist_s_dpk"), "synthetic", mode, **common)
    return jd, td


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_split_order_matches_jax(mode, shuffle):
    jd, td = _pair(mode, seed=11, events=57, shuffle=shuffle)
    want = jd._dataset._meta_data["idx"].to_numpy()
    np.testing.assert_array_equal(td._dataset._meta_data["idx"], want)
    assert len(td) == len(jd)


@pytest.mark.parametrize("epoch", [0, 3])
def test_epoch_indices_match_jax(epoch):
    for shuffle in (True, False):
        np.testing.assert_array_equal(
            tp.epoch_indices(50, seed=5, epoch=epoch, shuffle=shuffle),
            jp.epoch_indices(50, seed=5, epoch=epoch, shuffle=shuffle))


def _same_batches(jl, tl, epochs):
    n = 0
    for e in epochs:
        jl.set_epoch(e)
        tl.set_epoch(e)
        for a, b in zip(jl, tl, strict=True):
            assert a.inputs.tobytes() == b.inputs.tobytes()
            assert a.inputs.dtype == b.inputs.dtype and a.inputs.shape == b.inputs.shape
            assert a.loss_targets.tobytes() == b.loss_targets.tobytes()
            assert a.metrics_targets.keys() == b.metrics_targets.keys()
            for k in a.metrics_targets:
                assert a.metrics_targets[k].tobytes() == b.metrics_targets[k].tobytes(), k
            assert a.meta == b.meta
            assert a.mask.tobytes() == b.mask.tobytes()
            n += 1
    return n


def test_train_loader_batches_are_byte_identical_to_jax():
    jd, td = _pair("train", **AUG)
    jl = jp.Loader(jd, 8, shuffle=True, drop_last=True, num_workers=3, seed=3)
    tl = tp.Loader(td, 8, shuffle=True, drop_last=True, num_workers=2, seed=3)
    assert len(tl) == len(jl) == (2 * 32) // 8
    assert _same_batches(jl, tl, epochs=(0, 1)) == 2 * len(tl)
    tl.close()
    jl.close()


def test_eval_loader_pads_and_masks_like_jax():
    jd, td = _pair("val", events=57)
    jl = jp.Loader(jd, 4, shuffle=False, drop_last=False, num_workers=2, seed=3)
    tl = tp.Loader(td, 4, shuffle=False, drop_last=False, num_workers=2, seed=3)
    assert len(tl) == len(jl) == 2  # 5 val events -> one full batch, one padded
    assert _same_batches(jl, tl, epochs=(0,)) == 2
    last = list(tl)[-1]
    np.testing.assert_array_equal(last.mask, [1, 0, 0, 0])


@pytest.mark.parametrize("shape", ["gaussian", "triangle", "box", "sigmoid"])
def test_preprocessor_helpers_match_jax(shape):
    np.testing.assert_array_equal(tpre.make_soft_window(20, shape),
                                  jpre.make_soft_window(20, shape))
    assert tpre.pad_phases([30, 400], [10, 200], 25, 500) == jpre.pad_phases(
        [30, 400], [10, 200], 25, 500)
    x = np.random.default_rng(0).standard_normal((3, 300)).astype(np.float32)
    for mode in ("std", "max", "absmax", ""):
        np.testing.assert_array_equal(tpre.normalize(x, mode, axis=1),
                                      jpre.normalize(x, mode, axis=1))


def test_dataset_registry():
    assert "synthetic" in DATASETS
    with pytest.raises(KeyError, match="Unknown dataset"):
        DATASETS.get("diting_light")
