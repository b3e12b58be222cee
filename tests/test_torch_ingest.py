"""The port's device-augmentation data plane against the JAX package's, on
the CPU: ``pipeline.RawStore``, ``DeviceEpochCache``, ``iter_raw_batches``
and ``ingest.PackedRawStore`` (direct shard ingest).

* ``RawStore.build`` arrays byte-identical to JAX's (synthetic dataset, a
  value row and a one-hot row too), and its refusals;
* ``PackedRawStore.build``'s resident arrays and every staged batch
  byte-identical to JAX's on float32, bfloat16 and int8 packs;
* the step mode's batches (``iter_raw_batches``, from a resume offset too)
  and the cached mode's (k, B) index chunks equal to JAX's;
* under ``SEIST_FAULT_IO_CORRUPT`` / ``_FLAKY_P`` the staged batches and the
  quarantine report byte-identical to JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest

import seist_tpu
from seist_tpu import native
from seist_tpu import taskspec as jts
from seist_tpu.data import ingest as jing
from seist_tpu.data import pipeline as jp
from seist_tpu.obs.bus import BUS as JBUS

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.data import ingest as ting
from seist_tpu_torch.data import packed as tpk
from seist_tpu_torch.data import pipeline as tp
from seist_tpu_torch.obs.bus import BUS as TBUS

AUG = dict(augmentation=True, shift_event_rate=0.3, add_noise_rate=0.4, add_gap_rate=0.4,
           drop_channel_rate=0.4, scale_amplitude_rate=0.4, pre_emphasis_rate=0.4,
           generate_noise_rate=0.1, max_event_num=2, add_event_rate=0.3)


@pytest.fixture(autouse=True)
def _load(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    seist_tpu.load_all()
    seist_tpu_torch.load_all()


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """A pack of 24 synthetic events of 700 samples in each storage dtype,
    several shards each."""
    root = tmp_path_factory.mktemp("packs")
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        src = tpk.PackSource(name="synthetic",
                             dataset_kwargs={"num_events": 24, "trace_samples": 700,
                                             "cache": False})
        out[dtype] = tpk.pack_sources([src], str(root / dtype), samples_per_shard=7,
                                      dtype=dtype)["out"]
    return out


def _datasets(model="seist_s_dpk", dataset="synthetic", **kw):
    common = dict(seed=3, in_samples=256, **AUG)
    common.update(kw)
    return (jp.from_task_spec(jts.get_task_spec(model), dataset, "train", **common),
            tp.from_task_spec(tts.get_task_spec(model), dataset, "train", **common))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    return {prefix: np.asarray(tree)}


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert la[k].tobytes() == lb[k].tobytes(), k


@pytest.mark.parametrize("model", ["seist_s_dpk", "seist_s_emg", "seist_s_pmp"])
def test_raw_store_build_is_byte_identical(model):
    kw = {} if model == "seist_s_dpk" else dict(generate_noise_rate=0.0)
    jd, td = _datasets(model, dataset_kwargs={"num_events": 20, "trace_samples": 600}, **kw)
    js, ts = jp.RawStore.build(jd), tp.RawStore.build(td)
    _same(js.arrays, ts.arrays)
    assert (ts.n_raw, ts.augmentation, ts.raw_len, ts.phase_slots, len(ts), ts.nbytes) == (
        js.n_raw, js.augmentation, js.raw_len, js.phase_slots, len(js), js.nbytes)
    assert tp.RawStore.estimate_bytes(td) == jp.RawStore.estimate_bytes(jd)
    raw = np.array([3, 0, 7, 7, 15])
    _same(js.row_batch(raw), ts.row_batch(raw))


def test_stores_refuse_what_jax_refuses(packs):
    """A noise-classified trace under a VALUE label, and direct ingest of a
    dataset that is not packed: both packages refuse."""
    jd, td = _datasets("seist_s_emg", dataset_kwargs={"num_events": 20, "trace_samples": 600},
                       min_snr=1e9, generate_noise_rate=0.0)
    for build, ds in ((jp.RawStore.build, jd), (tp.RawStore.build, td)):
        with pytest.raises(ValueError, match="noise-classified"):
            build(ds)
    assert ting.packed_dataset_of(td) is None
    for build, ds in ((jing.PackedRawStore.build, jd), (ting.PackedRawStore.build, td)):
        with pytest.raises(ValueError, match="packed dataset"):
            build(ds)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_packed_raw_store_is_byte_identical(packs, dtype):
    jd, td = _datasets(dataset="packed", data_dir=packs[dtype])
    js = jing.PackedRawStore.build(jd, batch_size=5, reuse_staging=False)
    ts = ting.PackedRawStore.build(td, batch_size=5, reuse_staging=True)
    _same(js.arrays, ts.arrays)
    assert (ts.n_raw, ts.raw_len, ts.phase_slots, ts.row_nbytes, ts.disk_bytes) == (
        js.n_raw, js.raw_len, js.phase_slots, js.row_nbytes, js.disk_bytes)
    # The packed store's phases are the resident RawStore's on the same pack.
    every = np.arange(ts.n_raw)
    _same(tp.RawStore.build(td).row_batch(every),
          ting.PackedRawStore.build(td, reuse_staging=False).row_batch(every))
    names = ("data_ingest_batches", "data_ingest_samples", "data_ingest_bytes",
             "data_ingest_int8_rows")

    def counts(bus):
        return {n: bus.counter(n).value for n in names}

    jbefore, tbefore = counts(JBUS), counts(TBUS)
    for epoch in (0, 1):
        for (jr, ji, ja), (tr, ti, ta) in zip(
                jp.iter_raw_batches(js, epoch, seed=3, shuffle=True, batch_size=5),
                tp.iter_raw_batches(ts, epoch, seed=3, shuffle=True, batch_size=5),
                strict=True):
            _same(jr, tr)
            assert ji.tobytes() == ti.tobytes() and ja.tobytes() == ta.tobytes()
    # The bus counters move as the JAX package's do over the same batches.
    got = {n: v - tbefore[n] for n, v in counts(TBUS).items()}
    assert got == {n: v - jbefore[n] for n, v in counts(JBUS).items()}
    assert got["data_ingest_batches"] == 2 * (len(ts) // 5)
    assert got["data_ingest_int8_rows"] == (got["data_ingest_samples"] if dtype == "int8" else 0)
    assert f"from {dtype}" in ting.describe(ts)


def test_packed_ingest_under_injected_faults_matches_jax(packs, monkeypatch):
    monkeypatch.setenv("SEIST_FAULT_IO_CORRUPT", "2,5,9")
    monkeypatch.setenv("SEIST_FAULT_IO_FLAKY_P", "0.2")
    jd, td = _datasets(dataset="packed", data_dir=packs["float32"], max_quarantine_frac=0.5)
    js = jing.PackedRawStore.build(jd, batch_size=4)
    ts = ting.PackedRawStore.build(td, batch_size=4)
    for (jr, ji, _), (tr, ti, _) in zip(
            jp.iter_raw_batches(js, 1, seed=3, shuffle=True, batch_size=4),
            tp.iter_raw_batches(ts, 1, seed=3, shuffle=True, batch_size=4), strict=True):
        _same(jr, tr)
        assert ji.tobytes() == ti.tobytes()
    assert td.quarantine_report() == jd.quarantine_report()
    assert td.quarantine_report()["quarantined"] == [2, 5, 9]


@pytest.mark.parametrize("start", [0, 3])
def test_raw_batches_and_index_chunks_follow_jax_orders(start):
    jd, td = _datasets(dataset_kwargs={"num_events": 30, "trace_samples": 400})
    js, ts = jp.RawStore.build(jd), tp.RawStore.build(td)
    for epoch in (0, 2):
        got = list(tp.iter_raw_batches(ts, epoch, seed=3, shuffle=True, batch_size=4,
                                       start_batch=start))
        want = list(jp.iter_raw_batches(js, epoch, seed=3, shuffle=True, batch_size=4,
                                        start_batch=start))
        assert len(got) == len(want) == len(ts) // 4 - start
        for (jr, ji, ja), (tr, ti, ta) in zip(want, got):
            _same(jr, tr)
            assert ji.tobytes() == ti.tobytes() and ja.tobytes() == ta.tobytes()
        for k in (1, 3, 4):
            tc = list(tp.DeviceEpochCache(ts, "cpu").epoch_index_chunks(
                epoch, seed=3, shuffle=True, batch_size=4, steps_per_call=k, start_batch=start))
            jc = list(jp.DeviceEpochCache(js).epoch_index_chunks(
                epoch, seed=3, shuffle=True, batch_size=4, steps_per_call=k, start_batch=start))
            assert len(tc) == len(jc) > 0
            for a, b in zip(jc, tc):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_device_cache_holds_the_store_and_the_feed_copies():
    _, td = _datasets(dataset_kwargs={"num_events": 10, "trace_samples": 300})
    ts = tp.RawStore.build(td)
    cache = tp.DeviceEpochCache(ts, "cpu")
    assert cache.nbytes == ts.nbytes
    for k, v in _leaves(ts.arrays).items():
        assert _leaves(cache.arrays)[k].tobytes() == v.tobytes(), k
    item = next(tp.iter_raw_batches(ts, 0, seed=3, shuffle=True, batch_size=4))
    rows, idx, aug = tp.raw_batch_tensors(item)
    item[0]["data"][...] = 0.0  # the slab refilled: the batch does not alias it
    assert float(rows["data"].abs().sum()) > 0
    assert idx.dtype.is_floating_point is False and aug.dtype.__repr__() == "torch.bool"
