"""The port's packed-shard data plane against ``seist_tpu.data.packed`` and
``seist_tpu.data.pipeline``, on the CPU.

* The port reads packs written by the JAX package (float32, bfloat16 and
  int8, several shards; a DiTing-light HDF5 fixture with keys and missing
  labels): the same events, splits and rows.
* A pack written by the port has the JAX pack's ``.bin`` bytes and the same
  index and sidecar arrays (npz zips carry timestamps, so arrays are
  compared), in each storage dtype, for one source and for a mixture.
* A parallel pack equals a serial one, a resumed pack packs only its holes,
  and mismatched sources, multi-event windows and dtype mixes are refused.
* bfloat16 without ml_dtypes gives ml_dtypes' bytes; mixture orders equal
  the JAX package's.
* ``Loader`` batches on one pack are byte-identical to the JAX Loader's with
  threads and with processes, under a mixture temperature, with injected
  corrupt and flaky reads (the quarantine reports equal too) and with a
  truncated shard.

The JAX side runs its numpy path (``seist_tpu.native._lib = None``): the
optional wavekit library rounds in its own order.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

import seist_tpu
from seist_tpu import native
from seist_tpu import taskspec as jts
from seist_tpu.data import packed as jpk
from seist_tpu.data import pipeline as jp

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.data import packed as tpk
from seist_tpu_torch.data import pipeline as tp

ROOT = Path(__file__).resolve().parent.parent
DTYPES = ["float32", "bfloat16", "int8"]


@pytest.fixture(autouse=True)
def _numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    seist_tpu.load_all()
    seist_tpu_torch.load_all()


def _synthetic(module, n_events=30, trace_samples=512):
    return module.PackSource(
        name="synthetic",
        dataset_kwargs={"num_events": n_events, "trace_samples": trace_samples, "cache": False},
    )


def _fingerprint(root):
    """Every shard's bytes and every npz's arrays (the identity of a pack)."""
    out = {}
    for f in sorted(os.listdir(root)):
        p = os.path.join(root, f)
        if f.endswith(".bin"):
            out[f] = Path(p).read_bytes()
        elif f.endswith(".npz"):
            with np.load(p, allow_pickle=False) as z:
                out[f] = {k: (z[k].dtype.str, z[k].tolist()) for k in sorted(z.files)}
        elif f == "meta.json":
            out[f] = json.loads(Path(p).read_text())
    return out


# ------------------------------------------------------------ reading JAX packs
@pytest.fixture(scope="module")
def diting_src(tmp_path_factory):
    from tools.fixtures import write_diting_light_fixture

    root = str(tmp_path_factory.mktemp("diting"))
    write_diting_light_fixture(root, n_events=24, trace_samples=768, n_parts=2)
    return root


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_reads_a_jax_pack_event_for_event(diting_src, tmp_path, dtype):
    seist_tpu.load_all()
    out = str(tmp_path / "pack")
    stats = jpk.pack_sources([jpk.PackSource(name="diting_light", data_dir=diting_src)], out,
                             samples_per_shard=5, dtype=dtype)
    assert stats["shards"] == 5
    for mode in ("train", "val", "test"):
        want = jpk.PackedDataset(seed=11, mode=mode, data_dir=out)
        got = tpk.PackedDataset(seed=11, mode=mode, data_dir=out)
        assert len(got) == len(want) > 0 and got.dtype == dtype
        for i in range(len(got)):
            ev_j, row_j = want[i]
            ev_t, row_t = got[i]
            assert ev_t["data"].dtype == np.float32
            np.testing.assert_array_equal(ev_t["data"], ev_j["data"])  # exact, all dtypes
            for f in ("ppks", "spks", "emg", "smg", "pmp", "clr", "baz", "dis"):
                assert ev_t[f] == ev_j[f], (i, f)
                assert [type(v) for v in ev_t[f]] == [type(v) for v in ev_j[f]]
            np.testing.assert_array_equal(ev_t["snr"], ev_j["snr"])
            assert {k: str(v) for k, v in row_t.items()} == {k: str(v) for k, v in row_j.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_pack_is_byte_identical_to_the_jax_pack(tmp_path, dtype):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    sj = jpk.pack_sources([_synthetic(jpk)], a, samples_per_shard=7, dtype=dtype)
    st = tpk.pack_sources([_synthetic(tpk)], b, samples_per_shard=7, dtype=dtype)
    assert st["shards"] == sj["shards"] == 5
    for key in ("samples", "bytes", "on_disk_bytes", "bytes_vs_fp32", "samples_per_shard"):
        assert st[key] == sj[key], key
    assert _fingerprint(b) == _fingerprint(a)


def test_shard_mb_plans_like_the_jax_packer(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    sj = jpk.pack_sources([_synthetic(jpk, 20, 1000)], a, shard_mb=0.03, dtype="bfloat16")
    st = tpk.pack_sources([_synthetic(tpk, 20, 1000)], b, shard_mb=0.03, dtype="bfloat16")
    assert st["samples_per_shard"] == sj["samples_per_shard"] == 5
    assert _fingerprint(b) == _fingerprint(a)


def test_mixture_pack_provenance_matches_jax(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jpk.pack_sources([_synthetic(jpk, 10, 256), _synthetic(jpk, 17, 256)], a,
                     samples_per_shard=4)
    tpk.pack_sources([_synthetic(tpk, 10, 256), _synthetic(tpk, 17, 256)], b,
                     samples_per_shard=4)
    assert _fingerprint(b) == _fingerprint(a)
    ds = tpk.PackedDataset(seed=0, mode="train", data_dir=b, shuffle=False, data_split=False)
    sids = ds.source_ids()
    assert sids.shape == (27,) and (sids[:10] == 0).all() and (sids[10:] == 1).all()
    assert [s["n_events"] for s in ds.sources()] == [10, 17]
    for mode in ("train", "test"):
        np.testing.assert_array_equal(
            tpk.PackedDataset(seed=4, mode=mode, data_dir=b).source_ids(),
            jpk.PackedDataset(seed=4, mode=mode, data_dir=a).source_ids())
    single = tpk.pack_sources([_synthetic(tpk, 8, 256)], str(tmp_path / "one"))["out"]
    assert tpk.PackedDataset(seed=0, mode="train", data_dir=single).source_ids() is None


# ------------------------------------------------- parallel / resume / refusals
def test_parallel_pack_equals_serial(tmp_path):
    a, b = str(tmp_path / "serial"), str(tmp_path / "par")
    s1 = tpk.pack_sources([_synthetic(tpk)], a, samples_per_shard=7, dtype="int8")
    s2 = tpk.pack_sources([_synthetic(tpk)], b, num_workers=2, samples_per_shard=7,
                          dtype="int8")
    assert s1["shards"] == s2["shards"] > 1 and s2["samples"] == 30
    assert _fingerprint(a) == _fingerprint(b)


def test_pack_resume_skips_complete_shards(tmp_path):
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    tpk.pack_sources([_synthetic(tpk)], full, samples_per_shard=7)
    tpk.pack_sources([_synthetic(tpk)], part, samples_per_shard=7)
    # An interrupted pack: no meta/index yet, shard 1's sidecar missing,
    # shard 2 gone, shard 3's bin truncated.
    for f in ("meta.json", "index.npz"):
        os.unlink(os.path.join(part, f))
    os.unlink(tpk.sidecar_path(part, 1))
    os.unlink(tpk.shard_path(part, 2))
    os.unlink(tpk.sidecar_path(part, 2))
    with open(tpk.shard_path(part, 3), "r+b") as f:
        f.truncate(100)
    stats = tpk.pack_sources([_synthetic(tpk)], part, samples_per_shard=7)
    assert stats["shards_skipped"] == stats["shards"] - 3
    assert stats["samples_packed"] == 3 * 7
    assert _fingerprint(full) == _fingerprint(part)


class _Source:
    """A minimal in-memory source dataset."""

    def __init__(self, event, fs=50, name="mem"):
        self._event, self._fs, self._name = event, fs, name

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return dict(self._event), {"key": "k"}

    def name(self):
        return self._name

    def channels(self):
        return ["z", "n", "e"]

    def sampling_rate(self):
        return self._fs


def test_mixture_refuses_mismatched_sources(tmp_path):
    other = tpk.PackSource(dataset=_Source({"data": np.zeros((3, 64), np.float32)}, fs=100))
    with pytest.raises(ValueError, match="sampling rate"):
        tpk.pack_sources([_synthetic(tpk, 4, 128), other], str(tmp_path / "bad"))


def test_pack_refuses_multi_event_windows(tmp_path):
    two = _Source({"data": np.zeros((3, 64), np.float32), "ppks": [1, 2], "snr": np.zeros(3)})
    with pytest.raises(ValueError, match="one event per window"):
        tpk.pack_dataset(two, str(tmp_path / "out"))


@pytest.mark.parametrize("first,then", [("float32", "int8"), ("int8", "bfloat16")])
def test_pack_refuses_a_dtype_mix(tmp_path, first, then):
    out = str(tmp_path / "mix")
    tpk.pack_sources([_synthetic(tpk, 8, 256)], out, dtype=first)
    with pytest.raises(tpk.DtypeMixError):
        tpk.pack_sources([_synthetic(tpk, 8, 256)], out, dtype=then)
    # --no-resume rewrites the directory instead.
    assert tpk.pack_sources([_synthetic(tpk, 8, 256)], out, dtype=then, resume=False)[
        "dtype"] == then


def test_pack_command_prints_a_verdict_and_refuses_a_mix(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    base = [sys.executable, "-m", "seist_tpu_torch", "pack", "--dataset", "synthetic",
            "--dataset-kwargs", '{"num_events": 12, "trace_samples": 256}',
            "--out", str(tmp_path / "p"), "--samples-per-shard", "5"]
    runs = [subprocess.run(base + extra, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=120)
            for extra in ([], [], ["--dtype", "int8"])]
    first, again, mixed = (json.loads(r.stdout.strip().splitlines()[-1]) for r in runs)
    assert [r.returncode for r in runs] == [0, 0, 2]
    assert (first["shards"], first["samples"], first["dtype"]) == (3, 12, "float32")
    assert again["shards_skipped"] == 3 and again["samples_packed"] == 0
    assert mixed["ok"] is False and mixed["error"] == "dtype_mix"


# ---------------------------------------------------------- storage and orders
def test_bfloat16_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x7FC00001, 0x7F800001, 0xFF800001, 0xFFFFFFFF, 0x7F800000,
                        0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x80008000,
                        0x00018000, 0x3F808000, 0x3F818000, 0x3F817FFF, 0], np.uint32)
    x = np.concatenate([bits, special]).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = tpk.float32_to_bf16(x)
    np.testing.assert_array_equal(got, want)
    back = tpk.bf16_to_float32(got)
    finite = np.isfinite(back)
    np.testing.assert_array_equal(back[finite], want.view(ml_dtypes.bfloat16)[finite]
                                  .astype(np.float32))


@pytest.mark.parametrize("seed,epoch,temperature", [(0, 0, 1.0), (3, 2, 2.0), (7, 5, 0.5),
                                                     (11, 1, 100.0)])
def test_mixture_epoch_indices_match_jax(seed, epoch, temperature):
    sids = np.repeat([0, 1, 2], [40, 7, 13])
    got = tp.mixture_epoch_indices(sids, seed=seed, epoch=epoch, temperature=temperature)
    np.testing.assert_array_equal(got, jp.mixture_epoch_indices(
        sids, seed=seed, epoch=epoch, temperature=temperature))
    np.testing.assert_array_equal(
        tp._epoch_order(60, seed=seed, epoch=epoch, shuffle=True, source_ids=sids,
                        mixture_temperature=temperature), got)


def test_mixture_order_refuses_bad_input():
    with pytest.raises(ValueError, match="> 0"):
        tp.mixture_epoch_indices(np.array([0, 1]), seed=0, epoch=0, temperature=0.0)
    with pytest.raises(ValueError, match=">= 2 sources"):
        tp.mixture_epoch_indices(np.zeros(5, int), seed=0, epoch=0, temperature=1.0)


# ----------------------------------------------------------------- the Loader
@pytest.fixture(scope="module")
def mixture_pack(tmp_path_factory):
    """A two-source float32 pack over four shards (JAX-written: the port
    writes the same bytes, pinned above)."""
    out = str(tmp_path_factory.mktemp("mixture") / "pack")
    seist_tpu.load_all()
    jpk.pack_sources([_synthetic(jpk, 16, 900), _synthetic(jpk, 14, 900)], out,
                     samples_per_shard=8)
    return out


AUG = dict(augmentation=True, shift_event_rate=0.3, add_noise_rate=0.4, add_gap_rate=0.4,
           drop_channel_rate=0.4, scale_amplitude_rate=0.4, pre_emphasis_rate=0.4,
           generate_noise_rate=0.1, max_event_num=1)


def _loaders(data_dir, mode="train", processes=0, temperature=0.0, **kw):
    common = dict(seed=5, in_samples=512, data_dir=data_dir, **AUG, **kw)
    jd = jp.from_task_spec(jts.get_task_spec("seist_s_dpk"), "packed", mode, **common)
    td = tp.from_task_spec(tts.get_task_spec("seist_s_dpk"), "packed", mode, **common)
    train = mode == "train"
    jl = jp.Loader(jd, 6, shuffle=train, drop_last=train, num_workers=3, seed=5,
                   mixture_temperature=temperature)
    tl = tp.Loader(td, 6, shuffle=train, drop_last=train, num_workers=2, seed=5,
                   worker_processes=processes, mixture_temperature=temperature)
    return jl, tl


def _same_batches(jl, tl, epochs=(0, 1)):
    n = 0
    try:
        for e in epochs:
            jl.set_epoch(e)
            tl.set_epoch(e)
            for a, b in zip(jl, tl, strict=True):
                assert a.inputs.tobytes() == b.inputs.tobytes()
                assert a.loss_targets.tobytes() == b.loss_targets.tobytes()
                assert a.metrics_targets.keys() == b.metrics_targets.keys()
                for k in a.metrics_targets:
                    assert a.metrics_targets[k].tobytes() == b.metrics_targets[k].tobytes(), k
                assert a.meta == b.meta
                assert a.mask.tobytes() == b.mask.tobytes()
                n += 1
    finally:
        jl.close()
        tl.close()
    return n


@pytest.mark.parametrize("case", ["threads", "processes", "mixture", "val"])
def test_loader_batches_are_byte_identical_to_jax(mixture_pack, case):
    jl, tl = _loaders(mixture_pack, mode="val" if case == "val" else "train",
                      processes=2 if case == "processes" else 0,
                      temperature=2.0 if case == "mixture" else 0.0)
    assert len(tl) == len(jl) > 0
    assert _same_batches(jl, tl) == 2 * len(tl)


def test_loader_under_injected_faults_matches_jax(mixture_pack, monkeypatch):
    monkeypatch.setenv("SEIST_FAULT_IO_CORRUPT", "2,5,9")
    monkeypatch.setenv("SEIST_FAULT_IO_FLAKY_P", "0.2")
    jl, tl = _loaders(mixture_pack, max_quarantine_frac=0.5)
    assert _same_batches(jl, tl, epochs=(0,)) == len(tl)
    report = tl.dataset.quarantine_report()
    assert report == jl.dataset.quarantine_report()
    assert report["quarantined"] == [2, 5, 9]


def test_loader_on_a_truncated_shard_matches_jax(mixture_pack, tmp_path):
    data = str(tmp_path / "pack")
    shutil.copytree(mixture_pack, data)
    with open(tpk.shard_path(data, 1), "r+b") as f:  # source 0's last 8 samples
        f.truncate(3 * 3 * 900 * 4 + 100)
    jl, tl = _loaders(data, max_quarantine_frac=0.5)
    assert _same_batches(jl, tl, epochs=(0,)) == len(tl)
    report = tl.dataset.quarantine_report()
    assert report == jl.dataset.quarantine_report()
    assert report["quarantined"] and all("short read" in r for r in report["reasons"].values())


def test_a_pack_of_the_synthetic_dataset_trains_on_the_same_bytes(tmp_path):
    """The card's packed phase holds its losses to the synthetic run's: the
    train batches of a pack (seed 0) are the synthetic dataset's, byte for
    byte, apart from the metadata."""
    out = str(tmp_path / "pack")
    tpk.pack_sources([_synthetic(tpk, 40, 900)], out, samples_per_shard=9)
    common = dict(seed=0, in_samples=512, **AUG)
    spec = tts.get_task_spec("seist_s_dpk")
    a = tp.from_task_spec(spec, "synthetic", "train",
                          dataset_kwargs={"num_events": 40, "trace_samples": 900}, **common)
    b = tp.from_task_spec(spec, "packed", "train", data_dir=out, **common)
    la, lb = (tp.Loader(d, 8, shuffle=True, drop_last=True, num_workers=2) for d in (a, b))
    try:
        for x, y in zip(la, lb, strict=True):
            assert x.inputs.tobytes() == y.inputs.tobytes()
            assert x.loss_targets.tobytes() == y.loss_targets.tobytes()
            for k in x.metrics_targets:
                assert x.metrics_targets[k].tobytes() == y.metrics_targets[k].tobytes(), k
    finally:
        la.close()
        lb.close()


def test_int8_poison_and_bad_scales_are_corruption_like_jax(tmp_path):
    out = str(tmp_path / "pack")
    tpk.pack_sources([_synthetic(tpk, 6, 128)], out, dtype="int8")
    with open(tpk.shard_path(out, 0), "r+b") as f:  # row 1, channel 0, sample 5
        f.seek(1 * 3 * 128 + 5)
        f.write(np.int8(tpk.INT8_POISON).tobytes())
    with np.load(os.path.join(out, "index.npz")) as z:
        cols = {k: z[k] for k in z.files}
    cols["scale_2"][4] = np.nan
    np.savez(os.path.join(out, "index.npz"), **cols)
    for i, match in ((1, "out-of-contract -128"), (4, "non-finite int8 scale")):
        with pytest.raises(tpk.CorruptSampleError, match=match) as mine:
            tpk.PackedDataset(seed=0, mode="train", data_dir=out, shuffle=False,
                              data_split=False)[i]
        with pytest.raises(Exception) as theirs:
            jpk.PackedDataset(seed=0, mode="train", data_dir=out, shuffle=False,
                              data_split=False)[i]
        assert str(mine.value) == str(theirs.value)


def test_a_packed_dataset_pickles_without_its_memmaps(tmp_path):
    import pickle

    out = tpk.pack_sources([_synthetic(tpk, 6, 128)], str(tmp_path / "p"))["out"]
    ds = tpk.PackedDataset(seed=0, mode="train", data_dir=out)
    first = ds[0][0]["data"]
    assert ds._mmaps
    clone = pickle.loads(pickle.dumps(ds))
    assert clone._mmaps == {} and len(pickle.dumps(ds)) < 20_000
    np.testing.assert_array_equal(clone[0][0]["data"], first)


def test_a_failing_memmap_is_dropped_and_counted(tmp_path):
    class Gone:
        def __getitem__(self, key):
            raise OSError("stale handle")

    before = tpk.COUNTERS.snapshot()["reopens"]
    mmaps = {0: Gone()}
    with pytest.raises(OSError):
        tpk.read_waveform_slice(mmaps, str(tmp_path), 0, 0, 8, desc="x")
    assert mmaps == {} and tpk.COUNTERS.snapshot()["reopens"] - before == 1
