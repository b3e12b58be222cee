"""Packed-shard datasets: the packer and the ``packed`` reader (the port's
copy of ``seist_tpu/data/packed.py``; same files, same bytes).

A pack directory holds:

* ``shard_XXXXX.bin`` — the waveforms, C-order ``(C, L)`` rows
  concatenated, in the pack's storage dtype (float32, bfloat16 or int8),
  read through a per-process ``np.memmap``;
* ``shard_XXXXX.bin.idx.npz`` — the shard's columnar sidecar (byte offset,
  shape, every label field, source id), written atomically AFTER the
  ``.bin``: its presence marks the shard complete for a resumed pack;
* ``index.npz`` — every sidecar merged, plus a ``shard`` column; the
  reader loads it into the numpy column table of
  :class:`~seist_tpu_torch.data.base.DatasetBase`, whose seeded
  shuffle-then-split is the JAX package's, so a seed gives the same split
  in both packages and as the source dataset;
* ``meta.json`` — source name(s), channels, sampling rate, counts, dtype;
  written LAST, and a directory without it is refused.

The shard partition is a pure function of the source sizes and the
capacity knobs, planned before any bytes move, so an N-worker pack is
byte-identical to a serial one, an interrupted pack resumes at its first
incomplete shard, and several datasets pack into one directory (a
mixture, with a ``source_id`` column) for temperature-weighted sampling
(``pipeline.mixture_epoch_indices``).

bfloat16 without ``ml_dtypes``: a bfloat16 shard is read as ``uint16`` and
widened by a 16-bit shift, which is exact; it is written by rounding the
float32 bit pattern to nearest even, with NaN made the quiet NaN of its
sign, which gives the bytes ``ml_dtypes.bfloat16`` gives.

HDF5 sources (DiTing, PNW, SOS) are packed by the JAX package's
``python -m tools.pack_dataset`` on a machine with h5py; this module packs
the port's own registered datasets and reads any pack.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from seist_tpu_torch.data.base import DatasetBase, Event, Meta
from seist_tpu_torch.data.io_guard import COUNTERS, CorruptSampleError
from seist_tpu_torch.registry import register_dataset
from seist_tpu_torch.utils.logger import logger

_INDEX = "index.npz"
_META = "meta.json"
_SIDECAR_SUFFIX = ".idx.npz"

# Event fields packed as scalar-or-NaN columns, in a fixed order.
_SCALAR_FIELDS = ("ppks", "spks", "emg", "smg", "pmp", "clr", "baz", "dis")
_INT_FIELDS = frozenset({"ppks", "spks", "pmp", "clr"})

# Sidecar/index column dtypes (keys excluded; they stay str).
_INT_COLS = (
    "shard", "offset", "n_ch", "n_samp", "source_id",
    "total_bytes", "plan_lo", "plan_hi", "storage_itemsize",
)
# Per-shard bookkeeping columns that never reach the merged index.
_SIDECAR_ONLY = ("total_bytes", "plan_lo", "plan_hi", "storage_itemsize")

_DTYPE_ALIASES = {"fp32": "float32", "bf16": "bfloat16", "i8": "int8"}

#: int8 per-channel scale columns (format v3), NaN-padded to 3 channels.
_SCALE_COLS = ("scale_0", "scale_1", "scale_2")

#: Symmetric int8 quantization never emits -128, so a -128 byte in a
#: shard is the poison marker of a corrupt int8 row.
INT8_POISON = -128


def canonical_dtype(name: str) -> str:
    name = _DTYPE_ALIASES.get(str(name).lower(), str(name).lower())
    if name not in ("float32", "bfloat16", "int8"):
        raise ValueError(
            f"unsupported packed storage dtype '{name}' (use float32, bfloat16 or int8)"
        )
    return name


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a pack's waveform bytes are read as: bfloat16 rows
    are read as their ``uint16`` bit patterns (:func:`bf16_to_float32`)."""
    return np.dtype({"float32": np.float32, "bfloat16": np.uint16, "int8": np.int8}[
        canonical_dtype(name)])


def float32_to_bf16(data: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (``uint16``) of float32 ``data``: round to
    nearest even on the bit pattern; NaN becomes the quiet NaN of its sign
    (0x7FC0 / 0xFFC0). Bit for bit what ``ml_dtypes.bfloat16`` gives."""
    bits = np.ascontiguousarray(data, np.float32).view(np.uint32).astype(np.uint64)
    out = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(data)
    if nan.any():
        out[nan] = np.where((bits[nan] >> 31) != 0, 0xFFC0, 0x7FC0)
    return out


def bf16_to_float32(bits: np.ndarray) -> np.ndarray:
    """Widen bfloat16 bit patterns (``uint16``) to float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def quantize_rows(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization of one ``(C, L)`` float32
    waveform: ``scale = max|x| / 127``, ``q = clip(round(x / scale), -127,
    127)``. Returns ``(q int8 (C, L), scale float32 (C,))``."""
    data = np.asarray(data, np.float32)
    scale = (np.maximum(np.abs(data).max(axis=1), 1e-8) / 127.0).astype(np.float32)
    q = np.clip(np.round(data / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


class DtypeMixError(ValueError):
    """The pack directory already holds shards across the quantized/float
    boundary from what this run asks for: int8 packs carry scale columns
    float packs lack, so the mix is refused."""

    def __init__(self, existing: str, requested: str, out_dir: str):
        self.existing = existing
        self.requested = requested
        self.out_dir = out_dir
        super().__init__(
            f"pack dir {out_dir} already holds {existing} shards; "
            f"refusing to mix with --dtype {requested} (int8 packs carry "
            "a scale sidecar column float packs lack). Pack into a fresh "
            "directory, or rewrite this one with --no-resume."
        )


def shard_path(out_dir: str, shard_id: int) -> str:
    return os.path.join(out_dir, f"shard_{shard_id:05d}.bin")


def sidecar_path(out_dir: str, shard_id: int) -> str:
    return shard_path(out_dir, shard_id) + _SIDECAR_SUFFIX


# ------------------------------------------------------------------- planning
@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One shard: source ``source_id``'s samples ``[lo, hi)``."""

    shard_id: int
    source_id: int
    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


def _samples_per_shard(sample_nbytes: int, shard_mb: float) -> int:
    """How many sample-0 sized waveforms fit in ``shard_mb``."""
    return max(1, int(shard_mb * 1_000_000) // max(int(sample_nbytes), 1))


def plan_shards(
    sources: Sequence[Any],
    *,
    samples_per_shard: Optional[int] = None,
    shard_mb: float = 512,
    dtype: str = "float32",
) -> Tuple[List[ShardPlan], List[int]]:
    """The shard partition, a pure function of the source lengths and the
    capacity knobs (never of the worker count or of the shards on disk).
    Returns ``(plans, per-source capacities)``. Sources occupy consecutive
    shard ranges; with only ``shard_mb``, each source's capacity comes from
    its sample 0."""
    caps: List[int] = []
    for src in sources:
        if samples_per_shard is not None:
            caps.append(max(1, int(samples_per_shard)))
            continue
        event0, _ = src[0]
        nbytes0 = (
            np.ascontiguousarray(event0["data"], dtype=np.float32).size
            * storage_dtype(dtype).itemsize
        )
        caps.append(_samples_per_shard(nbytes0, shard_mb))
    plans: List[ShardPlan] = []
    shard_id = 0
    for source_id, src in enumerate(sources):
        n = len(src)
        sps = caps[source_id]
        for lo in range(0, n, sps):
            plans.append(ShardPlan(shard_id, source_id, lo, min(lo + sps, n)))
            shard_id += 1
    return plans, caps


# ---------------------------------------------------------------- shard write
def _new_cols(quantized: bool = False) -> Dict[str, list]:
    return {
        **{f: [] for f in _SCALAR_FIELDS},
        "snr_0": [],
        "snr_1": [],
        "snr_2": [],
        **({c: [] for c in _SCALE_COLS} if quantized else {}),
        "offset": [],
        "n_ch": [],
        "n_samp": [],
        "key": [],
    }


def _append_sample(cols: Dict[str, list], event: Event, row: Any, i: int) -> None:
    for f in _SCALAR_FIELDS:
        v = event.get(f, [])
        if len(v) > 1:
            raise ValueError(
                f"event {i}: field {f} has {len(v)} values; the "
                "packed format stores one event per window"
            )
        cols[f].append(float(v[0]) if len(v) else np.nan)
    snr = np.asarray(event.get("snr", []), dtype=np.float64).ravel()
    for c in range(3):
        cols[f"snr_{c}"].append(float(snr[c]) if c < snr.size else np.nan)
    cols["key"].append(str(row.get("key", i)) if isinstance(row, dict) else str(i))


def _col_array(name: str, values: list) -> np.ndarray:
    if name in _INT_COLS:
        return np.asarray(values, np.int64)
    if name == "key":
        return np.asarray(values, str)
    return np.asarray(values, np.float64)


def _write_atomic_npz(path: str, cols: Dict[str, Any]) -> None:
    tmp = path + ".tmp.npz"  # suffix .npz so np.savez appends none
    np.savez(tmp, **{k: _col_array(k, v) for k, v in cols.items()})
    os.replace(tmp, path)


def pack_shard(src, out_dir: str, plan: ShardPlan, *, dtype: str = "float32") -> Dict[str, int]:
    """Pack ONE shard: the plan's samples streamed into ``shard_XXXXX.bin``
    (through a ``.tmp`` rename), then its sidecar, whose rename commits the
    shard: a kill at any instant leaves a complete shard or a hole."""
    dtype = canonical_dtype(dtype)
    store_dt = storage_dtype(dtype)
    quantized = dtype == "int8"
    cols = _new_cols(quantized)
    total = 0
    bin_path = shard_path(out_dir, plan.shard_id)
    tmp_bin = bin_path + ".tmp"
    try:
        with open(tmp_bin, "wb") as f:
            for j in range(plan.lo, plan.hi):
                event, row = src[j]
                data = np.ascontiguousarray(event["data"], dtype=np.float32)
                if data.ndim != 2:
                    raise ValueError(f"event {j}: data must be (C, L), got {data.shape}")
                if quantized:
                    if data.shape[0] > len(_SCALE_COLS):
                        raise ValueError(
                            f"event {j}: int8 packs support up to "
                            f"{len(_SCALE_COLS)} channels (scale sidecar "
                            f"columns), got {data.shape[0]}"
                        )
                    data, scale = quantize_rows(data)
                    for c in range(len(_SCALE_COLS)):
                        cols[f"scale_{c}"].append(float(scale[c]) if c < scale.size else np.nan)
                elif dtype == "bfloat16":
                    data = float32_to_bf16(data)
                f.write(data.tobytes())
                _append_sample(cols, event, row, j)
                cols["offset"].append(total)
                cols["n_ch"].append(data.shape[0])
                cols["n_samp"].append(data.shape[1])
                total += data.nbytes
    except BaseException:
        try:
            os.unlink(tmp_bin)
        except OSError:
            pass
        raise
    os.replace(tmp_bin, bin_path)
    cols["source_id"] = [plan.source_id] * plan.n
    cols["total_bytes"] = [total]
    # Plan identity: a resume whose re-plan gives this shard another
    # sample range or storage dtype repacks it (sources are assumed
    # immutable; --no-resume after editing one in place).
    cols["plan_lo"] = [plan.lo]
    cols["plan_hi"] = [plan.hi]
    cols["storage_itemsize"] = [store_dt.itemsize]
    _write_atomic_npz(sidecar_path(out_dir, plan.shard_id), cols)
    return {"samples": plan.n, "bytes": total}


def shard_complete(out_dir: str, plan: ShardPlan, *, dtype: str = "float32") -> bool:
    """A shard is complete iff its sidecar exists and describes the plan's
    samples and storage dtype, and its ``.bin`` has exactly the byte length
    the sidecar recorded."""
    side = sidecar_path(out_dir, plan.shard_id)
    bin_p = shard_path(out_dir, plan.shard_id)
    if not (os.path.exists(side) and os.path.exists(bin_p)):
        return False
    try:
        with np.load(side, allow_pickle=False) as z:
            total = int(z["total_bytes"][0])
            n = int(z["offset"].shape[0])
            source_id = int(z["source_id"][0]) if n else plan.source_id
            lo = int(z["plan_lo"][0])
            hi = int(z["plan_hi"][0])
            itemsize = int(z["storage_itemsize"][0]) if "storage_itemsize" in z.files else 4
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return False  # a torn or older sidecar: repack the shard
    return (
        n == plan.n
        and source_id == plan.source_id
        and (lo, hi) == (plan.lo, plan.hi)
        and itemsize == storage_dtype(dtype).itemsize
        and os.path.getsize(bin_p) == total
    )


# --------------------------------------------------------------- orchestration
@dataclasses.dataclass
class PackSource:
    """One pack input: a live dataset, or a registered dataset's name,
    directory and keyword arguments that every pack worker can build for
    itself."""

    name: str = ""
    data_dir: str = ""
    dataset_kwargs: Optional[dict] = None
    dataset: Any = None

    def create(self) -> Any:
        if self.dataset is not None:
            return self.dataset
        from seist_tpu_torch.registry import DATASETS

        register_datasets()
        # Pack order is the source metadata order: no shuffle, no split.
        self.dataset = DATASETS.create(
            self.name,
            seed=0,
            mode="train",
            data_dir=self.data_dir,
            shuffle=False,
            data_split=False,
            **(self.dataset_kwargs or {}),
        )
        return self.dataset


def register_datasets() -> None:
    """Register the port's datasets without importing the models (a pack
    worker needs no torch)."""
    from seist_tpu_torch.data import synthetic  # noqa: F401


_POOL_SOURCES: Optional[List[Any]] = None


def _pack_pool_init(sources: List[PackSource]) -> None:
    global _POOL_SOURCES
    _POOL_SOURCES = [s.create() for s in sources]


def _pack_pool_shard(job: Tuple[str, ShardPlan, str]) -> Dict[str, int]:
    out_dir, plan, dtype = job
    return pack_shard(_POOL_SOURCES[plan.source_id], out_dir, plan, dtype=dtype)


def merge_index(out_dir: str, plans: Sequence[ShardPlan]) -> Dict[str, np.ndarray]:
    """Concatenate every sidecar (in shard order) into ``index.npz`` with
    the per-row ``shard`` column added. Returns the merged columns."""
    merged: Dict[str, List[Any]] = {}
    for plan in plans:
        with np.load(sidecar_path(out_dir, plan.shard_id), allow_pickle=False) as z:
            for k in z.files:
                if k in _SIDECAR_ONLY:
                    continue
                merged.setdefault(k, []).append(z[k])
            merged.setdefault("shard", []).append(np.full(plan.n, plan.shard_id, np.int64))
    arrays = {k: np.concatenate(v) for k, v in merged.items()}
    _write_atomic_npz(os.path.join(out_dir, _INDEX), arrays)
    return arrays


def _existing_pack_dtype(out_dir: str) -> Optional[str]:
    """The canonical dtype of what already lives in ``out_dir``: meta.json
    when the pack committed, else the first readable sidecar; None when
    the directory holds no pack."""
    meta_p = os.path.join(out_dir, _META)
    if os.path.exists(meta_p):
        try:
            with open(meta_p) as f:
                return canonical_dtype(json.load(f).get("dtype", "float32"))
        except (OSError, ValueError, KeyError):
            return None
    try:
        sidecars = sorted(f for f in os.listdir(out_dir) if f.endswith(_SIDECAR_SUFFIX))
    except OSError:
        return None
    for name in sidecars:
        try:
            with np.load(os.path.join(out_dir, name), allow_pickle=False) as z:
                if "scale_0" in z.files:
                    return "int8"
                itemsize = int(z["storage_itemsize"][0]) if "storage_itemsize" in z.files else 4
            return {1: "int8", 2: "bfloat16"}.get(itemsize, "float32")
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            continue
    return None


def pack_sources(
    sources: Sequence[PackSource],
    out_dir: str,
    *,
    num_workers: int = 0,
    samples_per_shard: Optional[int] = None,
    shard_mb: float = 512,
    resume: bool = True,
    dtype: str = "float32",
) -> Dict[str, Any]:
    """Pack one or more sources into ``out_dir``: parallel, resumable,
    mixture-capable. Returns the stats dict ``python -m seist_tpu_torch
    pack`` prints as its verdict."""
    dtype = canonical_dtype(dtype)
    t0 = time.monotonic()
    os.makedirs(out_dir, exist_ok=True)
    if resume:
        existing = _existing_pack_dtype(out_dir)
        if existing is not None and (existing == "int8") != (dtype == "int8"):
            raise DtypeMixError(existing, dtype, out_dir)
    datasets = [s.create() for s in sources]
    channels = list(datasets[0].channels())
    fs = int(datasets[0].sampling_rate())
    for ds in datasets[1:]:
        if list(ds.channels()) != channels or int(ds.sampling_rate()) != fs:
            raise ValueError(
                "mixture sources must share channels and sampling rate: "
                f"{ds.name()} has ({ds.channels()}, {ds.sampling_rate()}) "
                f"vs ({channels}, {fs})"
            )
    plans, caps = plan_shards(
        datasets, samples_per_shard=samples_per_shard, shard_mb=shard_mb, dtype=dtype
    )
    todo = [p for p in plans if not (resume and shard_complete(out_dir, p, dtype=dtype))]
    skipped = len(plans) - len(todo)
    if skipped:
        logger.info(
            f"pack resume: {skipped}/{len(plans)} shard(s) already "
            f"complete in {out_dir}; packing the remaining {len(todo)}"
        )

    stats = {"samples": 0, "bytes": 0}
    if todo:
        if num_workers and num_workers > 1:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # forkserver or spawn, never fork: a forked child of a process
            # that has touched CUDA fails at its first CUDA call, and one
            # forked from a threaded parent can inherit a held lock.
            try:
                ctx = multiprocessing.get_context("forkserver")
            except ValueError:
                ctx = multiprocessing.get_context("spawn")
            # Named sources travel as specs that each worker builds; a live
            # reader can hold state that pickles badly (a cached memmap
            # pickles as its whole shard).
            ship = [dataclasses.replace(s, dataset=None) if s.name else s for s in sources]
            with ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=ctx,
                initializer=_pack_pool_init,
                initargs=(ship,),
            ) as pool:
                for out in pool.map(_pack_pool_shard, [(out_dir, p, dtype) for p in todo]):
                    stats["samples"] += out["samples"]
                    stats["bytes"] += out["bytes"]
        else:
            for plan in todo:
                out = pack_shard(datasets[plan.source_id], out_dir, plan, dtype=dtype)
                stats["samples"] += out["samples"]
                stats["bytes"] += out["bytes"]

    arrays = merge_index(out_dir, plans)
    n_total = int(arrays["offset"].shape[0])
    meta = {
        "source": (
            datasets[0].name()
            if len(datasets) == 1
            else "mixture:" + "+".join(ds.name() for ds in datasets)
        ),
        "channels": channels,
        "sampling_rate": fs,
        "n_events": n_total,
        "n_shards": len(plans),
        # v3 = int8 waveforms + scale columns; float packs stay v2.
        "format_version": 3 if dtype == "int8" else 2,
        "dtype": dtype,
        "samples_per_shard": caps[0] if len(set(caps)) == 1 else caps,
        "sources": [
            {
                "source_id": sid,
                "name": ds.name(),
                "data_dir": getattr(sources[sid], "data_dir", ""),
                "n_events": len(ds),
                "samples_per_shard": caps[sid],
            }
            for sid, ds in enumerate(datasets)
        ],
    }
    # meta.json LAST: its presence commits the whole pack.
    tmp = os.path.join(out_dir, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(out_dir, _META))
    wall_s = time.monotonic() - t0
    logger.info(
        f"packed {n_total} events into {len(plans)} shard(s) at {out_dir} "
        f"({skipped} resumed, {wall_s:.1f}s)"
    )
    on_disk = sum(os.path.getsize(shard_path(out_dir, p.shard_id)) for p in plans)
    fp32_bytes = int((arrays["n_ch"] * arrays["n_samp"]).sum()) * 4
    return {
        "out": out_dir,
        "dtype": dtype,
        "shards": len(plans),
        "shards_skipped": skipped,
        "samples": n_total,
        "samples_packed": stats["samples"],
        "bytes": stats["bytes"],
        "on_disk_bytes": on_disk,
        "bytes_per_row": round(on_disk / max(n_total, 1), 1),
        "fp32_bytes_per_row": round(fp32_bytes / max(n_total, 1), 1),
        "bytes_vs_fp32": round(on_disk / max(fp32_bytes, 1), 4),
        "samples_per_shard": meta["samples_per_shard"],
        "sources": [s["name"] for s in meta["sources"]],
        "wall_s": round(wall_s, 2),
    }


def pack_dataset(
    src,
    out_dir: str,
    *,
    shard_mb: float = 512,
    samples_per_shard: Optional[int] = None,
    num_workers: int = 0,
    dtype: str = "float32",
) -> str:
    """Repack ``src`` (any dataset built with ``data_split=False``) into
    ``out_dir``. Returns ``out_dir``."""
    pack_sources(
        [PackSource(dataset=src)],
        out_dir,
        num_workers=num_workers,
        samples_per_shard=samples_per_shard,
        shard_mb=shard_mb,
        dtype=dtype,
    )
    return out_dir


# ---------------------------------------------------------------------- read
def read_waveform_slice(
    mmaps: Dict[int, np.memmap],
    data_dir: str,
    shard: int,
    off: int,
    nbytes: int,
    *,
    desc: str,
) -> np.ndarray:
    """THE raw-slice fault ladder of a packed shard: memmaps cached per
    shard in ``mmaps``; an ``OSError`` (the shard vanished, a page-in
    failed on a network mount) drops the cached map (counted as
    ``reopens``) and re-raises as a TRANSIENT fault, so the retry maps a
    fresh file; a short slice means a truncated shard, a PERMANENT fault
    (:class:`CorruptSampleError`). Returns the uint8 slice."""
    mm = mmaps.get(shard)
    if mm is None:
        mm = mmaps[shard] = np.memmap(shard_path(data_dir, shard), dtype=np.uint8, mode="r")
    try:
        raw = mm[off : off + nbytes]
    except OSError:
        if mmaps.pop(shard, None) is not None:
            COUNTERS.inc("reopens")
        raise
    if raw.size != nbytes:
        raise CorruptSampleError(
            f"{desc}: short read in shard {shard} (want {nbytes} bytes "
            f"at {off}, got {raw.size} — truncated shard?)"
        )
    return raw


class PackedDataset(DatasetBase):
    """Reader of a pack directory (registered as ``packed``): the Event
    contract of every dataset, a waveform read being one memmap slice and
    one float32 copy."""

    _name = "packed"

    def __init__(self, **kwargs):
        data_dir = kwargs.get("data_dir", "")
        with open(os.path.join(data_dir, _META)) as f:
            self._meta = json.load(f)
        self._dtype = canonical_dtype(self._meta.get("dtype", "float32"))
        self._storage_dtype = storage_dtype(self._dtype)
        self._mmaps: Dict[int, np.memmap] = {}
        super().__init__(**kwargs)

    # Instance-level overrides of the classmethod accessors: the values
    # come from meta.json, not the class.
    def name(self):  # type: ignore[override]
        return self._name

    def __repr__(self) -> str:
        return (
            f"Dataset(name:packed, source:{self._meta['source']}, "
            f"channels:{self._meta['channels']}, "
            f"sampling_rate:{self._meta['sampling_rate']}, "
            f"n_events:{self._meta['n_events']}, "
            f"n_shards:{self._meta['n_shards']}, "
            f"data_dir:{self._data_dir}, mode:{self._mode})"
        )

    def channels(self):  # type: ignore[override]
        return list(self._meta["channels"])

    def sampling_rate(self):  # type: ignore[override]
        return int(self._meta["sampling_rate"])

    @property
    def dtype(self) -> str:
        """The pack's storage dtype name (reads widen to float32)."""
        return self._dtype

    def sources(self) -> List[Dict[str, Any]]:
        """Provenance of a mixture pack (one entry per source)."""
        return list(
            self._meta.get(
                "sources",
                [{"source_id": 0, "name": self._meta["source"],
                  "n_events": self._meta["n_events"]}],
            )
        )

    def source_ids(self) -> Optional[np.ndarray]:
        """Per-sample source id (this split's row order) when the pack
        holds a mixture; ``None`` for a single source."""
        if len(self.sources()) <= 1 or "source_id" not in self._meta_data:
            return None
        return np.asarray(self._meta_data["source_id"])

    def _load_meta_data(self) -> Meta:
        with np.load(os.path.join(self._data_dir, _INDEX), allow_pickle=False) as z:
            meta = {k: z[k] for k in z.files}
        n = len(next(iter(meta.values())))
        if n != self._meta["n_events"]:
            raise ValueError(f"index has {n} rows, meta.json says {self._meta['n_events']}")
        return self._shuffle_and_split(meta)

    # Instances cross process boundaries (loader and pack workers), and a
    # cached np.memmap pickles as its whole shard: ship the state without
    # the maps; a worker maps the shards again at its first read.
    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        state["_mmaps"] = {}
        return state

    def _load_event_data(self, idx: int) -> Tuple[Event, dict]:
        row = self._row_dict(idx)
        c, length = int(row["n_ch"]), int(row["n_samp"])
        raw = read_waveform_slice(
            self._mmaps,
            self._data_dir,
            int(row["shard"]),
            int(row["offset"]),
            c * length * self._storage_dtype.itemsize,
            desc=f"packed (sample {idx})",
        )
        rows = np.frombuffer(raw, dtype=self._storage_dtype).reshape(c, length)
        if self._dtype == "bfloat16":
            data = bf16_to_float32(rows)
        else:
            data = rows.astype(np.float32)  # a copy out of the memmap
        if self._dtype == "int8":
            # int8 rows cannot carry NaN: their poison markers are the
            # out-of-contract -128 byte and a non-finite scale, both
            # permanent corruption.
            scale = np.array([row[f"scale_{ch}"] for ch in range(c)], np.float32)
            if data.min() <= INT8_POISON:
                raise CorruptSampleError(
                    f"packed (sample {idx}): int8 row holds the "
                    f"out-of-contract {INT8_POISON} byte (poisoned?)"
                )
            if not np.isfinite(scale).all():
                raise CorruptSampleError(
                    f"packed (sample {idx}): non-finite int8 scale {scale.tolist()}"
                )
            data *= scale[:, None]

        def scalar(field):
            v = row[field]
            if v != v:  # NaN
                return []
            return [int(v)] if field in _INT_FIELDS else [np.float32(v)]

        event: Event = {"data": data}
        for f in _SCALAR_FIELDS:
            event[f] = scalar(f)
        event["snr"] = np.array([row["snr_0"], row["snr_1"], row["snr_2"]])
        return event, row


@register_dataset
def packed(**kwargs):
    return PackedDataset(**kwargs)
