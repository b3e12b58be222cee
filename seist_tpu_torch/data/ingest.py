"""Direct ingest of packed shards for ``--device-aug step`` (the port's
counterpart of ``seist_tpu/data/ingest.py``).

On a packed dataset the shard file already holds contiguous waveform
rows, so the step path need not decode every event into a resident
:class:`~seist_tpu_torch.data.pipeline.RawStore`. :class:`PackedRawStore`
feeds it straight from the shards:

* **build** reads only the columnar index: phases and labels follow the
  ``host_prepare`` row contract, vectorised over the index, with
  ``RawStore.build``'s refusals; no waveform is read and host memory is
  O(index);
* **row_batch_at** copies each sample's bytes out of its shard's
  ``np.memmap`` into a float32 staging batch (bfloat16 rows widened and
  int8 rows dequantised by their scale on the way), one copy per sample.
  With ``stage_raw`` (int8 packs only) the int8 rows are staged as they
  are stored, beside a resident per-row ``data_scale`` column that rides
  the same gather as the labels (so a quarantine fallback keeps row and
  scale paired), and the consuming program dequantises on the device:
  batch re-picking's int8 path, whose rows cross the bus at a quarter of
  the float32 bytes;
* **the data-plane guard**: every row fill runs the fault ladder of the
  packed reader (``data/io_guard.py``): a transient ``OSError`` is
  retried with the memmap mapped anew; a short read, a non-finite value,
  an int8 poison byte or an injected ``SEIST_FAULT_IO_*`` fault
  quarantines the sample, replaced by the fallback keyed ``(seed, epoch,
  logical idx)`` of the dataset's :class:`~io_guard.Quarantine`, so a
  resumed run reads what the first one read. Over several data ranks each
  rank's store fills only its shard's rows (``pipeline.iter_raw_batches``),
  and the key stays the sample's global epoch index: a rank reads what one
  rank would read for the same sample;
* **telemetry**: the metrics bus's ``data_ingest_batches``, ``_samples``,
  ``_bytes`` and ``_int8_rows`` counters and the ``data_ingest_fill`` span
  of each batch's row fills (``obs/bus.py``), as in the JAX package.

Staging: the feed copies each batch out of its slab
(``pipeline.raw_batch_tensors``) before the next fill, so one slab is
reused (the JAX package keeps a ring of them, which ``device_put`` reads
while the next fills). Reuse is on where the train device is a GPU (the
worker passes ``reuse_staging``); ``SEIST_INGEST_REUSE_STAGING=0/1``
overrides, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from seist_tpu_torch import taskspec
from seist_tpu_torch.data import io_guard
from seist_tpu_torch.data.packed import INT8_POISON, PackedDataset, read_waveform_slice
from seist_tpu_torch.data.pipeline import RawStore, SeismicDataset, _tree_map
from seist_tpu_torch.data.preprocess import pad_phases
from seist_tpu_torch.obs.bus import BUS

# The invalid phase-slot sentinel of device_aug._BIG.
_BIG = 2**30


def packed_dataset_of(sds: SeismicDataset) -> Optional[PackedDataset]:
    """The :class:`PackedDataset` under ``sds`` when it reads a pack, else
    None: whether direct ingest applies."""
    ds = getattr(sds, "_dataset", None)
    return ds if isinstance(ds, PackedDataset) else None


class PackedRawStore(RawStore):
    """A :class:`RawStore` whose waveforms stay on disk: the per-sample
    phases, values and classes are resident, the ``data`` rows are filled
    per batch from the shard memmaps. It serves ``pipeline.iter_raw_batches``
    and the device-aug step path as a RawStore does."""

    def __init__(self, arrays: Dict[str, Any], *, n_raw: int, augmentation: bool, raw_len: int,
                 phase_slots: int, n_ch: int, data_dir: str, shards: np.ndarray,
                 offsets: np.ndarray, seed: int, quarantine: io_guard.Quarantine,
                 injector=None, batch_size: int = 0,
                 reuse_staging: Optional[bool] = None, pack_dtype: str = "float32",
                 storage_dtype: Optional[np.dtype] = None,
                 scales: Optional[np.ndarray] = None, stage_raw: bool = False) -> None:
        self.stage_raw = bool(stage_raw)
        if self.stage_raw and pack_dtype != "int8":
            raise ValueError("stage_raw staging is the int8 device-dequant path; "
                             f"this pack stores {pack_dtype}")
        if pack_dtype == "int8":
            if scales is None:
                raise ValueError("int8 packs need the per-row scale sidecar columns (scale_0..); "
                                 "this index has none: repack (v3)")
            scales = np.ascontiguousarray(scales, np.float32)
            if self.stage_raw:
                # Resident like the labels, so a quarantine fallback's gather
                # (a[actual]) keeps each row with its own scale.
                arrays = dict(arrays)
                arrays["data_scale"] = scales
        super().__init__(arrays, n_raw=n_raw, augmentation=augmentation, raw_len=raw_len,
                         phase_slots=phase_slots)
        self.pack_dtype = pack_dtype
        self.storage_dtype = np.dtype(storage_dtype if storage_dtype is not None else np.float32)
        self._scales = scales
        self.n_ch = int(n_ch)
        self.row_nbytes = self.n_ch * self.raw_len * self.storage_dtype.itemsize
        self._data_dir = data_dir
        self._shards = np.asarray(shards, np.int64)
        self._offsets = np.asarray(offsets, np.int64)
        self._seed = int(seed)
        self._quarantine = quarantine
        self._injector = injector
        self._injector_enabled = bool(getattr(injector, "enabled", False))
        self._mmaps: Dict[int, np.memmap] = {}
        env = os.environ.get("SEIST_INGEST_REUSE_STAGING", "auto")
        if env in ("0", "1"):
            reuse_staging = env == "1"
        self._reuse = bool(reuse_staging) and batch_size > 0
        self._batch_size = int(batch_size)
        self._staging_dtype = np.dtype(np.int8 if self.stage_raw else np.float32)
        # One slab: the feed copies each batch out before the next fill.
        self._slab = (np.empty((self._batch_size, self.n_ch, self.raw_len), self._staging_dtype)
                      if self._reuse else None)
        self._c_batches = BUS.counter("data_ingest_batches")
        self._c_samples = BUS.counter("data_ingest_samples")
        self._c_bytes = BUS.counter("data_ingest_bytes")
        self._c_int8 = BUS.counter("data_ingest_int8_rows")

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, sds: SeismicDataset, *, batch_size: int = 0,
              reuse_staging: Optional[bool] = None, stage_raw: bool = False) -> "PackedRawStore":
        """Construction from the index of a packed dataset alone: the
        ``host_prepare`` row contract and ``RawStore.build``'s refusals
        (each a ``ValueError``, on which the worker falls back). No
        waveform is read. ``stage_raw`` stages an int8 pack's rows as
        they are stored (class docstring)."""
        ds = packed_dataset_of(sds)
        if ds is None:
            raise ValueError("direct ingest requires a packed dataset (--dataset-name packed)")
        pre = sds.preprocessor
        col = ds._meta_data
        n = len(ds)
        if n == 0:
            raise ValueError("empty packed split")
        n_ch_col, n_samp_col = col["n_ch"], col["n_samp"]
        if (n_ch_col != n_ch_col[0]).any() or (n_samp_col != n_samp_col[0]).any():
            raise ValueError("direct ingest needs uniform raw trace shapes; this pack mixes them")
        n_ch, raw_len = int(n_ch_col[0]), int(n_samp_col[0])

        scales = None
        if ds.dtype == "int8":
            missing = [f"scale_{c}" for c in range(n_ch) if f"scale_{c}" not in col]
            if missing:
                raise ValueError(f"int8 packs need the per-row scale sidecar columns "
                                 f"({', '.join(missing)}); this index has none: repack "
                                 "(format v3)")
            scales = np.stack([col[f"scale_{c}"] for c in range(n_ch)], axis=1).astype(np.float32)

        names = taskspec.flatten_io_names(sds.input_names + sds.label_names)
        value_names = sorted({m for m in names if taskspec.get_kind(m) == taskspec.VALUE})
        onehot_names = sorted({m for m in names if taskspec.get_kind(m) == taskspec.ONEHOT})
        snr = np.stack([col["snr_0"], col["snr_1"], col["snr_2"]], axis=1)
        # data only feeds _is_noise's shape check: one empty proxy of the
        # trace length serves every row.
        shape_proxy = np.empty((0, raw_len), np.float32)

        def row_phases(i):
            p, s = col["ppks"][i], col["spks"][i]
            ppks = [] if p != p else [int(p)]
            spks = [] if s != s else [int(s)]
            if pre._is_noise(shape_proxy, ppks, spks, snr[i]):
                return [], [], True
            pp, ss = pad_phases(ppks, spks, pre.min_event_gap, pre.in_samples)
            return pp, ss, False

        phases = [row_phases(i) for i in range(n)]
        max_phases = max([1] + [max(len(pp), len(ss)) for pp, ss, noise in phases if not noise])
        phase_slots = max(max_phases, pre._max_event_num)
        arrays: Dict[str, Any] = {
            "ppks": np.full((n, phase_slots), _BIG, np.int32),
            "np_p": np.empty((n,), np.int32),
            "spks": np.full((n, phase_slots), _BIG, np.int32),
            "np_s": np.empty((n,), np.int32),
        }
        vals = {m: np.zeros((n, 1), np.float32) for m in value_names}
        oh = {m: np.zeros((n,), np.int32) for m in onehot_names}
        for i, (pp, ss, is_noise) in enumerate(phases):
            arrays["ppks"][i, :len(pp)] = pp
            arrays["np_p"][i] = len(pp)
            arrays["spks"][i, :len(ss)] = ss
            arrays["np_s"][i] = len(ss)
            if is_noise and (value_names or onehot_names):
                raise ValueError(f"sample {i} is noise-classified but the task has VALUE/ONEHOT "
                                 f"labels ({value_names + onehot_names}); the device path will "
                                 "not fabricate label values for it")
            for m in value_names:
                v = col[m][i]
                if v != v:  # NaN: absent
                    raise ValueError(f"sample {i} has no '{m}' value; refusing to fabricate a "
                                     "device-path label")
                vals[m][i] = np.float32(v)
            for m in onehot_names:
                v = col[m][i]
                if v != v:
                    raise ValueError(f"sample {i} has no '{m}' class; refusing to fabricate a "
                                     "device-path label")
                oh[m][i] = int(v)
        if value_names:
            arrays["values"] = vals
        if onehot_names:
            arrays["onehots"] = oh
        return cls(arrays, n_raw=n, augmentation=sds.augmentation, raw_len=raw_len,
                   phase_slots=phase_slots, n_ch=n_ch, data_dir=ds._data_dir, shards=col["shard"],
                   offsets=col["offset"], seed=sds._seed, quarantine=sds.quarantine,
                   injector=sds.io_faults, batch_size=batch_size,
                   reuse_staging=reuse_staging, pack_dtype=ds.dtype,
                   storage_dtype=ds._storage_dtype, scales=scales, stage_raw=stage_raw)

    # ---------------------------------------------------------- raw read
    def _read_into(self, out: np.ndarray, r: int, validate: bool) -> None:
        """Fill ``out`` (C, L) with raw sample ``r``: the one copy of the
        fast path, through the packed reader's fault ladder
        (``read_waveform_slice``); a non-finite value is permanent
        corruption too."""
        raw = read_waveform_slice(self._mmaps, self._data_dir, int(self._shards[r]),
                                  int(self._offsets[r]), self.row_nbytes,
                                  desc=f"packed.direct (sample {r})")
        row = np.frombuffer(raw, self.storage_dtype).reshape(self.n_ch, self.raw_len)
        if self.pack_dtype == "int8":
            # int8 holds no NaN: its corruption is the out-of-contract -128
            # byte or a non-finite scale.
            if validate:
                if (row == INT8_POISON).any():
                    raise io_guard.CorruptSampleError(
                        f"packed.direct: int8 sample {r} has {int((row == INT8_POISON).sum())} "
                        f"poison byte(s) ({INT8_POISON})")
                if not np.isfinite(self._scales[r]).all():
                    raise io_guard.CorruptSampleError(
                        f"packed.direct: int8 sample {r} has a non-finite dequant scale")
            out[...] = row
            if not self.stage_raw:  # else the bytes stay narrow: the device dequantises
                out *= self._scales[r][:, None]
            return
        if self.pack_dtype == "bfloat16":
            # The bit patterns widened in place: exact, no intermediate copy.
            np.left_shift(row.astype(np.uint32), 16, out=out.view(np.uint32))
        else:
            out[...] = row
        if validate and not np.isfinite(out).all():
            raise io_guard.CorruptSampleError(
                f"packed.direct: sample {r} has {int(out.size - np.isfinite(out).sum())} "
                "non-finite value(s)")

    def _fill_row(self, out: np.ndarray, raw: int, *, epoch: int, key: int) -> int:
        """Guarded fill of one staging row; returns the index actually read
        (``raw`` unless a quarantine fallback replaced it), whose phase and
        label rows the caller gathers."""
        if not io_guard.enabled():
            self._read_into(out, raw, validate=False)
            return raw
        if not (self._quarantine.active or self._injector_enabled):
            try:
                self._read_into(out, raw, validate=True)
                io_guard.COUNTERS.inc("reads")
                return raw
            except (OSError, io_guard.CorruptSampleError):
                pass  # into the retrying, quarantining ladder below
        for cand in self._quarantine.candidates(raw, seed=self._seed, epoch=epoch, idx=key):
            try:
                io_guard.read_with_retry(lambda c=cand: self._read_into(out, c, validate=True),
                                         desc=f"packed.direct[{cand}]", fault_key=cand,
                                         injector=self._injector)
                if self._injector is not None and self._injector.is_corrupt(cand):
                    raise io_guard.CorruptSampleError(f"[faults] injected corrupt sample {cand}")
            except io_guard.CorruptSampleError as e:
                self._quarantine.add(cand, repr(e))
                continue
            if cand != raw:
                io_guard.COUNTERS.inc("fallback_reads")
            return cand
        raise io_guard.CorruptSampleError(
            f"no clean fallback found for packed sample {raw} "
            f"(quarantined: {len(self._quarantine)}/{self.n_raw})")

    # --------------------------------------------------------- batch fill
    def _staging(self, batch: int) -> np.ndarray:
        if not self._reuse:
            return np.empty((batch, self.n_ch, self.raw_len), self._staging_dtype)
        return self._slab[:batch]

    def row_batch_at(self, raw_idx: np.ndarray, *, epoch: int = 0,
                     idx: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Fill one staging batch from the shards and gather the matching
        resident rows; ``idx`` (the logical epoch indices) keys quarantine
        fallbacks as on the host path."""
        raw_idx = np.asarray(raw_idx)
        batch = int(raw_idx.shape[0])
        if self._reuse and batch > self._batch_size:
            raise ValueError(f"batch {batch} exceeds the staging slab's {self._batch_size}")
        buf = self._staging(batch)
        actual = np.empty(batch, np.int64)
        with BUS.span("data_ingest_fill"):
            for j in range(batch):
                key = int(idx[j]) if idx is not None else int(raw_idx[j])
                actual[j] = self._fill_row(buf[j], int(raw_idx[j]), epoch=int(epoch), key=key)
        rows = _tree_map(lambda a: a[actual], self.arrays)
        rows["data"] = buf
        self._c_batches.inc()
        self._c_samples.inc(batch)
        self._c_bytes.inc(batch * self.row_nbytes)
        if self.pack_dtype == "int8":
            self._c_int8.inc(batch)
        return rows

    def row_batch(self, raw_idx: np.ndarray) -> Dict[str, Any]:
        return self.row_batch_at(raw_idx)

    @property
    def disk_bytes(self) -> int:
        """Waveform bytes that stay on disk (a RawStore would hold them)."""
        return int(self.n_raw) * self.row_nbytes


def describe(store: PackedRawStore) -> str:
    return (
        f"packed direct ingest: {store.n_raw} samples, {store.disk_bytes / 2**20:.1f} MiB "
        f"on-disk waveforms, {store.nbytes / 2**20:.2f} MiB resident metadata, staging "
        f"{'one reused slab' if store._reuse else 'per-batch'} ({store.n_ch}x{store.raw_len} "
        f"{store._staging_dtype.name} rows from {store.pack_dtype}"
        f"{', device dequant' if store.stage_raw else ''})"
    )
