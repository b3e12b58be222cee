"""Input pipeline: dataset + preprocessor -> fixed-shape numpy batches.

The port's copy of the host path of ``seist_tpu/data/pipeline.py``:

* :class:`SeismicDataset` — a registered dataset reader composed with the
  ``DataPreprocessor``: (inputs, loss_targets, metrics_targets, meta json)
  per index, with the 2x-epoch augmentation rule (raw copy for
  ``idx < size``, augmented for ``idx >= size``). Every sample's RNG is
  ``default_rng(SeedSequence([seed, epoch, idx]))``, so batches are
  byte-identical to the JAX package's and independent of worker scheduling.
  Every read goes through the data-plane guard (``data/io_guard.py``):
  transient faults are retried, a corrupt sample is quarantined and
  replaced by the ``(seed, epoch, idx)``-keyed fallback.
* :func:`epoch_indices` / :func:`mixture_epoch_indices` — the seeded
  per-epoch order, plain or temperature-weighted over the sources of a
  mixture pack; :func:`_epoch_order` picks between them.
* :class:`Loader` — batch assembly with fixed shapes by a thread pool, or
  by worker processes (``worker_processes``, started by forkserver or
  spawn): ``drop_last`` on train; eval pads the final batch and zeroes
  ``mask`` on the padding rows; :meth:`Loader.set_start_batch` begins an
  epoch mid-way for a resumed run. A worker that raises anything but a
  sample fault surfaces as :class:`~io_guard.LoaderDeathError`.

* :func:`group_batches` — k train batches stacked into one
  ``(inputs_k, targets_k)`` pair of torch tensors (leading axis k), in
  pinned host memory for a CUDA train loop, whose copies to the device
  then do not wait for it (``seist_tpu/data/pipeline.py::
  prefetch_packed_to_device``).

* The device-augmentation feeds (``--device-aug``): :class:`RawStore`
  (raw rows decoded once, the draw-free preprocessing done),
  :class:`DeviceEpochCache` (those rows resident on the card, one card),
  :func:`iter_raw_batches` (step mode's raw batches in the Loader's order)
  and :func:`raw_batch_tensors` (a batch copied into pinned memory by the
  worker's feed thread).

* :func:`_double_buffer` — a bounded producer thread that applies a
  ``transform`` ahead of the consumer (batch re-picking's fill feed,
  ``batch/engine.py``), with backpressure accounting on the metrics bus.

Not ported: host sharding (multi-GPU training). Host batches stay numpy;
the train loop moves them to the device.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from seist_tpu_torch import taskspec
from seist_tpu_torch.data import io_guard
from seist_tpu_torch.data.base import Event
from seist_tpu_torch.data.preprocess import DataPreprocessor
from seist_tpu_torch.registry import DATASETS
from seist_tpu_torch.utils import faults as faults_lib
from seist_tpu_torch.utils.logger import logger

Batch = collections.namedtuple(
    "Batch", ["inputs", "loss_targets", "metrics_targets", "meta", "mask"]
)


class SeismicDataset:
    """Dataset reader + preprocessing -> one training example."""

    def __init__(
        self,
        dataset_name: str,
        mode: str,
        *,
        seed: int,
        data_dir: str = "",
        input_names: Sequence = (),
        label_names: Sequence = (),
        task_names: Sequence[str] = (),
        in_samples: int = 8192,
        augmentation: bool = False,
        shuffle: bool = True,
        data_split: bool = True,
        train_size: float = 0.8,
        val_size: float = 0.1,
        max_event_num: int = 1,
        max_quarantine_frac: float = 0.05,
        dataset_kwargs: Optional[dict] = None,
        **preprocessor_kwargs,
    ) -> None:
        self._seed = int(seed)
        self._mode = mode.lower()
        self._input_names = list(input_names)
        self._label_names = list(label_names)
        self._task_names = list(task_names)
        self._max_event_num = max_event_num
        self._epoch = 0

        # val/test never augment.
        self._augmentation = bool(augmentation) and self._mode == "train"
        if self._augmentation != bool(augmentation):
            logger.warning(f"[{self._mode}] Augmentation -> {self._augmentation}")

        self._dataset = DATASETS.create(
            dataset_name,
            seed=self._seed,
            mode=self._mode,
            data_dir=data_dir,
            shuffle=shuffle,
            data_split=data_split,
            train_size=train_size,
            val_size=val_size,
            **(dataset_kwargs or {}),
        )
        logger.info(repr(self._dataset))
        self._dataset_size = len(self._dataset)
        # The data-plane guard: this dataset's quarantine and the injector
        # of SEIST_FAULT_IO_*, both fixed at construction.
        self._quarantine = io_guard.Quarantine(
            self._dataset_size, max_frac=float(max_quarantine_frac)
        )
        self._io_faults = faults_lib.IoFaultInjector.from_env()
        self._io_faults_enabled = self._io_faults.enabled
        if self._augmentation:
            logger.warning(f"Data augmentation: Dataset size -> {self._dataset_size * 2}")

        label_width_sec = preprocessor_kwargs.pop("label_width", 0.5)
        self._preprocessor = DataPreprocessor(
            data_channels=self._dataset.channels(),
            sampling_rate=self._dataset.sampling_rate(),
            in_samples=in_samples,
            max_event_num=max_event_num,
            soft_label_width=int(label_width_sec * self._dataset.sampling_rate()),
            **preprocessor_kwargs,
        )

    @property
    def preprocessor(self) -> DataPreprocessor:
        return self._preprocessor

    @property
    def augmentation(self) -> bool:
        return self._augmentation

    @property
    def raw_size(self) -> int:
        """Number of RAW events (len() doubles under augmentation)."""
        return self._dataset_size

    @property
    def input_names(self) -> list:
        return list(self._input_names)

    @property
    def label_names(self) -> list:
        return list(self._label_names)

    @property
    def quarantine(self) -> io_guard.Quarantine:
        return self._quarantine

    @property
    def io_faults(self) -> faults_lib.IoFaultInjector:
        return self._io_faults

    def quarantine_report(self) -> Dict[str, Any]:
        """Epoch-end quarantine report (logged by the train worker)."""
        return self._quarantine.report()

    def source_ids(self) -> Optional[np.ndarray]:
        """Per-LOGICAL-index source ids when the dataset is a mixture pack,
        else None; doubled under augmentation (logical index ``n + i`` is
        sample ``i``'s augmented copy, same source)."""
        fn = getattr(self._dataset, "source_ids", None)
        sids = fn() if callable(fn) else None
        if sids is None:
            return None
        sids = np.asarray(sids)
        return np.concatenate([sids, sids]) if self._augmentation else sids

    def raw_event(self, idx: int) -> Tuple[Event, dict]:
        """One unprocessed event and its meta: the device-augmentation store
        reads raw traces here (``--device-aug``)."""
        return self._dataset[idx % self._dataset_size]

    def _fetch_event(self, raw_idx: int, *, idx: int) -> Tuple[Event, dict]:
        """Guarded sample read. The fast path (nothing quarantined, no
        injected faults) is one read and its validation; any failure falls
        through to the retry/quarantine ladder of :meth:`_fetch_event_slow`."""
        if not (self._quarantine.active or self._io_faults_enabled):
            try:
                event, meta = self._dataset[raw_idx]
                io_guard.validate_event(event)
                io_guard.COUNTERS.inc("reads")
                return event, meta
            except (OSError, io_guard.CorruptSampleError):
                pass
        return self._fetch_event_slow(raw_idx, idx=idx)

    def _fetch_event_slow(self, raw_idx: int, *, idx: int) -> Tuple[Event, dict]:
        """Transient faults retried; a permanently bad candidate
        quarantined; the first clean candidate of the ``(seed, epoch,
        idx)``-keyed fallback sequence taken."""
        for cand in self._quarantine.candidates(
            raw_idx, seed=self._seed, epoch=self._epoch, idx=idx
        ):
            try:
                event, meta = io_guard.guarded_event_read(
                    lambda c=cand: self._dataset[c],
                    key=cand,
                    desc=f"{self._dataset.name()}[{cand}]",
                    injector=self._io_faults,
                )
            except io_guard.CorruptSampleError as e:
                # Covers RetriesExhaustedError; add() raises
                # QuarantineOverflowError past --max-quarantine-frac.
                self._quarantine.add(cand, repr(e))
                continue
            if cand != raw_idx:
                io_guard.COUNTERS.inc("fallback_reads")
            return event, meta
        raise io_guard.CorruptSampleError(
            f"no clean fallback found for sample {raw_idx} "
            f"(quarantined: {len(self._quarantine)}/{self._dataset_size})"
        )

    def sampling_rate(self) -> int:
        return self._dataset.sampling_rate()

    def name(self) -> str:
        return f"{self._dataset.name()}_{self._mode}"

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-sample RNG stream."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return 2 * self._dataset_size if self._augmentation else self._dataset_size

    def __getitem__(self, idx: int) -> Tuple[Any, Any, Dict[str, np.ndarray], str]:
        raw_idx = idx % self._dataset_size
        if io_guard.enabled():
            event, meta_data = self._fetch_event(raw_idx, idx=int(idx))
        else:
            event, meta_data = self._dataset[raw_idx]
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, self._epoch, int(idx)])
        )
        event = self._preprocessor.process(
            event=event,
            augmentation=(self._augmentation and idx >= self._dataset_size),
            rng=rng,
        )
        inputs = self._preprocessor.get_inputs(event, self._input_names)
        loss_targets = self._preprocessor.get_targets_for_loss(event, self._label_names)
        metrics_targets = self._preprocessor.get_targets_for_metrics(
            event, max_event_num=self._max_event_num, task_names=self._task_names
        )
        meta_json = json.dumps({k: str(v) for k, v in dict(meta_data).items()})
        return inputs, loss_targets, metrics_targets, meta_json


def from_task_spec(
    spec: taskspec.TaskSpec, dataset_name: str, mode: str, **kwargs
) -> SeismicDataset:
    """A :class:`SeismicDataset` wired to a model's task spec."""
    return SeismicDataset(
        dataset_name,
        mode,
        input_names=[list(g) if isinstance(g, (tuple, list)) else g for g in spec.inputs],
        label_names=[list(g) if isinstance(g, (tuple, list)) else g for g in spec.labels],
        task_names=list(spec.eval),
        **kwargs,
    )


def epoch_indices(n: int, *, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    """The epoch-``epoch`` sample order: a seeded permutation, a pure
    function of (seed, epoch)."""
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        return rng.permutation(n)
    return np.arange(n)


# Keys the mixture-draw PRNG stream apart from the shuffle/fallback ones.
_MIXTURE_SALT = 0x313C7


def mixture_epoch_indices(
    source_ids: np.ndarray, *, seed: int, epoch: int, temperature: float
) -> np.ndarray:
    """Temperature-weighted mixture order over a multi-source pack, under
    the resume contract of :func:`epoch_indices`: a pure function of
    (seed, epoch), ``len(source_ids)`` long.

    Each slot draws its source with probability ``p_s ∝ (n_s / n)^(1/T)``
    (T = 1: proportional; large T: uniform over sources) and takes the
    next sample of that source's stream, a seeded permutation of its
    members drawn again at every wrap: small sources are resampled evenly,
    large ones subsampled without replacement."""
    source_ids = np.asarray(source_ids)
    n = int(source_ids.shape[0])
    if temperature <= 0:
        raise ValueError(f"mixture temperature must be > 0, got {temperature}")
    counts = np.bincount(source_ids)
    if counts.size < 2:
        raise ValueError("mixture sampling needs >= 2 sources")
    p = (counts / n) ** (1.0 / float(temperature))
    p = np.where(counts > 0, p, 0.0)
    p = p / p.sum()
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(epoch), _MIXTURE_SALT]))
    choice = rng.choice(counts.size, size=n, p=p)
    order = np.empty(n, np.int64)
    for s in range(counts.size):
        slots = np.flatnonzero(choice == s)
        if slots.size == 0:
            continue
        members = np.flatnonzero(source_ids == s)
        wraps = -(-slots.size // members.size)
        stream = np.concatenate([
            np.random.default_rng(
                np.random.SeedSequence([int(seed), int(epoch), _MIXTURE_SALT, s, w])
            ).permutation(members)
            for w in range(wraps)
        ])
        order[slots] = stream[: slots.size]
    return order


def _epoch_order(
    n: int,
    *,
    seed: int,
    epoch: int,
    shuffle: bool,
    source_ids: Optional[np.ndarray] = None,
    mixture_temperature: float = 0.0,
) -> np.ndarray:
    """The one epoch-order dispatcher: the seeded permutation, or the
    temperature-weighted mixture order when a multi-source pack and a
    temperature are given. Both are pure functions of (seed, epoch)."""
    if mixture_temperature and source_ids is not None:
        if len(source_ids) != n:
            raise ValueError(f"source_ids has {len(source_ids)} entries for {n} samples")
        return mixture_epoch_indices(
            source_ids, seed=seed, epoch=epoch, temperature=mixture_temperature
        )
    return epoch_indices(n, seed=seed, epoch=epoch, shuffle=shuffle)


def _stack(samples: List[Any]) -> Any:
    """Stack a list of per-sample structures (arrays / tuples of arrays)."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


def group_batches(batches, k: int, pin: bool = False) -> Iterator[Tuple[Any, Any]]:
    """Group ``k`` train batches into one stacked ``(inputs_k, targets_k)``
    pair of torch tensors: leading axis the batch's place in the group,
    each batch's bytes unchanged. ``pin`` puts them in pinned host memory.
    A trailing group smaller than ``k`` is dropped, as the JAX package
    drops it (fixed shapes); only the inputs and the loss targets survive
    grouping, as there."""
    import torch

    def stacked(parts: List[Any]) -> Any:
        if isinstance(parts[0], tuple):
            return tuple(stacked([p[i] for p in parts]) for i in range(len(parts[0])))
        first = torch.from_numpy(np.ascontiguousarray(parts[0]))
        out = torch.empty((len(parts),) + tuple(first.shape), dtype=first.dtype, pin_memory=pin)
        for i, x in enumerate(parts):
            out[i].copy_(torch.from_numpy(np.ascontiguousarray(x)))
        return out

    group: List[Batch] = []
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield stacked([g.inputs for g in group]), stacked([g.loss_targets for g in group])
            group = []


class Loader:
    """Host-side batch loader with fixed shapes.

    Each epoch: the seeded order (:func:`_epoch_order`) -> fixed-size
    batches. Train drops the tail (``drop_last``); eval pads the final
    batch by repeating its last index and sets ``Batch.mask`` zeros on the
    padding rows.

    Workers: ``num_workers`` threads (numpy releases the GIL for the heavy
    parts), or ``worker_processes > 0`` processes, each holding the dataset
    pickled once, which sidesteps the GIL at the cost of per-sample IPC.
    Batches are byte-identical either way: a sample's RNG comes from
    (seed, epoch, idx), never from the worker.
    """

    def __init__(
        self,
        dataset: SeismicDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        worker_processes: int = 0,
        seed: int = 0,
        mixture_temperature: float = 0.0,
    ) -> None:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.worker_processes = max(0, worker_processes)
        self.seed = seed
        # Mixture sampling (multi-source packs only); the per-sample
        # source ids are fixed for the dataset's lifetime.
        self.mixture_temperature = float(mixture_temperature or 0.0)
        self._source_ids = None
        if self.mixture_temperature > 0:
            fn = getattr(dataset, "source_ids", None)
            self._source_ids = fn() if callable(fn) else None
            if self._source_ids is None:
                raise ValueError(
                    "mixture_temperature set but the dataset exposes no mixture "
                    "sources (pack with python -m seist_tpu_torch pack --mixture)"
                )
        self.epoch = 0
        self._start_batch = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        self._proc_pool = None
        if self.worker_processes and io_guard.enabled():
            # Each worker process holds its own copy of the dataset, so the
            # quarantine and the counters accumulate per worker: the
            # parent's epoch report undercounts and --max-quarantine-frac
            # applies per worker. Replacement content stays the same.
            logger.warning(
                "worker_processes > 0: data-plane quarantine/counters are "
                "tracked per worker process; parent-side epoch reports "
                "undercount and the --max-quarantine-frac abort applies "
                "per worker"
            )
        # One injector per pipeline: the dataset's, so a programmatic plan
        # reaches the stall hook too.
        self._io_faults = (
            getattr(dataset, "io_faults", None) or faults_lib.IoFaultInjector.from_env()
        )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self.dataset.set_epoch(epoch)

    def set_start_batch(self, start_batch: int) -> None:
        """Begin the NEXT ``__iter__`` at batch ``start_batch`` instead of 0
        (one-shot; later epochs start at 0). The order is a pure function of
        (seed, epoch), so a resumed run consumes exactly the batches an
        uninterrupted one would have; the skipped ones are never assembled."""
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self._start_batch = int(start_batch)

    def close(self) -> None:
        """Release the worker pools; the loader stays usable."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=False, cancel_futures=True)
            self._proc_pool = None

    def _indices(self) -> np.ndarray:
        return _epoch_order(
            len(self.dataset),
            seed=self.seed,
            epoch=self.epoch,
            shuffle=self.shuffle,
            source_ids=self._source_ids,
            mixture_temperature=self.mixture_temperature,
        )

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, chunk: np.ndarray) -> List[Any]:
        """One batch's samples. Sample faults never reach here (the guarded
        read retries and quarantines them); anything a worker still raises
        is a loader death, wrapped as :class:`io_guard.LoaderDeathError`
        for the train worker to checkpoint and preempt-exit. The deliberate
        aborts (quarantine overflow, no clean fallback) pass through: they
        must end the run, not start a relaunch loop."""
        try:
            return self._fetch_inner(chunk)
        except (io_guard.QuarantineOverflowError, io_guard.CorruptSampleError):
            raise
        except Exception as e:
            io_guard.COUNTERS.inc("loader_deaths")
            raise io_guard.LoaderDeathError(
                f"loader worker died fetching batch chunk "
                f"[{int(chunk[0])}..{int(chunk[-1])}]: {e!r}"
            ) from e

    def _fetch_inner(self, chunk: np.ndarray) -> List[Any]:
        if self.worker_processes:
            if self._proc_pool is None:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor

                # forkserver or spawn, never fork: the pool starts from the
                # prefetch thread of a process that has touched CUDA, and a
                # forked child fails at its first CUDA call or inherits a
                # lock held by another thread. The dataset is pickled once
                # per worker, by the initializer.
                try:
                    ctx = multiprocessing.get_context("forkserver")
                except ValueError:
                    ctx = multiprocessing.get_context("spawn")
                self._proc_pool = ProcessPoolExecutor(
                    max_workers=self.worker_processes,
                    mp_context=ctx,
                    initializer=_proc_worker_init,
                    initargs=(self.dataset,),
                )
            epoch = self.epoch
            return list(self._proc_pool.map(
                _proc_worker_getitem,
                [(epoch, int(i)) for i in chunk],
                chunksize=max(1, len(chunk) // self.worker_processes),
            ))
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers, thread_name_prefix="seist-loader"
            )
        # A few tasks per worker, not one per sample.
        n_tasks = min(len(chunk), self.num_workers * 4)
        getitem = self.dataset.__getitem__

        def run_slice(ids):
            return [getitem(int(i)) for i in ids]

        out: List[Any] = []
        for part in self._pool.map(run_slice, np.array_split(np.asarray(chunk), n_tasks)):
            out.extend(part)
        return out

    def __iter__(self) -> Iterator[Batch]:
        from seist_tpu_torch.obs.bus import BUS

        # Bus counters resolved once per epoch (scraped on --metrics-port).
        c_batches = BUS.counter("loader_batches")
        c_samples = BUS.counter("loader_samples")
        indices = self._indices()
        start, self._start_batch = self._start_batch, 0  # one-shot
        for b in range(start, len(self)):
            # SEIST_FAULT_IO_STALL_BATCH wedges the loader here: the stall
            # watchdog's stand-in for a deadlocked pool or a hung mount.
            self._io_faults.maybe_stall(b)
            chunk = indices[b * self.batch_size : (b + 1) * self.batch_size]
            pad = self.batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1], pad)])
            samples = self._fetch(chunk)
            inputs = _stack([s[0] for s in samples])
            loss_targets = _stack([s[1] for s in samples])
            metrics_targets = {k: np.stack([s[2][k] for s in samples]) for k in samples[0][2]}
            meta = [s[3] for s in samples]
            mask = np.ones(self.batch_size, dtype=np.float32)
            if pad:
                mask[-pad:] = 0.0
            c_batches.inc()
            c_samples.inc(len(samples) - pad)
            yield Batch(inputs, loss_targets, metrics_targets, meta, mask)


_PROC_DATASET: Optional[SeismicDataset] = None


def _proc_worker_init(dataset: SeismicDataset) -> None:
    global _PROC_DATASET
    _PROC_DATASET = dataset


def _proc_worker_getitem(epoch_idx):
    """A worker process's sample fetch. The epoch rides along with every
    index: the parent's ``set_epoch`` does not reach live workers, and the
    sample RNG is seeded from (seed, epoch, idx)."""
    epoch, idx = epoch_idx
    _PROC_DATASET.set_epoch(epoch)
    return _PROC_DATASET[idx]


# ------------------------------------------------------ device augmentation
def _double_buffer(iterator, transform, prefetch: int, account: str = ""):
    """Producer-thread double buffering (``seist_tpu/data/pipeline.py::
    _double_buffer``): a thread applies ``transform`` to each item of
    ``iterator`` and queues it (at most ``prefetch`` ahead); producer
    exceptions re-raise in the consumer. To stop early, the consumer makes
    ``iterator`` end (the repick engine sets an abort flag its fill
    generator reads) and drains this generator; the thread then ends.

    ``account`` names a bus-counter prefix: ``<account>_backpressure_s``
    sums the seconds the producer waited on a full queue (the consumer,
    i.e. the device, set the pace), ``<account>_queue_full`` counts those
    waits."""
    buf: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    err: List[BaseException] = []
    if account:
        from seist_tpu_torch.obs.bus import BUS, monotonic

        c_wait = BUS.counter(f"{account}_backpressure_s")
        c_full = BUS.counter(f"{account}_queue_full")

    def _put(item) -> None:
        if not account or not buf.full():
            buf.put(item)
            return
        c_full.inc()
        t0 = monotonic()
        buf.put(item)
        c_wait.inc(monotonic() - t0)

    def producer():
        try:
            for item in iterator:
                _put(transform(item))
        except BaseException as e:  # the consumer re-raises it
            err.append(e)
        finally:
            buf.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = buf.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def _guarded_raw_event(sds: SeismicDataset, i: int) -> dict:
    """A raw read for the device-augmentation store: transient faults are
    retried as on the host path; a permanently corrupt sample raises
    ValueError. The store holds every sample for the whole run, so it
    refuses rather than bake a fallback in; the worker then falls back to
    the host path, whose per-read quarantine handles the sample."""
    if not io_guard.enabled():
        return sds.raw_event(i)[0]
    try:
        event, _ = io_guard.guarded_event_read(
            lambda: sds.raw_event(i), key=i, desc=f"{sds.name()}.raw[{i}]",
            injector=sds.io_faults)
        return event
    except io_guard.CorruptSampleError as e:
        raise ValueError(
            f"sample {i} is permanently corrupt ({e}); --device-aug falls back to the host "
            "path, which quarantines it"
        ) from e


def _tree_map(fn, tree):
    """``fn`` over the arrays of a (nested) dict of arrays."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


class RawStore:
    """Fixed-shape raw arrays on the host for ``--device-aug step|cached``:
    every raw trace decoded once, the draw-free preprocessing
    (``_is_noise`` and ``pad_phases``, :func:`device_aug.host_prepare`)
    done per sample, VALUE/ONEHOT labels as dense arrays. A step's host work
    is then a row gather; augmentation, windowing, normalisation and labels
    run on the device (``data/device_aug.py``).

    Needs one raw trace length across the dataset; :meth:`build` raises
    ``ValueError`` otherwise, and the worker falls back to the host path."""

    def __init__(self, arrays: Dict[str, Any], *, n_raw: int, augmentation: bool,
                 raw_len: int, phase_slots: int) -> None:
        self.arrays = arrays
        self.n_raw = int(n_raw)
        self.augmentation = bool(augmentation)
        self.raw_len = int(raw_len)
        self.phase_slots = int(phase_slots)

    def __len__(self) -> int:
        # The 2x-epoch rule: raw copy for idx < n_raw, augmented above.
        return 2 * self.n_raw if self.augmentation else self.n_raw

    @property
    def nbytes(self) -> int:
        return int(sum(np.asarray(a).nbytes for a in _tree_leaves(self.arrays)))

    @classmethod
    def estimate_bytes(cls, sds: SeismicDataset) -> int:
        """The resident size without decoding the dataset: one sample's
        float32 waveform bytes times the dataset size. The probe read is
        guarded, as the build's reads are."""
        event = _guarded_raw_event(sds, 0)
        return int(np.asarray(event["data"]).astype(np.float32, copy=False).nbytes
                   * sds.raw_size)

    @classmethod
    def build(cls, sds: SeismicDataset) -> "RawStore":
        from seist_tpu_torch.data import device_aug as da  # it imports this module
        from seist_tpu_torch.data.preprocess import pad_phases

        pre = sds.preprocessor
        names = taskspec.flatten_io_names(sds.input_names + sds.label_names)
        value_names = sorted({n for n in names if taskspec.get_kind(n) == taskspec.VALUE})
        onehot_names = sorted({n for n in names if taskspec.get_kind(n) == taskspec.ONEHOT})
        # One decode per sample; the waveforms go straight into the stacked
        # array and each event is dropped once consumed, so host memory
        # stays about one dataset.
        n = sds.raw_size
        events: List[Optional[dict]] = []
        raw_len = None
        max_phases = 1
        for i in range(n):
            event = _guarded_raw_event(sds, i)
            length = int(np.asarray(event["data"]).shape[-1])
            if raw_len is None:
                raw_len = length
            elif length != raw_len:
                raise ValueError(f"device-aug needs uniform raw trace lengths; sample {i} has "
                                 f"{length} != {raw_len}")
            ppks, spks = list(event["ppks"]), list(event["spks"])
            if not pre._is_noise(event["data"], ppks, spks, event["snr"]):
                p, s = pad_phases(ppks, spks, pre.min_event_gap, pre.in_samples)
                max_phases = max(max_phases, len(p), len(s))
            events.append(event)
        phase_slots = max(max_phases, pre._max_event_num)
        n_ch = len(pre.data_channels)
        arrays: Dict[str, Any] = {
            "data": np.empty((n, n_ch, int(raw_len or 0)), np.float32),
            "ppks": np.empty((n, phase_slots), np.int32),
            "np_p": np.empty((n,), np.int32),
            "spks": np.empty((n, phase_slots), np.int32),
            "np_s": np.empty((n,), np.int32),
        }
        vals = {name: np.zeros((n, 1), np.float32) for name in value_names}
        oh = {name: np.zeros((n,), np.int32) for name in onehot_names}
        for i in range(n):
            event, events[i] = events[i], None
            row = da.host_prepare(pre, event, phase_slots)
            for k in ("data", "ppks", "np_p", "spks", "np_s"):
                arrays[k][i] = row[k]
            if row["is_noise"] and (value_names or onehot_names):
                # The host path fails on a noise-classified trace with
                # VALUE/ONEHOT labels; zero-filling would train on invented
                # labels. Refuse: the worker falls back to the host path.
                raise ValueError(f"sample {i} is noise-classified but the task has VALUE/ONEHOT "
                                 f"labels ({value_names + onehot_names}); the device path will "
                                 "not fabricate label values for it")
            for name in value_names:
                v = np.asarray(event.get(name, []), np.float32)
                if v.size == 0:
                    raise ValueError(f"sample {i} has no '{name}' value; refusing to fabricate "
                                     "a device-path label")
                vals[name][i] = v.reshape(-1)[:1]
            for name in onehot_names:
                v = event.get(name, [])
                if not len(v):
                    raise ValueError(f"sample {i} has no '{name}' class; refusing to fabricate "
                                     "a device-path label")
                oh[name][i] = int(v[0])
        if value_names:
            arrays["values"] = vals
        if onehot_names:
            arrays["onehots"] = oh
        return cls(arrays, n_raw=n, augmentation=sds.augmentation, raw_len=int(raw_len or 0),
                   phase_slots=phase_slots)

    def row_batch(self, raw_idx: np.ndarray) -> Dict[str, Any]:
        """The raw rows of a batch (a numpy fancy index: step mode's host
        work)."""
        return _tree_map(lambda a: a[raw_idx], self.arrays)


class DeviceEpochCache:
    """The raw epoch resident on the card (``--device-aug cached``): the
    :class:`RawStore` arrays uploaded once, so a call of k steps receives
    only a (k, B) int32 index array. One card: no mesh, no host sharding
    (multi-GPU training is in ROADMAP.md)."""

    def __init__(self, store: RawStore, device) -> None:
        import torch

        self.store = store
        self.arrays = _tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device),
                                store.arrays)
        self.nbytes = int(sum(t.numel() * t.element_size() for t in _tree_leaves(self.arrays)))

    def epoch_index_chunks(self, epoch: int, *, seed: int, shuffle: bool, batch_size: int,
                           steps_per_call: int, start_batch: int = 0,
                           source_ids: Optional[np.ndarray] = None,
                           mixture_temperature: float = 0.0) -> Iterator[np.ndarray]:
        """(k, B) int32 index arrays of one epoch: the sample sequence the
        host Loader would produce (:func:`_epoch_order`), in calls of k;
        a trailing part-call is dropped (drop-last, fixed shapes)."""
        order = _epoch_order(len(self.store), seed=seed, epoch=epoch, shuffle=shuffle,
                             source_ids=source_ids, mixture_temperature=mixture_temperature)
        nb = len(order) // batch_size
        calls = nb // steps_per_call
        per_call = steps_per_call * batch_size
        for c in range(start_batch // steps_per_call, calls):
            flat = order[c * per_call:(c + 1) * per_call]
            yield np.asarray(flat.reshape(steps_per_call, batch_size), np.int32)


def iter_raw_batches(store: RawStore, epoch: int, *, seed: int, shuffle: bool, batch_size: int,
                     start_batch: int = 0, source_ids: Optional[np.ndarray] = None,
                     mixture_temperature: float = 0.0):
    """Step mode's feed (``--device-aug step``): per batch, the raw rows
    gathered on the host (no augmentation, labels or stacking) as ``(rows,
    idx, aug)`` for the augmenting train step. The order is the host
    Loader's (:func:`_epoch_order`, drop-last). A store with
    ``row_batch_at`` (packed direct ingest) gets the (epoch, logical idx)
    its guarded reads key quarantine fallbacks on."""
    order = _epoch_order(len(store), seed=seed, epoch=epoch, shuffle=shuffle,
                         source_ids=source_ids, mixture_temperature=mixture_temperature)
    nb = len(order) // batch_size
    n_raw = store.n_raw
    row_batch_at = getattr(store, "row_batch_at", None)
    for b in range(start_batch, nb):
        sel = np.asarray(order[b * batch_size:(b + 1) * batch_size], np.int64)
        raw = sel % n_raw if store.augmentation else sel
        aug = (sel >= n_raw) if store.augmentation else np.zeros(sel.shape, bool)
        if row_batch_at is not None:
            rows = row_batch_at(raw, epoch=epoch, idx=sel)
        else:
            rows = store.row_batch(raw)
        yield rows, sel.astype(np.int32), aug


def raw_batch_tensors(item, pin: bool = False):
    """One :func:`iter_raw_batches` item as torch tensors, copied out of the
    numpy arrays (into pinned memory with ``pin``). The copy is what lets a
    staging slab be refilled at once: the batch no longer aliases it, and
    a pinned block is reused by torch's host allocator only after the
    non-blocking copies that read it have run."""
    import torch

    def copy(a):
        a = np.ascontiguousarray(a)
        out = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=pin)
        out.copy_(torch.from_numpy(a))
        return out

    rows, idx, aug = item
    return _tree_map(copy, rows), copy(idx), copy(aug)
