"""Input pipeline: dataset + preprocessor -> fixed-shape numpy batches.

The port's copy of the host path of ``seist_tpu/data/pipeline.py``:

* :class:`SeismicDataset` — a registered dataset reader composed with the
  ``DataPreprocessor``: (inputs, loss_targets, metrics_targets, meta json)
  per index, with the 2x-epoch augmentation rule (raw copy for
  ``idx < size``, augmented for ``idx >= size``). Every sample's RNG is
  ``default_rng(SeedSequence([seed, epoch, idx]))``, so batches are
  byte-identical to the JAX package's and independent of worker scheduling.
* :func:`epoch_indices` — the seeded per-epoch permutation.
* :class:`Loader` — thread-pool batch assembly with fixed shapes:
  ``drop_last`` on train; eval pads the final batch and zeroes ``mask``
  on the padding rows; :meth:`Loader.set_start_batch` begins an epoch
  mid-way for a resumed run.

Not ported: the data-plane guard (retry/quarantine, fault injection),
process-pool workers, host sharding, mixture sampling and the
device-augmentation feeds. Batches stay numpy; the train loop moves them
to the device.
"""

from __future__ import annotations

import collections
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from seist_tpu_torch import taskspec
from seist_tpu_torch.data.preprocess import DataPreprocessor
from seist_tpu_torch.registry import DATASETS
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
        event, meta_data = self._dataset[idx % self._dataset_size]
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


def _stack(samples: List[Any]) -> Any:
    """Stack a list of per-sample structures (arrays / tuples of arrays)."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


class Loader:
    """Host-side batch loader with fixed shapes.

    Each epoch: seeded permutation -> fixed-size batches assembled by a
    thread pool (numpy releases the GIL for the heavy parts). Train drops
    the tail (``drop_last``); eval pads the final batch by repeating its
    last index and sets ``Batch.mask`` zeros on the padding rows.
    """

    def __init__(
        self,
        dataset: SeismicDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        seed: int = 0,
    ) -> None:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        self._start_batch = 0
        self._pool: Optional[ThreadPoolExecutor] = None

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
        """Release the worker pool; the loader stays usable."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def _indices(self) -> np.ndarray:
        return epoch_indices(
            len(self.dataset), seed=self.seed, epoch=self.epoch, shuffle=self.shuffle
        )

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, chunk: np.ndarray) -> List[Any]:
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
        indices = self._indices()
        start, self._start_batch = self._start_batch, 0  # one-shot
        for b in range(start, len(self)):
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
            yield Batch(inputs, loss_targets, metrics_targets, meta, mask)
