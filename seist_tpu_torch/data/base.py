"""Dataset base class: metadata + seeded shuffle/split (the port's copy of
``seist_tpu/data/base.py``, numpy only).

A dataset owns a metadata table — here a dict of equal-length numpy
columns, where the JAX package keeps a pandas frame — and reads one
event's waveform and labels per ``__getitem__``. The seeded
shuffle-then-contiguous-split contract is the JAX package's:
``DataFrame.sample(frac=1, random_state=seed)`` is the permutation
``np.random.RandomState(seed).permutation(n)``, so the same seed gives the
same train/val/test split in both packages.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import numpy as np

from seist_tpu_torch.utils.logger import logger

Event = Dict[str, Any]
Meta = Dict[str, np.ndarray]


class DatasetBase:
    _name: str = ""
    _part_range: Optional[tuple] = None
    _channels: list = []
    _sampling_rate: int = 0

    def __init__(
        self,
        seed: int,
        mode: str,
        data_dir: str,
        shuffle: bool = True,
        data_split: bool = True,
        train_size: float = 0.8,
        val_size: float = 0.1,
        **kwargs,
    ):
        self._seed = seed
        mode = mode.lower()
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train/val/test, got '{mode}'")
        self._mode = mode
        self._data_dir = data_dir
        self._shuffle = shuffle
        self._data_split = data_split
        if train_size + val_size >= 1.0:
            raise ValueError(f"train_size:{train_size}, val_size:{val_size}")
        self._train_size = train_size
        self._val_size = val_size
        self._meta_data = self._load_meta_data()

    # -- subclass hooks ------------------------------------------------------
    def _load_meta_data(self) -> Meta:
        raise NotImplementedError

    def _load_event_data(self, idx: int) -> Tuple[Event, dict]:
        raise NotImplementedError

    # -- shared split logic --------------------------------------------------
    def _shuffle_and_split(self, meta: Meta) -> Meta:
        """Seeded whole-table shuffle, then contiguous train/val/test ranges."""
        n = len(next(iter(meta.values())))
        order = (
            np.random.RandomState(self._seed).permutation(n)
            if self._shuffle
            else np.arange(n)
        )
        if self._data_split:
            t_end = int(self._train_size * n)
            v_end = t_end + int(self._val_size * n)
            lo, hi = {
                "train": (0, t_end),
                "val": (t_end, v_end),
                "test": (v_end, n),
            }[self._mode]
            order = order[lo:hi]
            logger.info(f"Data Split: {self._mode}: {lo}-{hi}")
        return {c: np.asarray(a)[order] for c, a in meta.items()}

    def _row_dict(self, idx: int) -> Dict[str, Any]:
        """Metadata row ``idx`` as a plain dict."""
        return {c: a[idx] for c, a in self._meta_data.items()}

    # -- public API ----------------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self._meta_data.values())))

    def __getitem__(self, idx: int) -> Tuple[Event, dict]:
        return self._load_event_data(idx=idx)

    def __repr__(self) -> str:
        return (
            f"Dataset(name:{self._name}, part_range:{self._part_range}, "
            f"channels:{self._channels}, sampling_rate:{self._sampling_rate}, "
            f"data_dir:{self._data_dir}, shuffle:{self._shuffle}, "
            f"data_split:{self._data_split}, train_size:{self._train_size}, "
            f"val_size:{self._val_size})"
        )

    @classmethod
    def name(cls) -> str:
        return cls._name

    @classmethod
    def sampling_rate(cls) -> int:
        return cls._sampling_rate

    @classmethod
    def channels(cls) -> list:
        return copy.deepcopy(cls._channels)
