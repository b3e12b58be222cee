"""Synthetic seismogram dataset — no disk, fully deterministic (the port's
copy of ``seist_tpu/data/synthetic.py``).

Plausible 3-channel event waveforms (noise + damped P/S wavelets) with
every label the io-item catalog knows (ppks/spks, emg, smg, pmp, clr, baz,
dis, snr). Event ``idx`` is generated from ``default_rng(seed * 1e6 +
idx)``: the same events as the JAX package's, stable across epochs and
worker layouts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from seist_tpu_torch.data.base import DatasetBase, Event, Meta
from seist_tpu_torch.registry import register_dataset


def make_wavelet(
    rng: np.random.Generator, length: int, freq: float, fs: int
) -> np.ndarray:
    """Damped sinusoid: t*exp(-3t) envelope, random-phase carrier."""
    t = np.arange(length) / fs
    envelope = t * np.exp(-3.0 * t)
    carrier = np.sin(2 * np.pi * freq * t + rng.uniform(0, 2 * np.pi))
    return (envelope * carrier / (np.abs(envelope).max() + 1e-9)).astype(
        np.float32
    )


class Synthetic(DatasetBase):
    _name = "synthetic"
    _part_range = None
    _channels = ["z", "n", "e"]
    _sampling_rate = 50

    def __init__(
        self,
        *,
        num_events: int = 256,
        trace_samples: int = 12000,
        data_dir: str = "",
        cache: bool = True,
        **kwargs,
    ):
        self._num_events = num_events
        self._trace_samples = trace_samples
        # Generated events are cached; copies are returned because the
        # preprocessor mutates in place.
        self._cache: dict = {} if cache else None
        super().__init__(data_dir=data_dir, **kwargs)

    def _load_meta_data(self) -> Meta:
        return self._shuffle_and_split({"idx": np.arange(self._num_events)})

    def _make_wavelet(self, rng, length: int, freq: float) -> np.ndarray:
        return make_wavelet(rng, length, freq, self._sampling_rate)

    @staticmethod
    def _copy_event(event: Event) -> Event:
        """Deep-enough copy: the preprocessor mutates data/label fields in
        place, so cached events must never be handed out aliased."""
        return {
            k: (v.copy() if isinstance(v, np.ndarray) else list(v))
            if isinstance(v, (np.ndarray, list))
            else v
            for k, v in event.items()
        }

    def _load_event_data(self, idx: int) -> Tuple[Event, dict]:
        if self._cache is not None and idx in self._cache:
            event, meta = self._cache[idx]
            return self._copy_event(event), dict(meta)
        row = self._row_dict(idx)
        rng = np.random.default_rng(int(self._seed) * 1_000_000 + int(row["idx"]))
        length = self._trace_samples
        n_ch = len(self._channels)

        data = rng.normal(0, 1.0, size=(n_ch, length)).astype(np.float32)
        ppk = int(rng.integers(length // 10, length // 2))
        spk = int(ppk + rng.integers(length // 20, length // 4))
        amp = rng.uniform(5.0, 20.0)
        wl = min(length - spk, length // 4)
        for c in range(n_ch):
            p_w = self._make_wavelet(rng, wl, freq=rng.uniform(4, 8))
            s_w = self._make_wavelet(rng, wl, freq=rng.uniform(1.5, 4))
            data[c, ppk : ppk + wl] += amp * p_w
            data[c, spk : spk + wl] += 1.6 * amp * s_w

        emg = float(np.clip(rng.normal(3.5, 1.0), 0, 8))
        event: Event = {
            "data": data,
            "ppks": [ppk],
            "spks": [spk],
            "emg": [emg],
            "smg": [float(np.clip(emg + rng.normal(0, 0.2), 0, 8))],
            "pmp": [int(rng.integers(0, 2))],
            "clr": [int(rng.integers(0, 2))],
            "baz": [float(rng.uniform(0, 360))],
            "dis": [float(rng.uniform(0, 330))],
            "snr": np.full(n_ch, 20.0, dtype=np.float32),
        }
        meta = {"idx": int(row["idx"])}
        if self._cache is not None:
            self._cache[idx] = (self._copy_event(event), dict(meta))
        return event, meta


@register_dataset
def synthetic(**kwargs):
    return Synthetic(**kwargs)
