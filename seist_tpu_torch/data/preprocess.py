"""Waveform preprocessing: augmentation, windowing, normalization, labels.

The port's copy of ``seist_tpu/data/preprocess.py`` (numpy only; the JAX
package's optional native wavekit kernels are not used — the numpy path
is theirs too). Every stochastic method takes a ``numpy.random.Generator``;
event data is ``(C, L)`` internally and assembled io-items are
channels-last: grouped items stack to ``(L, C)``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from seist_tpu_torch import taskspec
from seist_tpu_torch.utils.logger import logger

Event = Dict[str, Any]

NORM_MODES = ("std", "max", "absmax", "")


def normalize(data: np.ndarray, mode: str = "std", axis: int = -1) -> np.ndarray:
    """Demean + scale along ``axis``.

    * ``'std'``    — z-score.
    * ``'max'``    — divide by the SIGNED per-channel max after demeaning
      (the reference training pipeline's quirk, kept as it is).
    * ``'absmax'`` — divide by the abs max.
    * ``''``       — demean only.

    Zero scales divide by 1. Never mutates the input.
    """
    data = np.asarray(data)
    data = data - np.mean(data, axis=axis, keepdims=True)
    if mode == "max":
        scale = np.max(data, axis=axis, keepdims=True)
    elif mode == "absmax":
        scale = np.max(np.abs(data), axis=axis, keepdims=True)
    elif mode == "std":
        scale = np.std(data, axis=axis, keepdims=True)
    elif mode == "":
        return data
    else:
        raise ValueError(
            f"Supported modes: 'max', 'absmax', 'std', '', got '{mode}'"
        )
    scale[scale == 0] = 1
    return data / scale


def make_soft_window(soft_label_width: int, soft_label_shape: str) -> np.ndarray:
    """The (width+1)-sample soft-label window (ref: preprocess.py:571-601).

    The gaussian's sigma is fixed at 10 whatever the width (the
    reference's quirk, kept).
    """
    left = int(soft_label_width / 2)
    right = soft_label_width - left
    if soft_label_shape == "gaussian":
        # NB the gaussian sigma is fixed at 10 regardless of label width
        # (ref quirk, preprocess.py:576-578).
        return np.exp(-((np.arange(-left, right + 1)) ** 2) / (2 * 10**2))
    if soft_label_shape == "triangle":
        return 1 - np.abs(2 / soft_label_width * np.arange(-left, right + 1))
    if soft_label_shape == "box":
        return np.ones(soft_label_width + 1)
    if soft_label_shape == "sigmoid":
        def _sigmoid(x):
            return 1 / (1 + np.exp(x))

        l_l, l_r = -int(left / 2), left - int(left / 2)
        r_l, r_r = -int(right / 2), right - int(right / 2)
        x_l = -10 / left * np.arange(l_l, l_r)
        x_r = -10 / right * (-1) * np.arange(r_l, r_r)
        return np.concatenate((_sigmoid(x_l), [1.0], _sigmoid(x_r)), axis=0)
    raise NotImplementedError(f"Unsupported label shape: '{soft_label_shape}'")


def pad_phases(
    ppks: list, spks: list, padding_idx: int, num_samples: int
) -> Tuple[list, list]:
    """Pad the P/S phase lists to equal length (ref: preprocess.py:16-35).

    Leading unmatched S picks get a ``-padding_idx`` partner P; trailing
    unmatched P picks get a ``num_samples + padding_idx`` partner S.
    """
    padding_idx = abs(padding_idx)
    ppks, spks = sorted(ppks), sorted(spks)
    ppk_arr, spk_arr = np.array(ppks), np.array(spks)
    idx = 0
    while idx < min(len(ppks), len(spks)) and all(
        ppk_arr[: idx + 1] < spk_arr[-idx - 1 :]
    ):
        idx += 1
    ppks = len(spk_arr[: len(spk_arr) - idx]) * [-padding_idx] + ppks
    spks = spks + len(ppk_arr[idx:]) * [num_samples + padding_idx]
    assert len(ppks) == len(spks), f"pad_phases failed: {ppks} vs {spks}"
    return ppks, spks


def pad_array(s, length: int, padding_value: Union[int, float]) -> np.ndarray:
    """Right-pad a 1-D array to ``length`` (ref: preprocess.py:38-49)."""
    s = np.asarray(s)
    padding_size = int(length - s.shape[0])
    if padding_size < 0:
        raise ValueError(f"length < len(s): {s.shape[0]} > {length}")
    return np.pad(s, (0, padding_size), mode="constant", constant_values=padding_value)


class DataPreprocessor:
    """Augmentation + windowing + normalization + label generation.

    Ref: training/preprocess.py:52-821. Constructor arguments carry the same
    names and semantics as the reference so CLI flags map 1:1.
    """

    def __init__(
        self,
        data_channels: Sequence[str],
        sampling_rate: int,
        in_samples: int,
        min_snr: float = float("-inf"),
        p_position_ratio: float = -1.0,
        coda_ratio: float = 1.4,
        norm_mode: str = "std",
        add_event_rate: float = 0.0,
        add_noise_rate: float = 0.0,
        add_gap_rate: float = 0.0,
        drop_channel_rate: float = 0.0,
        scale_amplitude_rate: float = 0.0,
        pre_emphasis_rate: float = 0.0,
        pre_emphasis_ratio: float = 0.97,
        max_event_num: int = 1,
        generate_noise_rate: float = 0.0,
        shift_event_rate: float = 0.0,
        mask_percent: float = 0.0,
        noise_percent: float = 0.0,
        min_event_gap_sec: float = 0.0,
        soft_label_shape: str = "gaussian",
        soft_label_width: int = 50,
        dtype=np.float32,
    ):
        self.data_channels = list(data_channels)
        self.sampling_rate = sampling_rate
        self.in_samples = in_samples
        self.coda_ratio = coda_ratio
        self.norm_mode = norm_mode
        self.min_snr = min_snr
        self.p_position_ratio = p_position_ratio

        self.add_event_rate = add_event_rate
        self.add_noise_rate = add_noise_rate
        self.add_gap_rate = add_gap_rate
        self.drop_channel_rate = drop_channel_rate
        self.scale_amplitude_rate = scale_amplitude_rate
        self.pre_emphasis_rate = pre_emphasis_rate
        self.pre_emphasis_ratio = pre_emphasis_ratio
        self._max_event_num = max_event_num
        self.generate_noise_rate = generate_noise_rate
        self.shift_event_rate = shift_event_rate
        self.mask_percent = mask_percent
        self.noise_percent = noise_percent
        self.min_event_gap = int(min_event_gap_sec * self.sampling_rate)

        # p_position_ratio mode force-disables add/shift/noise-gen augments
        # (ref: preprocess.py:113-131).
        if 0 <= self.p_position_ratio <= 1:
            for attr in ("add_event_rate", "shift_event_rate", "generate_noise_rate"):
                if getattr(self, attr) > 0:
                    setattr(self, attr, 0.0)
                    logger.warning(
                        f"`p_position_ratio` is {p_position_ratio}, `{attr}` -> 0.0"
                    )

        self.soft_label_shape = soft_label_shape
        self.soft_label_width = soft_label_width
        self.dtype = dtype
        # (width, shape) -> window array; hot-path memo for _soft_window.
        self._window_cache: dict = {}

    # ------------------------------------------------------------------ noise
    def _clear_event_except(self, event: Event, *keep: str) -> None:
        """Blank all event fields except ``keep`` (ref: preprocess.py:136-152)."""
        for k in set(event) - set(keep):
            v = event[k]
            if isinstance(v, (list, dict)):
                v.clear()
            elif isinstance(v, np.ndarray):
                event[k] = np.array([])
            elif isinstance(v, (int, float, np.integer, np.floating)):
                event[k] = 0
            elif isinstance(v, str):
                event[k] = ""
            else:
                raise TypeError(f"Got `{v}` ({type(v)})")

    def _is_noise(self, data, ppks, spks, snr) -> bool:
        """Classify a trace as noise (ref: preprocess.py:154-170)."""
        snr = np.asarray(snr)
        is_noise = (
            (len(ppks) != len(spks))
            or len(ppks) < 1
            or len(spks) < 1
            or min(ppks + spks) < 0
            or max(ppks + spks) >= data.shape[-1]
            or bool(np.all(snr < self.min_snr))
        )
        # NB: iterate min(len) — the reference indexes spks over len(ppks)
        # (preprocess.py:168-169), which raises on mismatched lists; with a
        # mismatch is_noise is already True so the semantics are unchanged.
        for i in range(min(len(ppks), len(spks))):
            is_noise |= ppks[i] >= spks[i]
        return bool(is_noise)

    # ---------------------------------------------------------------- window
    def _cut_window(
        self,
        data: np.ndarray,
        ppks: list,
        spks: list,
        window_size: int,
        rng: np.random.Generator,
    ) -> Tuple[np.ndarray, list, list]:
        """Cut to ``window_size`` (ref: preprocess.py:172-222)."""
        input_len = data.shape[-1]

        if 0 <= self.p_position_ratio <= 1:
            # Pin the first P arrival at a fixed window fraction.
            new_data = np.zeros((data.shape[0], window_size), dtype=np.float32)
            tgt_l, tgt_r = 0, window_size
            p_idx = ppks[0]
            c_l = p_idx - int(window_size * self.p_position_ratio)
            c_r = c_l + window_size
            offset = -c_l
            if c_l < 0:
                tgt_l += abs(c_l)
                offset += c_l
                c_l = 0
            if c_r > data.shape[-1]:
                tgt_r -= c_r - data.shape[-1]
                c_r = data.shape[-1]
            new_data[:, tgt_l:tgt_r] = data[:, c_l:c_r]
            offset += tgt_l
            data = new_data
            ppks = [t + offset for t in ppks if 0 <= t + offset < window_size]
            spks = [t + offset for t in spks if 0 <= t + offset < window_size]
        else:
            if input_len > window_size:
                # Random crop; events near the left edge stay in-window
                # (ref: preprocess.py:206-215).
                c_l = int(
                    rng.integers(
                        0,
                        max(
                            min(ppks + [input_len - window_size]) - self.min_event_gap,
                            1,
                        ),
                    )
                )
                c_r = c_l + window_size
                data = data[:, c_l:c_r]
                ppks = [t - c_l for t in ppks if c_l <= t < c_r]
                spks = [t - c_l for t in spks if c_l <= t < c_r]
            elif input_len < window_size:
                data = np.concatenate(
                    [data, np.zeros((data.shape[0], window_size - input_len))], axis=1
                )
        return data, ppks, spks

    def _normalize(self, data: np.ndarray, mode: str) -> np.ndarray:
        """Per-channel demean + max/std normalize (ref: preprocess.py:224-242).

        Thin wrapper over the canonical module-level :func:`normalize`
        (signed-max semantics); kept as a method because subclass hooks and
        tests target it."""
        if mode not in ("max", "std", ""):
            raise ValueError(f"Supported mode: 'max','std', got '{mode}'")
        return normalize(data, mode, axis=1)

    # ----------------------------------------------------------- augmentation
    def _generate_noise_data(self, data, ppks, spks, rng):
        """Wipe phases+coda with white noise (ref: preprocess.py:244-263)."""
        if len(ppks) > 0 and len(spks) > 0:
            for ppk, spk in zip(ppks, spks):
                coda_end = int(
                    np.clip(int(spk + self.coda_ratio * (spk - ppk)), 0, data.shape[-1])
                )
                if ppk < coda_end:
                    data[:, ppk:coda_end] = rng.standard_normal(
                        (data.shape[0], coda_end - ppk)
                    )
        return data, [], []

    def _add_event(self, data, ppks, spks, min_gap, rng):
        """Duplicate a scaled copy of an event (ref: preprocess.py:265-292)."""
        target_idx = int(rng.integers(0, len(ppks)))
        ppk, spk = ppks[target_idx], spks[target_idx]
        coda_end = int(spk + self.coda_ratio * (spk - ppk))
        left = coda_end + min_gap
        right = data.shape[-1] - (spk - ppk) - min_gap
        if left < right:
            ppk_add = int(rng.integers(left, right))
            spk_add = ppk_add + spk - ppk
            space = min(data.shape[-1] - ppk_add, coda_end - ppk)
            scale = rng.random()
            data[:, ppk_add : ppk_add + space] += data[:, ppk : ppk + space] * scale
            ppks.append(ppk_add)
            spks.append(spk_add)
        ppks.sort()
        spks.sort()
        return data, ppks, spks

    def _shift_event(self, data, ppks, spks, rng):
        """Circular time shift (ref: preprocess.py:294-305)."""
        shift = int(rng.integers(0, data.shape[-1]))
        data = np.concatenate((data[:, -shift:], data[:, :-shift]), axis=1)
        ppks = sorted((p + shift) % data.shape[-1] for p in ppks)
        spks = sorted((s + shift) % data.shape[-1] for s in spks)
        return data, ppks, spks

    def _drop_channel(self, data, rng):
        """Zero a random subset of channels (ref: preprocess.py:307-321)."""
        if data.shape[0] < 2:
            return data
        drop_num = int(rng.choice(range(1, data.shape[0])))
        candidates = list(range(data.shape[0]))
        for _ in range(drop_num):
            c = int(rng.choice(candidates))
            candidates.remove(c)
            data[c, :] = 0.0
        return data

    def _adjust_amplitude(self, data):
        """Rescale after channel drop (ref: preprocess.py:323-333)."""
        max_amp = np.max(np.abs(data), axis=1)
        if np.count_nonzero(max_amp) > 0:
            data *= data.shape[0] / np.count_nonzero(max_amp)
        return data

    def _scale_amplitude(self, data, rng):
        """Random amplitude scale x/÷ U(1,3) (ref: preprocess.py:335-344)."""
        if rng.uniform(0, 1) < 0.5:
            data *= rng.uniform(1, 3)
        else:
            data /= rng.uniform(1, 3)
        return data

    def _pre_emphasis(self, data, pre_emphasis: float):
        """First-order pre-emphasis filter (ref: preprocess.py:346-353)."""
        emphasized = np.empty_like(data)
        emphasized[:, 0] = data[:, 0]
        emphasized[:, 1:] = data[:, 1:] - pre_emphasis * data[:, :-1]
        data[...] = emphasized
        return data

    def _add_noise(self, data, rng):
        """Add gaussian noise at random SNR in [10,50) dB
        (ref: preprocess.py:355-368)."""
        for c in range(data.shape[0]):
            x = data[c, :]
            snr = int(rng.integers(10, 50))
            px = np.sum(x**2) / len(x)
            pn = px * 10 ** (-snr / 10.0)
            data[c, :] += rng.standard_normal(len(x)) * np.sqrt(pn)
        return data

    def _add_gaps(self, data, ppks, spks, rng):
        """Zero a random span between phases (ref: preprocess.py:370-390)."""
        phases = sorted(ppks + spks)
        if len(phases) > 0:
            phases.append(data.shape[-1] - 1)
            phases = sorted(set(phases))
            insert_pos = int(rng.integers(0, len(phases) - 1))
            sgt = int(rng.integers(phases[insert_pos], phases[insert_pos + 1]))
            egt = int(rng.integers(sgt, phases[insert_pos + 1]))
        else:
            sgt = int(rng.integers(0, data.shape[-1] - 1))
            egt = int(rng.integers(sgt + 1, data.shape[-1]))
        data[:, sgt:egt] = 0
        return data

    def _add_mask_windows(self, data, percent, window_size, rng, mask_value=1.0):
        """Mask a percentage of fixed windows (ref: preprocess.py:392-412)."""
        p = np.clip(percent, 0, 100)
        num_windows = data.shape[-1] // window_size
        num_mask = int(num_windows * p // 100)
        selected = rng.choice(range(num_windows), num_mask, replace=False)
        for i in selected:
            st = i * window_size
            data[:, st : st + window_size] = mask_value
        return data

    def _add_noise_windows(self, data, percent, window_size, rng):
        """White-noise a percentage of fixed windows (ref: preprocess.py:414-430)."""
        p = np.clip(percent, 0, 100)
        num_windows = data.shape[-1] // window_size
        num_block = int(num_windows * p // 100)
        selected = rng.choice(range(num_windows), num_block, replace=False)
        for i in selected:
            st = i * window_size
            data[:, st : st + window_size] = rng.standard_normal(
                (data.shape[0], window_size)
            )
        return data

    def _data_augmentation(self, event: Event, rng: np.random.Generator) -> Event:
        """The 9-way augmentation pipeline (ref: preprocess.py:432-499)."""
        data, ppks, spks = event["data"], event["ppks"], event["spks"]

        if rng.random() < self.generate_noise_rate:
            data, ppks, spks = self._generate_noise_data(data, ppks, spks, rng)
            self._clear_event_except(event, "data")
            if rng.random() < self.drop_channel_rate:
                data = self._drop_channel(data, rng)
                data = self._adjust_amplitude(data)
            if rng.random() < self.scale_amplitude_rate:
                data = self._scale_amplitude(data, rng)
        else:
            for _ in range(self._max_event_num - len(ppks)):
                if rng.random() < self.add_event_rate and ppks:
                    data, ppks, spks = self._add_event(
                        data, ppks, spks, self.min_event_gap, rng
                    )
            if rng.random() < self.shift_event_rate:
                data, ppks, spks = self._shift_event(data, ppks, spks, rng)
            if rng.random() < self.drop_channel_rate:
                data = self._drop_channel(data, rng)
                data = self._adjust_amplitude(data)
            if rng.random() < self.scale_amplitude_rate:
                data = self._scale_amplitude(data, rng)
            if rng.random() < self.pre_emphasis_rate:
                data = self._pre_emphasis(data, self.pre_emphasis_ratio)
            if rng.random() < self.add_noise_rate:
                data = self._add_noise(data, rng)
            if rng.random() < self.add_gap_rate:
                data = self._add_gaps(data, ppks, spks, rng)

        if self.mask_percent > 0:
            data = self._add_mask_windows(
                data, self.mask_percent, self.sampling_rate // 2, rng
            )
        if self.noise_percent > 0:
            data = self._add_noise_windows(
                data, self.noise_percent, self.sampling_rate // 2, rng
            )

        event.update({"data": data, "ppks": ppks, "spks": spks})
        return event

    # ---------------------------------------------------------------- process
    def process(
        self,
        event: Event,
        augmentation: bool,
        rng: Optional[np.random.Generator] = None,
        inplace: bool = True,
    ) -> Event:
        """Full preprocessing of one event (ref: preprocess.py:501-542)."""
        if rng is None:
            # Interactive use only: the pipeline threads a Generator seeded
            # from (seed, epoch, idx).
            rng = np.random.default_rng()
        if not inplace:
            event = copy.deepcopy(event)

        if self._is_noise(event["data"], event["ppks"], event["spks"], event["snr"]):
            self._clear_event_except(event, "data")

        event["ppks"], event["spks"] = pad_phases(
            event["ppks"], event["spks"], self.min_event_gap, self.in_samples
        )

        if augmentation:
            event = self._data_augmentation(event, rng)

        event["data"], event["ppks"], event["spks"] = self._cut_window(
            event["data"], event["ppks"], event["spks"], self.in_samples, rng
        )

        event["data"] = self._normalize(event["data"], self.norm_mode)
        return event

    # ------------------------------------------------------------- soft labels
    def _soft_window(self, soft_label_width: int, soft_label_shape: str) -> np.ndarray:
        """The (width+1)-sample label window (ref: preprocess.py:571-601).

        Cached per (width, shape): the window is identical for every call
        in a run and sits on the per-sample hot path."""
        key = (soft_label_width, soft_label_shape)
        window = self._window_cache.get(key)
        if window is None:
            window = self._window_cache[key] = self._make_soft_window(
                soft_label_width, soft_label_shape
            )
        return window

    def _make_soft_window(
        self, soft_label_width: int, soft_label_shape: str
    ) -> np.ndarray:
        return make_soft_window(soft_label_width, soft_label_shape)

    def _soft_label(
        self, idxs, length: int, soft_label_width: int, soft_label_shape: str
    ) -> np.ndarray:
        """Place label windows at phase indices (ref: preprocess.py:567-619)."""
        slabel = np.zeros(length)
        if len(idxs) > 0:
            left = int(soft_label_width / 2)
            right = soft_label_width - left
            window = self._soft_window(soft_label_width, soft_label_shape)
            for idx in idxs:
                if idx < 0:
                    pass  # out of range
                elif idx - left < 0:
                    slabel[: idx + right + 1] += window[
                        soft_label_width + 1 - (idx + right + 1) :
                    ]
                elif idx + right <= length - 1:
                    slabel[idx - left : idx + right + 1] += window
                elif idx <= length - 1:
                    slabel[-(length - (idx - left)) :] += window[: length - (idx - left)]
                else:
                    pass  # out of range
        return slabel

    def _generate_soft_label(
        self,
        name: str,
        event: Event,
        soft_label_width: Optional[int] = None,
        soft_label_shape: Optional[str] = None,
    ) -> np.ndarray:
        """Generate one soft io-item (ref: preprocess.py:544-683)."""
        width = soft_label_width or self.soft_label_width
        shape = soft_label_shape or self.soft_label_shape
        length = event["data"].shape[-1]

        def _clip(x: int) -> int:
            return min(max(x, 0), length)

        def _padded_phases():
            # Padded lists are used by 'non' and 'det' only; 'ppk'/'spk'
            # use the raw event lists (ref: preprocess.py:621-631).
            return pad_phases(
                ppks=event["ppks"],
                spks=event["spks"],
                padding_idx=width,
                num_samples=length,
            )

        if name in ("ppk", "spk"):
            key = {"ppk": "ppks", "spk": "spks"}[name]
            label = self._soft_label(event[key], length, width, shape)

        elif name == "non":
            ppks, spks = _padded_phases()
            label = (
                np.ones(length)
                - self._soft_label(ppks, length, width, shape)
                - self._soft_label(spks, length, width, shape)
            )
            label[label < 0] = 0

        elif name == "det":
            ppks, spks = _padded_phases()
            label = np.zeros(length)
            assert len(ppks) == len(spks)
            for ppk, spk in zip(ppks, spks):
                dst = ppk
                det = int(spk + self.coda_ratio * (spk - ppk))
                label_i = self._soft_label([dst, det], length, width, shape)
                label_i[_clip(dst) : _clip(det)] = 1.0
                label += label_i
            label[label > 1] = 1.0

        elif name in ("ppk+", "spk+"):
            label = np.zeros(length)
            key = {"ppk+": "ppks", "spk+": "spks"}[name]
            phases = event[key]
            for st in phases:
                label_i = self._soft_label([st], length, width, shape)
                label_i[_clip(st) :] = 1.0
                label += label_i / len(phases)

        elif name in self.data_channels:
            label = event["data"][self.data_channels.index(name)]

        elif name in [f"d{c}" for c in self.data_channels]:
            channel_data = event["data"][self.data_channels.index(name[-1])]
            label = np.zeros_like(channel_data)
            label[1:] = np.diff(channel_data)

        else:
            raise NotImplementedError(f"Unsupported label name: '{name}'")

        return label.astype(self.dtype)

    # ------------------------------------------------------------- io assembly
    def get_io_item(
        self,
        name: Union[str, tuple, list],
        event: Event,
        soft_label_width: Optional[int] = None,
        soft_label_shape: Optional[str] = None,
    ):
        """Build one io-item; groups stack channels-last to ``(L, C)``
        (the reference stacks channels-first, preprocess.py:714-717)."""
        if isinstance(name, (tuple, list)):
            # Fast path for the dominant case (waveform group == dataset
            # channel order, e.g. ("z","n","e")): a transpose VIEW of the
            # already-processed (C, L) array — the copy happens once at
            # batch assembly (_stack) instead of per sample here.
            if tuple(name) == tuple(self.data_channels):
                return event["data"].T.astype(self.dtype, copy=False)
            children = [self.get_io_item(sub, event) for sub in name]
            return np.stack(children, axis=-1)

        kind = taskspec.get_kind(name)
        if kind == taskspec.SOFT:
            return self._generate_soft_label(
                name, event, soft_label_width, soft_label_shape
            )
        if kind == taskspec.VALUE:
            return np.asarray(event[name]).astype(self.dtype)
        if kind == taskspec.ONEHOT:
            cidx = event[name]
            if not len(cidx) > 0:
                raise ValueError(f"Item:{name}, Value:{cidx}")
            nc = taskspec.get_num_classes(name)
            return np.eye(nc)[cidx[0]].astype(np.int64)
        raise NotImplementedError(f"Unknown item: {name}")

    def get_inputs(self, event: Event, input_names: Sequence):
        """Model inputs (ref: preprocess.py:806-821)."""
        inputs = [self.get_io_item(name, event) for name in input_names]
        return tuple(inputs) if len(inputs) > 1 else inputs[0]

    def get_targets_for_loss(self, event: Event, label_names: Sequence):
        """Loss targets (ref: preprocess.py:744-759)."""
        targets = [self.get_io_item(name, event) for name in label_names]
        return tuple(targets) if len(targets) > 1 else targets[0]

    def get_targets_for_metrics(
        self, event: Event, max_event_num: int, task_names: Sequence[str]
    ) -> Dict[str, np.ndarray]:
        """Metrics targets (ref: preprocess.py:761-804)."""
        targets: Dict[str, np.ndarray] = {}
        for name in task_names:
            if name in ("ppk", "spk"):
                key = {"ppk": "ppks", "spk": "spks"}[name]
                tgt = self.get_io_item(key, event)
                tgt = pad_array(tgt, max_event_num, int(-1e7)).astype(np.int64)
            elif name == "det":
                padded_ppks, padded_spks = pad_phases(
                    event["ppks"],
                    event["spks"],
                    self.soft_label_width,
                    self.in_samples,
                )
                detections: List[int] = []
                for ppk, spk in zip(padded_ppks, padded_spks):
                    st = int(np.clip(ppk, 0, self.in_samples))
                    et = int(spk + self.coda_ratio * (spk - ppk))
                    detections.extend([st, et])
                expected_num = self.expected_det_num()
                if len(detections) // 2 < expected_num:
                    detections = detections + [1, 0] * (
                        expected_num - len(detections) // 2
                    )
                tgt = np.array(detections).astype(np.int64)
            else:
                tgt = self.get_io_item(name, event)
            targets[name] = tgt
        return targets

    def expected_det_num(self) -> int:
        """Number of detection-interval slots in metrics targets
        (ref: preprocess.py:793)."""
        return (
            self._max_event_num
            + int(bool(self.add_event_rate))
            + int(bool(self.shift_event_rate))
            + int(0 <= self.p_position_ratio <= 1)
        )
