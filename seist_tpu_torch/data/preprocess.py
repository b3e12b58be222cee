"""Waveform normalization for the serving path (the port's copy of
``seist_tpu/data/preprocess.py::normalize``, numpy only)."""

from __future__ import annotations

import numpy as np

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
