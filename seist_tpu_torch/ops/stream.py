"""Continuous-record annotation: sliding-window inference and overlap
stitching, in torch (the port's counterpart of ``seist_tpu/ops/stream.py``).

    windows, offsets = sliding_windows(record, window, stride)   # host view
    probs = <the model's forward over batches of windows>        # device
    curve = stitch_probs(probs, offsets, len(record))            # device
    picks = pick_peaks(curve[None, :, 1], ...)                   # device

* Windows advance by ``stride``; the last is right-aligned, so the tail of
  the record is always covered. ``annotate`` cuts the windows one batch at
  a time, so the host holds O(batch) of them whatever the record's length.
* Stitching combines overlapping windows on the device: the elementwise
  maximum (``index_reduce_`` with ``amax``) or the mean (``index_add_`` of
  values and of hit counts).
* ``annotate`` runs the whole path: it pads the last batch to the batch
  size by repeating its last window (so ONE program serves every record
  length), stitches on the device of the forward's outputs, picks with
  ``ops/postprocess.pick_peaks`` / ``detect_events`` there, and copies the
  result to the host once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from seist_tpu_torch.data.preprocess import normalize
from seist_tpu_torch.ops.postprocess import detect_events, pick_peaks


def window_offsets(record_len: int, window: int, stride: int) -> np.ndarray:
    """Window start offsets: advance by ``stride``; the last window is
    clamped to ``L - window`` (right-aligned) so the tail is always
    covered. Requires ``L >= window``."""
    if record_len < window:
        raise ValueError(f"record length {record_len} < window {window}")
    offsets = list(range(0, record_len - window + 1, stride))
    if offsets[-1] != record_len - window:
        offsets.append(record_len - window)
    return np.asarray(offsets, dtype=np.int32)


def sliding_windows(record: np.ndarray, window: int, stride: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(L, C) record -> ((n, window, C) windows, (n,) offsets). Copies
    every window; :func:`annotate` cuts them per batch instead."""
    offsets = window_offsets(record.shape[0], window, stride)
    windows = np.stack([record[o : o + window] for o in offsets], axis=0)
    return windows, offsets


def stitch_probs(probs: torch.Tensor, offsets: Any, total_len: int,
                 combine: str = "mean") -> torch.Tensor:
    """Combine overlapping windows' probabilities back onto the record:
    ``probs`` (n, window, C) and ``offsets`` (n,) -> (total_len, C), on
    ``probs``' device. ``'mean'`` averages the k windows covering a sample;
    ``'max'`` takes their maximum (a pick near one window's edge is never
    attenuated by a neighbour that missed it)."""
    n, window, c = probs.shape
    offsets = torch.as_tensor(np.asarray(offsets), dtype=torch.long, device=probs.device)
    flat_pos = (offsets[:, None]
                + torch.arange(window, device=probs.device)[None, :]).reshape(-1)
    flat = probs.reshape(-1, c)
    out = torch.zeros((total_len, c), dtype=probs.dtype, device=probs.device)
    if combine == "max":
        return out.index_reduce_(0, flat_pos, flat, "amax", include_self=True)
    if combine != "mean":
        raise ValueError(f"unknown combine {combine!r}")
    out.index_add_(0, flat_pos, flat)
    hits = torch.zeros((total_len,), dtype=probs.dtype, device=probs.device)
    hits.index_add_(0, flat_pos, torch.ones_like(flat_pos, dtype=probs.dtype))
    return out / torch.clamp(hits, min=1.0)[:, None]


def annotate(
    apply_fn: Callable[[np.ndarray], Any],
    record: np.ndarray,
    *,
    window: int = 8192,
    stride: Optional[int] = None,
    batch_size: int = 32,
    sampling_rate: int = 50,
    ppk_threshold: float = 0.3,
    spk_threshold: float = 0.3,
    det_threshold: float = 0.5,
    min_peak_dist: float = 1.0,
    max_events: Optional[int] = None,
    combine: str = "mean",
    channel0: str,
) -> Dict[str, np.ndarray]:
    """Pick P and S phases and detection intervals over a continuous record.

    ``apply_fn`` maps a (N, window, C) float32 batch (numpy) to (N, window,
    3) probabilities (a tensor, or anything ``torch.as_tensor`` takes) on
    the device it computes on: the serve pool's ``entry.run`` puts the
    batch on the entry's device and replays the bucket's program. The
    stitching and picking run on the device of its outputs. ``channel0``
    (required: a wrong guess inverts the detections) names the first
    output channel: ``'non'`` (noise probability: PhaseNet) or ``'det'``
    (event probability: the SeisT dpk family, EQTransformer). ``record``:
    (L, C), raw (each window is z-normalized here).

    ``max_events`` caps the picks over the whole record (the tallest are
    kept); by default 4 per window, rounded up to a power of two.

    Under ``combine='max'`` the ``non`` channel is combined in
    event-evidence space (through its complement): a maximum of ``non``
    itself would let one window that missed an event veto its neighbour's
    detection.

    A record shorter than one window is zero right-padded to one window
    (the pad joins the window's normalization), scored, then trimmed:
    picks in the pad are dropped, intervals clipped to the last true
    sample, and ``prob`` returned at the true length.

    Returns {"ppk": indices, "spk": indices, "det": (k, 2) intervals,
    "prob": (L, 3) stitched curve} as numpy, in absolute sample positions,
    copied from the device once.
    """
    if channel0 not in ("non", "det"):
        raise ValueError(f"channel0 must be 'non' or 'det', got {channel0!r}")
    record = np.asarray(record, np.float32)
    if record.shape[0] == 0:
        raise ValueError("empty record")
    true_len = record.shape[0]
    if true_len < window:
        record = np.concatenate(
            [record, np.zeros((window - true_len, record.shape[1]), np.float32)], axis=0)
    stride = stride or window // 2
    offsets = window_offsets(record.shape[0], window, stride)
    if max_events is None:
        # A power of two: the picks' shapes take few distinct values.
        max_events = 1 << (max(32, 4 * len(offsets)) - 1).bit_length()

    n = len(offsets)
    probs = []
    for i in range(0, n, batch_size):
        offs = offsets[i : i + batch_size]
        chunk = np.stack([record[o : o + window] for o in offs], axis=0)
        chunk = normalize(chunk, "std", axis=1)  # per window; time is axis 1
        pad = batch_size - chunk.shape[0]
        if pad:  # one batch shape: one warm program
            chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, 0)], axis=0)
        out = torch.as_tensor(apply_fn(np.ascontiguousarray(chunk, np.float32)))
        # Stays on its device; the slice of a replay's output is a view of
        # a fresh copy (the program copies its outputs out of the graph).
        probs.append(out[: batch_size - pad] if pad else out)
    probs_t = torch.cat(probs, dim=0).float()

    invert0 = channel0 == "non"
    if combine == "max" and invert0:
        ev = probs_t.clone()
        ev[..., 0] = 1.0 - ev[..., 0]  # event-evidence space (docstring)
        curve = stitch_probs(ev, offsets, record.shape[0], combine="max")
        curve[..., 0] = 1.0 - curve[..., 0]
    else:
        curve = stitch_probs(probs_t, offsets, record.shape[0], combine=combine)

    dist = int(min_peak_dist * sampling_rate)
    ppk = pick_peaks(curve[None, :, 1], ppk_threshold, dist, max_events)[0]
    spk = pick_peaks(curve[None, :, 2], spk_threshold, dist, max_events)[0]
    strength = (1.0 - curve[:, 0]) if invert0 else curve[:, 0]
    det = detect_events(strength[None, :], det_threshold, max_events)[0]
    # The one device-to-host copy: picks and the curve's bits as int32.
    flat = torch.cat([ppk, spk, det, curve[:true_len].contiguous().view(torch.int32).reshape(-1)])
    host = flat.cpu().numpy()
    k = max_events
    ppk, spk, det = host[:k], host[k : 2 * k], host[2 * k : 4 * k].reshape(-1, 2)
    prob = host[4 * k :].view(np.float32).reshape(true_len, curve.shape[1])
    ppk = ppk[ppk >= 0]
    spk = spk[spk >= 0]
    # >= keeps single-sample events (on == off); the [1, 0] padding is stripped.
    det = det[det[:, 1] >= det[:, 0]]
    if true_len < record.shape[0]:  # trim the short record's pad back off
        ppk = ppk[ppk < true_len]
        spk = spk[spk < true_len]
        det = det[det[:, 0] < true_len]
        det = np.minimum(det, true_len - 1)
    return {"ppk": ppk, "spk": spk, "det": det, "prob": prob}
