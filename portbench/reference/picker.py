"""The reference picker and the input preparation of re-picking, in NumPy
and plain PyTorch.

Peaks: rising-edge local maxima (a plateau keeps its rising edge), the
first and last sample excluded, height at least the threshold; the
``topk`` tallest (ties to the earlier sample), then greedy suppression of
any peak within ``min_dist`` samples of a taller kept one; positions
ascending. Events: maximal runs above the threshold, the ``topk``
longest (ties to the earlier run), as [onset, offset] pairs, longest
first. These are the decision rules of SeisT's post-processing.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def normalize(raw: torch.Tensor) -> torch.Tensor:
    """(B, C, L) traces -> channels-last (B, L, C), each channel's mean
    removed and divided by its population std (a zero std by 1)."""
    x = raw - raw.mean(dim=2, keepdim=True)
    std = raw.std(dim=2, keepdim=True, correction=0)
    return (x / torch.where(std == 0, torch.ones_like(std), std)).transpose(1, 2)


def peaks(x: np.ndarray, threshold: float, min_dist: int, topk: int) -> List[int]:
    x = np.asarray(x, np.float32)
    dx = np.diff(x)
    cand = np.zeros(x.size, bool)
    cand[1:-1] = (dx[1:] <= 0) & (dx[:-1] > 0)
    cand &= x >= np.float32(threshold)
    idx = np.flatnonzero(cand)
    order = idx[np.argsort(-x[idx], kind="stable")][:topk]
    kept: List[int] = []
    deleted = np.zeros(order.size, bool)
    for k, centre in enumerate(order):
        if deleted[k]:
            continue
        kept.append(int(centre))
        deleted |= np.abs(order - centre) <= min_dist
    return sorted(kept)


def events(x: np.ndarray, threshold: float, topk: int) -> List[List[int]]:
    above = np.asarray(x, np.float32) > np.float32(threshold)
    edges = np.diff(np.concatenate([[0], above.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1) - 1
    order = np.argsort(-(ends - starts), kind="stable")[:topk]
    return [[int(starts[i]), int(ends[i])] for i in order]


def pick_row(curves: np.ndarray, opts: Dict) -> Dict[str, list]:
    """One row's (L, 3) (det, ppk, spk) probabilities -> its catalog
    fields."""
    mpd = int(opts["min_peak_dist_s"] * opts["sampling_rate"])
    k = int(opts["max_events"])
    return {
        "det": events(curves[:, 0], opts["det_threshold"], k),
        "ppk": peaks(curves[:, 1], opts["ppk_threshold"], mpd, k),
        "spk": peaks(curves[:, 2], opts["spk_threshold"], mpd, k),
    }
