"""Batched peak picking and event detection on the device, in torch.

Counterpart of ``seist_tpu/ops/postprocess.py``, with the same fixed
shapes and the same results:

* peaks: rising-edge local maxima (a plateau keeps its rising edge), first
  and last sample excluded, height >= ``prob_threshold``, the ``topk``
  tallest kept, then greedy minimum-distance suppression in height order,
  sorted by position and padded with ``padding_value``.
* events: maximal runs with prob > threshold, the ``topk`` longest, padded
  with ``[1, 0]`` pairs.

Ties break toward the earlier index, as ``lax.top_k`` does: ``torch.topk``
guarantees no order among equal values, so ranking uses
``torch.sort(stable=True, descending=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch

PAD_VALUE = int(-1e7)


def _rank_desc(x: torch.Tensor, topk: int):
    """Values and indices of the ``topk`` largest per row, equal values in
    index order."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :topk], idx[:, :topk]


def pick_peaks(
    x: torch.Tensor,
    prob_threshold: float,
    min_peak_dist: int,
    topk: int,
    padding_value: int = PAD_VALUE,
) -> torch.Tensor:
    """Batched peak picking: ``x`` (N, L) -> (N, topk) int32 peak indices."""
    if x.dim() != 2:
        raise ValueError(f"pick_peaks expects (N, L), got {tuple(x.shape)}")
    n, length = x.shape
    x = x.float()
    dx = x[:, 1:] - x[:, :-1]
    zeros = torch.zeros((n, 1), dtype=x.dtype, device=x.device)
    dx_next = torch.cat([dx, zeros], dim=1)
    dx_prev = torch.cat([zeros, dx], dim=1)
    cand = (dx_next <= 0) & (dx_prev > 0)
    cand[:, 0] = False
    cand[:, -1] = False
    cand &= x >= prob_threshold

    heights = torch.where(cand, x, float("-inf"))
    top_h, top_i = _rank_desc(heights, topk)
    valid = torch.isfinite(top_h)

    if min_peak_dist > 1:
        # Greedy suppression in height order among the topk; K is small.
        idel = ~valid
        for k in range(top_i.shape[1]):
            alive = ~idel[:, k] & valid[:, k]
            centre = top_i[:, k : k + 1]
            close = (top_i >= centre - min_peak_dist) & (top_i <= centre + min_peak_dist)
            idel = torch.where(alive[:, None], idel | close, idel)
            idel[:, k] = torch.where(alive, False, idel[:, k])
        keep = ~idel & valid
    else:
        keep = valid

    sentinel = length + 1
    pos = torch.where(keep, top_i, sentinel)
    pos, _ = torch.sort(pos, dim=1)
    return torch.where(pos >= sentinel, padding_value, pos).to(torch.int32)


def detect_events(x: torch.Tensor, prob_threshold: float, topk: int) -> torch.Tensor:
    """Batched event detection: ``x`` (N, L) -> (N, topk*2) int32 [on, off]."""
    if x.dim() != 2:
        raise ValueError(f"detect_events expects (N, L), got {tuple(x.shape)}")
    n, length = x.shape
    above = x > prob_threshold
    false_col = torch.zeros((n, 1), dtype=torch.bool, device=x.device)
    starts = above & ~torch.cat([false_col, above[:, :-1]], dim=1)
    ends = above & ~torch.cat([above[:, 1:], false_col], dim=1)

    # Each maximal run has one start and one end; its id is the running
    # count of starts. Positions that are not a start (or an end) scatter
    # into a spare slot ``capacity`` that is dropped afterwards.
    capacity = length // 2 + 1
    run_id = torch.cumsum(starts.long(), dim=1) - 1
    pos = torch.arange(length, device=x.device).expand(n, length)

    def runs(marks: torch.Tensor) -> torch.Tensor:
        ids = torch.where(marks, run_id, capacity)
        arr = torch.full((n, capacity + 1), -1, dtype=torch.long, device=x.device)
        return arr.scatter_(1, ids, pos)[:, :capacity]

    s_arr, e_arr = runs(starts), runs(ends)
    run_valid = s_arr >= 0
    lengths = torch.where(run_valid, e_arr - s_arr, -1)

    _, idx = _rank_desc(lengths, topk)
    sel_valid = torch.gather(run_valid, 1, idx)
    on = torch.where(sel_valid, torch.gather(s_arr, 1, idx), 1)
    off = torch.where(sel_valid, torch.gather(e_arr, 1, idx), 0)
    return torch.stack([on, off], dim=-1).reshape(n, topk * 2).to(torch.int32)


def process_outputs(
    outputs: Union[torch.Tensor, Sequence[torch.Tensor]],
    label_names: Sequence[Union[str, Sequence[str]]],
    sampling_rate: int,
    *,
    ppk_threshold: float = 0.3,
    spk_threshold: float = 0.3,
    det_threshold: float = 0.5,
    min_peak_dist: float = 1.0,
    max_detect_event_num: int = 1,
) -> Dict[str, Any]:
    """Raw model outputs -> per-task results. Dense per-sample groups are
    channels-last ``(N, L, C)``. ppk/spk -> (N, topk) indices, det ->
    (N, topk*2) on/off pairs, others passed through (at least 2-D)."""
    outputs_list = outputs if isinstance(outputs, (tuple, list)) else [outputs]
    mpd = int(min_peak_dist * sampling_rate)
    results: Dict[str, Any] = {}
    for out, label_group in zip(outputs_list, label_names):
        if isinstance(label_group, (tuple, list)):
            for i, name in enumerate(label_group):
                if name in ("ppk", "spk"):
                    results[name] = pick_peaks(
                        out[..., i],
                        prob_threshold=ppk_threshold if name == "ppk" else spk_threshold,
                        min_peak_dist=mpd,
                        topk=max_detect_event_num,
                    )
                elif name == "det":
                    results[name] = detect_events(
                        out[..., i],
                        prob_threshold=det_threshold,
                        topk=max_detect_event_num,
                    )
                else:
                    tmp = out[..., i]
                    results[name] = tmp[:, None] if tmp.dim() < 2 else tmp
        else:
            results[label_group] = out
    return results


#: The decision-level picker results a catalog keeps (dense per-sample
#: channels such as ``non`` are decode intermediates, not catalog content).
_CATALOG_PICK_NAMES = ("ppk", "spk", "det")


def decode_head_batch(
    spec: Any,
    outputs: Any,
    *,
    is_picker: bool,
    sampling_rate: int,
    ppk_threshold: float = 0.3,
    spk_threshold: float = 0.3,
    det_threshold: float = 0.5,
    min_peak_dist: float = 1.0,
    max_events: int = 8,
) -> Dict[str, Any]:
    """Batched decode of ONE head's raw outputs into named result tensors
    on the outputs' device (``seist_tpu/ops/postprocess.py::decode_head_batch``).
    The caller copies every head's results to the host at once and feeds
    them to :func:`seist_tpu_torch.ops.results.catalog_rows`.

    Pickers go through :func:`process_outputs` and keep only the
    decision-level ``ppk``/``spk``/``det`` tensors. VALUE heads apply the
    spec's ``outputs_transform_for_results`` (baz (cos, sin) -> degrees,
    MagNet's mean) and give one tensor per label with leading dim N;
    ONEHOT heads give the (N, C) scores (the argmax is taken on the host,
    in ``catalog_rows``)."""
    if is_picker:
        res = process_outputs(
            outputs,
            spec.labels,
            sampling_rate,
            ppk_threshold=ppk_threshold,
            spk_threshold=spk_threshold,
            det_threshold=det_threshold,
            min_peak_dist=min_peak_dist,
            max_detect_event_num=max_events,
        )
        return {k: v for k, v in res.items() if k in _CATALOG_PICK_NAMES}
    transform = spec.outputs_transform_for_results
    outs = transform(outputs) if transform else outputs
    outs_list = outs if isinstance(outs, (tuple, list)) else [outs]
    if len(outs_list) != len(spec.labels):
        raise ValueError(f"head produced {len(outs_list)} outputs for {len(spec.labels)} labels")
    return {str(name): arr for name, arr in zip(spec.labels, outs_list)}
