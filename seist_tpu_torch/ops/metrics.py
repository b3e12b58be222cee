"""Streaming task metrics as counter dicts, in torch (counterpart of
``seist_tpu/ops/metrics.py``).

:func:`batch_counters` turns one batch of (targets, predictions) into a
dict of scalar (or per-class) counters on the predictions' device, with no
host sync; :func:`merge` adds two such dicts; :func:`finalize` turns the
accumulated counters into metric values in float64 on the host. The
:class:`Metrics` class keeps the reference's API (``compute`` per batch,
``+`` / ``add`` to accumulate, ``get_metrics`` to read) on top; R2's raw
targets are gathered on the host.

Per task, as the JAX package computes it:

* ppk/spk: predictions matched greedily to targets (:func:`order_phases`);
  a true positive has both indices in [0, num_samples) and
  |t - p| <= time_threshold * fs; residual metrics are masked by it.
* det: interval-overlap indicator sums over the sample axis.
* onehot: argmax -> per-class confusion counters, macro-averaged at
  :func:`finalize`.
* value: mean/rmse/mae/mape over per-sample residual means; baz residuals
  wrap at +/-180 degrees; R2 against the gathered targets.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

EPSILON = 1e-6
CMAT_KEYS = ("tp", "predp", "possp")
REGR_KEYS = ("sum_res", "sum_squ_res", "sum_abs_res", "sum_abs_per_res")
AVAILABLE_METRICS = ("precision", "recall", "f1", "mean", "rmse", "mae", "mape", "r2")

_CMAT_METRICS = frozenset(("precision", "recall", "f1"))
_REGR_METRICS = frozenset(("mean", "rmse", "mae", "mape"))


def _needs(metric_names: Sequence[str]) -> Tuple[bool, bool, bool]:
    names = set(metric_names)
    return (
        bool(names & _CMAT_METRICS),
        bool(names & (_REGR_METRICS | {"r2"})),
        "r2" in names,
    )


def order_phases(targets: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Greedily match predicted phase indices to targets by |distance|:
    repeatedly take the closest remaining (target, pred) pair of each row,
    assign it and mask its row and column. Returns the reordered
    predictions, shape (N, P).

    Consumed cells are masked with +inf, as the JAX package does (the
    reference's 1e6 is smaller than the ~1e7 distance to a padded
    prediction, so its argmin can pick a consumed cell again)."""
    n, num_phases = targets.shape
    dmat = (targets[:, :, None] - preds[:, None, :]).abs().to(torch.float32)
    ordered = torch.zeros_like(preds)
    rows = torch.arange(n, device=preds.device)
    for _ in range(num_phases):
        flat = torch.argmin(dmat.reshape(n, -1), dim=1)  # first minimum, as jnp.argmin
        ito, ifr = flat // num_phases, flat % num_phases
        ordered[rows, ito] = preds[rows, ifr]
        dmat[rows, ito, :] = float("inf")
        dmat[rows, :, ifr] = float("inf")
    return ordered


def init_counters(metric_names: Sequence[str], num_classes: int = 1) -> Dict[str, torch.Tensor]:
    """Zero counters; ``num_classes > 1`` only for onehot tasks."""
    want_cmat, want_regr, _ = _needs(metric_names)
    data: Dict[str, torch.Tensor] = {}
    if want_cmat:
        shape = (num_classes,) if num_classes > 1 else ()
        for k in CMAT_KEYS:
            data[k] = torch.zeros(shape, dtype=torch.float32)
    if want_regr:
        for k in REGR_KEYS:
            data[k] = torch.zeros((), dtype=torch.float32)
    data["data_size"] = torch.zeros((), dtype=torch.int32)
    return data


def batch_counters(
    task: str,
    metric_names: Sequence[str],
    targets: torch.Tensor,
    preds: torch.Tensor,
    *,
    num_samples: int,
    time_threshold_samples: int = 0,
) -> Dict[str, torch.Tensor]:
    """Counters of ONE batch, shapes (N, ...) -> scalars (or (classes,)),
    on ``preds``' device; :func:`merge` accumulates them."""
    task = task.lower()
    metric_names = tuple(n.lower() for n in metric_names)
    want_cmat, want_regr, _ = _needs(metric_names)
    dev = preds.device
    # 32-bit arithmetic, as the JAX package computes (64-bit inputs are
    # narrowed there when they enter jnp).
    narrow = {torch.float64: torch.float32, torch.int64: torch.int32}
    targets = targets.to(dev, narrow.get(targets.dtype, targets.dtype))
    preds = preds.to(narrow.get(preds.dtype, preds.dtype))
    data: Dict[str, torch.Tensor] = {
        "data_size": torch.tensor(targets.shape[0], dtype=torch.int32, device=dev)
    }
    mask: Union[float, torch.Tensor] = 1.0

    if want_cmat:
        if task in ("ppk", "spk"):
            t = targets.to(torch.int32)
            p = preds.to(torch.int32)
            if t.shape[-1] > 1:
                p = order_phases(t, p)
            preds_bin = (p >= 0) & (p < num_samples)
            targets_bin = (t >= 0) & (t < num_samples)
            tp_bin = preds_bin & targets_bin & ((t - p).abs() <= time_threshold_samples)
            mask = tp_bin
            targets, preds = t, p
            data["tp"] = tp_bin.sum().to(torch.float32)
            data["predp"] = preds_bin.sum().to(torch.float32)
            data["possp"] = targets_bin.sum().to(torch.float32)
        elif task == "det":
            bs = targets.shape[0]
            t = targets.to(torch.int32).reshape(bs, -1, 2)
            p = preds.to(torch.int32).reshape(bs, -1, 2)
            idx = torch.arange(num_samples, device=dev)[None, None, :]
            targets_bin = ((t[:, :, :1] <= idx) & (idx <= t[:, :, 1:])).sum(dim=-2)
            preds_bin = ((p[:, :, :1] <= idx) & (idx <= p[:, :, 1:])).sum(dim=-2)
            data["tp"] = (targets_bin * preds_bin).clamp(0, 1).sum().to(torch.float32)
            data["predp"] = preds_bin.clamp(0, 1).sum().to(torch.float32)
            data["possp"] = targets_bin.clamp(0, 1).sum().to(torch.float32)
        else:  # onehot: argmax -> per-class counters
            classes = preds.shape[-1]
            p1 = torch.nn.functional.one_hot(preds.argmax(dim=-1), classes).to(torch.float32)
            t1 = torch.nn.functional.one_hot(targets.argmax(dim=-1), targets.shape[-1]).to(
                torch.float32)
            data["tp"] = (t1 * p1).sum(dim=0)
            data["predp"] = p1.sum(dim=0)
            data["possp"] = t1.sum(dim=0)
            targets, preds = t1, p1

    if want_regr:
        res = (targets - preds).to(torch.float32)
        if task == "baz":  # wrap residuals at +/-180 degrees
            res = torch.where(res.abs() > 180, -torch.sign(res) * (360 - res.abs()), res)
        res_m = res * mask
        data["sum_res"] = res_m.mean(-1).sum()
        data["sum_squ_res"] = res_m.square().mean(-1).sum()
        data["sum_abs_res"] = res_m.abs().mean(-1).sum()
        data["sum_abs_per_res"] = (
            (res_m / (targets.to(torch.float32) + EPSILON)).abs().mean(-1).sum()
        )
    return data


def merge(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Accumulate counters."""
    if set(a) != set(b):
        raise TypeError(f"Mismatched data fields: {set(a)} and {set(b)}")
    return {k: a[k] + b[k] for k in a}


def finalize(
    task: str,
    metric_names: Sequence[str],
    counters: Dict[str, np.ndarray],
    tgts: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Metric values from accumulated host counters, in float64. ``tgts``
    (all raw targets) is needed only for R2."""
    task = task.lower()
    out: Dict[str, float] = {}
    c = {k: np.asarray(v, dtype=np.float64) for k, v in counters.items()}
    for key in (n.lower() for n in metric_names):
        if key == "precision":
            v = (c["tp"] / (c["predp"] + EPSILON)).mean()
        elif key == "recall":
            v = (c["tp"] / (c["possp"] + EPSILON)).mean()
        elif key == "f1":
            pr = c["tp"] / (c["predp"] + EPSILON)
            re = c["tp"] / (c["possp"] + EPSILON)
            v = (2 * pr * re / (pr + re + EPSILON)).mean()
        elif key == "mean":
            v = c["sum_res"] / c["data_size"]
        elif key == "rmse":
            v = np.sqrt(c["sum_squ_res"] / c["data_size"])
        elif key == "mae":
            v = c["sum_abs_res"] / c["data_size"]
        elif key == "mape":
            v = c["sum_abs_per_res"] / c["data_size"]
        elif key == "r2":
            if tgts is None:
                raise ValueError("r2 requires the gathered targets")
            t = np.asarray(tgts, dtype=np.float64)
            t = t - t.mean()
            if task == "baz":
                t = np.where(np.abs(t) > 180, -np.sign(t) * (360 - np.abs(t)), t)
            v = 1 - c["sum_squ_res"] / (np.square(t).mean(-1).sum() + EPSILON)
        else:
            raise ValueError(f"Unexpected metric name: '{key}'")
        out[key] = float(v)
    return out


class Metrics:
    """The reference's metrics API: ``compute`` per batch, ``+``/``add`` to
    accumulate, ``get_metrics`` to read. Counters stay on the predictions'
    device until read (one transfer); R2 targets accumulate on the host."""

    def __init__(
        self,
        task: str,
        metric_names: Union[list, tuple],
        sampling_rate: int,
        time_threshold: float,
        num_samples: int,
    ) -> None:
        self._task = task.lower()
        self._metric_names = tuple(n.lower() for n in metric_names)
        unexpected = set(self._metric_names) - set(AVAILABLE_METRICS)
        if unexpected:
            raise ValueError(f"Unexpected metrics: {unexpected}")
        self._t_thres = int(time_threshold * sampling_rate)
        self._num_samples = num_samples
        self._counters: Optional[Dict[str, torch.Tensor]] = None
        self._host_counters: Optional[Dict[str, np.ndarray]] = None
        self._tgts: List[np.ndarray] = []
        self._results: Optional[Dict[str, float]] = None

    @property
    def counters(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._counters

    def compute(self, targets, preds) -> None:
        """Accumulate one batch. ``targets`` are host numpy arrays (the
        loader's metrics targets) or tensors; ``preds`` a tensor, whose
        device the counters live on."""
        preds = torch.as_tensor(preds)
        batch = batch_counters(
            self._task,
            self._metric_names,
            torch.as_tensor(targets),
            preds,
            num_samples=self._num_samples,
            time_threshold_samples=self._t_thres,
        )
        self._counters = batch if self._counters is None else merge(self._counters, batch)
        if "r2" in self._metric_names:
            self._tgts.append(
                targets.detach().cpu().numpy() if torch.is_tensor(targets) else np.asarray(targets)
            )
        self._results = None

    def add(self, other: "Metrics") -> None:
        if type(self) is not type(other):
            raise TypeError(f"Type of `other` must be `Metrics`, got `{type(other)}`")
        if other._counters is not None:
            self._counters = (
                copy.deepcopy(other._counters)
                if self._counters is None
                else merge(self._counters, other._counters)
            )
        self._tgts.extend(other._tgts)
        self._results = None

    def __add__(self, other: "Metrics") -> "Metrics":
        c = copy.deepcopy(self)
        c.add(other)
        return c

    def synchronize_between_processes(self, group=None) -> None:
        """Sum the counters over ``group``'s ranks (every rank, or the data
        group: seq ranks score the same rows) and gather the R2 targets in
        rank order (``seist_tpu/ops/metrics.py:303``): each rank's rows are
        padded to the largest count, gathered, and trimmed by each rank's
        count. One rank: nothing."""
        from seist_tpu_torch.parallel import comm

        if comm.group_size(group) <= 1:
            return
        if self._counters is not None:
            self._counters = {k: comm.all_reduce(v, "sum", group)
                              for k, v in self._counters.items()}
        if "r2" in self._metric_names:
            local = np.concatenate(self._tgts, axis=0) if self._tgts else np.zeros((0, 1))
            counts = comm.all_gather(torch.tensor([local.shape[0]], dtype=torch.int64),
                                     0, group).tolist()
            padded = np.zeros((max(counts),) + local.shape[1:], dtype=local.dtype)
            padded[: local.shape[0]] = local
            gathered = comm.all_gather(torch.from_numpy(padded)[None], 0, group).numpy()
            self._tgts = [np.concatenate([gathered[r, :c] for r, c in enumerate(counts)],
                                         axis=0)]
        self._results = None

    def _all(self) -> Dict[str, float]:
        if self._results is None:
            tgts = np.concatenate(self._tgts, axis=0) if self._tgts else None
            counters = (
                self._counters if self._counters is not None
                else init_counters(self._metric_names)
            )
            self._host_counters = {k: v.cpu().numpy() for k, v in counters.items()}
            self._results = finalize(self._task, self._metric_names, self._host_counters, tgts)
        return self._results

    def get_metric(self, name: str) -> float:
        return self._all()[name.lower()]

    def get_metrics(self, names: Sequence[str]) -> Dict[str, float]:
        all_m = self._all()
        return {n: all_m[n.lower()] for n in names if n.lower() in all_m}

    def get_all_metrics(self) -> Dict[str, float]:
        return dict(self._all())

    def metric_names(self) -> List[str]:
        return list(self._metric_names)

    def __repr__(self) -> str:
        return "  ".join(f"{k.upper()} {v:6.4f}" for k, v in self._all().items())

    def to_dict(self) -> dict:
        self._all()
        out: dict = {}
        if self._counters:
            for k, arr in self._host_counters.items():
                if arr.ndim == 0:
                    out[k] = arr.item()
                else:
                    for i, vi in enumerate(arr.tolist()):
                        out[f"{k}.{i}"] = vi
        out.update(self._all())
        return out


def data_plane_counters() -> Dict[str, int]:
    """Snapshot of the data-plane guard's counters (reads, retries, handle
    reopens, quarantined samples, fallback reads, stall trips, loader
    deaths): the one reader of ``data/io_guard.py::COUNTERS`` behind the
    metrics bus's ``data_plane`` collector (``obs/bus.py``), as
    ``seist_tpu/ops/metrics.py::data_plane_counters`` is in the JAX
    package."""
    from seist_tpu_torch.data.io_guard import COUNTERS

    return COUNTERS.snapshot()
