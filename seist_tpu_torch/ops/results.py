"""Test-time result accumulation -> CSV, and the re-picking catalog's rows
(counterpart of ``seist_tpu/ops/results.py``: ``ResultSaver``,
``catalog_rows``, ``catalog_row_lines``).

``ResultSaver`` collects per-batch meta data, targets and processed
results and writes one CSV with ``<meta>``, ``pred_<task>`` and
``tgt_<task>`` columns: the ``test_results_<dataset>.csv`` file contract.
The JAX package writes it with pandas' ``DataFrame.to_csv``; the port has
no pandas, so :meth:`ResultSaver.save_as_csv` writes the same bytes with
the ``csv`` module: an unnamed leading index column, ``str`` of each value
(NaN as an empty cell), minimal quoting, ``\\n`` line ends.
"""

from __future__ import annotations

import csv
import json
import math
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seist_tpu_torch import taskspec
from seist_tpu_torch.utils.logger import logger


class ResultSaver:
    def __init__(self, item_names: Sequence[str]):
        self._item_names = list(item_names)
        self._results_dict: Dict[str, list] = defaultdict(list)
        self._warned_unknown = False

    @staticmethod
    def _to_list(v: Any) -> list:
        if torch.is_tensor(v):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            v = np.asarray(v).tolist()
        if not isinstance(v, list):
            raise TypeError(f"Unknown data type: {type(v)}")
        return v

    def _convert_type(self, v: Any) -> list:
        """Flatten nested per-row lists to CSV cells: [] -> '', [x] -> x,
        [a, b] -> 'a,b'."""
        v = self._to_list(v)
        for i in range(len(v)):
            if isinstance(v[i], list):
                if len(v[i]) == 0:
                    v[i] = ""
                elif len(v[i]) == 1:
                    v[i] = v[i][0]
                else:
                    v[i] = ",".join(str(x) for x in v[i])
        return v

    def _process_item(self, k: str, v: Any, prefix: str = "") -> Tuple[str, Any]:
        """One-hot -> argmax index; ppk/spk padding stripped (> 0 kept)."""
        if k in taskspec.IO_ITEMS and taskspec.get_kind(k) == taskspec.ONEHOT:
            v = np.argmax(np.asarray(self._to_list(v)), axis=-1)
        if k in ("ppk", "spk"):
            v = [[x for x in row if x > 0] for row in self._to_list(v)]
        return f"{prefix}{k}", v

    def append(
        self,
        batch_meta_data: Dict[str, list],
        targets: Dict[str, Any],
        results: Dict[str, Any],
    ) -> None:
        """Append one batch of rows."""
        if not isinstance(batch_meta_data, dict):
            raise TypeError(f"batch_meta_data must be a dict, got {type(batch_meta_data)}")
        known = set(results) | set(targets)
        unknown = known - set(self._item_names)
        missing = set(self._item_names) - known
        if unknown and not self._warned_unknown:
            logger.warning(
                f"[ResultSaver] unknown names in outputs: {unknown}, "
                f"expected: {self._item_names}"
            )
            self._warned_unknown = True
        if missing:
            raise AttributeError(
                f"[ResultSaver] not found names: {missing}, expected: {self._item_names}"
            )
        for k, v in batch_meta_data.items():
            self._results_dict[k].extend(self._convert_type(list(v)))
        for k in self._item_names:
            pred_k, pred_v = self._process_item(k, results[k], prefix="pred_")
            self._results_dict[pred_k].extend(self._convert_type(pred_v))
            tgt_k, tgt_v = self._process_item(k, targets[k], prefix="tgt_")
            self._results_dict[tgt_k].extend(self._convert_type(tgt_v))

    @staticmethod
    def _cell(x: Any) -> str:
        if x is None or (isinstance(x, float) and math.isnan(x)):
            return ""
        return str(x)

    def save_as_csv(self, path: str) -> None:
        columns = list(self._results_dict)
        lengths = {len(self._results_dict[c]) for c in columns}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {sorted(lengths)}")
        n = lengths.pop() if lengths else 0
        sdir = os.path.dirname(path)
        if sdir:
            os.makedirs(sdir, exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + columns)
            for i in range(n):
                w.writerow([str(i)] + [self._cell(self._results_dict[c][i]) for c in columns])


def catalog_rows(
    decoded: Dict[str, Dict[str, Any]],
    *,
    n_valid: int,
    row_ids: Sequence[int],
    keys: Optional[Sequence[str]] = None,
    stations: Optional[Dict[str, Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """Batched head results -> JSON-able catalog rows, one per waveform
    (``seist_tpu/ops/results.py::catalog_rows``, the same rows).

    ``decoded`` is ``{task: {name: host array}}`` from
    ``ops/postprocess.py::decode_head_batch`` after the caller's one copy
    to the host; padding rows (``>= n_valid``) are dropped. Per name:

    * ``ppk``/``spk`` -> the kept pick sample indices (padding stripped);
    * ``det`` -> ``[onset, offset]`` sample pairs (empty pairs stripped);
    * ONEHOT labels -> ``{"class": argmax, "scores": [...]}``;
    * VALUE labels -> the scalar, rounded to 6 decimals (its float repr is
      then deterministic: the catalog's byte identity).

    Label names are unique across the five task heads, so a group's heads
    flatten into one row. ``stations`` (``{key: {"id", "network", "lat",
    "lon"}}``) adds each matched row's ``station`` block, the metadata
    ``/predict`` and ``/stream`` carry."""
    rows: List[Dict[str, Any]] = []
    host = {task: {k: np.asarray(v) for k, v in outs.items()} for task, outs in decoded.items()}
    for j in range(int(n_valid)):
        row: Dict[str, Any] = {"row": int(row_ids[j])}
        if keys is not None:
            row["key"] = str(keys[j])
            if stations is not None:
                st = stations.get(row["key"])
                if st is not None:
                    row["station"] = st
        for outs in host.values():
            for name, arr in outs.items():
                if name in ("ppk", "spk"):
                    idxs = arr[j]
                    row[name] = [int(i) for i in idxs[idxs >= 0]]
                elif name == "det":
                    pairs = arr[j].reshape(-1, 2)
                    pairs = pairs[pairs[:, 1] >= pairs[:, 0]]
                    row[name] = [[int(a), int(b)] for a, b in pairs]
                elif name in taskspec.IO_ITEMS and taskspec.get_kind(name) == taskspec.ONEHOT:
                    scores = arr[j].reshape(-1)
                    row[name] = {
                        "class": int(np.argmax(scores)),
                        "scores": [round(float(s), 6) for s in scores],
                    }
                else:
                    row[name] = round(float(arr[j].reshape(-1)[0]), 6)
        rows.append(row)
    return rows


def catalog_row_lines(rows: Sequence[Dict[str, Any]]) -> List[str]:
    """Catalog rows as canonical JSONL lines (sorted keys, compact
    separators): the same rows give the same bytes in any process."""
    return [json.dumps(r, sort_keys=True, separators=(",", ":")) + "\n" for r in rows]
