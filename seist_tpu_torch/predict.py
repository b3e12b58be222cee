"""``python -m seist_tpu_torch predict``: a continuous record -> a picks CSV.

    python -m seist_tpu_torch predict --model-name seist_s_dpk \\
        --checkpoint seist_s_dpk.pt --input record.npz --output picks.csv \\
        [--window 8192] [--stride 4096] [--batch-size 32] [--device cuda]

The counterpart of ``tools/predict.py``, with its flags and defaults
(``--combine max``) plus ``--device``. ``--input`` is an ``.npz`` whose
``data`` is (L, C) or (C, L), any length. The model loads through the
serve pool (``serve/pool.py::load_model_entry``, ``--checkpoint ""``
serves seeded weights), and its bucket of ``--batch-size`` is captured
before the record is read: every window batch replays that program (a
CUDA graph on the card, with K1 in it). ``ops/stream.py::annotate``
stitches and picks on the device. A model that is not of the dpk family
(``(non|det, ppk, spk)`` outputs) is refused before the input is read.

The CSV is the one ``tools/predict.py`` writes through pandas
(``DataFrame(rows).to_csv(index=False)``), written here without pandas
byte for byte (:func:`picks_csv`): one row per P pick, S pick and
detection, with its sample and time in seconds at ``--sampling-rate``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seist_tpu_torch predict",
                                 description="continuous-record picking")
    ap.add_argument("--model-name", default="seist_s_dpk")
    ap.add_argument("--checkpoint", required=True,
                    help="the port's weights file (.pt); '' serves seeded weights")
    ap.add_argument("--input", required=True, help=".npz with 'data'")
    ap.add_argument("--output", default="picks.csv")
    ap.add_argument("--window", type=int, default=8192)
    ap.add_argument("--stride", type=int, default=0, help="0 = window//2")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--sampling-rate", type=int, default=50)
    ap.add_argument("--ppk-threshold", type=float, default=0.3)
    ap.add_argument("--spk-threshold", type=float, default=0.3)
    ap.add_argument("--det-threshold", type=float, default=0.5)
    ap.add_argument("--min-peak-dist", type=float, default=1.0)
    ap.add_argument("--combine", default="max", choices=["mean", "max"],
                    help="overlap stitching: max (robust picks, default) or mean "
                    "(smoother curves)")
    ap.add_argument("--max-events", type=int, default=0,
                    help="cap on picks over the whole record; 0 = scale with record "
                    "length (4 per window span)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def pick_rows(picks: Mapping[str, Any], sampling_rate: float) -> List[Dict[str, Any]]:
    """``annotate``'s picks as ``tools/predict.py``'s rows: P, then S, then
    detections (with their ends)."""
    fs = float(sampling_rate)
    rows: List[Dict[str, Any]] = []
    for idx in picks["ppk"]:
        rows.append({"kind": "P", "sample": int(idx), "time_s": idx / fs})
    for idx in picks["spk"]:
        rows.append({"kind": "S", "sample": int(idx), "time_s": idx / fs})
    for on, off in picks["det"]:
        rows.append({"kind": "detection", "sample": int(on), "time_s": on / fs,
                     "end_sample": int(off), "end_time_s": off / fs})
    return rows


def picks_csv(rows: List[Dict[str, Any]]) -> str:
    """``pandas.DataFrame(rows).to_csv(index=False)`` for these rows: the
    columns in order of first appearance; a column with a missing cell or a
    float is a float column, whose values are written as Python writes a
    float (``300.0``) and whose missing cells stay empty; no rows: one
    empty line."""
    if not rows:
        return "\n"
    columns: List[str] = []
    for row in rows:
        columns += [c for c in row if c not in columns]
    floats = {c: any(c not in row or isinstance(row[c], (float, np.floating)) for row in rows)
              for c in columns}
    lines = [",".join(columns)]
    for row in rows:
        cells = []
        for c in columns:
            if c not in row:
                cells.append("")
            elif isinstance(row[c], str):
                cells.append(row[c])
            elif floats[c]:
                cells.append(repr(float(row[c])))
            else:
                cells.append(str(int(row[c])))
        lines.append(",".join(cells))
    return "\n".join(lines) + "\n"


def read_record(path: str) -> np.ndarray:
    """An ``.npz``'s ``data`` as (L, C) float32; (C, L) is transposed."""
    record = np.asarray(np.load(path)["data"], np.float32)
    if record.ndim != 2:
        raise ValueError(f"'data' must be 2-D, got {record.shape}")
    if record.shape[0] < record.shape[1]:  # (C, L) -> (L, C)
        record = record.T
    return record


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Pick the record and write the CSV; returns ``annotate``'s picks."""
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.ops.stream import annotate
    from seist_tpu_torch.serve.pool import load_model_entry

    args = get_args(argv)
    # Refuse the model family before the input is read.
    spec = taskspec.get_task_spec(args.model_name)
    first_group = spec.labels[0]
    if not (isinstance(first_group, (tuple, list)) and tuple(first_group)[0] in ("non", "det")
            and len(first_group) == 3):
        raise SystemExit(
            f"{args.model_name} is not a dpk-family model (labels {spec.labels}); "
            "continuous picking needs (non|det, ppk, spk) outputs")
    channel0 = first_group[0]

    entry = load_model_entry(args.model_name, args.checkpoint, window=args.window,
                             device=args.device)
    entry.warmup([args.batch_size])  # the one program every window batch replays
    record = read_record(args.input)
    picks = annotate(
        lambda x: entry.run(x, "fp32"), record, window=args.window,
        stride=args.stride or None, batch_size=args.batch_size,
        sampling_rate=args.sampling_rate, ppk_threshold=args.ppk_threshold,
        spk_threshold=args.spk_threshold, det_threshold=args.det_threshold,
        min_peak_dist=args.min_peak_dist, combine=args.combine,
        max_events=args.max_events or None, channel0=channel0)
    out = os.path.abspath(args.output)
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w", newline="") as f:
        f.write(picks_csv(pick_rows(picks, args.sampling_rate)))
    os.replace(tmp, out)
    print(f"{len(picks['ppk'])} P, {len(picks['spk'])} S, {len(picks['det'])} detections "
          f"-> {args.output}", flush=True)
    return picks
