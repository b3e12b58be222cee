"""Repick catalog: deterministic work units and segment-committed output
(the port's copy of ``seist_tpu/batch/catalog.py``; it writes the same
files under the same names, byte for byte).

Re-picking (``batch/engine.py``) is a map-reduce over a packed archive
(``data/packed.py``). This module owns the map side's addressing and the
reduce side's merge:

* **Work unit** = one packed shard's index rows ``[row_lo, row_hi)`` in
  pack order. :func:`plan_units` is a pure function of the archive's
  index, never of the worker count or of what output already exists, so
  any worker layout gets the same unit list.
* **Segment** = ``commit_every`` consecutive device calls of one unit (a
  call is ``batches_per_call x batch_size`` rows). Each segment's rows go
  to ``unit_XXXXX.seg_XXXX.jsonl`` through a temporary file and a rename:
  the rename is the commit, so a SIGKILL leaves either a whole segment or
  a hole, and :func:`first_missing_segment` restarts a worker at its
  exact offset.
* **Plan identity**: ``repick_plan.json`` records everything that fixes
  segment boundaries and row content (batch geometry, model, variant,
  thresholds); a worker refuses to resume into a directory whose plan
  differs.
* **Merge**: segments concatenated in (unit, segment) order into
  ``catalog.jsonl``; ``catalog_meta.json`` is written last (a directory
  without it holds no finished catalog). Every row is a pure function of
  (archive, plan), so the merged catalog is byte-identical across worker
  counts and kill/resume histories.

Rows are compact JSON objects, one per waveform, with sorted keys
(``ops/results.py::catalog_rows``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_PLAN = "repick_plan.json"
_CATALOG = "catalog.jsonl"
_CATALOG_META = "catalog_meta.json"
_SEG_RE = re.compile(r"^unit_(\d{5})\.seg_(\d{4})\.jsonl$")


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One packed shard's rows ``[row_lo, row_hi)`` (pack index order)."""

    unit_id: int  # == packed shard id
    row_lo: int
    row_hi: int

    @property
    def n(self) -> int:
        return self.row_hi - self.row_lo


def plan_units(shards_col: np.ndarray) -> List[WorkUnit]:
    """The deterministic unit partition from the archive index's
    ``shard`` column (rows of one shard are contiguous in pack order —
    the index is merged sidecar-by-sidecar)."""
    shards_col = np.asarray(shards_col, np.int64)
    if shards_col.size == 0:
        return []
    if (np.diff(shards_col) < 0).any():
        raise ValueError(
            "archive index 'shard' column is not in pack order; refusing "
            "to plan work units over a reordered index"
        )
    units: List[WorkUnit] = []
    ids, starts = np.unique(shards_col, return_index=True)
    bounds = list(starts) + [shards_col.size]
    for i, uid in enumerate(ids):
        units.append(WorkUnit(int(uid), int(bounds[i]), int(bounds[i + 1])))
    return units


# ------------------------------------------------------------- segment math
def calls_per_unit(unit: WorkUnit, rows_per_call: int) -> int:
    return -(-unit.n // rows_per_call)


def segments_per_unit(
    unit: WorkUnit, rows_per_call: int, commit_every: int
) -> int:
    return -(-calls_per_unit(unit, rows_per_call) // commit_every)


def segment_path(out_dir: str, unit_id: int, seg: int) -> str:
    return os.path.join(out_dir, f"unit_{unit_id:05d}.seg_{seg:04d}.jsonl")


def segment_fence_path(out_dir: str, unit_id: int, seg: int) -> str:
    return segment_path(out_dir, unit_id, seg) + ".fence"


def read_segment_fence(out_dir: str, unit_id: int, seg: int) -> Optional[int]:
    """The fencing token recorded beside a fleet-committed segment, or
    None for serial commits / the crash window between link and sidecar
    (both tolerated by the merge audit — the segment bytes themselves
    are identical either way)."""
    try:
        with open(segment_fence_path(out_dir, unit_id, seg)) as f:
            return int(f.read().strip())
    except FileNotFoundError:
        return None


def commit_segment(
    out_dir: str,
    unit_id: int,
    seg: int,
    lines: Sequence[str],
    *,
    fence: Optional[int] = None,
) -> str:
    """Atomically commit one segment's catalog rows.

    Serial path (``fence=None``, the resume contract):
    tmp+rename — last rename wins with identical content, since rows are
    a pure function of the plan.

    Fleet path (``fence`` = the committer's lease fencing token):
    EXCLUSIVE publish via ``os.link`` — the first committer wins and a
    zombie worker racing past its fence check hits FileExistsError
    instead of silently re-publishing (the engine converts that into the
    counted ``DoubleCommit``). The winning fence is recorded in a
    ``.fence`` sidecar AFTER the link so the merge audit can reject
    stale-fence histories; catalog bytes are untouched (byte-identity
    with serial runs is preserved — the sidecar is not merged)."""
    path = segment_path(out_dir, unit_id, seg)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("".join(lines))
    if fence is None:
        os.replace(tmp, path)
        return path
    try:
        os.link(tmp, path)
    finally:
        os.unlink(tmp)
    fpath = segment_fence_path(out_dir, unit_id, seg)
    ftmp = f"{fpath}.tmp.{os.getpid()}"
    with open(ftmp, "w") as f:
        f.write(str(int(fence)))
    os.replace(ftmp, fpath)
    return path


def first_missing_segment(
    out_dir: str, unit: WorkUnit, rows_per_call: int, commit_every: int
) -> int:
    """Resume point: the first segment of ``unit`` with no committed
    file. Returns ``segments_per_unit`` when the unit is complete.
    Committed files are trusted (the rename only ever publishes whole
    segments); holes after a committed segment are repacked from the
    hole on — later segments are redundant work at worst, never wrong
    (their content is deterministic)."""
    total = segments_per_unit(unit, rows_per_call, commit_every)
    for seg in range(total):
        if not os.path.exists(segment_path(out_dir, unit.unit_id, seg)):
            return seg
    return total


# --------------------------------------------------------------- plan file
def write_or_check_plan(out_dir: str, plan: Dict[str, Any]) -> None:
    """Create ``repick_plan.json`` (atomic) or validate the existing one
    matches — the resume geometry guard. Two workers racing the create
    write identical bytes, so either rename is correct."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _PLAN)
    blob = json.dumps(plan, sort_keys=True)
    if os.path.exists(path):
        with open(path) as f:
            existing = f.read()
        if existing != blob:
            raise ValueError(
                f"output dir {out_dir} holds a catalog built under a "
                "different plan (batch geometry / model / variant / "
                "thresholds changed); resume would mix incompatible "
                "segments — use a fresh --out or delete the directory"
            )
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(blob)
    os.replace(tmp, path)


def read_plan(out_dir: str) -> Dict[str, Any]:
    with open(os.path.join(out_dir, _PLAN)) as f:
        return json.load(f)


# ------------------------------------------------------------------- merge
def merge_catalog(
    out_dir: str,
    units: Sequence[WorkUnit],
    rows_per_call: int,
    commit_every: int,
    *,
    meta: Optional[Dict[str, Any]] = None,
    fences: Optional[Dict[int, int]] = None,
) -> Dict[str, Any]:
    """Reduce step: concatenate every unit's segments in (unit, segment)
    order into ``catalog.jsonl`` (tmp+rename), then commit
    ``catalog_meta.json`` LAST. Refuses loudly while any segment is
    missing (a partial merge would look complete).

    ``fences`` (fleet merges only) maps unit id -> the fencing token the
    unit was marked DONE under, from the lease store's done ledger. The
    merge then audits every segment's ``.fence`` sidecar: a sidecar
    GREATER than the done fence means a zombie published a segment after
    the unit was already completed and handed over — the exactly-once
    invariant is broken and the merge refuses. Sidecars at or below the
    done fence are normal history (earlier incarnations' segments are
    trusted: content is a pure function of the plan); a missing sidecar
    is the link-to-sidecar crash window, also trusted. The audit summary
    lands in ``catalog_meta.json``; catalog bytes never depend on it."""
    missing: List[str] = []
    stale: List[str] = []
    fleet_segments = 0
    for unit in units:
        total = segments_per_unit(unit, rows_per_call, commit_every)
        done_fence = (fences or {}).get(unit.unit_id)
        for seg in range(total):
            if not os.path.exists(segment_path(out_dir, unit.unit_id, seg)):
                missing.append(f"unit {unit.unit_id} seg {seg}")
                continue
            if fences is None:
                continue
            seg_fence = read_segment_fence(out_dir, unit.unit_id, seg)
            if seg_fence is not None:
                fleet_segments += 1
                if done_fence is not None and seg_fence > done_fence:
                    stale.append(
                        f"unit {unit.unit_id} seg {seg}: committed under "
                        f"fence {seg_fence} > done fence {done_fence}"
                    )
    if missing:
        raise FileNotFoundError(
            f"catalog merge: {len(missing)} segment(s) not committed yet "
            f"(first: {missing[0]}) — finish or resume the workers first"
        )
    if stale:
        raise ValueError(
            f"catalog merge: {len(stale)} segment(s) carry a fence NEWER "
            f"than the fence their unit was completed under (first: "
            f"{stale[0]}) — a zombie worker wrote after handover; the "
            "exactly-once commit invariant is broken, refusing to merge"
        )
    cat_path = os.path.join(out_dir, _CATALOG)
    tmp = f"{cat_path}.tmp.{os.getpid()}"
    n_rows = 0
    with open(tmp, "w") as f:
        for unit in units:
            total = segments_per_unit(unit, rows_per_call, commit_every)
            for seg in range(total):
                with open(
                    segment_path(out_dir, unit.unit_id, seg)
                ) as seg_f:
                    for line in seg_f:
                        f.write(line)
                        n_rows += 1
    os.replace(tmp, cat_path)
    out_meta = dict(meta or {})
    out_meta.update({
        "n_rows": n_rows,
        "n_units": len(units),
        "catalog": _CATALOG,
    })
    if fences is not None:
        out_meta["fleet"] = {
            "done_fences": {str(k): fences[k] for k in sorted(fences)},
            "fenced_segments": fleet_segments,
            "stale_fence_segments": 0,  # a nonzero count never merges
        }
    meta_tmp = os.path.join(out_dir, _CATALOG_META + f".tmp.{os.getpid()}")
    with open(meta_tmp, "w") as f:
        json.dump(out_meta, f, sort_keys=True)
    os.replace(meta_tmp, os.path.join(out_dir, _CATALOG_META))
    return out_meta


def catalog_paths(out_dir: str) -> Dict[str, str]:
    return {
        "catalog": os.path.join(out_dir, _CATALOG),
        "meta": os.path.join(out_dir, _CATALOG_META),
        "plan": os.path.join(out_dir, _PLAN),
    }
