"""Finding a cell's parts by name, and printing a run's result.

Everything that belongs to one cell, configuration, traffic mix, lane
driver or per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``workloads/<cell>.json``: the lane driver, the precision and the limits
  of the numbers that decide ``correct``;
* ``configs/<config>.json`` (the path in ``BENCHMARK.json``): the model's
  sizes, what was reduced, the frozen work counts;
* ``traffic/<traffic>.json``: the parameters of the one generator
  (``lib/traffic.py``);
* ``drivers/<driver>.py``: a lane, ``run(ctx) -> Outcome``;
* ``metrics/<metric>.py``: ``read(run) -> float | None`` for one per-layer
  metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

#: The benchmark's folder; the checkout's root is its parent.
PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent

#: Top-level module names that may not be loaded in a run: the JAX stack
#: and the JAX package this port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "seist_tpu")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]  # the cell's entry in BENCHMARK.json
    spec: Dict[str, Any]  # workloads/<cell>.json
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]  # the per-layer metrics this cell reports


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in names]
    return Cell(name=name, entry=entry, spec=load_json(PB / "workloads" / f"{name}.json"),
                config=config, traffic=load_json(PB / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path) -> ModuleType:
    """A driver's or metric's file as a module (its name may hold dots)."""
    key = "portbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def driver(name: str) -> ModuleType:
    return load_module(PB / "drivers" / f"{name}.py")


def metric_reader(name: str) -> ModuleType:
    return load_module(PB / "metrics" / f"{name}.py")


def device_peaks(kind: str) -> Dict[str, Any]:
    """The published peaks of the card ``kind`` names (``devices/*.json``,
    matched by each file's ``match`` substring)."""
    for path in sorted((PB / "devices").glob("*.json")):
        table = load_json(path)
        if table["match"] in kind:
            return table
    raise SystemExit(f"no table of peaks under portbench/devices/ for the card {kind!r}")


def process_start() -> float:
    """The ``time.time()`` at which this process started (from
    ``/proc/self/stat``; where that is missing, the moment this module
    was imported)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime, field 22 of stat(5)
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "--id=0"], capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``: it passes at or under its
    limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a lane driver hands back."""

    attempted: int
    failed: int
    checks: List[Check]
    e2e: Dict[str, float]  # end-to-end values, by metric name (setup_s included)
    run: Dict[str, Any]  # what the per-layer readers read
    device: Dict[str, Any]
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def per_layer_values(cell: Cell, run: Dict[str, Any]) -> Tuple[Dict[str, Dict], List[str]]:
    """Each per-layer metric of the cell that its reader finds, and the
    errors: a share outside (0, 105] fails the run."""
    out: Dict[str, Dict] = {}
    errors: List[str] = []
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(run)
        if value is None:
            continue
        value = float(value)
        if m["unit"] == "%" and not 0.0 < value <= 105.0:
            errors.append(f"{m['name']} reads {value!r} %, outside (0, 105]")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out, errors


def emit(result: Dict[str, Any], checks: List[Check]) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, ``checks`` its last key."""
    for c in checks:
        print(f"[check] {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                                 "limit": c.limit} for c in checks}
    print(json.dumps(result), flush=True)
