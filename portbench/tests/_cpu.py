"""Running a cell on the CPU at a small size: the rest of a run without
the look for a card (``run.execute``), its sizes cut so that a test run
holds it."""

from __future__ import annotations

import tempfile
from typing import Dict, Optional

import torch

from portbench import run as bench
from portbench.lib import harness

H100 = "NVIDIA H100 80GB HBM3"

SMALL = {
    "train": {"batch": 4, "pool_batches": 4, "trace_steps": 1},
    "repick": {"traces": 64, "batch": 8, "batches_per_call": 2,
               "calibration_rows": 8, "sample_rows": 8, "reference_block": 4},
}


def small_cell(name: str, window: int = 512, traffic: Optional[Dict] = None) -> harness.Cell:
    cell = harness.find_cell(name)
    cell.traffic.update(SMALL[cell.traffic["lane"]], window=window, **(traffic or {}))
    cell.config["window"] = window
    return cell


def run_small(cell: harness.Cell, seed: int = 7, seconds: float = 0.5, readings: bool = False):
    """(result, outcome) of the cell on the CPU."""
    with tempfile.TemporaryDirectory(prefix="portbench-test-") as tmp:
        ctx = bench.Context(seed=seed, seconds=seconds, trace=False, spec=cell.spec,
                            config=cell.config, traffic=cell.traffic,
                            device=torch.device("cpu"), peaks=harness.device_peaks(H100),
                            t_start=bench.T_START, tmpdir=tmp, readings=readings)
        result, outcome, _ = bench.execute(cell, ctx)
    return result, outcome
