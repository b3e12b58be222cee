"""Readings that set the limits of ``correct``; the benchmark's own runs do
not run this.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3 \
        [--readings] [--out FILE]

For each seed, in one process: a run of the cell's driver with a short
window (the numbers it compares: the lower readings), and with
``--readings`` what the control (the reference in TF32 in the program's
place) and the planted faults read against the reference (the upper
readings). One JSON line per seed, to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run as bench  # noqa: E402
from portbench.lib import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--readings", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            ctx = bench.Context(seed=seed, seconds=args.seconds, trace=False, spec=cell.spec,
                                config=cell.config, traffic=cell.traffic, device=device,
                                peaks=harness.device_peaks(kind), t_start=time.time(),
                                tmpdir=tmp, readings=args.readings)
            result, outcome, _ = bench.execute(cell, ctx)
        line = {"workload": args.workload, "seed": seed, "kind": kind,
                "power_limit_w": harness.power_limit(), "correct": result["correct"],
                "checks": {c.name: c.value for c in outcome.checks},
                "limits": {c.name: c.limit for c in outcome.checks},
                "e2e": outcome.e2e, "memory_peak_bytes": outcome.device.get("memory_peak_bytes"),
                **outcome.extra}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del outcome
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
