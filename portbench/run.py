"""The benchmark of the PyTorch/CUDA port (``seist_tpu_torch``) on NVIDIA
cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Finds the cell's parts by name
(``lib/harness.py``), runs its lane driver on the card, checks what the
timed path produced against the plain reference, and prints one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).

It exits 2, printing no result, without as many CUDA cards as the cell
asks for; 3 when the JAX stack or the JAX package was loaded; 4 when a
share reads outside (0, 105] %.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib import harness  # noqa: E402

T_START = harness.process_start()


@dataclasses.dataclass
class Context:
    """What a lane driver gets."""

    seed: int
    seconds: float
    trace: bool
    spec: dict
    config: dict
    traffic: dict
    device: object
    peaks: dict
    t_start: float
    tmpdir: str
    readings: bool = False  # also read the control and the faults (control.py)


def execute(cell: harness.Cell, ctx: Context):
    """Run the cell's driver; returns (result dict, checks, outcome)."""
    outcome = harness.driver(cell.spec["driver"]).run(ctx)
    if ctx.trace:
        metrics, errors = harness.per_layer_values(cell, outcome.run)
    else:
        metrics = {m["name"]: {"value": float(outcome.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
        errors = []
    correct = all(c.ok for c in outcome.checks) and outcome.failed == 0 and not errors
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": outcome.device}
    if ctx.trace and "trace" in outcome.run:
        result["breakdown"] = outcome.run["trace"].breakdown()
    return result, outcome, errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    cell = harness.find_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import seist_tpu_torch  # noqa: F401  (fails where the checkout lacks the program)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(device)
    peaks = harness.device_peaks(kind)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      spec=cell.spec, config=cell.config, traffic=cell.traffic, device=device,
                      peaks=peaks, t_start=T_START, tmpdir=tmp)
        result, outcome, errors = execute(cell, ctx)
    result["device"] = {"platform": "gpu", "kind": kind, "count": chips,
                        "memory_peak_bytes": outcome.device.get("memory_peak_bytes", 0),
                        **{k: v for k, v in outcome.device.items()
                           if k in ("busy_s", "window_s")},
                        "power_limit_w": harness.power_limit()}
    bad = harness.loaded_forbidden()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for e in errors:
        print(f"portbench: {e}", file=sys.stderr)
    print(f"[time] setup {outcome.e2e['setup_s']:.2f} s, window {outcome.run['wall_s']:.2f} s, "
          f"check {outcome.extra.get('check_s', 0.0):.2f} s", file=sys.stderr)
    harness.emit(result, outcome.checks)
    return 4 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
