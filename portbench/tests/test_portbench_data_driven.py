"""The harness is driven by data: a cell, a traffic file and a metric
added as new files (and entries in BENCHMARK.json) are found by name,
with no file that is there edited."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.lib import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.lib import harness
cell = harness.find_cell("seist_l_dpk.train.fp32.b64")
print(json.dumps({{"traffic": cell.traffic["batch"], "driver": cell.spec["driver"],
                  "per_layer": [m["name"] for m in cell.per_layer],
                  "e2e": [m["name"] for m in cell.end_to_end],
                  "new": harness.metric_reader("steps_per_s.train").read({{"steps": 6, "wall_s": 2.0}}),
                  "file": harness.metric_reader("steps_per_s.train").__file__}}))
"""


def test_new_cell_and_metric_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.benchmark()
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench["workloads"].append({"name": "seist_l_dpk.train.fp32.b64", "config": "seist_l_dpk",
                               "traffic": "train_bursts_b64", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_per_s.train", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "train_waveforms_per_s",
                               "workloads": ["seist_l_dpk.train.fp32.b64"]})
    bench["end_to_end"][0]["workloads"].append("seist_l_dpk.train.fp32.b64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = root / "portbench"
    spec = json.loads((pb / "workloads" / "seist_l_dpk.train.fp32.b500.json").read_text())
    (pb / "workloads" / "seist_l_dpk.train.fp32.b64.json").write_text(json.dumps(spec))
    traffic = json.loads((pb / "traffic" / "train_bursts_b500.json").read_text())
    (pb / "traffic" / "train_bursts_b64.json").write_text(json.dumps({**traffic, "batch": 64}))
    (pb / "metrics" / "steps_per_s.train.py").write_text(
        "def read(run):\n    return run['steps'] / run['wall_s']\n")
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(root))],
                         capture_output=True, text=True, check=True, timeout=120)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["traffic"] == 64 and got["driver"] == "train"
    assert got["new"] == 3.0 and Path(got["file"]).parent == pb / "metrics"
    # the existing metrics list their cells: only the new one reads the new cell
    assert got["per_layer"] == ["steps_per_s.train"]
    assert got["e2e"] == ["train_waveforms_per_s", "setup_s"]
    for p, data in before.items():  # nothing that was there was edited
        assert p.read_bytes() == data, p
