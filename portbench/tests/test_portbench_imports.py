"""No module that the benchmark loads is the JAX stack or the JAX package,
by whole top-level names (the port's ``seist_tpu_torch`` begins with the
JAX package's name and is allowed); and a run without a card fails with
no result."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.lib import harness

CODE = """
import sys
sys.path.insert(0, {root!r})
import torch
from portbench import run, control
from portbench.lib import harness, flops, trace, traffic, weights
from portbench.tests import _cpu
for d in ("train", "repick"):
    harness.driver(d)
for m in harness.benchmark()["per_layer"]:
    harness.metric_reader(m["name"])
_cpu.run_small(_cpu.small_cell("seist_l_dpk.train.fp32.b500", 256), seconds=0.1)
_cpu.run_small(_cpu.small_cell("seist_l_dpk.repick.fp32.b64x4", 256), seconds=0.1)
import json
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_of_jax_is_loaded():
    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "seist_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "seist_tpu"}, tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("seist_tpu_torch", "seist_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"seist_tpu_torch", "jaxtyping", "flaxen"} & set(harness.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "seist_tpu.models", sys)
    assert "seist_tpu" in harness.loaded_forbidden()


def test_a_run_without_a_card_fails_and_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, str(harness.PB / "run.py"), "--workload",
                          "seist_l_dpk.train.fp32.b500", "--seed", str(2**31 + 17),
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
