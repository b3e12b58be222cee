"""The port stands alone: seist_tpu_torch imports neither jax, flax nor
seist_tpu, nor pandas or h5py (the machine with the card has neither), and
its entry points do not fall back to the CPU silently."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "seist_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "seist_tpu", "pandas", "h5py")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_nothing_of_jax_or_seist_tpu(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    from seist_tpu_torch.serve.pool import load_model_entry
    from seist_tpu_torch.serve.server import build_service

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model_entry("seist_s_dpk", window=256)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_service([("seist_s_dpk", "")], window=256)
    entry = load_model_entry("seist_s_dpk", window=256, device="cpu")
    assert entry.device.type == "cpu"


def test_train_entry_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    from seist_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    args = ["--model-name", "seist_s_dpk", "--dataset-name", "synthetic",
            "--synthetic-events", "20", "--in-samples", "256", "--batch-size", "8",
            "--steps", "1", "--log-base", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)
    assert cli.get_args(args + ["--device", "cpu"]).device == "cpu"


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """No CUDA device: exit 1 and no result. A directory holding only the
    script: the port cannot be imported, and it exits non-zero too."""
    env = dict(os.environ, PYTHONPATH="")
    runs = [(ROOT, ROOT / "chip_smoke.py")]
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    runs.append((tmp_path, alone))
    for cwd, script in runs:
        if cwd == ROOT and torch.cuda.is_available():
            continue
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
            text=True, timeout=120,
        )
        assert proc.returncode != 0, (cwd, proc.stdout[-500:])
        assert '"ok"' not in proc.stdout
