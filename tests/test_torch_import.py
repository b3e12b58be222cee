"""The port stands alone: seist_tpu_torch imports neither jax, flax nor
seist_tpu, nor pandas, h5py or ml_dtypes (the machine with the card has
none of them), and its entry points do not fall back to the CPU silently.
The supervisor imports the standard library only."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "seist_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "seist_tpu", "pandas", "h5py", "ml_dtypes")


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


def test_the_supervisor_imports_no_torch():
    code = ("import sys, seist_tpu_torch.supervise\n"
            "assert 'torch' not in sys.modules and 'numpy' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


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


def test_the_telemetry_plane_is_covered_and_needs_no_torch():
    """``obs/`` is among the modules checked above, and importing it (the
    bus, traces, flight recorder, metrics endpoint) loads neither torch nor
    numpy: a scraper or a supervisor can read it cheaply."""
    assert {"seist_tpu_torch.obs", "seist_tpu_torch.obs.bus", "seist_tpu_torch.obs.trace",
            "seist_tpu_torch.obs.flight", "seist_tpu_torch.obs.http"} <= set(_modules())
    code = ("import sys, seist_tpu_torch.obs\n"
            "assert 'torch' not in sys.modules and 'numpy' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_the_serving_planes_are_covered():
    """The long-record and stream planes are among the modules checked
    above, each its own copy (no module of the JAX package's name)."""
    mods = set(_modules())
    for m in ("seist_tpu_torch.ops.stream", "seist_tpu_torch.serve.shed",
              "seist_tpu_torch.stream", "seist_tpu_torch.stream.session",
              "seist_tpu_torch.stream.mux", "seist_tpu_torch.stream.assoc",
              "seist_tpu_torch.stream.journal", "seist_tpu_torch.utils.faults"):
        assert m in mods, m


def test_the_front_tier_is_covered_and_needs_no_torch():
    """The router, the canary, the fleet pane and the fleet supervisor are
    among the modules checked above, and importing and constructing them
    loads neither torch nor numpy (nor JAX): the front tier starts on a
    box with no accelerator stack, as the JAX package's does."""
    assert {"seist_tpu_torch.serve.router", "seist_tpu_torch.serve.canary",
            "seist_tpu_torch.obs.fleet", "seist_tpu_torch.supervise_fleet"} <= set(_modules())
    code = (
        "import sys\n"
        "import seist_tpu_torch.serve.router as router\n"
        "import seist_tpu_torch.serve.canary as canary\n"
        "import seist_tpu_torch.obs.fleet as fleet\n"
        "import seist_tpu_torch.supervise_fleet as sf\n"
        "r = router.Router(config=router.RouterConfig())\n"
        "r.canary.start(2, 10.0); r.shadow.start(2, 0.5); r.stop()\n"
        "agg = fleet.FleetAggregator(); agg.add_source('router', lambda: {}); agg.merged()\n"
        "sf.rollout_cmd(['serve'], 2)\n"
        "canary.decision_diff({'task': 'regression', 'emg': 1.0}, {'task': 'regression', 'emg': 1.0})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{('torch', 'numpy') + FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_batch_repicking_is_covered_and_its_supervisor_needs_no_torch():
    """The re-picking modules are among the modules checked above (no JAX,
    no seist_tpu, no tools), and the fleet supervisor's module loads
    neither torch nor numpy, also when it parses its arguments and builds
    a worker's command."""
    assert {"seist_tpu_torch.batch", "seist_tpu_torch.batch.catalog",
            "seist_tpu_torch.batch.engine", "seist_tpu_torch.batch.fleet",
            "seist_tpu_torch.repick", "seist_tpu_torch.supervise_repick"} <= set(_modules())
    for path in ("seist_tpu_torch/repick.py", "seist_tpu_torch/supervise_repick.py",
                 "seist_tpu_torch/batch/engine.py", "seist_tpu_torch/batch/fleet.py"):
        assert "tools" not in {n.split(".")[0] for n in _imported_names(ROOT / path)}, path
    code = (
        "import sys\n"
        "import seist_tpu_torch.supervise_repick as sup\n"
        "args = sup.get_args(['--archive', 'A', '--out', 'O', '--model', 'm', "
        "'--lease-dir', 'L'])\n"
        "sup._worker_cmd(args, 0); sup._merge_cmd(args)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{('torch', 'numpy') + FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_repick_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    from seist_tpu_torch import repick

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    args = repick.get_args(["--archive", str(tmp_path), "--out", str(tmp_path / "o"),
                            "--model", "phasenet"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repick.build_engine(args)


def test_the_offline_tools_are_covered_and_load_no_pandas_or_matplotlib():
    """The published-weights import, ``predict``, ``demo`` and the plots are
    among the modules checked above (no JAX, no seist_tpu, no tools), and
    importing them, and every other module, loads neither pandas nor
    matplotlib: the plot imports matplotlib inside the call that draws."""
    new = {"seist_tpu_torch.models.reference", "seist_tpu_torch.import_pretrained",
           "seist_tpu_torch.predict", "seist_tpu_torch.demo",
           "seist_tpu_torch.utils.visualization"}
    assert new <= set(_modules())
    for mod in new:
        path = ROOT / (mod.replace(".", "/") + ".py")
        assert "tools" not in {n.split(".")[0] for n in _imported_names(path)}, path
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pandas', 'matplotlib'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_the_parallel_layer_is_covered():
    """The process group, the mesh, the collectives, the step check and the
    ring are among the modules checked above, each the port's own (the JAX
    package's HLO report ``collectives`` stays there)."""
    mods = set(_modules())
    assert {"seist_tpu_torch.parallel", "seist_tpu_torch.parallel.dist",
            "seist_tpu_torch.parallel.mesh", "seist_tpu_torch.parallel.comm",
            "seist_tpu_torch.parallel.check", "seist_tpu_torch.ops.ring_attention"} <= mods
    assert "seist_tpu_torch.parallel.collectives" not in mods


def test_the_twin_modules_are_covered_and_need_cuda_unless_cpu_is_asked_for():
    """``twin``, ``twin_replica`` and ``stream_chaos`` are among the
    modules checked above; the twin's picker runs on ``cuda`` unless the
    caller asks for the CPU, and without a GPU it raises."""
    from seist_tpu_torch import twin

    modules = set(_modules())
    assert {"seist_tpu_torch.twin", "seist_tpu_torch.twin_replica",
            "seist_tpu_torch.stream_chaos"} <= modules
    assert twin.get_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.TwinPickEntry(256, "cuda")
    assert twin.TwinPickEntry(256, "cpu").device.type == "cpu"
