"""The port's plots (``seist_tpu_torch/utils/visualization.py``, a copy of
the JAX package's) and ``python -m seist_tpu_torch demo`` on the CPU.

* Both figures are written by the port and by the JAX module from the same
  arrays, as PNGs of the same pixel size.
* ``demo`` (``demo_predict.py``'s counterpart) on a synthetic event: the
  same normalized trace as the JAX demo's, probabilities within 1e-5 of the
  JAX package's forward on the same weights, the picks printed as one JSON
  line, the figure written; ``--norm-mode max`` is the absolute maximum.
* Without matplotlib the demo prints its picks, then fails with
  ``ImportError``; importing the module needs no matplotlib.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import contextlib
import io
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

import demo_predict  # noqa: E402  (the JAX demo at the repo root)
import seist_tpu  # noqa: E402
from seist_tpu.models import api as japi  # noqa: E402
from seist_tpu.utils import visualization as jvis  # noqa: E402

import seist_tpu_torch  # noqa: E402
from seist_tpu_torch import demo  # noqa: E402
from seist_tpu_torch.utils import visualization as tvis  # noqa: E402

from _torch_parity import model_pair  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WINDOW = 512


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])


def test_both_figures_match_the_jax_module(tmp_path):
    rng = np.random.default_rng(0)
    waves = rng.standard_normal((3, 400)).astype(np.float32)
    preds = rng.uniform(0, 1, (3, 400)).astype(np.float32)
    sizes = []
    for mod, sub in ((tvis, "port"), (jvis, "jax")):
        a = mod.vis_phase_picking(waves, ["Z", "N", "E"], preds, [100, 250], ["P", "S"],
                                  ["Detection", "P-phase", "S-phase"], sampling_rate=50,
                                  save_name="_x", save_dir=str(tmp_path / sub))
        b = mod.vis_waves_preds_targets(waves, preds, preds, sampling_rate=50,
                                        save_dir=str(tmp_path / sub / "w"))
        assert len(a) == 1 and a[0].endswith("_x.png") and b.endswith(".png")
        sizes.append((_png_size(a[0]), _png_size(b)))
    assert sizes[0] == sizes[1]


@pytest.mark.parametrize("norm", ["std", "max"])
def test_demo_matches_the_jax_forward(norm, tmp_path, monkeypatch):
    import seist_tpu.native

    # The JAX side's numpy path: its optional wavekit library rounds otherwise.
    monkeypatch.setattr(seist_tpu.native, "_lib", None)
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jm, variables, tm = model_pair("seist_s_dpk", WINDOW, seed=8)
    weights = tmp_path / "w.pt"
    torch.save(tm.state_dict(), weights)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = demo.main(["--model-name", "seist_s_dpk", "--checkpoint", str(weights),
                         "--in-samples", str(WINDOW), "--norm-mode", norm,
                         "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
    first, second = buf.getvalue().strip().splitlines()
    picks = json.loads(first)
    assert picks["model"] == "seist_s_dpk" and picks["task"] == "picking"
    assert second == f"Saved: {res['paths']}" and os.path.exists(res["paths"][0])

    data = demo_predict.normalize(demo_predict.load_data("", WINDOW), norm)
    np.testing.assert_array_equal(res["data"], data)
    if norm == "max":
        assert np.abs(data).max(axis=-1) == pytest.approx(1.0)
    want = np.asarray(jm.apply(variables, data.T[None], train=False))[0]
    assert res["preds"].shape == (WINDOW, 3)
    assert np.abs(res["preds"] - want).max() <= 1e-5


def test_demo_without_matplotlib_fails_after_the_picks(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None  # any import of it raises ImportError\n"
        "import seist_tpu_torch.demo, seist_tpu_torch.utils.visualization\n"
        "from seist_tpu_torch.__main__ import main\n"
        f"main(['demo', '--model-name', 'phasenet', '--in-samples', '256', '--device', 'cpu',\n"
        f"      '--output-dir', {str(tmp_path)!r}])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert json.loads(proc.stdout.strip().splitlines()[-1])["model"] == "phasenet"
    assert "ImportError" in proc.stderr and "matplotlib" in proc.stderr
    assert not list(tmp_path.glob("*.png"))
