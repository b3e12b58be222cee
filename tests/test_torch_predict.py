"""``python -m seist_tpu_torch predict`` against ``tools/predict.py`` on the
CPU.

* PhaseNet at window 256 and ``seist_s_dpk`` at window 512, the same
  weights on both sides (tests/_torch_parity.py; the JAX pool's seeded init
  patched to return them), the same record and flags: the same rows, each
  pick and detection onset within 0.1 s (5 samples at 50 Hz).
* The CSV writer against ``pandas.DataFrame(rows).to_csv(index=False)``
  byte for byte, for fixed picks: P and S only, with detections,
  detections only, and none.
* A model outside the dpk family is refused before the input is read.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import contextlib
import io
import os
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import seist_tpu
from seist_tpu.models import api as japi

import seist_tpu_torch
from seist_tpu_torch.__main__ import main as port_main
from seist_tpu_torch.ops.stream import annotate
from seist_tpu_torch.predict import pick_rows, picks_csv
from seist_tpu_torch.serve.pool import load_model_entry

from _torch_parity import model_pair

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import predict as jax_predict  # noqa: E402  (tools/predict.py)

TOL_SAMPLES = 5  # 0.1 s at 50 Hz


def _record(n: int, seed: int) -> np.ndarray:
    """Seeded noise with P/S-like bursts, (n, 3)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    t = np.arange(n)
    for onset in range(200, n - 300, 700):
        for at, amp in ((onset, 6.0), (onset + 150, 10.0)):
            env = np.where(t >= at, np.exp(-(t - at) / 60.0), 0.0)
            x += (amp * env[:, None] * rng.standard_normal((n, 3))).astype(np.float32)
    return x


def _rows(path):
    with open(path) as f:
        text = f.read()
    if text == "\n":
        return []
    df = pd.read_csv(io.StringIO(text))
    return [(r.kind, int(r.sample)) for r in df.itertuples()]


def _match(mine, theirs):
    assert [k for k, _ in mine] == [k for k, _ in theirs], (mine, theirs)
    for (kind, a), (_, b) in zip(mine, theirs):
        assert abs(a - b) <= TOL_SAMPLES, (kind, a, b)


@pytest.mark.parametrize("name,window", [("phasenet", 256), ("seist_s_dpk", 512)])
def test_predict_matches_the_jax_tool(name, window, tmp_path, monkeypatch):
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    _, variables, tm = model_pair(name, window, seed=3)
    monkeypatch.setattr(japi, "init_variables", lambda model, **kw: variables)
    weights = tmp_path / f"{name}.pt"
    torch.save(tm.state_dict(), weights)
    rec = _record(window * 6 + 37, seed=5)
    np.savez(tmp_path / "rec.npz", data=rec.T)  # (C, L): transposed on read

    # Thresholds where this model's curves have picks: the CPU curve's
    # 0.995 quantile of each channel (random weights' outputs are not
    # calibrated probabilities).
    entry = load_model_entry(name, str(weights), window=window, device="cpu")
    curve = annotate(lambda x: entry.run(x), rec, window=window, batch_size=8,
                     combine="max", channel0=entry.channel0, ppk_threshold=2.0,
                     spk_threshold=2.0, det_threshold=2.0)["prob"]
    det = 1.0 - curve[:, 0] if entry.channel0 == "non" else curve[:, 0]
    flags = ["--model-name", name, "--input", str(tmp_path / "rec.npz"),
             "--window", str(window), "--batch-size", "8",
             "--ppk-threshold", repr(float(np.quantile(curve[:, 1], 0.995))),
             "--spk-threshold", repr(float(np.quantile(curve[:, 2], 0.995))),
             "--det-threshold", repr(float(np.quantile(det, 0.9)))]

    mine = tmp_path / "port.csv"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main(["predict", *flags, "--checkpoint", str(weights), "--output", str(mine),
                   "--device", "cpu"])
    assert buf.getvalue().strip().endswith(f"-> {mine}")
    theirs = tmp_path / "jax.csv"
    monkeypatch.setattr(sys, "argv", ["predict.py", *flags, "--checkpoint", "",
                                      "--output", str(theirs)])
    jax_predict.main()
    rows = _rows(mine)
    assert {k for k, _ in rows} >= {"P", "S"}, rows
    _match(rows, _rows(theirs))
    with open(mine) as f:
        header = f.readline().strip()
    with open(theirs) as f:
        assert header == f.readline().strip()


PICKS = {
    "ps": {"ppk": np.array([120, 4503], np.int32), "spk": np.array([377], np.int32),
           "det": np.zeros((0, 2), np.int32)},
    "with-detections": {"ppk": np.array([5, 1333], np.int32),
                        "spk": np.array([17, 2999], np.int32),
                        "det": np.array([[3, 300], [1200, 3011]], np.int32)},
    "detections-only": {"ppk": np.array([], np.int32), "spk": np.array([], np.int32),
                        "det": np.array([[7, 71]], np.int32)},
    "none": {"ppk": np.array([], np.int32), "spk": np.array([], np.int32),
             "det": np.zeros((0, 2), np.int32)},
}


@pytest.mark.parametrize("case", sorted(PICKS))
@pytest.mark.parametrize("fs", [50, 100])
def test_the_csv_is_pandas_byte_for_byte(case, fs, tmp_path):
    rows = pick_rows(PICKS[case], fs)
    want = tmp_path / "pandas.csv"
    pd.DataFrame(rows).to_csv(want, index=False)
    assert picks_csv(rows).encode() == want.read_bytes()
    if case == "with-detections":
        assert ",300.0," in picks_csv(rows)  # the column the P/S rows leave empty
    if case == "none":
        assert picks_csv(rows) == "\n"


def test_a_model_outside_the_dpk_family_is_refused_first(tmp_path):
    missing = tmp_path / "no-such-record.npz"
    with pytest.raises(SystemExit, match="dpk-family"):
        port_main(["predict", "--model-name", "seist_s_emg", "--checkpoint", "",
                   "--input", str(missing), "--device", "cpu"])
    assert not os.path.exists(missing)
