"""The control on the card: the reference in TF32 put in the program's
place fails at least one of each cell's numbers under the cell's limits,
at sizes a test run holds. Marked ``cuda``: on a machine without a card
these skip. On the card:

    python -m pytest -p no:cacheprovider -q -m cuda portbench/tests
"""

from __future__ import annotations

import tempfile

import pytest
import torch

from portbench import run as bench
from portbench.lib import harness

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32, the control's precision, exists only there")
    return torch.device("cuda", 0)


def _readings(name: str, traffic: dict):
    dev = _card()
    cell = harness.find_cell(name)
    cell.traffic.update(traffic)
    with tempfile.TemporaryDirectory(prefix="portbench-test-") as tmp:
        ctx = bench.Context(seed=2**31 + 101, seconds=1.0, trace=False, spec=cell.spec,
                            config=cell.config, traffic=cell.traffic, device=dev,
                            peaks=harness.device_peaks(torch.cuda.get_device_name(dev)),
                            t_start=bench.T_START, tmpdir=tmp, readings=True)
        result, outcome, _ = bench.execute(cell, ctx)
    return cell, result, outcome


@pytest.mark.parametrize("name", ["seist_l_dpk.train.fp32.b500", "phasenet.train.fp32.b500"])
def test_train_control_fails(name):
    cell, result, outcome = _readings(name, {"batch": 128, "pool_batches": 3})
    assert result["correct"], outcome.checks
    limits = cell.spec["limits"]
    readings = outcome.extra["readings"]
    for kind in ("control_tf32", "fault_half_batch", "fault_state_unchanged"):
        assert any(readings[kind][k] > v for k, v in limits.items()), (kind, readings[kind])


def test_repick_control_fails():
    cell, result, outcome = _readings("seist_l_dpk.repick.fp32.b64x4",
                                      {"traces": 512, "sample_rows": 32})
    assert result["correct"], outcome.checks
    ctrl = outcome.extra["readings"]["control_tf32"]["curve_gap"]
    assert ctrl > cell.spec["limits"]["curve_gap"]
