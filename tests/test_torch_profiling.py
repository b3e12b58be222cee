"""The port's step meters and profiler tables on the CPU
(``seist_tpu_torch/utils/profiling.py``, the measured half of
``obs/attribution.py``, ``python -m seist_tpu_torch profile-step``).

* ``StepTimeSplit``: tests/test_device_aug.py's summary math and
  tests/test_obs.py's span helpers; ``ThroughputMeter`` and
  ``device_memory_stats`` as the JAX package's;
* ``measured_kernels`` without a card (CPU activity, no kernel, idle share
  1), ``kernels_in_trace`` on a Chrome trace with kernel events and on the
  CPU trace that ``profiling.trace`` writes;
* ``profile-step``: raises without a GPU unless ``--device cpu``, and on
  the CPU writes its trace.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import time

import pytest
import torch

from seist_tpu_torch import profile_step
from seist_tpu_torch.obs import attribution as attr
from seist_tpu_torch.utils import profiling


def test_step_time_split_math():
    s = profiling.StepTimeSplit(skip_first=1)
    s.step(9.0, 9.0)  # the capture step, left out
    s.step(0.003, 0.001)
    s.step(0.001, 0.003)
    out = s.summary()
    assert out["steps"] == 2
    assert out["host_wait_ms_per_step"] == 2.0
    assert out["device_time_ms_per_step"] == 2.0
    assert out["input_bound_fraction"] == 0.5
    assert out["per_step_host_wait_ms"] == [3.0, 1.0]
    assert out["per_step_device_time_ms"] == [1.0, 3.0]
    assert profiling.StepTimeSplit().summary() == {
        "steps": 0, "host_wait_ms_per_step": None, "device_time_ms_per_step": None,
        "input_bound_fraction": None, "per_step_host_wait_ms": [],
        "per_step_device_time_ms": []}


def test_step_time_split_span_helpers():
    split = profiling.StepTimeSplit(skip_first=0)
    for _ in range(2):
        with split.host():
            time.sleep(0.004)
        with split.device():
            time.sleep(0.002)
    s = split.summary()
    assert s["steps"] == 2
    assert s["host_wait_ms_per_step"] >= 4.0
    assert s["device_time_ms_per_step"] >= 2.0
    assert 0.5 < s["input_bound_fraction"] < 1.0


def test_throughput_meter_skips_the_warmup():
    meter = profiling.ThroughputMeter(warmup_steps=2)
    assert meter.items_per_sec == 0.0
    for _ in range(2):
        meter.step(1000)  # warm-up: not counted
    assert meter.items_per_sec == 0.0
    meter.step(64)
    time.sleep(0.01)
    meter.step(64)
    rate = meter.items_per_sec
    assert 0.0 < rate < 128 / 0.01


def test_device_memory_stats_empty_without_a_card():
    assert profiling.device_memory_stats() == []


def test_measured_kernels_without_a_card():
    a = torch.ones(64, 64)
    out = attr.measured_kernels(lambda: a @ a, iters=2)
    assert out["iters"] == 2 and out["wall_ms"] > 0
    assert (out["kernels"], out["busy_ms"], out["top"], out["idle_share"]) == (0, 0, [], 1.0)


def test_kernels_in_trace_per_call(tmp_path):
    events = [{"cat": "kernel", "name": "fwd_kernel<float>", "dur": 40.0},
              {"cat": "kernel", "name": "fwd_kernel<float>", "dur": 60.0},
              {"cat": "kernel", "name": "gemm", "dur": 300.0},
              {"cat": "cpu_op", "name": "aten::mm", "dur": 900.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    table = attr.kernels_in_trace(str(path), calls=2, top_k=1)
    assert table["kernels"] == 1.5 and table["busy_ms"] == pytest.approx(0.2)
    assert table["top"] == [{"kernel": "gemm", "ms": pytest.approx(0.15), "launches": 0.5}]
    assert attr.launches_of(table, "fwd_kernel") == 1.0
    assert table["bytes"] == path.stat().st_size
    assert attr.kernel_lines(table, "step") == ["0.150 ms/step in 0.5 launches: gemm"]


def test_kernels_in_a_cpu_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).add_(1.0)
    table = attr.kernels_in_trace(str(tmp_path / profiling.TRACE_FILE))
    assert table["kernels"] == 0 and table["top"] == []


def test_profile_step_needs_a_gpu_or_the_cpu(tmp_path, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            profile_step.main(["--out", str(tmp_path)])
    profile_step.main(["--model-name", "phasenet", "--batch", "2", "--in-samples", "256",
                       "--steps", "1", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"trace written to {tmp_path / profiling.TRACE_FILE}" in out
    assert (tmp_path / profiling.TRACE_FILE).stat().st_size > 0
