"""The work counts kept with the benchmark: each configuration's frozen
FLOPs and attention calls, recounted on the reference; each roofline
metric's work formula against its terms counted by hand."""

from __future__ import annotations

import pytest

from portbench.lib import flops, harness


@pytest.mark.parametrize("config", ["seist_l_dpk", "phasenet"])
def test_frozen_flops_recount(config):
    bench = harness.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == config)
    cfg = harness.load_json(harness.ROOT / entry["file"])
    got = flops.count(cfg)
    assert got["flops_per_waveform"] == cfg["flops_per_waveform"]
    assert got["attention_calls"] == cfg["attention_calls"]
    assert got["flops_per_waveform"]["train_step"] > 2 * got["flops_per_waveform"]["forward"]


def test_seist_attention_calls_are_the_models():
    """(L, M, H, E) per call from the published sizes: the stem's strides
    (4) and each stage's aggregation (2) set L, the pooling ratios M."""
    cfg = harness.load_json(harness.PB / "configs" / "seist_l_dpk.json")
    want, length = [], cfg["window"] // 4
    for i, blocks in enumerate(cfg["attn_blocks"]):
        length //= cfg["stage_aggr_ratios"][i]
        heads = 3  # make_divisible(0.6 * C, head_dim) / head_dim at every stage of SeisT-L
        want += [[length, length // cfg["attn_aggr_ratios"][i], heads, cfg["head_dims"][i]]] * blocks
    assert cfg["attention_calls"] == want


def test_work_formulas():
    fwd = harness.metric_reader("attn_fwd_roofline.train").work
    fwd_serve = harness.metric_reader("attn_fwd_roofline.repick").work
    bwd = harness.metric_reader("attn_bwd_roofline.train").work
    n, length, m, h, e = 500, 1024, 128, 3, 8
    q = n * length * h * e * 4  # bytes of one (N, L, H, E) float32 tensor
    kv = n * m * h * e * 4
    lse = n * h * length * 4
    assert fwd(n, length, m, h, e) == (4 * n * length * m * h * e, 2 * q + 2 * kv + lse)
    assert fwd_serve(n, length, m, h, e) == (4 * n * length * m * h * e, 2 * q + 2 * kv)
    # reads q, k, v, g, o, lse; writes dq, dk, dv
    assert bwd(n, length, m, h, e) == (10 * n * length * m * h * e, 4 * q + 4 * kv + lse)


class _Trace:
    def __init__(self, secs, launches, calls=2, busy=0.9, window=1.0):
        self.secs, self.launches, self.calls = secs, launches, calls
        self.busy_s, self.window_s = busy, window

    def kernel_seconds(self, pattern):
        return self.secs, self.launches


def _run(lane="train", **kw):
    cfg = harness.load_json(harness.PB / "configs" / "seist_l_dpk.json")
    peaks = harness.load_json(harness.PB / "devices" / "h100.json")
    run = {"lane": lane, "config": cfg, "peaks": peaks, "batch": 500, "wall_s": 10.0,
           "waveforms": 20000, "calls": 40, "trace_calls": 16, "batches_per_call": 4,
           "stage_s": {"fill": 0.4, "decode": 0.2, "write": 0.1, "device": 3.0}}
    run.update(kw)
    return run


def test_readers():
    r = harness.metric_reader
    run = _run(trace=_Trace(0.01, 10))
    fpw = run["config"]["flops_per_waveform"]["train_step"]
    assert r("mfu.train").read(run) == pytest.approx(100 * fpw * 20000 / (10.0 * 67e12))
    assert r("device_idle.train").read(run) == pytest.approx(10.0)
    least = sum(max(o / 495e12, b / 3.35e12) for o, b in
                (r("attn_fwd_roofline.train").work(500, *c) for c in run["config"]["attention_calls"]))
    assert r("attn_fwd_roofline.train").read(run) == pytest.approx(100 * 2 * least / 0.01)
    rp = _run("repick", batch=64, trace=_Trace(0.02, 320))
    assert r("fill_ms_per_call.repick").read(rp) == pytest.approx(10.0)
    assert r("decode_ms_per_call.repick").read(rp) == pytest.approx(7.5)
    # busy 0.9 s over 16 traced calls, 40 calls in the unprofiled 10 s
    assert r("device_idle.repick").read(rp) == pytest.approx(100 * (1 - 0.9 / 16 * 40 / 10.0))
    # a reader finds nothing to read in another lane, or without a trace
    assert r("mfu.repick").read(run) is None
    assert r("attn_bwd_roofline.train").read(_run()) is None
    assert r("attn_fwd_roofline.train").read(_run(trace=_Trace(0.0, 0))) is None


def test_a_share_over_105_fails_the_run():
    cell = harness.find_cell("seist_l_dpk.train.fp32.b500")
    run = _run(trace=_Trace(1e-9, 10))  # a kernel time far under its least time
    values, errors = harness.per_layer_values(cell, run)
    assert "attn_fwd_roofline.train" in values
    assert any("attn_fwd_roofline.train" in e for e in errors)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    """A trace's reduction: busy time is the union of device intervals; a
    gap takes the name of the shortest host event over its midpoint, the
    program's bus spans (placed from the traced span's start) among them."""
    from portbench.lib.trace import WINDOW, Summary

    events = [{"name": WINDOW, "ph": "X", "cat": "user_annotation", "ts": 1000.0, "dur": 1000.0},
              {"name": "k", "ph": "X", "cat": "kernel", "ts": 1000.0, "dur": 100.0},
              {"name": "k", "ph": "X", "cat": "kernel", "ts": 1050.0, "dur": 100.0},
              {"name": "aten::copy_", "ph": "X", "cat": "cpu_op", "ts": 1100.0, "dur": 900.0},
              {"name": "k2", "ph": "X", "cat": "kernel", "ts": 1900.0, "dur": 100.0}]
    s = Summary(events, calls=1, bus_spans=[("batch_infer_decode", 200.0, 800.0)])
    assert s.busy_s == pytest.approx(250e-6) and s.window_s == pytest.approx(1e-3)
    assert s.idle_by_host == {"batch_infer_decode": pytest.approx(750e-6)}
    assert s.kernel_seconds("^k$") == (pytest.approx(200e-6), 2)
    assert Summary(events, calls=1).idle_by_host == {"aten::copy_": pytest.approx(750e-6)}
