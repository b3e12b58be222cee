"""The port's server on the CPU, with ``seist_s_dpk`` weights converted from
the JAX package's variables: concurrent ``/predict`` requests coalesce,
and their picks agree with the JAX package's ``decode_outputs`` on the JAX
model's output for the same trace.

Picks: the port's decode of a given output equals JAX's exactly; end to
end the two models' outputs differ by float rounding (< 1e-5), which can
move a pick between near-equal samples, so those agree within 0.1 s (the
repo's pick-residual convention)."""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_pair

from seist_tpu import taskspec as jtaskspec
from seist_tpu.serve import pool as jpool
from seist_tpu.serve import server as jserver

from seist_tpu_torch.models.convert import save_torch_weights
from seist_tpu_torch.ops import pooled_attention
from seist_tpu_torch.serve import server as tserver
from seist_tpu_torch.serve.batcher import BatcherConfig, MicroBatcher
from seist_tpu_torch.serve.pool import decode_outputs
from seist_tpu_torch.serve.protocol import (
    DeadlineExceeded,
    PredictOptions,
    QueueFull,
)

ROOT = Path(__file__).resolve().parent.parent
NAME = "seist_s_dpk"
WINDOW = 512
FS = 50
OPTS = {"max_events": 2, "ppk_threshold": 0.3, "spk_threshold": 0.3}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jm, variables, _ = model_pair(NAME, WINDOW, seed=5)
    weights = str(tmp_path_factory.mktemp("w") / f"{NAME}.pt")
    save_torch_weights(jax.device_get(variables), weights)

    def apply_fn(x):
        return jm.apply(variables, x, train=False)

    jentry = jpool.ModelEntry(
        name=NAME, model=jm, variables=variables,
        spec=jtaskspec.get_task_spec(NAME), window=WINDOW, in_channels=3,
        channel0="det", forward=jax.jit(apply_fn), apply=apply_fn,
    )
    service = tserver.build_service(
        [(NAME, weights)], window=WINDOW, device="cpu", max_batch=8, max_delay_ms=300.0,
        # A 300 ms batching delay is itself a queue delay the default tiers
        # would shed on: these tests measure batching, not admission.
        shed_config=tserver.ShedConfig(batch_delay_ms=float("inf"),
                                       interactive_delay_ms=float("inf")),
    )
    server = tserver.start_http_server(service, "127.0.0.1", 0)
    yield service, "http://127.0.0.1:%d" % server.server_address[1], jentry
    server.shutdown()
    service.shutdown()


def _post(url, body):
    req = urllib.request.Request(url + "/predict", data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _traces(n):
    rng = np.random.default_rng(11)
    lengths = [WINDOW] * (n - 2) + [400, 300]  # two short traces: padded + clipped
    return [rng.standard_normal((3, length)).astype(np.float32) * 50 for length in lengths]


def _jax_result(jentry, trace):
    """The JAX package's serving decode of the JAX model's output."""
    x = jserver._normalize_trace(trace.T, "std")
    n_real = x.shape[0]
    x = np.concatenate([x, np.zeros((WINDOW - n_real, 3), np.float32)])
    out = jentry.forward(x[None])
    res = jpool.decode_outputs(jentry, out, jpool.PredictOptions.from_dict(OPTS))
    if n_real < WINDOW:
        jserver._clip_picks(res, n_real, float(FS))
    return res, np.asarray(out)


def _assert_picks_close(got, want):
    tol = 0.1 * FS
    for kind in ("ppk", "spk"):
        a = [p["sample"] for p in got[kind]]
        b = [p["sample"] for p in want[kind]]
        assert len(a) == len(b) and all(abs(i - j) <= tol for i, j in zip(a, b)), (kind, a, b)
    a = [(d["onset"], d["offset"]) for d in got["det"]]
    b = [(d["onset"], d["offset"]) for d in want["det"]]
    assert len(a) == len(b), (a, b)
    assert all(abs(x[0] - y[0]) <= tol and abs(x[1] - y[1]) <= tol for x, y in zip(a, b))


def test_concurrent_predicts_coalesce_and_match_jax(served):
    service, url, jentry = served
    traces = _traces(10)
    before = service.metrics()
    results = [None] * len(traces)

    def one(i):
        results[i] = _post(url, {"data": traces[i].tolist(), "options": OPTS})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(traces))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None and r[0] == 200 for r in results), results
    metrics = json.loads(urllib.request.urlopen(url + "/metrics", timeout=30).read())
    stats = metrics["models"][NAME]
    forwards = stats["forwards"] - before["models"][NAME]["forwards"]
    requests = metrics["requests"]["predict"] - before["requests"]["predict"]
    assert requests == len(traces) and 1 <= forwards < requests
    assert 0 < stats["batch_fill_ratio"] <= 1 and stats["latency_ms"]["p99"] > 0
    assert metrics["kernels"]["pooled_attention_fwd"]["launches"] == pooled_attention.launches

    n_picks = 0
    for trace, (_, got) in zip(traces, results):
        want, jout = _jax_result(jentry, trace)
        assert got["model"] == NAME and got["task"] == "picking"
        _assert_picks_close(got, want)
        n_picks += sum(len(got[k]) for k in ("ppk", "spk", "det"))
        # The port's decode of the JAX output is the JAX decode, exactly.
        exact = decode_outputs(
            service.entries[NAME], torch.from_numpy(jout.copy()), PredictOptions.from_dict(OPTS)
        )
        if trace.shape[1] < WINDOW:
            tserver.clip_picks(exact, trace.shape[1], float(FS))
        assert exact == want
    assert n_picks > 0


def test_bad_requests_are_4xx(served):
    _, url, _ = served
    ok = np.zeros((3, 16), np.float32).tolist()
    assert _post(url, {"data": [[1.0, 2.0]]})[0] == 400
    assert _post(url, {"data": np.zeros((3, WINDOW + 1)).tolist()})[0] == 400
    assert _post(url, {"data": ok, "options": {"nope": 1}})[0] == 400
    assert _post(url, {"data": ok, "options": {"norm_mode": "zz"}})[0] == 400
    assert _post(url, {"data": ok, "model": "seist_l_dpk"})[0] == 404
    status, body = _post(url, {"data": ok})
    assert status == 200 and body["ppk"] == []  # all-zero trace: no picks
    health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=30).read())
    assert health["models"] == [NAME] and health["devices"] == {NAME: "cpu"}


@pytest.mark.parametrize("name", ["seist_s_emg", "seist_s_pmp"])
def test_value_and_class_heads_decode_like_jax(name):
    """Regression and classification heads: the same output decodes to the
    same JSON in both packages."""
    from types import SimpleNamespace

    from seist_tpu_torch.serve.pool import load_model_entry

    entry = load_model_entry(name, window=256, device="cpu")
    x = np.random.default_rng(0).standard_normal((1, 256, 3)).astype(np.float32)
    out = entry.run(x)
    opts = PredictOptions.from_dict({})
    jentry = SimpleNamespace(name=name, spec=jtaskspec.get_task_spec(name), is_picker=False)
    want = jpool.decode_outputs(jentry, out.numpy(), jpool.PredictOptions.from_dict({}))
    assert decode_outputs(entry, out, opts) == want
    assert want["task"] == ("classification" if name.endswith("pmp") else "regression")


def test_batcher_backpressure_and_deadline():
    gate = threading.Event()

    def slow(batch):
        gate.wait(5)
        return torch.from_numpy(batch)

    b = MicroBatcher(slow, BatcherConfig(max_batch=1, max_delay_ms=0.0, max_queue=1))
    try:
        first = threading.Thread(target=lambda: b.submit(np.zeros(2), timeout_ms=3000))
        first.start()
        time.sleep(0.2)  # the worker holds the first item in its forward
        with pytest.raises(DeadlineExceeded):
            b.submit(np.zeros(2), timeout_ms=50)  # queued behind it, expires
        with pytest.raises(QueueFull):  # the expired item still holds the slot
            b.submit(np.zeros(2), timeout_ms=50)
        gate.set()
        first.join(5)
        assert not first.is_alive()
    finally:
        gate.set()
        b.shutdown()
    stats = b.stats()
    assert stats["rejected"] == 1 and stats["expired"] == 1 and stats["completed"] == 1


def test_cli_serves_and_drains_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "seist_tpu_torch", "serve", "--model", NAME,
         "--window", "256", "--device", "cpu", "--port", "0", "--max-batch", "2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
            assert line or proc.poll() is None, "server exited before listening"
        assert port is not None
        # The socket opens before the warm-up; a request sent meanwhile pays
        # the process's first forward beside the captures, which on a busy
        # CPU can outlast the default deadline: wait for ready.
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz/ready", timeout=30)
                break
            except urllib.error.HTTPError as e:
                assert e.code == 503 and json.loads(e.read())["status"] == "warming"
                time.sleep(0.2)
        status, body = _post(f"http://127.0.0.1:{port}",
                             {"data": np.random.default_rng(0).standard_normal((3, 256)).tolist()})
        assert status == 200 and body["task"] == "picking"
        # SIGTERM is a managed preemption: drain, then exit 75 (a fleet
        # supervisor relaunches at once), as the JAX replica does.
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == tserver.PREEMPT_EXIT_CODE == 75, out[-1000:]
        assert "stopped (rc=75)" in out, out[-1000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
