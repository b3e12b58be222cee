"""The slice end to end on the CPU: two real port replicas
(``python -m seist_tpu_torch serve --device cpu``, ``seist_s_dpk`` at
window 256) behind the port's fleet supervisor and router.

* ``/predict`` through the router equals a direct in-process port
  service's answer on the same weights;
* one request's spans, fetched from the router's and both replicas'
  ``/traces``, stitch into one tree (``trace-report``): the replica's
  ``server:/predict`` root is a child of a router attempt, with no flags;
* a SIGTERM'd replica exits 75 and is relaunched at once, its crash
  budget untouched;
* a SIGHUP roll to a second weights file brings every response to
  version 2, each equal to the direct service's answer on those weights;
* SIGTERM to the supervisor drains both replicas with exit 75."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import os
import signal
import sys

import numpy as np
import torch

from seist_tpu_torch import trace_report
from seist_tpu_torch.models import api
from seist_tpu_torch.obs import trace as obs_trace
from seist_tpu_torch.serve import server as tserver

from test_torch_fleet import _get, _pid_of, _replicas, _start_fleet, _stop, _wait

NAME = "seist_s_dpk"
WINDOW = 256


def _post(host, port, body, headers=None):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=60.0)
    try:
        conn.request("POST", "/predict", json.dumps(body).encode(),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _direct(weights, body, version):
    svc = tserver.build_service([(NAME, weights)], window=WINDOW, device="cpu", max_batch=2,
                                version=version)
    try:
        return svc.predict(body["data"], options=body["options"])
    finally:
        svc.shutdown()


def test_two_replicas_answer_like_one_service_preempt_and_roll(tmp_path):
    weights = []
    for seed in (5, 6):
        path = str(tmp_path / f"w{seed}.pt")
        torch.save(api.create_model(NAME, in_samples=WINDOW, seed=seed).state_dict(), path)
        weights.append(path)
    rng = np.random.default_rng(0)
    trace = (rng.standard_normal((WINDOW, 3)) * 0.1).astype(np.float32)
    trace[100:104, 0] += 30.0
    body = {"data": trace.tolist(), "options": {"ppk_threshold": 0.3, "spk_threshold": 0.3}}
    want = [_direct(weights[0], body, 1), _direct(weights[1], body, 2)]
    spec = tmp_path / "rollout.json"
    cmd = (sys.executable, "-m", "seist_tpu_torch", "serve", "--model", f"{NAME}={weights[0]}",
           "--window", str(WINDOW), "--device", "cpu", "--max-batch", "2")
    proc, host, port = _start_fleet(
        replicas=2, cmd=cmd, cwd=tmp_path,
        extra_args=("--rollout-file", str(spec), "--rollout-ready-timeout-s", "120"))
    try:
        two_ready = (lambda: [(r["probe_state"], r["breaker"]["state"])
                              for r in _replicas(host, port)] == [("ok", "closed")] * 2)
        _wait(two_ready, timeout_s=120, what="two ready port replicas", proc=proc)
        for _ in range(2):  # one answer from each replica (round robin)
            status, got = _post(host, port, body)
            assert status == 200 and got == want[0], (got, want[0])
        tid = obs_trace._new_trace_id()
        parent = obs_trace.format_traceparent(tid, obs_trace._new_span_id())
        assert _post(host, port, body, {obs_trace.TRACEPARENT_HEADER: parent})[0] == 200
        router = f"http://{host}:{port}"
        st = trace_report.stitch_from_endpoints(
            tid, [router] + trace_report.replica_endpoints(router))
        (root,) = st.roots
        (served,) = st.find("server:/predict")
        by_id = {s["span_id"]: s for s in st.spans}
        assert root["name"] == "router:/predict" and st.flags == [], st.format()
        assert by_id[served["parent_id"]]["name"] == "attempt", st.format()
        # A managed preemption: exit 75, relaunched at once, no budget spent.
        os.kill(_pid_of(proc.err, 1), signal.SIGTERM)
        _wait(lambda: "replica 1 clean preempt (rc=75)" in "".join(proc.err), timeout_s=60,
              what="replica 1's exit 75", proc=proc)
        _wait(two_ready, timeout_s=120, what="replica 1 back in rotation", proc=proc)
        status, got = _post(host, port, body)
        assert status == 200 and got == want[0]
        # The roll: one replica at a time to the second weights, version 2.
        spec.write_text(json.dumps({"version": 2, "checkpoint": weights[1]}))
        proc.send_signal(signal.SIGHUP)
        _wait(lambda: "rollout complete: version 2" in "".join(proc.err), timeout_s=180,
              what="the roll", proc=proc)
        _wait(two_ready, timeout_s=60, what="both rolled replicas in rotation", proc=proc)
        for _ in range(2):
            status, got = _post(host, port, body)
            assert status == 200 and got["model_version"] == 2 and got == want[1], got
        assert _get(host, port, "/healthz")[1]["ready_replicas"] == 2
    finally:
        err = _stop(proc, expect_rc=0)
    assert "crashed" not in err, err
    assert err.count("clean preempt (rc=75)") == 3 and err.count("drained (rc=75)") == 2, err
