"""The replica's lifecycle against the JAX package's, on the CPU.

* **Async warm-up.** The socket comes up before the programs are captured:
  with the warm-up held on an ``Event``, ``/healthz/live`` and
  ``/healthz/ready`` answer the JAX replica's codes and bodies (200, and
  503 ``warming``) and ``serve_state_code`` reads 1; a ``/predict`` sent
  meanwhile is served, eagerly (``fallback_runs`` +1), and a reload is
  refused until the warm-up is done. Released, both report ready.
* **A failed warm-up** makes the replica dead, and the watchdog returns 1,
  as in the JAX package; a failed sync warm-up raises.
* **Exit codes.** ``serve`` exits 0 on SIGINT (an operator's stop); the
  SIGTERM case (75) is ``tests/test_torch_serve.py``'s CLI test."""

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
from types import SimpleNamespace

import numpy as np
import pytest

from seist_tpu.obs.bus import BUS as JBUS
from seist_tpu.serve import BatcherConfig as JBatcherConfig
from seist_tpu.serve import server as jserver

import seist_tpu_torch
from seist_tpu_torch.obs.bus import BUS as TBUS
from seist_tpu_torch.serve import server as tserver
from seist_tpu_torch.serve.batcher import BatcherConfig
from seist_tpu_torch.serve.pool import ModelPool

ROOT = Path(__file__).resolve().parent.parent
NAME = "seist_s_dpk"
WINDOW = 256


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _HeldJaxPool:
    """A JAX-side pool whose warm-up waits on ``gate`` (the JAX package's
    own tests drive ``ServeService`` with such stand-ins)."""

    warmup_report: list = []

    def __init__(self, gate, fail=False):
        self.gate, self.fail = gate, fail

    def names(self):
        return [NAME]

    def get(self, name=None):
        return SimpleNamespace(name=NAME, version=1, forward=lambda x: x)

    def warmup(self, buckets):
        self.gate.wait(60)
        if self.fail:
            raise RuntimeError("capture boom")


def _held_port_pool(gate, fail=False):
    seist_tpu_torch.load_all()  # a worker may hold a partial registry from another file
    pool = ModelPool([(NAME, "")], window=WINDOW, device="cpu")
    warmup = pool.warmup

    def held(buckets):
        gate.wait(60)
        if fail:
            raise RuntimeError("capture boom")
        return warmup(buckets)

    pool.warmup = held
    return pool


def _health(base, bus):
    return (_get(base + "/healthz/live"), _get(base + "/healthz/ready"),
            bus.snapshot()["gauges"]["serve_state_code"])


def test_async_warmup_health_and_a_request_while_warming_equal_jax():
    jgate, tgate = threading.Event(), threading.Event()
    jsvc = jserver.ServeService(_HeldJaxPool(jgate), JBatcherConfig(max_batch=2, max_delay_ms=5.0),
                                warmup_async=True)
    tsvc = tserver.ServeService(_held_port_pool(tgate), BatcherConfig(max_batch=2, max_delay_ms=5.0),
                                warmup_async=True)
    jsrv = jserver.start_http_server(jsvc, "127.0.0.1", 0)
    tsrv = tserver.start_http_server(tsvc, "127.0.0.1", 0)
    jbase = "http://127.0.0.1:%d" % jsrv.server_address[1]
    tbase = "http://127.0.0.1:%d" % tsrv.server_address[1]
    try:
        warming = _health(tbase, TBUS)
        assert warming == _health(jbase, JBUS)
        assert warming == ((200, {"status": "ok"}),
                           (503, {"status": "warming", "ready": False, "versions": {NAME: 1}}),
                           tserver.STATE_CODES["warming"])
        assert tserver.STATE_CODES == jserver.STATE_CODES and warming[2] == 1
        # A reload waits for the warm-up, in both packages.
        jcode = _post(jbase + "/admin/reload", {"checkpoint": "x.pt"})
        tcode = _post(tbase + "/admin/reload", {"checkpoint": "x.pt"})
        assert (tcode[0], tcode[1]["error"]) == (jcode[0], jcode[1]["error"]) == (409,
                                                                                   "reload_failed")
        # A request while warming is served, eagerly.
        x = np.random.default_rng(0).standard_normal((WINDOW, 3)).tolist()
        status, body = _post(tbase + "/predict", {"data": x})
        assert status == 200 and body["task"] == "picking"
        assert tsvc.metrics()["fallback_runs"] == 1 and tsvc.healthz()["ready_s"] is None
        jgate.set()
        tgate.set()
        assert tsvc.wait_warmup(120)
        deadline = time.monotonic() + 30
        while not jsvc.ready() and time.monotonic() < deadline:
            time.sleep(0.01)
        ready = _health(tbase, TBUS)
        assert ready == _health(jbase, JBUS)
        assert ready == ((200, {"status": "ok"}),
                         (200, {"status": "ok", "ready": True, "versions": {NAME: 1}}),
                         tserver.STATE_CODES["ok"])
        status, again = _post(tbase + "/predict", {"data": x})
        assert status == 200 and again == body  # the captured program's answer
        assert tsvc.metrics()["fallback_runs"] == 1 and tsvc.healthz()["ready_s"] > 0
    finally:
        jgate.set()
        tgate.set()
        for srv, svc in ((jsrv, jsvc), (tsrv, tsvc)):
            srv.shutdown()
            svc.shutdown(drain=False)


def test_failed_warmup_is_dead_and_the_watchdog_exits_1_like_jax():
    gate = threading.Event()
    gate.set()
    got = {}
    for pkg, mod, svc in (
        ("jax", jserver, jserver.ServeService(_HeldJaxPool(gate, fail=True),
                                              JBatcherConfig(max_batch=2), warmup_async=True)),
        ("torch", tserver, tserver.ServeService(_held_port_pool(gate, fail=True),
                                                BatcherConfig(max_batch=2), warmup_async=True)),
    ):
        try:
            deadline = time.monotonic() + 60
            while svc._warmup_error is None and time.monotonic() < deadline:
                time.sleep(0.01)
            got[pkg] = (svc.alive(), svc.ready(), svc._state_str(),
                        mod.watch_until_shutdown(svc, threading.Event(), poll_s=0.01))
        finally:
            svc.shutdown(drain=False)
    assert got["torch"] == got["jax"] == (False, False, "dead", 1)
    # Sync, the same failure raises from the constructor.
    with pytest.raises(RuntimeError, match="capture boom"):
        tserver.ServeService(_held_port_pool(gate, fail=True), BatcherConfig(max_batch=2))


def test_cli_exits_0_on_sigint(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "seist_tpu_torch", "serve", "--model", NAME,
         "--window", str(WINDOW), "--device", "cpu", "--port", "0", "--max-batch", "2"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        port, seen = None, []
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            seen.append(line)
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
            assert line or proc.poll() is None, "server exited before listening"
        assert port is not None
        while _get(f"http://127.0.0.1:{port}/healthz/ready")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        proc.send_signal(signal.SIGINT)  # an operator's stop: no relaunch
        out, _ = proc.communicate(timeout=60)
        out = "".join(seen) + out
        assert proc.returncode == 0 and "stopped (rc=0)" in out, out[-1000:]
        # The socket opened before the warm-up ended.
        assert out.index("listening on") < out.index("ready in")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
