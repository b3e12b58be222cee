"""The port's serving pool on the CPU against the JAX package's: SeisT task
groups (one trunk, several heads), the programs' accounting, the
batcher's union of tasks, hot reload and the serve CLI.

``seist_s`` at window 512 with buckets 1, 2 and 4; weights from
``tests/_torch_parity.py`` (std 0.5/sqrt(fan_in)), converted for the
port and written as ``.pt`` files. The group fan-out is held against
``seist_tpu/serve/pool.py::MultiTaskEntry.fanout`` on the same weights
within 1e-5 (fp32 and int8) and 0.05 (bf16) of max(1, max|JAX output|):
the distance head answers in the hundreds, where one float32 ulp is
1.5e-5. The 400s, the FLOPs ratio and the zero-miss storm mirror
``tests/test_multitask.py``."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import model_pair

from seist_tpu import taskspec as jtaskspec
from seist_tpu.serve import pool as jpool

from seist_tpu_torch.models.convert import save_torch_weights
from seist_tpu_torch.serve import server as tserver
from seist_tpu_torch.serve.batcher import BatcherConfig, MicroBatcher, slice_outputs
from seist_tpu_torch.serve.pool import ModelPool, load_group_entry
from seist_tpu_torch.serve.protocol import (
    BadRequest,
    IncompatibleCheckpoint,
    ParityGateFailed,
    PredictOptions,
    parse_tasks,
)

ROOT = Path(__file__).resolve().parent.parent
WINDOW = 512
TASKS = ("dpk", "emg", "dis")
BUCKETS = (1, 2, 4)
TOL = {"fp32": 1e-5, "int8": 1e-5, "bf16": 0.05}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{task: (flax module, flax variables, .pt path)} of seist_s_<task>,
    and the single model seist_s_dpk's file."""
    out = {}
    d = tmp_path_factory.mktemp("w")
    for i, task in enumerate(TASKS):
        jm, variables, _ = model_pair(f"seist_s_{task}", WINDOW, seed=20 + i)
        path = str(d / f"seist_s_{task}.pt")
        save_torch_weights(jax.device_get(variables), path)
        out[task] = (jm, variables, path)
    return out


@pytest.fixture(scope="module")
def service(weights):
    svc = tserver.build_service(
        [("seist_s_dpk", weights["dpk"][2])],
        groups=[("seist_s", [(t, weights[t][2]) for t in TASKS])],
        window=WINDOW, device="cpu", max_batch=4, max_delay_ms=5.0,
        variants=("fp32", "bf16", "int8"),
        # The storm measures programs on the CPU's slow flushes, not shedding.
        shed_config=tserver.ShedConfig(batch_delay_ms=float("inf"),
                                       interactive_delay_ms=float("inf")))
    yield svc
    svc.shutdown()


@pytest.fixture(scope="module")
def trace():
    return np.random.default_rng(7).standard_normal((WINDOW, 3)).astype(np.float32).tolist()


def _jax_group(weights):
    """JAX's MultiTaskEntry over the same variables, as load_group_entry
    builds it: the first task's trunk, each task's own out_head."""
    heads, trunk_vars, trunk_model = {}, None, None
    for task in TASKS:
        jm, variables, _ = weights[task]
        if trunk_model is None:
            trunk_model = jm
            trunk_vars = {c: {k: v for k, v in t.items() if k != "out_head"}
                          for c, t in variables.items()}
        merged = {c: dict(trunk_vars.get(c, {}), out_head=variables[c]["out_head"])
                  for c in variables if "out_head" in variables[c]}
        for c in trunk_vars:
            merged.setdefault(c, dict(trunk_vars[c]))
        spec = jtaskspec.get_task_spec(f"seist_s_{task}")
        heads[task] = jpool.TaskHead(task=task, name=f"seist_s_{task}", model=jm,
                                     variables=merged, spec=spec,
                                     channel0="det" if task == "dpk" else None,
                                     head_scale=float(jm.head_scale or 1.0))
    return jpool.MultiTaskEntry(name="seist_s", window=WINDOW, in_channels=3, tasks=TASKS,
                                heads=heads, trunk_model=trunk_model,
                                trunk_variables=trunk_vars,
                                variants=("fp32", "bf16", "int8"))


@pytest.mark.parametrize("variant", ["fp32", "bf16", "int8"])
def test_group_fanout_matches_jax(service, weights, variant):
    entry = service.pool.get("seist_s")
    jentry = _jax_group(weights)
    batch = np.random.default_rng(2).standard_normal((2, WINDOW, 3)).astype(np.float32)
    for tasks in (TASKS, ("emg",), ("dpk", "dis")):
        before = entry.fanout_stats()["trunk_runs"]
        got = entry.fanout(batch, tasks, variant)
        assert entry.fanout_stats()["trunk_runs"] == before + 1  # the trunk once
        want = jentry.fanout(batch, tasks, variant, account=False)
        assert sorted(got) == sorted(tasks)
        for t in tasks:
            ref = np.asarray(want[t], np.float32)
            err = float(np.abs(got[t].numpy() - ref).max())
            assert err <= TOL[variant] * max(1.0, float(np.abs(ref).max())), (variant, t, err)


def test_predict_one_trunk_run_all_heads_and_subsets(service, trace):
    entry = service.pool.get("seist_s")
    before = entry.fanout_stats()
    res = service.predict(trace, model="seist_s", tasks=list(TASKS))
    after = entry.fanout_stats()
    assert sorted(res["tasks"]) == sorted(TASKS) and res["trunk_runs"] == 1
    assert after["trunk_runs"] - before["trunk_runs"] == 1
    for t in TASKS:
        assert after["head_runs"][t] - before["head_runs"].get(t, 0) == 1
    assert after["trunk_flops_saved"] > before["trunk_flops_saved"]
    assert res["tasks"]["dpk"]["task"] == "picking"
    assert res["tasks"]["emg"]["task"] == "regression"
    assert res["model_version"] == 1 and res["variant"] == "fp32"
    assert sorted(service.predict(trace, model="seist_s")["tasks"]) == sorted(TASKS)
    assert list(service.predict(trace, model="seist_s", tasks=["emg"])["tasks"]) == ["emg"]
    single = service.predict(trace, model="seist_s_dpk")
    assert single["model"] == "seist_s_dpk" and single["task"] == "picking"
    assert "tasks" not in single and "trunk_runs" not in single


def test_unknown_task_single_task_and_variant_400s(service, trace):
    with pytest.raises(BadRequest, match="does not serve tasks"):
        service.predict(trace, model="seist_s", tasks=["baz"])
    with pytest.raises(BadRequest, match="single-task"):
        service.predict(trace, model="seist_s_dpk", tasks=["dpk"])
    assert service.pool.get("seist_s").resolve_tasks(None) == TASKS
    entry = service.pool.get("seist_s")
    saved = entry.variant_tasks["bf16"]
    try:
        entry.variant_tasks["bf16"] = ("emg",)  # dpk and dis "failed" their gates
        with pytest.raises(BadRequest, match="variant 'bf16'"):
            service.predict(trace, model="seist_s", tasks=["dpk"],
                            options={"variant": "bf16"})
        assert service.predict(trace, model="seist_s", tasks=["emg"],
                               options={"variant": "bf16"})["variant"] == "bf16"
    finally:
        entry.variant_tasks["bf16"] = saved
    with pytest.raises(BadRequest, match="variant"):
        service.predict(trace, model="seist_s", options={"variant": "fp8"})
    for bad in ("dpk", [], [1], ["dpk", "dpk"]):
        with pytest.raises(BadRequest):
            parse_tasks(bad)


def test_variant_not_loaded_is_400(tmp_path):
    svc = tserver.build_service([("seist_s_emg", "")], window=128, device="cpu", max_batch=1)
    try:
        x = np.zeros((128, 3), np.float32).tolist()
        with pytest.raises(BadRequest, match="variant 'int8' is not loaded"):
            svc.predict(x, options={"variant": "int8"})
        assert svc.predict(x)["task"] == "regression"
    finally:
        svc.shutdown()


def test_fanout_flops_at_most_half_of_three_singles(service):
    entry = service.pool.get("seist_s")
    for b in BUCKETS:
        trunk = entry.programs[("fp32", "trunk", b)].flops
        heads = {t: entry.programs[("fp32", t, b)].flops for t in TASKS}
        assert trunk > 0 and all(f > 0 for f in heads.values())
        fanout = trunk + sum(heads.values())
        singles = sum(trunk + h for h in heads.values())
        assert fanout <= 0.5 * singles, (b, fanout, singles)
    # the single-task model's program = trunk + its head, K1's products included
    full = service.pool.get("seist_s_dpk").programs["fp32"][1].flops
    assert full == pytest.approx(entry.programs[("fp32", "trunk", 1)].flops
                                 + entry.programs[("fp32", "dpk", 1)].flops, rel=1e-9)


def test_storm_after_warmup_misses_no_program(service, trace):
    entries = service.entries
    calls = lambda: sum(p.calls for e in entries.values() for p in e.all_programs())  # noqa: E731
    misses = service.metrics()["fallback_runs"]
    before = calls()
    reqs = [
        lambda: service.predict(trace, model="seist_s", tasks=["dpk", "emg"]),
        lambda: service.predict(trace, model="seist_s", tasks=["emg"]),
        lambda: service.predict(trace, model="seist_s_dpk"),
        lambda: service.predict(trace, model="seist_s_dpk", options={"variant": "int8"}),
        lambda: service.predict(trace, model="seist_s"),
        lambda: service.predict(trace, model="seist_s", tasks=["dis"],
                                options={"variant": "bf16"}),
    ] * 3
    with ThreadPoolExecutor(6) as ex:
        results = [f.result() for f in [ex.submit(r) for r in reqs]]
    assert len(results) == len(reqs)
    metrics = service.metrics()
    assert metrics["fallback_runs"] == misses == 0
    assert calls() > before
    assert metrics["graph_captures"] == 0  # the CPU runs each program eagerly
    assert {"seist_s", "seist_s@bf16", "seist_s@int8", "seist_s_dpk"} <= set(metrics["models"])
    programs = [r for r in service.healthz()["warmup"] if r["model"] == "seist_s"]
    assert len(programs) == len(BUCKETS) * 3 * (1 + len(TASKS))
    assert metrics["programs"]["seist_s"]["graph_programs"] == len(programs)


def test_batcher_unions_tasks_and_slices_dict_outputs():
    seen = []

    def forward(batch, tasks=None):
        seen.append(tasks)
        return {t: torch.full((batch.shape[0], 2), float(ord(t[0]))) for t in tasks}

    b = MicroBatcher(forward, BatcherConfig(max_batch=2, max_delay_ms=200.0), name="union")
    try:
        with ThreadPoolExecutor(2) as ex:
            f1 = ex.submit(b.submit, np.zeros((4, 1)), 2000.0, frozenset({"aa"}))
            f2 = ex.submit(b.submit, np.zeros((4, 1)), 2000.0, frozenset({"bb"}))
            r1, r2 = f1.result(), f2.result()
        assert frozenset({"aa", "bb"}) in seen  # one flush ran the union
        for r in (r1, r2):
            assert set(r) == {"aa", "bb"} and all(v.shape == (1, 2) for v in r.values())
        assert b.stats()["completed"] == 2
    finally:
        b.shutdown()
    out = {"dpk": torch.arange(12).reshape(3, 4),
           "pmp": (torch.arange(6).reshape(3, 2), torch.arange(3).reshape(3, 1))}
    s = slice_outputs(out, 1)
    assert s["dpk"].shape == (1, 4) and int(s["dpk"][0, 0]) == 4
    assert s["pmp"][0].shape == (1, 2) and s["pmp"][1].shape == (1, 1)


def test_group_loader_validation():
    with pytest.raises(ValueError, match="unknown task"):
        load_group_entry("seist_s", [("xyz", "")], window=128, device="cpu")
    with pytest.raises(ValueError, match="at least one task"):
        load_group_entry("seist_s", [], window=128, device="cpu")
    with pytest.raises(ValueError, match="duplicate task"):
        load_group_entry("seist_s", [("emg", ""), ("emg", "")], window=128, device="cpu")
    with pytest.raises(ValueError, match="unknown variants"):
        load_group_entry("seist_s", [("emg", "")], window=128, device="cpu",
                         variants=("fp4",))


# ------------------------------------------------------------------ reload
@pytest.fixture(scope="module")
def reload_pool():
    pool = ModelPool([("seist_s_emg", "")], window=128, device="cpu", variants=("fp32", "bf16"),
                     version=3)
    pool.warmup((1,))
    return pool


def test_reload_incompatible_checkpoint_names_first_bad_key(reload_pool, tmp_path):
    from seist_tpu_torch.models import api

    state = api.create_model("seist_s_emg", in_samples=128).state_dict()
    first = sorted(state)[0]
    bad = dict(state)
    bad[first] = torch.zeros(7)
    path = str(tmp_path / "bad.pt")
    torch.save(bad, path)
    with pytest.raises(IncompatibleCheckpoint, match=re.escape(f"shape mismatch at '{first}'")):
        reload_pool.reload("seist_s_emg", buckets=(1,), checkpoint=path)
    missing = {k: v for k, v in state.items() if k != first}
    torch.save(missing, path)
    with pytest.raises(IncompatibleCheckpoint, match=re.escape(f"missing key at '{first}'")):
        reload_pool.reload("seist_s_emg", buckets=(1,), checkpoint=path)
    torch.save(dict(state, extra=torch.zeros(1)), path)
    with pytest.raises(IncompatibleCheckpoint, match="unexpected key at 'extra'"):
        reload_pool.reload("seist_s_emg", buckets=(1,), checkpoint=path)
    assert reload_pool.versions() == {"seist_s_emg": 3}


def test_reload_gates_keep_the_incumbent_and_a_good_one_swaps(reload_pool, tmp_path):
    from seist_tpu_torch.models import api

    incumbent = reload_pool.get("seist_s_emg")
    state = api.create_model("seist_s_emg", in_samples=128, seed=1).state_dict()
    nan = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v
           for k, v in state.items()}
    path = str(tmp_path / "nan.pt")
    torch.save(nan, path)
    with pytest.raises(ParityGateFailed):
        reload_pool.reload("seist_s_emg", buckets=(1,), checkpoint=path)
    assert reload_pool.get("seist_s_emg") is incumbent
    good = str(tmp_path / "good.pt")
    torch.save(state, good)
    with pytest.raises(ParityGateFailed, match="injected"):
        reload_pool.reload("seist_s_emg", buckets=(1,), checkpoint=good, version=4,
                           force_gate_failure=True)
    assert reload_pool.get("seist_s_emg") is incumbent
    with pytest.raises(BadRequest, match="monotonic"):
        reload_pool.reload("seist_s_emg", buckets=(1,), checkpoint=good, version=2)
    candidate, report = reload_pool.reload("seist_s_emg", buckets=(1,), checkpoint=good)
    assert reload_pool.get("seist_s_emg") is candidate and candidate.version == 4
    assert len(report) == 2 and candidate.supported_variants() == ["fp32", "bf16"]
    served = candidate.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in state.items())
    assert not all(torch.equal(incumbent.model.state_dict()[k], v) for k, v in state.items())


def test_service_reload_flips_model_version_and_refuses_bad(tmp_path, monkeypatch, trace):
    from seist_tpu_torch.models import api

    monkeypatch.setenv("SEIST_FAULT_SERVE_BAD_CANDIDATE", "3")
    svc = tserver.build_service([("seist_s_dpk", "")], window=WINDOW, device="cpu",
                                max_batch=1)
    try:
        assert svc.predict(trace)["model_version"] == 1
        path = str(tmp_path / "w.pt")
        torch.save(api.create_model("seist_s_dpk", in_samples=WINDOW, seed=2).state_dict(), path)
        out = svc.reload(checkpoint=path)
        assert out["version"] == 2 and out["previous_version"] == 1 and out["programs"] == 1
        assert svc.predict(trace)["model_version"] == 2
        with pytest.raises(ParityGateFailed, match="SEIST_FAULT_SERVE_BAD_CANDIDATE"):
            svc.reload(checkpoint=path)  # version 3 is the injected bad one
        assert svc.healthz()["entries"]["seist_s_dpk"]["version"] == 2
        assert svc.metrics()["reloads"] == {"ok": 1, "parity_gate_failed": 1}
        with pytest.raises(BadRequest):
            svc.reload(checkpoint=path, checkpoints={"dpk": path}, version=5)
    finally:
        svc.shutdown()


# --------------------------------------------------------------------- CLI
def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_cli_groups_variants_and_reload(tmp_path):
    from seist_tpu_torch.models import api

    ckpt = str(tmp_path / "emg.pt")
    torch.save(api.create_model("seist_s_emg", in_samples=128, seed=3).state_dict(), ckpt)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seist_tpu_torch", "serve", "--model-group",
         "seist_s=dpk,emg", "--variants", "fp32,int8", "--window", "128", "--device", "cpu",
         "--port", "0", "--max-batch", "2", "--buckets", "2", "--model-version", "7"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        port = None
        deadline = time.monotonic() + 240
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
            assert line or proc.poll() is None, "server exited before listening"
        assert port is not None
        url = f"http://127.0.0.1:{port}"
        # The socket opens before the warm-up; the checks below (a reload,
        # no fallback run) want the captured programs, so wait for ready.
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(url + "/healthz/ready", timeout=30)
                break
            except urllib.error.HTTPError as e:
                assert e.code == 503 and json.loads(e.read())["status"] == "warming"
                time.sleep(0.2)
        x = np.random.default_rng(0).standard_normal((3, 128)).tolist()
        status, body = _post(url + "/predict", {"data": x, "options": {"variant": "int8"}})
        assert status == 200 and sorted(body["tasks"]) == ["dpk", "emg"], body
        assert body["model_version"] == 7 and body["variant"] == "int8"
        status, body = _post(url + "/predict", {"data": x, "tasks": ["pmp"]})
        assert status == 400 and "does not serve tasks" in body["message"]
        status, body = _post(url + "/predict", {"data": x, "options": {"variant": "bf16"}})
        assert status == 400 and "not loaded" in body["message"]
        status, body = _post(url + "/admin/reload", {"checkpoints": {"emg": ckpt}})
        assert status == 200 and body["version"] == 8 and body["programs"] == 6, body
        status, body = _post(url + "/admin/reload", {"checkpoint": ckpt})
        assert status == 400 and "task group" in body["message"]
        status, body = _post(url + "/admin/reload", {"checkpoints": {"emg": "/nonexistent.pt"}})
        assert status == 409 and body["error"] == "reload_failed"
        status, body = _post(url + "/predict", {"data": x, "tasks": ["emg"]})
        assert status == 200 and body["model_version"] == 8
        health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=30).read())
        assert health["entries"]["seist_s"] == {"version": 8, "variants": ["fp32", "int8"],
                                                "tasks": ["dpk", "emg"]}
        assert len([r for r in health["warmup"] if "program" in r]) == 6
        metrics = json.loads(urllib.request.urlopen(url + "/metrics", timeout=30).read())
        assert metrics["fanout"]["seist_s"]["trunk_runs"] == 1  # the candidate's own
        assert metrics["fallback_runs"] == 0
        proc.send_signal(signal.SIGTERM)  # a managed preemption: exit 75
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 75 and "stopped (rc=75)" in out, out[-1000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_predict_options_variant_field():
    assert PredictOptions.from_dict({"variant": "bf16"}).variant == "bf16"
    with pytest.raises(BadRequest):
        PredictOptions.from_dict({"variant": 16})


@pytest.mark.parametrize("name,window", [("baz_network", 256), ("ditingmotion", 128)])
def test_programs_of_staged_and_tuple_models(name, window):
    """BAZNetwork's programs take (x, eigen features) staged before each
    call; DiTingMotion answers a tuple, sliced per caller. Both through
    their programs and variants against the fp32 model run directly."""
    svc = tserver.build_service([(name, "")], window=window, device="cpu", max_batch=2,
                                variants=("fp32", "int8"))
    try:
        entry = svc.pool.get(name)
        x = np.random.default_rng(3).standard_normal((2, window, entry.in_channels))
        x = x.astype(np.float32)
        with torch.inference_mode():
            want = entry.model(torch.from_numpy(x))
        calls = entry.programs["fp32"][2].calls
        got = entry.run(x, "fp32")
        assert entry.programs["fp32"][2].calls == calls + 1 and entry.fallback_runs == 0
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        q = entry.run(x, "int8")
        assert all(bool(torch.isfinite(t).all()) for t in q)
        trace = x[0].tolist()
        for variant in ("fp32", "int8"):
            res = svc.predict(trace, options={"variant": variant})
            assert res["model"] == name and res["model_version"] == 1
    finally:
        svc.shutdown()


@pytest.mark.parametrize("name,window", [("magnet", 256), ("baz_network", 256),
                                         ("ditingmotion", 128)])
def test_results_transform_decodes_like_jax(name, window):
    """The baselines' value and class heads decode through the task spec's
    results transform, as the JAX package's decode does."""
    from types import SimpleNamespace

    from seist_tpu_torch.serve.pool import decode_outputs, load_model_entry

    entry = load_model_entry(name, window=window, device="cpu")
    x = np.random.default_rng(0).standard_normal((1, window, entry.in_channels))
    out = entry.run(x.astype(np.float32))
    jentry = SimpleNamespace(name=name, spec=jtaskspec.get_task_spec(name), is_picker=False)
    host = tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()
    want = jpool.decode_outputs(jentry, host, jpool.PredictOptions.from_dict({}))
    got = decode_outputs(entry, out, PredictOptions())
    assert got.keys() == want.keys() and got["task"] == want["task"]
    for key in got:
        if key == "task":
            continue
        if isinstance(want[key], dict):
            assert got[key]["class"] == want[key]["class"]
            np.testing.assert_allclose(got[key]["scores"], want[key]["scores"], rtol=1e-6)
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-6)
