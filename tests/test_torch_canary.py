"""The port's canary and shadow (``seist_tpu_torch/serve/canary.py``)
against the JAX package's, on the CPU: the same inputs go through both
and the results must be identical. Cohort membership, the controller's
routing and rollback trails, the mirror's sampling and JSONL report, and
the decision-level diff of two responses."""

from __future__ import annotations

import hashlib
import json
import time

import pytest

from seist_tpu.obs import bus as jbus
from seist_tpu.serve import canary as jcanary
from seist_tpu.serve import router as jrouter

from seist_tpu_torch.obs import bus as tbus
from seist_tpu_torch.serve import canary as tcanary
from seist_tpu_torch.serve import router as trouter

from test_torch_router import _Fake

MODS = {"jax": jcanary, "torch": tcanary}


@pytest.mark.parametrize("versions,version,model", [
    ({"m": 2}, 2, None), ({"m": 1}, 2, None), ({}, 2, None), (None, 2, None),
    ({"a": 2, "b": 1}, 2, "a"), ({"a": 2, "b": 1}, 2, "b"), ({"a": "junk"}, 2, None),
    ({"a": "2"}, 2, None), ({"a": 2}, 2, "c"), ({"a": None}, 2, "a"),
])
def test_serves_version_equals_jax(versions, version, model):
    assert (tcanary.serves_version(versions, version, model)
            == jcanary.serves_version(versions, version, model))


# (percent, budget kwargs, model, [(op, args)]): "r" routing_cohort(first),
# "o" observe(cohort, error, latency), "c" cohort_of(versions), "x" stop().
CONTROLLER_SCRIPTS = {
    "weighted_share": (20.0, {}, None, [("r", (True,))] * 60 + [("r", (False,))] * 5),
    "error_delta_rolls_back_once": (
        50.0, {"max_error_delta": 0.2, "min_requests": 5}, None,
        [("o", ("incumbent", False, 10.0))] * 20 + [("o", ("candidate", True, None))] * 6
        + [("r", (True,))] * 6),
    "latency_delta": (
        50.0, {"max_error_delta": 1.1, "max_latency_delta_ms": 50.0, "min_requests": 5}, None,
        [("o", ("incumbent", False, 10.0))] * 10 + [("o", ("candidate", False, 200.0))] * 10),
    "small_sample_guard": (
        50.0, {"max_error_delta": 0.1, "min_requests": 10}, None,
        [("o", ("candidate", True, None))] * 9),
    "healthy": (
        50.0, {"max_error_delta": 0.1, "min_requests": 5}, None,
        [("o", ("candidate", False, 12.0)), ("o", ("incumbent", False, 10.0))] * 30),
    "model_scoped": (
        50.0, {}, "b",
        [("c", ({"a": 2, "b": 1},)), ("c", ({"a": 2, "b": 2},)), ("c", ({"a": 2},)),
         ("c", ({},)), ("x", ()), ("r", (True,))]),
}


def _run_controller(mod, script):
    percent, budget, model, ops = CONTROLLER_SCRIPTS[script]
    c = mod.CanaryController()
    trail = [(c.state, c.routing_cohort(True), c.observe("candidate", True, None))]
    trail.append(c.start(2, percent, mod.CanaryBudget(**budget), model=model))
    for op, args in ops:
        if op == "r":
            out = c.routing_cohort(*args)
        elif op == "o":
            out = c.observe(*args)
        elif op == "c":
            out = c.cohort_of(*args)
        else:
            out = c.stop()
        trail.append((op, out, c.state, c.percent))
    trail.append(c.status())
    return trail


@pytest.mark.parametrize("script", sorted(CONTROLLER_SCRIPTS))
def test_canary_controller_trail_equals_jax(script):
    assert _run_controller(tcanary, script) == _run_controller(jcanary, script)


def test_canary_rejects_bad_percent_like_jax():
    for percent in (0.0, -1.0, 101.0):
        errors = []
        for mod in (jcanary, tcanary):
            with pytest.raises(ValueError) as e:
                mod.CanaryController().start(2, percent)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_shadow_sampling_and_report_equal_jax(tmp_path):
    ids = [hashlib.md5(str(i).encode()).hexdigest() for i in range(300)] + ["zz", "", "1" * 32]
    got = {}
    for pkg, mod in MODS.items():
        s = mod.ShadowMirror()
        before = [s.should_mirror(t) for t in ids]
        report = tmp_path / f"{pkg}.jsonl"
        started = s.start(2, 0.37, str(report), model="m")
        sampled = [s.should_mirror(t) for t in ids]
        for i, verdict in enumerate(("match", "mismatch", "no_candidate", "mirror_errors",
                                     "skipped_busy", "match")):
            s.record(f"t{i}", verdict, None if verdict == "skipped_busy" else
                     {"replica": "r:1", "diff": {"match": verdict == "match"}})
        status = s.status()
        stopped = s.stop()
        for st in (started, status, stopped):
            st.pop("report_path")
        lines = [json.loads(x) for x in report.read_text().splitlines()]
        got[pkg] = (before, sampled, started, status, stopped, lines)
    assert got["torch"] == got["jax"]
    assert 0 < sum(got["torch"][1]) < len(ids)
    with pytest.raises(ValueError):
        tcanary.ShadowMirror().start(2, 1.5)


PICKS = {"task": "picking", "ppk": [{"sample": 100}], "spk": [{"sample": 400}],
         "det": [{"onset": 90, "offset": 300}]}
DIFF_CASES = [
    (PICKS, dict(PICKS, ppk=[{"sample": 105}], det=[{"onset": 95, "offset": 305}])),
    (PICKS, dict(PICKS, ppk=[{"sample": 200}])),
    (PICKS, dict(PICKS, ppk=[])),
    (PICKS, dict(PICKS, ppk=[0.5])),
    (PICKS, dict(PICKS, det=[{"onset": 90}])),
    ({"task": "classification", "pmp": {"class": 1, "scores": [0.1, 0.9]}},
     {"task": "classification", "pmp": {"class": 1, "scores": [0.4, 0.6]}}),
    ({"task": "classification", "pmp": {"class": 1, "scores": [0.1, 0.9]}},
     {"task": "classification", "pmp": {"class": 0, "scores": [0.6, 0.4]}}),
    ({"task": "classification", "pmp": {"class": 1, "scores": [0.1, 0.9]}},
     {"task": "classification", "pmp": 0.9}),
    ({"task": "regression", "emg": 4.0}, {"task": "regression", "emg": 4.1}),
    ({"task": "regression", "emg": 4.0}, {"task": "regression", "emg": 5.0}),
    ({"task": "regression", "emg": 0.01}, {"task": "regression", "emg": 0.05}),
    ({"task": "regression", "baz": [1.0, 2.0]}, {"task": "regression", "baz": [1.0, 2.5]}),
    ({"task": "regression", "emg": 4.0, "model_version": 1},
     {"task": "regression", "emg": 4.0, "model_version": 2}),
    ({"tasks": {"dpk": PICKS, "emg": {"task": "regression", "emg": 4.0}}},
     {"tasks": {"dpk": PICKS, "emg": {"task": "regression", "emg": 4.02}}}),
    ({"tasks": {"dpk": PICKS, "emg": {"task": "regression", "emg": 4.0}}},
     {"tasks": {"dpk": PICKS}}),
    ({"task": "picking", "ppk": "x"}, {"task": "picking", "ppk": "x"}),
    ({}, {"error": "internal"}),
]


@pytest.mark.parametrize("case", range(len(DIFF_CASES)))
def test_decision_diff_equals_jax(case):
    a, b = DIFF_CASES[case]
    assert tcanary.decision_diff(a, b) == jcanary.decision_diff(a, b)


def test_router_shadow_report_equals_jax(tmp_path):
    """Shadow mode over sockets: every sampled /predict is mirrored to the
    candidate, and the report's lines (trace ids and the replica's address
    aside) and the mirror counters are the JAX router's."""
    body = json.dumps({"data": [[0.0] * 3] * 8}).encode()
    got = {}
    for pkg, router_mod, bus_mod in (("jax", jrouter, jbus), ("torch", trouter, tbus)):
        incumbent, candidate = _Fake("ok", version=1), _Fake("ok", version=2)
        router = router_mod.Router(config=router_mod.RouterConfig(request_timeout_s=5.0),
                                   bus=bus_mod.MetricsBus())
        for fake in (incumbent, candidate):
            router.registry.add(fake.url).versions = {"m": fake.version}
        report = tmp_path / f"{pkg}.jsonl"
        try:
            router.shadow.start(2, 1.0, str(report))
            for i in range(6):
                if i == 3:
                    candidate.behavior = "error:500:internal"
                status, _, _ = router.forward("/predict", body)
                assert status == 200
                deadline = time.monotonic() + 10  # one mirror at a time
                while (time.monotonic() < deadline and (not report.exists() or
                       len(report.read_text().splitlines()) < i + 1)):
                    time.sleep(0.02)
            lines = [json.loads(x) for x in report.read_text().splitlines()]
            for line in lines:
                line.pop("trace_id")
                line.pop("replica", None)
            counters = {k: v for k, v in router._bus.snapshot()["counters"].items()
                        if k.startswith("router_shadow")}
            got[pkg] = (sorted(json.dumps(x, sort_keys=True) for x in lines),
                        router.shadow.status()["counts"], counters)
        finally:
            router.stop()
            incumbent.stop()
            candidate.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["mirrored"] + got["torch"][1]["mirror_errors"] == 6
