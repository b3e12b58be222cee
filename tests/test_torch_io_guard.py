"""The port's data-plane guard (``seist_tpu_torch/data/io_guard.py``) and
fault injector (``seist_tpu_torch/utils/faults.py``) against the JAX
package's: the unit cases of ``tests/test_io_guard.py``, merged where they
repeat each other, and the same fallback sequences, flaky selections, fault
plans and quarantine reports as ``seist_tpu``'s on the same inputs."""

from __future__ import annotations

import pickle
import time

import numpy as np
import pytest
import torch

import seist_tpu
from seist_tpu import native
from seist_tpu import taskspec as jts
from seist_tpu.data import io_guard as jg
from seist_tpu.data import pipeline as jp
from seist_tpu.utils import faults as jf

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.data import io_guard
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    seist_tpu.load_all()
    seist_tpu_torch.load_all()


def test_preempt_code_is_the_contract():
    from seist_tpu.train.checkpoint import PREEMPT_EXIT_CODE as jax_code
    from tools import supervise as jax_supervise

    from seist_tpu_torch import supervise
    from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE

    assert (io_guard.PREEMPT_EXIT_CODE == PREEMPT_EXIT_CODE == supervise.PREEMPT_EXIT_CODE
            == jg.PREEMPT_EXIT_CODE == jax_code == jax_supervise.PREEMPT_EXIT_CODE == 75)


# ------------------------------------------------------------------- retries
def _policy(attempts=3):
    return io_guard.RetryPolicy(attempts=attempts, backoff_base_s=0.01, backoff_cap_s=0.08)


def test_retry_succeeds_after_transient_failures():
    naps, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("blip")
        return "payload"

    before = io_guard.COUNTERS.snapshot()["retries"]
    assert io_guard.read_with_retry(flaky, policy=_policy(), sleep=naps.append) == "payload"
    assert calls["n"] == 3 and io_guard.COUNTERS.snapshot()["retries"] - before == 2
    assert len(naps) == 2
    for k, s in enumerate(naps):  # jittered exponential backoff
        base = min(0.01 * 2**k, 0.08)
        assert 0.5 * base <= s <= 1.5 * base
    assert _policy(attempts=10).sleep_s(9) <= 0.08 * 1.5  # capped


@pytest.mark.parametrize("exc", [io_guard.CorruptSampleError("bad bytes"),
                                 RuntimeError("a bug, not a fault")])
def test_permanent_faults_and_bugs_are_not_retried(exc):
    calls = {"n": 0}

    def read():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        io_guard.read_with_retry(read, policy=_policy(), sleep=lambda s: None)
    assert calls["n"] == 1


def test_exhausted_retries_become_permanent():
    def down():
        raise OSError("still down")

    with pytest.raises(io_guard.RetriesExhaustedError) as ei:
        io_guard.read_with_retry(down, policy=_policy(), sleep=lambda s: None)
    assert isinstance(ei.value, io_guard.CorruptSampleError)


def test_injected_flakiness_rides_the_retry_loop():
    inj = faults.IoFaultInjector(faults.IoFaultPlan(flaky_p=1.0, flaky_fails=1))
    out = io_guard.read_with_retry(lambda: "payload", fault_key=7, injector=inj,
                                   policy=_policy(), sleep=lambda s: None)
    assert out == "payload"
    with pytest.raises(OSError):
        inj.maybe_flaky_read(7, attempt=0)
    inj.maybe_flaky_read(7, attempt=1)  # past flaky_fails: clean


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_flaky_selection_matches_jax(p):
    mine = faults.IoFaultInjector(faults.IoFaultPlan(flaky_p=p))
    theirs = jf.IoFaultInjector(jf.IoFaultPlan(flaky_p=p))
    assert [mine._is_flaky(k) for k in range(300)] == [theirs._is_flaky(k) for k in range(300)]


# ---------------------------------------------------------------- validation
@pytest.mark.parametrize("data", [np.random.randn(3, 64).astype(np.float32),
                                  np.zeros((1, 8), np.int32)])
def test_validate_event_accepts_clean_and_int_data(data):
    io_guard.validate_event({"data": data})


@pytest.mark.parametrize("event", [
    {"data": np.full((3, 16), np.nan, np.float32)},
    {"data": np.r_[np.zeros(15, np.float32), np.inf].reshape(1, 16)},
    {"data": np.zeros((16,), np.float32)},  # wrong ndim
    {"data": np.zeros((3, 0), np.float32)},  # empty
    {"data": np.array([[None, "x"]], dtype=object)},  # non-numeric
    {"ppks": [1]},  # no data field
    None,
])
def test_validate_event_rejects_corruption_like_jax(event):
    with pytest.raises(io_guard.CorruptSampleError) as mine:
        io_guard.validate_event(event)
    with pytest.raises(jg.CorruptSampleError) as theirs:
        jg.validate_event(event)
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------- quarantine
@pytest.mark.parametrize("raw,seed,epoch,idx", [(7, 3, 2, 107), (0, 0, 0, 0), (99, 5, 9, 42)])
def test_quarantine_candidates_match_jax(raw, seed, epoch, idx):
    q, jq = io_guard.Quarantine(100, max_frac=0.5), jg.Quarantine(100, max_frac=0.5)
    a = list(q.candidates(raw, seed=seed, epoch=epoch, idx=idx))
    assert a == list(jq.candidates(raw, seed=seed, epoch=epoch, idx=idx))
    assert a[0] == raw and raw not in a[1:]
    assert a[1:] != list(q.candidates(raw, seed=seed, epoch=epoch + 1, idx=idx))[1:]
    for bad in (raw, a[1]):  # benched samples leave both sequences alike
        q.add(bad, "corrupt")
        jq.add(bad, "corrupt")
    b = list(q.candidates(raw, seed=seed, epoch=epoch, idx=idx))
    assert b == list(jq.candidates(raw, seed=seed, epoch=epoch, idx=idx))
    assert b == [c for c in a if c not in (raw, a[1])]


def test_quarantine_overflow_aborts():
    q = io_guard.Quarantine(10, max_frac=0.1)
    q.add(0, "bad")  # 1/10 == max, not over
    with pytest.raises(io_guard.QuarantineOverflowError):
        q.add(1, "bad")


def test_quarantine_report_matches_jax_and_pickles():
    q, jq = io_guard.Quarantine(20, max_frac=0.5), jg.Quarantine(20, max_frac=0.5)
    for qq in (q, jq):
        qq.add(3, "nan burst")
        qq.add(11, "short read")
    assert q.report() == jq.report()
    assert q.report()["quarantined"] == [3, 11] and q.report()["frac"] == pytest.approx(0.1)
    q2 = pickle.loads(pickle.dumps(q))
    assert 3 in q2 and q2.active and q2.max_frac == 0.5 and len(q2) == 2


# ------------------------------------------------------------- fault plans
@pytest.mark.parametrize("env", [
    {},
    {"SEIST_FAULT_IO_FLAKY_P": "0.25", "SEIST_FAULT_IO_FLAKY_FAILS": "2",
     "SEIST_FAULT_IO_CORRUPT": "3, 7", "SEIST_FAULT_IO_STALL_BATCH": "5",
     "SEIST_FAULT_IO_STALL_SEC": "12.5"},
    {"SEIST_FAULT_NAN_STEP": "4", "SEIST_FAULT_NAN_COUNT": "2", "SEIST_FAULT_KILL_STEP": "9",
     "SEIST_FAULT_SIGTERM_STEP": "3", "SEIST_FAULT_SLOW_MS": "1.5",
     "SEIST_FAULT_SLOW_STEP": "2", "SEIST_FAULT_STAMP": "/x"},
])
def test_fault_plans_parse_like_jax(env):
    for mine, theirs in ((faults.IoFaultPlan, jf.IoFaultPlan), (faults.FaultPlan, jf.FaultPlan)):
        a, b = mine.from_env(env), theirs.from_env(env)
        assert vars(a) == vars(b) and a.enabled == b.enabled
    assert faults.IoFaultPlan.from_env(env).enabled == ("SEIST_FAULT_IO_CORRUPT" in env)
    assert faults.FaultPlan.from_env(env).enabled == ("SEIST_FAULT_NAN_STEP" in env)


@pytest.mark.parametrize("plan,env", [("IoFaultPlan", {"SEIST_FAULT_IO_CORRUPT": "soon"}),
                                      ("IoFaultPlan", {"SEIST_FAULT_IO_FLAKY_P": "often"}),
                                      ("FaultPlan", {"SEIST_FAULT_KILL_STEP": "x"})])
def test_fault_plans_refuse_garbage(plan, env):
    with pytest.raises(ValueError, match="SEIST_FAULT_"):
        getattr(faults, plan).from_env(env)


def test_injector_stall_fires_once(monkeypatch):
    naps = []
    monkeypatch.setattr(faults.time, "sleep", naps.append)
    inj = faults.IoFaultInjector(faults.IoFaultPlan(stall_batch=2, stall_sec=9.0))
    for b in range(4):
        inj.maybe_stall(b)
    assert naps == [9.0]


def test_step_faults_fire_once_across_relaunches(tmp_path, monkeypatch):
    kills, naps = [], []
    monkeypatch.setattr(faults.os, "kill", lambda pid, sig: kills.append(sig))
    monkeypatch.setattr(faults.time, "sleep", naps.append)
    stamp = str(tmp_path / "stamp")
    plan = faults.FaultPlan(sigterm_step=3, kill_step=5, slow_ms=20, slow_step=1,
                            stamp_path=stamp)
    inj = faults.FaultInjector(plan)
    for step in range(7):
        inj.on_step(step)
    import signal

    assert kills == [signal.SIGTERM, signal.SIGKILL] and naps == [0.02]
    relaunched = faults.FaultInjector(plan)  # the stamp file survives
    for step in range(7):
        relaunched.on_step(step)
    assert kills == [signal.SIGTERM, signal.SIGKILL]


def test_nan_injection_turns_inputs_to_nan_in_its_window():
    inj = faults.FaultInjector(faults.FaultPlan(nan_step=2, nan_count=2))
    x = torch.ones(2, 3)
    assert inj.corrupt_inputs(1, x) is x
    assert torch.isnan(inj.corrupt_inputs(2, x)).all()
    pair = inj.corrupt_inputs(3, (x, np.ones(2, np.float32)))
    assert isinstance(pair, tuple) and torch.isnan(pair[0]).all() and np.isnan(pair[1]).all()
    assert inj.corrupt_inputs(3, x) is x  # each step's NaN fires once


# ----------------------------------------------- dataset-level wiring (fast)
def _pair(**over):
    kwargs = dict(seed=1, in_samples=256, augmentation=False,
                  dataset_kwargs={"num_events": 20, "trace_samples": 1024})
    kwargs.update(over)
    return (jp.from_task_spec(jts.get_task_spec("seist_s_dpk"), "synthetic", "train", **kwargs),
            pipeline.from_task_spec(tts.get_task_spec("seist_s_dpk"), "synthetic", "train",
                                    **kwargs))


def test_corrupt_injection_quarantines_exactly_like_jax(monkeypatch):
    monkeypatch.setenv("SEIST_FAULT_IO_CORRUPT", "2,5")
    jd, td = _pair(max_quarantine_frac=0.5)
    items = [td[i][0] for i in range(len(td))]
    for i, x in enumerate(items):
        np.testing.assert_array_equal(x, jd[i][0])
    assert td.quarantine_report() == jd.quarantine_report()
    assert td.quarantine_report()["quarantined"] == [2, 5]
    assert all(x.shape == items[0].shape for x in items)  # replaced, not dropped


def test_flaky_reads_are_invisible_after_retries(monkeypatch):
    clean = [_pair()[1][i][0] for i in range(16)]
    monkeypatch.setenv("SEIST_FAULT_IO_FLAKY_P", "0.5")
    before = io_guard.COUNTERS.snapshot()["retries"]
    _, flaky = _pair()
    for i in range(16):
        np.testing.assert_array_equal(flaky[i][0], clean[i])
    assert io_guard.COUNTERS.snapshot()["retries"] - before > 0
    assert len(flaky.quarantine) == 0  # transient != corrupt


def test_guard_disabled_bypasses_wrapping():
    _, td = _pair()
    with io_guard.disabled():
        assert not io_guard.enabled()
        x = td[0][0]
    np.testing.assert_array_equal(x, td[0][0])


def test_epoch_keyed_fallback_changes_across_epochs(monkeypatch):
    monkeypatch.setenv("SEIST_FAULT_IO_CORRUPT", "2")
    _, td = _pair(max_quarantine_frac=0.5)
    td.set_epoch(0)
    e0 = td[2][0]
    td.set_epoch(1)
    assert not np.array_equal(e0, td[2][0])


def test_loader_reuses_dataset_injector():
    _, td = _pair()
    loader = pipeline.Loader(td, batch_size=4)
    assert loader._io_faults is td.io_faults
    loader.close()


def test_mixture_temperature_needs_mixture_sources():
    _, td = _pair()
    with pytest.raises(ValueError, match="no mixture sources"):
        pipeline.Loader(td, batch_size=4, mixture_temperature=1.0)


# ---------------------------------------------------------- stall watchdog
def test_watchdog_trips_on_armed_timeout():
    exits = []
    wd = io_guard.StallWatchdog(0.05, exit_fn=exits.append, poll_s=0.01).start()
    try:
        wd.arm()
        deadline = time.monotonic() + 2.0
        while not exits and time.monotonic() < deadline:
            time.sleep(0.01)
        assert exits == [io_guard.PREEMPT_EXIT_CODE] and wd.tripped
    finally:
        wd.stop()


def test_watchdog_disarmed_never_trips():
    exits = []
    wd = io_guard.StallWatchdog(0.05, exit_fn=exits.append, poll_s=0.01).start()
    try:
        for _ in range(6):  # armed, but always fed in time
            wd.arm()
            time.sleep(0.01)
            wd.disarm()
        time.sleep(0.15)  # disarmed time never counts
        assert exits == [] and not wd.tripped
    finally:
        wd.stop()


def test_watchdog_rejects_nonpositive_timeout():
    with pytest.raises(ValueError):
        io_guard.StallWatchdog(0)


def test_watch_passthrough_and_on_death():
    assert list(io_guard.watch(iter([1, 2, 3]), None)) == [1, 2, 3]

    def dying():
        yield 1
        raise io_guard.LoaderDeathError("thread gone")

    seen = []
    with pytest.raises(io_guard.LoaderDeathError):
        for item in io_guard.watch(dying(), None, on_death=seen.append):
            assert item == 1
    assert len(seen) == 1


# ------------------------------------------------------------- loader death
def _subclass(td, getitem):
    td.__class__ = type("Patched", (type(td),), {"__getitem__": getitem})
    return td


def test_loader_worker_raise_surfaces_as_loader_death():
    _, td = _pair()
    calls = {"n": 0}
    orig = type(td).__getitem__

    def dying(self, idx):
        calls["n"] += 1
        if calls["n"] > 6:
            raise RuntimeError("loader bug")
        return orig(self, idx)

    loader = pipeline.Loader(_subclass(td, dying), batch_size=4, num_workers=2)
    before = io_guard.COUNTERS.snapshot()["loader_deaths"]
    try:
        with pytest.raises(io_guard.LoaderDeathError):
            list(loader)
    finally:
        loader.close()
    assert io_guard.COUNTERS.snapshot()["loader_deaths"] - before == 1


@pytest.mark.parametrize("exc", [io_guard.QuarantineOverflowError("rotted"),
                                 io_guard.CorruptSampleError("no clean fallback")])
def test_loader_passes_deliberate_aborts_through(exc):
    """These end the run: a relaunch loop on a rotted dataset would burn
    the supervisor's budget."""
    _, td = _pair()

    def aborting(self, idx):
        raise exc

    loader = pipeline.Loader(_subclass(td, aborting), batch_size=4, num_workers=2)
    try:
        with pytest.raises(type(exc)):
            list(loader)
    finally:
        loader.close()


def test_counters_and_quarantine_lose_no_update_under_thread_contention():
    import sys
    import threading

    counters, q = io_guard.Counters(), io_guard.Quarantine(10_000, max_frac=1.0)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(500):
                counters.inc("retries")
                q.add(t * 500 + i, "bad")

        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert counters.snapshot()["retries"] == 16 * 500
    assert len(q) == 16 * 500 and q.report()["quarantined"] == list(range(16 * 500))
