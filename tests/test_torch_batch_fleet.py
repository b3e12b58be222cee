"""The port's lease plane (``seist_tpu_torch/batch/fleet.py``) and fleet
supervisor (``python -m seist_tpu_torch supervise-repick``) against the JAX
package's, on the CPU.

One scripted history of lease operations runs through both packages'
stores, the shared-directory store and the KV store over an in-memory
fake, driven by ONE fake clock, and through their guarded wrappers, held
leases (the commit-check ladder) and fault injectors: the fences, the
outcomes and the counters must be the same. The supervisor runs
in-process over stub workers of a few lines that act out a crash, an exit
75 and a clean finish."""

from __future__ import annotations

import json
import os
import sys
import threading
from pathlib import Path

import _torch_threads  # noqa: F401  (caps torch's threads first)
import pytest

from seist_tpu.batch import catalog as jcatalog
from seist_tpu.batch import fleet as jfleet
from seist_tpu.utils import faults as jfaults
from seist_tpu_torch.batch import catalog as tcatalog
from seist_tpu_torch.batch import fleet as tfleet
from seist_tpu_torch.utils import faults as tfaults

PACKAGES = {"jax": (jfleet, jfaults, jcatalog), "torch": (tfleet, tfaults, tcatalog)}

# Clocks of the script (seconds of the fake clock); no real wait depends
# on them.
CFG = dict(ttl_s=5.0, heartbeat_s=1000.0, grace_s=0.5, retries=4, backoff_base_s=0.0005,
           backoff_cap_s=0.001, op_timeout_s=30.0, park_s=0.01, rescan_s=0.01)


class FakeKV:
    """In-memory KV speaking the KVLeaseStore protocol, with an injectable
    failure window (``fail_ops`` counts down per op): the port's copy of
    ``tests/test_batch_fleet.py::FakeKV``, raising ``error`` (the store
    module's ``LeaseStoreError``)."""

    def __init__(self, error):
        self._d = {}
        self._lock = threading.Lock()
        self.fail_ops = 0
        self.error = error

    def _maybe_fail(self):
        with self._lock:
            if self.fail_ops > 0:
                self.fail_ops -= 1
                raise self.error("injected kv failure")

    def put_new(self, key, value):
        self._maybe_fail()
        with self._lock:
            if key in self._d:
                return False
            self._d[key] = value
            return True

    def put(self, key, value):
        self._maybe_fail()
        with self._lock:
            self._d[key] = value

    def get(self, key):
        self._maybe_fail()
        with self._lock:
            return self._d.get(key)

    def keys(self, prefix):
        self._maybe_fail()
        with self._lock:
            return sorted(k for k in self._d if k.startswith(prefix))


class FakeClock:
    """Wall and monotonic time of the lease plane, moved by the script."""

    def __init__(self):
        self.t = 1_000.0

    def __call__(self):
        return self.t


def _outcome(fn, *args):
    """A call's result as comparable data: a record's (unit, fence,
    owner, deadline), a plain value, or the exception's class name."""
    try:
        r = fn(*args)
    except Exception as e:  # the outcome under test
        return ("raise", type(e).__name__)
    if hasattr(r, "fence") and hasattr(r, "owner"):
        return ("record", r.unit_id, r.fence, r.owner, r.deadline)
    return ("value", r)


def lease_history(pkg, kind, root, monkeypatch):
    """The scripted history over one package's store of ``kind``:
    contention, expiry and reclaim, a zombie's renew, handoffs, done
    markers, the guarded wrapper's retries over a flaky KV and over
    injected store errors, and the held lease's commit-check ladder."""
    fleet, faults, _ = PACKAGES[pkg]
    clock = FakeClock()
    monkeypatch.setattr(fleet, "_wall_now", clock)
    monkeypatch.setattr(fleet, "_monotonic", clock)
    kv = None
    if kind == "dir":
        store = fleet.DirLeaseStore(os.path.join(root, pkg, "leases"))
    else:
        kv = FakeKV(fleet.LeaseStoreError)
        store = fleet.KVLeaseStore(kv)
    h = []
    a = store.try_acquire(7, "w0", 5.0, 0.5)
    h.append(_outcome(lambda: a))
    h.append(_outcome(store.try_acquire, 7, "w1", 5.0, 0.5))  # held, live
    clock.t += 5.2  # past the deadline, inside the grace
    h.append(_outcome(store.try_acquire, 7, "w1", 5.0, 0.5))
    clock.t += 0.4
    b = store.try_acquire(7, "w1", 5.0, 0.5)
    h.append(_outcome(lambda: b))
    h.append(_outcome(store.renew, a, 5.0))  # the zombie's renew
    clock.t += 1.0
    h.append(_outcome(store.renew, b, 5.0))
    h.append(_outcome(store.peek, 7))
    store.release(b)
    clock.t += 0.6
    c = store.try_acquire(7, "w2", 5.0, 0.5)
    h.append(_outcome(lambda: c))
    h.append(_outcome(store.mark_done, 7, c.fence, "w2"))
    h.append(_outcome(store.mark_done, 7, c.fence, "w2"))
    h.append(_outcome(store.try_acquire, 7, "w3", 5.0, 0.5))
    h.append(_outcome(store.renew, c, 5.0))  # done under its own fence
    h.append(_outcome(store.done_fences, [7, 8]))
    h.append(_outcome(store.current_fence, 8))

    # The guarded wrapper over the store, with a transient-error schedule
    # (a pure function of the op's ordinal) and, for the KV, a flaky KV.
    inj = faults.BatchFaultInjector(faults.BatchFaultPlan(lease_error_p=0.3), worker_index=0)
    guarded = fleet.GuardedLeaseStore(store, fleet.LeaseConfig(**CFG), faults=inj)
    if kv is not None:
        kv.fail_ops = 2
    d = guarded.try_acquire(8, "w0")
    h.append(_outcome(lambda: d))
    clock.t += 6.0
    e = guarded.try_acquire(8, "w1")  # a reclaim of an expired lease
    h.append(_outcome(lambda: e))
    h.append(_outcome(guarded.renew, d))
    h.append(_outcome(guarded.renew, e))

    # The held lease's commit check: a current fence passes; after a
    # peer's reclaim the zombie's check is a fence reject, counted.
    held = fleet.HeldLease(guarded, guarded.renew(e))
    try:
        h.append(_outcome(held.check_commit))
        clock.t += 6.0
        h.append(_outcome(guarded.try_acquire, 8, "w2"))
        h.append(_outcome(held.check_commit))
        h.append(_outcome(held.check_commit))  # latched: no store read
    finally:
        held.stop()
    h.append(("counters", guarded.snapshot()))
    h.append(("ops", inj._op_ordinal))
    return h


@pytest.mark.parametrize("kind", ["dir", "kv"])
def test_lease_history_matches_jax(kind, tmp_path, monkeypatch):
    jax_h = lease_history("jax", kind, str(tmp_path), monkeypatch)
    torch_h = lease_history("torch", kind, str(tmp_path), monkeypatch)
    assert torch_h == jax_h
    counters = torch_h[-2][1]
    assert counters["fence_rejects"] == 2 and counters["reclaims"] >= 1  # each refusal counts
    assert counters["store_errors"] >= 1  # the retries absorbed something


@pytest.mark.parametrize("env", [
    {},
    {"SEIST_LEASE_TTL_S": "2.5", "SEIST_LEASE_HEARTBEAT_S": "0.5", "SEIST_LEASE_GRACE_S": "0.5",
     "SEIST_LEASE_RETRIES": "3", "SEIST_LEASE_BACKOFF_MS": "30",
     "SEIST_LEASE_BACKOFF_CAP_MS": "200", "SEIST_LEASE_OP_TIMEOUT_S": "1.0",
     "SEIST_LEASE_PARK_S": "0.3", "SEIST_LEASE_RESCAN_S": "0.1"},
])
def test_lease_config_from_env_matches_jax(env):
    t = tfleet.LeaseConfig.from_env(env)
    j = jfleet.LeaseConfig.from_env(env)
    assert {k: getattr(t, k) for k in CFG} == {k: getattr(j, k) for k in CFG}
    assert t.heartbeat == j.heartbeat


@pytest.mark.parametrize("env", [
    {},
    {"SEIST_FAULT_BATCH_LEASE_LATENCY_MS": "3", "SEIST_FAULT_BATCH_LEASE_ERROR_P": "0.2",
     "SEIST_FAULT_BATCH_PARTITION_AFTER_S": "0.6", "SEIST_FAULT_BATCH_PARTITION_FOR_S": "60",
     "SEIST_FAULT_BATCH_KILL_UNIT": "1", "SEIST_FAULT_BATCH_PREEMPT_UNIT": "2",
     "SEIST_FAULT_BATCH_WORKER": "1", "SEIST_FAULT_STAMP": "/x/stamp"},
])
def test_batch_fault_plan_from_env_matches_jax(env):
    assert tfaults.BatchFaultPlan.from_env(env).__dict__ == \
        jfaults.BatchFaultPlan.from_env(env).__dict__
    for worker in (-1, 0, 1):
        assert tfaults.BatchFaultInjector(tfaults.BatchFaultPlan.from_env(env), worker).enabled \
            == jfaults.BatchFaultInjector(jfaults.BatchFaultPlan.from_env(env), worker).enabled


def test_store_error_schedule_matches_jax():
    """The transient errors are a pure function of the op's ordinal: the
    same ops fail in both packages."""
    def schedule(faults):
        inj = faults.BatchFaultInjector(faults.BatchFaultPlan(lease_error_p=0.25), worker_index=0)
        return [_outcome(inj.store_op, "peek")[0] for _ in range(64)]

    assert schedule(tfaults) == schedule(jfaults)
    assert "raise" in schedule(tfaults)


def test_partition_clock_starts_at_the_first_store_op(monkeypatch):
    now = {"t": 50.0}
    monkeypatch.setattr(tfaults.time, "monotonic", lambda: now["t"])
    inj = tfaults.BatchFaultInjector(
        tfaults.BatchFaultPlan(partition_after_s=1.0, partition_for_s=2.0), worker_index=0)
    inj.store_op("peek")  # anchors the clock
    now["t"] += 1.5
    with pytest.raises(OSError, match="partition"):
        inj.store_op("renew")
    now["t"] += 2.0
    inj.store_op("renew")  # healed


def test_unit_faults_fire_once_across_relaunches(tmp_path, monkeypatch):
    """The stamp makes a kill fire once across a worker's relaunches
    (mark before kill), and a fault aimed at another worker is inert."""
    stamp = str(tmp_path / "w1.stamp")
    kills = []
    monkeypatch.setattr(tfaults.os, "kill", lambda pid, sig: kills.append(sig))
    plan = tfaults.BatchFaultPlan(kill_unit=1, worker=1, stamp_path=stamp)
    tfaults.BatchFaultInjector(plan, worker_index=0).on_unit(1)
    assert kills == []
    tfaults.BatchFaultInjector(plan, worker_index=1).on_unit(1)
    tfaults.BatchFaultInjector(plan, worker_index=1).on_unit(2)  # a relaunch
    assert len(kills) == 1
    assert open(stamp).read().split() == ["batch_kill"]


def test_fenced_commit_and_merge_audit_match_jax(tmp_path):
    """The exclusive fenced publish and the merge's fence audit write the
    same files in both packages and refuse the same zombie history."""
    outs = {}
    for pkg, (_, _, cat) in PACKAGES.items():
        out = str(tmp_path / pkg)
        os.makedirs(out)
        cat.commit_segment(out, 0, 0, ['{"row":0}\n'], fence=2)
        with pytest.raises(FileExistsError):
            cat.commit_segment(out, 0, 0, ['{"row":0}\n'], fence=3)
        cat.commit_segment(out, 1, 0, ['{"row":1}\n'], fence=1)
        units = [cat.WorkUnit(0, 0, 1), cat.WorkUnit(1, 1, 2)]
        with pytest.raises(ValueError, match="zombie"):
            cat.merge_catalog(out, units, 8, 1, fences={0: 1, 1: 1})
        meta = cat.merge_catalog(out, units, 8, 1, fences={0: 2, 1: 1}, meta={"m": 1})
        outs[pkg] = (meta, {f: open(os.path.join(out, f), "rb").read()
                            for f in sorted(os.listdir(out))})
    assert outs["torch"] == outs["jax"]
    assert set(outs["torch"][1]) == {"catalog.jsonl", "catalog_meta.json",
                                     "unit_00000.seg_0000.jsonl",
                                     "unit_00000.seg_0000.jsonl.fence",
                                     "unit_00001.seg_0000.jsonl",
                                     "unit_00001.seg_0000.jsonl.fence"}


# ------------------------------------------------------- supervise-repick
STUB = r"""
import json, os, sys
i = int(os.environ["SEIST_BATCH_WORKER"])
stamp = os.path.join(sys.argv[1], f"stub{i}.runs")
runs = int(open(stamp).read()) + 1 if os.path.exists(stamp) else 1
open(stamp, "w").write(str(runs))
assert os.environ.get("SEIST_FAULT_X", "") == ("1" if i == 1 else "")
if i == 0 and runs == 1:
    os._exit(3)                       # a crash: relaunched, budget spent
if i == 1 and runs == 1:
    sys.exit(75)                      # a preemption: relaunched after the delay
if i == 2:
    sys.exit(9)                       # crashes until abandoned
lease = {k: runs for k in ("acquires", "renews")}
print(json.dumps({"role": "fleet-worker", "lease": lease, "compiles_after_warmup": 0}))
"""


def test_supervise_repick_relaunches_and_sums_the_lease_counters(tmp_path, monkeypatch, capsys):
    from seist_tpu_torch import supervise_repick as sup

    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    monkeypatch.setattr(sup, "_worker_cmd",
                        lambda args, i: [sys.executable, str(stub), str(tmp_path)])
    out = tmp_path / "out"
    rc = sup.main(["--archive", "unused", "--out", str(out), "--model", "phasenet",
                   "--workers", "3", "--lease-dir", str(tmp_path / "leases"),
                   "--retries", "1", "--rejoin-delay-s", "0.1", "--no-merge",
                   "--compile-gate", "--fault-env", "1:SEIST_FAULT_X=1", "--timeout-s", "60"])
    assert rc == 0
    v = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert v["role"] == "supervisor" and v["ok"]
    assert v["finished"] == 2 and v["abandoned"] == [2]
    assert v["preempts"] == 1 and v["crashes"] == 3 and v["relaunches"] == 3
    assert v["worker_verdicts"] == 2
    assert v["lease"]["acquires"] == 4 and v["lease"]["fence_rejects"] == 0
    assert v["compiles_after_warmup"] == 0
    logs = sorted(os.listdir(out / "logs"))
    assert logs == ["w0.01.log", "w0.02.log", "w1.01.log", "w1.02.log", "w2.01.log",
                    "w2.02.log"]
    # The worker with a fault of its own gets its stamp file.
    assert not (out / "logs" / "w0.stamp").exists()


def test_supervise_repick_fails_when_every_worker_is_gone(tmp_path, monkeypatch, capsys):
    from seist_tpu_torch import supervise_repick as sup

    monkeypatch.setattr(sup, "_worker_cmd", lambda args, i: [sys.executable, "-c",
                                                             "raise SystemExit(4)"])
    rc = sup.main(["--archive", "unused", "--out", str(tmp_path / "o"), "--model", "phasenet",
                   "--workers", "2", "--lease-dir", str(tmp_path / "l"), "--retries", "0",
                   "--no-merge"])
    assert rc == 1
    v = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not v["ok"] and v["crashes"] == 2


def test_supervise_repick_commands_match_the_jax_tool(tmp_path):
    """The worker command carries the JAX tool's flags (plus --device),
    and the merge is the port's model-free reduce with the lease ledger."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from seist_tpu_torch import supervise_repick as sup
    from tools import supervise_repick as jsup

    argv = ["--archive", "A", "--out", "O", "--model-group", "seist_s=dpk,emg", "--tasks", "emg",
            "--workers", "2", "--lease-dir", "L", "--compile-gate", "--variant", "int8"]
    t, j = sup._worker_cmd(sup.get_args(argv), 1), jsup._worker_cmd(jsup.get_args(argv), 1)
    assert t[:4] == [sys.executable, "-m", "seist_tpu_torch", "repick"]
    assert j[:3] == [sys.executable, "-m", "tools.repick_archive"]
    i = t.index("--device")
    assert t[i + 1] == "cuda"
    assert t[4:i] + t[i + 2:] == j[3:]
    assert sup._merge_cmd(sup.get_args(argv))[4:] == [
        "--archive", "A", "--out", "O", "--merge-only", "--lease-dir", "L"]
    assert sup._parse_fault_env(["1:K=V"], 2) == jsup._parse_fault_env(["1:K=V"], 2)
    assert sup._LEASE_KEYS == jsup._LEASE_KEYS
