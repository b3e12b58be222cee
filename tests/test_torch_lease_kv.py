"""The re-picking fleet's KV lease store over the process group's TCP store
(``seist_tpu_torch/batch/fleet.py``: ``TorchStoreKV``,
``KVLeaseStore.from_runtime``; ``python -m seist_tpu_torch repick
--lease-store kv``), on the CPU.

* The cases of the JAX package's ``tests/test_batch_fleet.py`` that drive
  ``KVLeaseStore(FakeKV())`` (the store matrix, the guarded wrapper, the
  commit check under a partition) run here against ``TorchStoreKV`` over a
  real ``TCPStore`` served in this process, with the same assertions:
  once over the server's own client and once through a ``PrefixStore``
  over it (the kind torchrun's agent hands a group). Injected failures
  are the store client's own exceptions, which must reach the lease
  plane as ``LeaseStoreError``.
* Two processes, clients of that store, race ``try_acquire`` over the same
  units for several rounds: exactly one wins each (unit, fence).
* ``repick --fleet --lease-store kv`` with two CPU workers launched under
  the env contract (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
  ``PROCESS_ID``) writes a catalog byte-identical to the serial run's,
  process 0 merging it with the fence audit read from the store.
* ``kv`` without a process group raises; ``auto`` without one takes the
  directory store (``tools/repick_archive.py::_lease_store``).
* A ``repick --workers 2`` driver started under the env contract runs its
  worker children outside any group: they inherit the contract's
  variables, but only a process without ``--workers`` or
  ``--worker-index`` joins.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import datetime
import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest
import torch.distributed as tdist

from seist_tpu_torch.batch import fleet
from seist_tpu_torch.parallel import dist
from seist_tpu_torch.utils.faults import BatchFaultInjector, BatchFaultPlan

from _torch_dist_worker import free_port

ROOT = Path(__file__).resolve().parent.parent

# Millisecond clocks, as tests/test_batch_fleet.py's FAST.
FAST = dict(ttl_s=0.25, heartbeat_s=0.05, grace_s=0.02, retries=3, backoff_base_s=0.01,
            backoff_cap_s=0.05, op_timeout_s=0.5, park_s=0.02, rescan_s=0.02)
MODES = ["tcp", "prefix"]


def _cfg(**over):
    return fleet.LeaseConfig(**{**FAST, **over})


def _inert():
    return BatchFaultInjector(BatchFaultPlan())


@pytest.fixture(scope="module")
def server():
    """A TCP store served by this process, as process 0 of a group serves
    its own."""
    store = tdist.TCPStore("127.0.0.1", 0, 1, is_master=True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=30))
    yield store


class FailingStore:
    """The server's client with an injectable failure window: ``fail_ops``
    store calls raise the client's kind of error (``RuntimeError``)."""

    def __init__(self, store):
        self._store = store
        self.fail_ops = 0

    def __getattr__(self, name):
        real = getattr(self._store, name)

        def call(*args, **kwargs):
            if self.fail_ops > 0:
                self.fail_ops -= 1
                raise RuntimeError("injected store failure (connection reset)")
            return real(*args, **kwargs)

        return call


def _client(server, mode):
    """``server`` itself, or a ``PrefixStore`` over it under a fresh
    prefix."""
    return server if mode == "tcp" else tdist.PrefixStore(f"p_{uuid.uuid4().hex}", server)


def _kv(server, mode, failing=False):
    """A TorchStoreKV over ``server`` in ``mode`` (the tests share one
    server; each lease store takes a fresh prefix)."""
    store = _client(server, mode)
    return fleet.TorchStoreKV(FailingStore(store) if failing else store)


def _lease_store(kv):
    return fleet.KVLeaseStore(kv, prefix=f"fleet_{uuid.uuid4().hex}")


@pytest.fixture(params=MODES)
def store(request, server):
    return _lease_store(_kv(server, request.param))


# ---------------------------------------------------------- store matrix
def test_acquire_contention_single_winner(store):
    a = store.try_acquire(7, "w0", ttl_s=5.0)
    assert a is not None and a.fence == 1 and a.owner == "w0"
    assert store.try_acquire(7, "w1", ttl_s=5.0) is None  # held, live
    assert store.current_fence(7) == 1


def test_ttl_expiry_then_reclaim_bumps_fence(store):
    a = store.try_acquire(1, "w0", ttl_s=0.05, grace_s=0.02)
    assert a.fence == 1
    time.sleep(0.06)
    assert store.try_acquire(1, "w1", ttl_s=5.0, grace_s=5.0) is None
    time.sleep(0.02)
    b = store.try_acquire(1, "w1", ttl_s=5.0, grace_s=0.02)
    assert b is not None and b.fence == 2 and b.owner == "w1"
    with pytest.raises(fleet.LeaseLost, match="fence advanced"):
        store.renew(a, 5.0)


def test_fence_strictly_monotonic_across_handoffs(store):
    fences = []
    for i in range(4):
        rec = store.try_acquire(2, f"w{i}", ttl_s=5.0)
        assert rec is not None
        fences.append(rec.fence)
        store.release(rec)
        time.sleep(0.03)
    assert fences == [1, 2, 3, 4]


def test_renew_extends_deadline(store):
    a = store.try_acquire(3, "w0", ttl_s=0.2)
    b = store.renew(a, 5.0)
    assert b.fence == a.fence and b.deadline > a.deadline
    assert store.peek(3).deadline == b.deadline


def test_mark_done_first_writer_wins_and_blocks_acquire(store):
    a = store.try_acquire(4, "w0", ttl_s=5.0)
    assert store.mark_done(4, a.fence, "w0") is True
    assert store.mark_done(4, 9, "w1") is False
    assert store.done_fence(4) == a.fence
    assert store.is_done(4)
    assert store.try_acquire(4, "w1", ttl_s=5.0) is None
    with pytest.raises(fleet.LeaseLost):
        store.renew(fleet.LeaseRecord(4, a.fence + 1, "w1", 0.0), 5.0)
    assert store.done_fences([4, 5]) == {4: a.fence}


# ------------------------------------------------------- guarded wrapper
@pytest.mark.parametrize("mode", MODES)
def test_guarded_retries_transient_then_succeeds(server, mode):
    kv = _kv(server, mode, failing=True)
    g = fleet.GuardedLeaseStore(_lease_store(kv), config=_cfg(), faults=_inert())
    kv._store.fail_ops = 2  # < retries: the caller never sees the failures
    rec = g.try_acquire(0, "w0")
    assert rec is not None and rec.fence == 1
    assert g.snapshot()["store_errors"] == 2


@pytest.mark.parametrize("mode", MODES)
def test_guarded_unavailable_after_retry_budget(server, mode):
    kv = _kv(server, mode, failing=True)
    g = fleet.GuardedLeaseStore(_lease_store(kv), config=_cfg(), faults=_inert())
    kv._store.fail_ops = 10_000
    with pytest.raises(fleet.LeaseStoreUnavailable):
        g.try_acquire(0, "w0")
    assert g.snapshot()["store_errors"] >= g.config.retries


@pytest.mark.parametrize("mode", MODES)
def test_guarded_passes_lease_lost_through_unretried(server, mode):
    st = _lease_store(_kv(server, mode))
    g = fleet.GuardedLeaseStore(st, config=_cfg(), faults=_inert())
    a = g.try_acquire(0, "w0")
    st.mark_done(0, a.fence + 1, "w1")
    before = g.snapshot()["store_errors"]
    with pytest.raises(fleet.LeaseLost):
        g.renew(a)
    assert g.snapshot()["store_errors"] == before


@pytest.mark.parametrize("mode", MODES)
def test_injected_partition_window_is_transient(server, mode):
    inj = BatchFaultInjector(BatchFaultPlan(partition_after_s=0.0, partition_for_s=0.15))
    g = fleet.GuardedLeaseStore(_lease_store(_kv(server, mode)),
                                config=_cfg(op_timeout_s=0.08, retries=2), faults=inj)
    with pytest.raises(fleet.LeaseStoreUnavailable):
        g.try_acquire(0, "w0")
    time.sleep(0.16)
    assert g.try_acquire(0, "w0") is not None


@pytest.mark.parametrize("mode", MODES)
def test_check_commit_partition_honors_local_validity(server, mode):
    kv = _kv(server, mode, failing=True)
    g = fleet.GuardedLeaseStore(_lease_store(kv),
                                config=_cfg(ttl_s=0.3, op_timeout_s=0.05, retries=2),
                                faults=_inert())
    held = fleet.HeldLease(g, g.try_acquire(0, "w0"))
    try:
        kv._store.fail_ops = 1 << 30  # hard partition from here on
        held.check_commit()  # locally valid -> allowed
        time.sleep(0.35)
        with pytest.raises(fleet.LeaseLost, match="locally expired|unreachable"):
            held.check_commit()
    finally:
        kv._store.fail_ops = 0
        held.stop()


# ------------------------------------------------------- the adapter itself
@pytest.mark.parametrize("mode", MODES)
def test_put_new_is_exclusive_even_for_the_same_text(server, mode):
    kv = _kv(server, mode)
    key = f"t_{uuid.uuid4().hex}/a/fence/000001"
    assert kv.put_new(key, "same") is True
    assert kv.put_new(key, "same") is False  # the stamp tells the writer apart
    assert kv.get(key) == "same"
    kv.put(key, "other")
    assert kv.get(key) == "other" and kv.get(key + "x") is None
    top = key.split("/")[0]
    kv.put_new(f"{top}/a/fence/000002", "x")
    kv.put(f"{top}/b/done", "y")  # a put that creates a key lists it too
    assert kv.keys(f"{top}/a/fence/") == [key, f"{top}/a/fence/000002"]
    assert kv.keys(f"{top}/") == sorted([key, f"{top}/a/fence/000002", f"{top}/b/done"])
    assert kv.keys(f"{top}/a/fence/0000") == [key, f"{top}/a/fence/000002"]
    assert kv.keys(f"{top}/c/") == []


@pytest.mark.parametrize("mode", MODES)
def test_every_store_error_is_a_lease_store_error(server, mode):
    kv = _kv(server, mode, failing=True)
    for call in (lambda: kv.put_new("k/1", "v"), lambda: kv.put("k/1", "v"),
                 lambda: kv.get("k/1"), lambda: kv.keys("k/")):
        kv._store.fail_ops = 1
        with pytest.raises(fleet.LeaseStoreError, match="injected store failure"):
            call()


def test_keys_reads_one_directory_of_the_index(server):
    """``keys`` reads the index of the prefix's directory alone, as the
    JAX package's ``key_value_dir_get`` lists one directory: a store
    holding other keys (the group's own, other units') costs it nothing."""
    reads = []

    class Reads(FailingStore):
        def get(self, key):
            reads.append(key)
            return self._store.get(key)

    kv = fleet.TorchStoreKV(Reads(tdist.PrefixStore(f"p_{uuid.uuid4().hex}", server)))
    st = fleet.KVLeaseStore(kv)
    for unit in range(5):
        st.mark_done(unit, 1, "w0")
        st.try_acquire(unit + 10, "w0", ttl_s=5.0)
    reads.clear()
    assert st.current_fence(12) == 1
    assert reads == [f"{kv._INDEX}/seist_tpu/fleet/unit_00012/fence/"]


def test_from_runtime_needs_a_process_group(monkeypatch):
    with pytest.raises(fleet.LeaseStoreError, match="no process group"):
        fleet.KVLeaseStore.from_runtime()
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK", "DIST_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    assert dist.init_distributed_mode(device="cpu")
    try:
        st = fleet.KVLeaseStore.from_runtime()
        assert isinstance(st.kv, fleet.TorchStoreKV)
        assert st.try_acquire(0, "w0", ttl_s=5.0).fence == 1
        assert st.current_fence(0) == 1
    finally:
        dist.shutdown()


# ------------------------------------------------------------ the race
RACER = """
import datetime, json, sys, time
import torch.distributed as tdist
from seist_tpu_torch.batch import fleet

port, me, units, rounds, prefix, index = sys.argv[1:7]
store = tdist.TCPStore("127.0.0.1", int(port), is_master=False,
                       timeout=datetime.timedelta(seconds=60))
if index == "prefix":
    store = tdist.PrefixStore(prefix + "_client", store)
kv = fleet.TorchStoreKV(store)
st = fleet.KVLeaseStore(kv, prefix=prefix)
store.add(prefix + "/ready", 1)
while int(store.add(prefix + "/ready", 0)) < 2:
    time.sleep(0.001)
won = []
for r in range(int(rounds)):
    for u in range(int(units)):
        rec = st.try_acquire(u, me, ttl_s=30.0, grace_s=0.0)
        if rec is not None:
            won.append([u, rec.fence])
            st.release(rec)
print(json.dumps(won))
"""


@pytest.mark.parametrize("mode", MODES)
def test_two_processes_race_and_one_wins_each_fence(server, mode):
    prefix = f"race_{uuid.uuid4().hex}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", RACER, str(server.port), f"w{i}", "6", "5",
                               prefix, mode], stdout=subprocess.PIPE, text=True, env=env)
             for i in range(2)]
    wins = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0
        wins.append([tuple(x) for x in json.loads(out.strip().splitlines()[-1])])
    both = wins[0] + wins[1]
    assert len(both) == len(set(both)), "a (unit, fence) won twice"
    client = server if mode == "tcp" else tdist.PrefixStore(prefix + "_client", server)
    check = fleet.KVLeaseStore(fleet.TorchStoreKV(client), prefix=prefix)
    for u in range(6):
        fences = sorted(f for unit, f in both if unit == u)
        # Every fence the store issued was won by exactly one process.
        assert fences == list(range(1, check.current_fence(u) + 1)) and fences
    assert wins[0] and wins[1]


# --------------------------------------------------- repick over the store
N_EVENTS, TRACE, SPS = 22, 256, 10


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    from seist_tpu_torch.data.packed import PackSource, pack_sources

    root = tmp_path_factory.mktemp("kv_archive")
    return pack_sources([PackSource(name="synthetic", dataset_kwargs={
        "num_events": N_EVENTS, "trace_samples": TRACE, "cache": False})],
        str(root), samples_per_shard=SPS, dtype="float32")["out"]


def _geometry():
    return ["--model", "phasenet", "--device", "cpu", "--batch-size", "4",
            "--batches-per-call", "2", "--commit-every", "1"]


@pytest.fixture(scope="module")
def serial(archive, tmp_path_factory):
    """The catalog of one process mapping every unit."""
    from seist_tpu_torch.repick import main

    out = tmp_path_factory.mktemp("serial")
    assert main(["--archive", archive, "--out", str(out), *_geometry()]) == 0
    return (out / "catalog.jsonl").read_bytes()


def _contract(monkeypatch_or_env, port, world, rank):
    """Set the env contract of ``world`` processes, rank ``rank``, in a
    dict or a ``MonkeyPatch``; the other launchers' variables removed."""
    values = dict(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(world),
                  PROCESS_ID=str(rank), SEIST_DIST_TIMEOUT_S="120", SEIST_LEASE_TTL_S="10")
    others = ("DIST_BACKEND", "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    if isinstance(monkeypatch_or_env, dict):
        monkeypatch_or_env.update(values)
        for var in others:
            monkeypatch_or_env.pop(var, None)
        return monkeypatch_or_env
    for k, v in values.items():
        monkeypatch_or_env.setenv(k, v)
    for var in others:
        monkeypatch_or_env.delenv(var, raising=False)


def test_repick_kv_fleet_of_two_is_byte_identical(archive, serial, tmp_path):
    """Two ``repick --fleet --lease-store kv`` processes under the env
    contract: process 0 merges, the catalog equals the serial one."""
    out = tmp_path / "fleet"
    port = free_port()
    logs = [tmp_path / f"w{r}.log" for r in range(2)]
    procs = []
    for r in range(2):
        env = _contract(dict(os.environ, PYTHONPATH=str(ROOT)), port, 2, r)
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "seist_tpu_torch", "repick", "--archive", archive,
                 "--out", str(out), "--fleet", "--lease-store", "kv", *_geometry()],
                cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT))
    for p in procs:
        p.wait(timeout=240)
    texts = [log.read_text() for log in logs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(t[-3000:] for t in texts)
    verdicts = [json.loads(x) for t in texts for x in t.splitlines() if x.startswith("{")]
    workers = [v for v in verdicts if v.get("role") == "fleet-worker"]
    assert sorted(v["worker"] for v in workers) == [0, 1]
    assert all(v["store"] == "KVLeaseStore" and v["all_done"] for v in workers)
    assert sum(v["units_done"] for v in workers) == 3
    assert all(v["lease"]["double_commits"] == 0 for v in workers)
    (merge,) = [v for v in verdicts if v.get("role") == "merge"]
    assert merge["fence_audit"]["fenced_segments"] == 5
    assert merge["fence_audit"]["stale_fence_segments"] == 0
    assert (out / "catalog.jsonl").read_bytes() == serial


def test_a_driver_under_the_contract_keeps_its_children_out_of_the_group(
        archive, serial, tmp_path, monkeypatch):
    """``repick --workers 2`` in a process that the env contract names
    rank 1 of 2, at an address that no process serves: the driver and its
    ``--worker-index`` children (which inherit the variables) join no
    group, so nothing waits for rank 0 and the merged catalog is the
    serial one."""
    from seist_tpu_torch.repick import main

    _contract(monkeypatch, free_port(), 2, 1)
    monkeypatch.setenv("SEIST_DIST_TIMEOUT_S", "20")  # a join would fail the test in 20 s
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    out = tmp_path / "driver"
    assert main(["--archive", archive, "--out", str(out), "--workers", "2",
                 *_geometry()]) == 0
    assert sorted(p.name for p in out.glob("worker_*.json")) == ["worker_0.json",
                                                                 "worker_1.json"]
    assert (out / "catalog.jsonl").read_bytes() == serial
    assert not dist.is_dist_avail_and_initialized()


def test_lease_store_choice_outside_a_group(tmp_path):
    from seist_tpu_torch.repick import _lease_store, get_args

    base = ["--archive", "A", "--out", "O", "--model", "phasenet", "--fleet"]
    auto = get_args(base + ["--lease-dir", str(tmp_path)])
    assert isinstance(_lease_store(auto), fleet.DirLeaseStore)
    with pytest.raises(fleet.LeaseStoreError, match="no process group"):
        _lease_store(get_args(base + ["--lease-store", "kv"]))
    with pytest.raises(SystemExit):
        get_args(base)  # auto needs --lease-dir for its fallback
