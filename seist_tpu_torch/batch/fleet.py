"""Lease plane of the fault-tolerant batch fleet (the port's copy of
``seist_tpu/batch/fleet.py``).

Re-picking is shard-deterministic and segment-committed
(``batch/catalog.py``), so the catalog is a pure function of (archive,
plan). This module adds the layer above: N workers sharing one archive,
surviving SIGKILL, exit-75 preemption and partitions of the lease store
without reprocessing, double-committing or a human restart. The lease /
heartbeat / fencing-token loop:

* **Lease**: one :class:`~seist_tpu_torch.batch.catalog.WorkUnit` at a
  time per worker, acquired by a compare-and-swap that issues fence token
  ``current + 1``. Fences are per-unit monotonic: every acquisition gets
  a strictly larger token, so the owner of a unit is the highest fence,
  and any actor holding a smaller one is a zombie.
* **Heartbeat**: the holder renews its deadline every ``heartbeat_s``; a
  worker that dies stops renewing and the lease expires ``ttl_s`` later,
  when any peer may reclaim it at the next fence.
* **Fenced commit**: before every segment commit the holder checks that
  its fence is still current (:meth:`HeldLease.check_commit`); the
  segment file is published with an exclusive link
  (``catalog.commit_segment(fence=)``), so a zombie that races past the
  check gets :class:`DoubleCommit` instead of overwriting.
* **Partitions**: every store operation runs behind retry with jittered
  exponential backoff and a deadline (:class:`GuardedLeaseStore`); while
  the store stays unreachable the worker commits only what it can prove
  it still owns (the lease is *locally* valid: less than ``ttl_s`` on a
  monotonic clock since the last renew), then parks and re-acquires on
  heal.

Two stores implement the same primitives (``try_acquire`` / ``renew`` /
``release`` / ``mark_done`` / ``current_fence``): :class:`DirLeaseStore`
over a shared directory (the compare-and-swap is an exclusive
``os.link``), and :class:`KVLeaseStore` over any key-value object with
``put_new``, ``put``, ``get`` and ``keys``. The JAX package builds the
latter over its coordination service (``KVLeaseStore.from_runtime``,
``JaxCoordinationKV``); the port has no multi-process runtime yet, so
``repick --lease-store kv`` refuses and ``auto`` takes the directory
store (``ROADMAP.md`` §1, queue 4). Neither store holds a Python lock
across store I/O.

Tuning: ``SEIST_LEASE_TTL_S``, ``SEIST_LEASE_HEARTBEAT_S``,
``SEIST_LEASE_GRACE_S``, ``SEIST_LEASE_RETRIES``,
``SEIST_LEASE_BACKOFF_MS``, ``SEIST_LEASE_BACKOFF_CAP_MS``,
``SEIST_LEASE_OP_TIMEOUT_S``, ``SEIST_LEASE_PARK_S``,
``SEIST_LEASE_RESCAN_S`` (:meth:`LeaseConfig.from_env`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Set

from seist_tpu_torch.data.io_guard import RetryPolicy
from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.utils.faults import BatchFaultInjector, _env_float, _env_int, batch_faults
from seist_tpu_torch.utils.logger import logger

_FENCE_RE = re.compile(r"^unit_(\d{5})\.fence_(\d{6})\.json$")


def _wall_now() -> float:
    """Shared-clock 'now' for lease deadlines. Wall clock is REQUIRED
    here: deadlines are compared by peers on other machines, so a
    process-local monotonic clock cannot express them. The value is
    coordination state only — it never reaches catalog bytes (segment
    content is a pure function of (archive, plan))."""
    return time.time()


def _monotonic() -> float:
    return time.monotonic()


# ------------------------------------------------------------------ errors
class LeaseError(RuntimeError):
    """Base class for every lease-plane failure."""


class LeaseStoreError(LeaseError):
    """One lease-store operation failed (possibly transient — the
    guarded wrapper retries these)."""


class LeaseStoreUnavailable(LeaseError):
    """Retries + deadline exhausted: the store is partitioned away.
    Workers park on this; they never crash on it."""


class LeaseLost(LeaseError):
    """This holder's fence is no longer current (expired + reclaimed,
    or locally expired during a partition)."""


class FenceRejected(LeaseLost):
    """A commit/done attempt carried a stale fence — the zombie write
    the fencing token exists to stop. Counted on the obs bus."""


class DoubleCommit(LeaseError):
    """An exclusive segment publish hit an already-committed file: the
    exactly-once machinery's last line of defense fired. The content is
    identical (purity), but the chaos gate pins this counter to zero —
    a nonzero count means the fence check ladder has a hole."""


# ------------------------------------------------------------------ config
@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """Lease-plane tuning. ``from_env`` reads the ``SEIST_LEASE_*``
    registry (all optional; the defaults suit real fleets — tests and
    chaos lanes shrink the clocks)."""

    ttl_s: float = 30.0
    heartbeat_s: float = 0.0  # 0 -> ttl_s / 3
    grace_s: float = 0.5  # reclaim waits deadline + grace (clock-skew margin)
    retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    op_timeout_s: float = 10.0  # overall deadline per guarded store op
    park_s: float = 0.5  # base park interval while partitioned
    rescan_s: float = 0.25  # idle wait when peers hold every open unit

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "LeaseConfig":
        env = os.environ if env is None else env
        return cls(
            ttl_s=_env_float(env, "SEIST_LEASE_TTL_S", 30.0),
            heartbeat_s=_env_float(env, "SEIST_LEASE_HEARTBEAT_S", 0.0),
            grace_s=_env_float(env, "SEIST_LEASE_GRACE_S", 0.5),
            retries=max(1, _env_int(env, "SEIST_LEASE_RETRIES", 3)),
            backoff_base_s=_env_float(env, "SEIST_LEASE_BACKOFF_MS", 50.0)
            / 1000.0,
            backoff_cap_s=_env_float(env, "SEIST_LEASE_BACKOFF_CAP_MS", 2000.0)
            / 1000.0,
            op_timeout_s=_env_float(env, "SEIST_LEASE_OP_TIMEOUT_S", 10.0),
            park_s=_env_float(env, "SEIST_LEASE_PARK_S", 0.5),
            rescan_s=_env_float(env, "SEIST_LEASE_RESCAN_S", 0.25),
        )

    @property
    def heartbeat(self) -> float:
        return self.heartbeat_s if self.heartbeat_s > 0 else self.ttl_s / 3.0


@dataclasses.dataclass(frozen=True)
class LeaseRecord:
    """One issued lease: (unit, fence, owner, wall-clock deadline).
    ``fence > 1`` means this acquisition reclaimed/superseded an
    earlier holder."""

    unit_id: int
    fence: int
    owner: str
    deadline: float  # wall-clock epoch seconds

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "LeaseRecord":
        d = json.loads(blob)
        return cls(
            unit_id=int(d["unit_id"]),
            fence=int(d["fence"]),
            owner=str(d["owner"]),
            deadline=float(d["deadline"]),
        )


# ----------------------------------------------------------- dir lease store
class DirLeaseStore:
    """Shared-directory lease store: one fence file per issued fence,
    one done marker per finished unit. LOCK-FREE — the acquire CAS is
    an exclusive ``os.link`` (EEXIST == lost the race), renewal is an
    atomic overwrite of the holder's own fence file, and reads are
    atomic whole-file JSON. Works for multi-process single-host fleets
    and any POSIX shared filesystem whose link/rename are atomic."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -------------------------------------------------------------- paths
    def _fence_path(self, unit_id: int, fence: int) -> str:
        return os.path.join(
            self.root, f"unit_{unit_id:05d}.fence_{fence:06d}.json"
        )

    def _done_path(self, unit_id: int) -> str:
        return os.path.join(self.root, f"unit_{unit_id:05d}.done.json")

    def _cas_create(self, path: str, blob: str) -> bool:
        """Exclusive create via link: True iff WE published ``path``."""
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(blob)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    # ------------------------------------------------------------- reads
    def current_fence(self, unit_id: int) -> int:
        """Highest fence ever issued for ``unit_id`` (0 = none).
        ``max`` is order-insensitive, so readdir order cannot matter."""
        prefix = f"unit_{unit_id:05d}.fence_"
        fences = [
            int(m.group(2))
            for m in (
                _FENCE_RE.match(name) for name in sorted(os.listdir(self.root))
            )
            if m is not None and int(m.group(1)) == unit_id
        ]
        del prefix
        return max(fences) if fences else 0

    def peek(self, unit_id: int) -> Optional[LeaseRecord]:
        fence = self.current_fence(unit_id)
        if fence == 0:
            return None
        with open(self._fence_path(unit_id, fence)) as f:
            return LeaseRecord.from_json(f.read())

    def is_done(self, unit_id: int) -> bool:
        return os.path.exists(self._done_path(unit_id))

    def done_fence(self, unit_id: int) -> Optional[int]:
        try:
            with open(self._done_path(unit_id)) as f:
                return int(json.load(f)["fence"])
        except FileNotFoundError:
            return None

    # ------------------------------------------------------------ writes
    def try_acquire(
        self, unit_id: int, owner: str, ttl_s: float, grace_s: float = 0.5
    ) -> Optional[LeaseRecord]:
        """CAS-acquire at fence ``current + 1``. None when the unit is
        done, the current holder's lease is still live (reclaim waits
        ``deadline + grace_s`` — clock-skew margin vs the holder's own
        local-validity window), or another acquirer won the race."""
        if self.is_done(unit_id):
            return None
        cur = self.peek(unit_id)
        if cur is not None and _wall_now() < cur.deadline + grace_s:
            return None
        fence = (cur.fence if cur is not None else 0) + 1
        rec = LeaseRecord(unit_id, fence, owner, _wall_now() + ttl_s)
        if self._cas_create(self._fence_path(unit_id, fence), rec.to_json()):
            return rec
        return None

    def renew(self, record: LeaseRecord, ttl_s: float) -> LeaseRecord:
        """Extend the holder's deadline. Raises :class:`LeaseLost` when
        a higher fence exists (someone reclaimed) or the unit finished
        under another fence. The overwrite itself cannot steal the unit
        back — peers always look at the HIGHEST fence."""
        cur = self.current_fence(record.unit_id)
        if cur != record.fence:
            raise LeaseLost(
                f"unit {record.unit_id}: fence advanced to {cur} past "
                f"{record.fence} (lease reclaimed)"
            )
        done = self.done_fence(record.unit_id)
        if done is not None and done != record.fence:
            raise LeaseLost(
                f"unit {record.unit_id}: completed under fence {done}"
            )
        new = dataclasses.replace(record, deadline=_wall_now() + ttl_s)
        path = self._fence_path(record.unit_id, record.fence)
        tmp = f"{path}.renew.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(new.to_json())
        os.replace(tmp, path)
        return new

    def release(self, record: LeaseRecord) -> None:
        """Zero the deadline so peers reclaim immediately (graceful
        handoff on preemption). Only meaningful while still current."""
        if self.current_fence(record.unit_id) != record.fence:
            return
        expired = dataclasses.replace(record, deadline=0.0)
        path = self._fence_path(record.unit_id, record.fence)
        tmp = f"{path}.rel.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(expired.to_json())
        os.replace(tmp, path)

    def mark_done(self, unit_id: int, fence: int, owner: str) -> bool:
        """Terminal marker (first writer wins): True iff WE marked it."""
        blob = json.dumps(
            {"unit_id": unit_id, "fence": fence, "owner": owner},
            sort_keys=True,
        )
        return self._cas_create(self._done_path(unit_id), blob)

    def done_fences(self, unit_ids: Sequence[int]) -> Dict[int, int]:
        """unit -> completing fence, for the merge-side ledger audit."""
        out: Dict[int, int] = {}
        for uid in unit_ids:
            fence = self.done_fence(int(uid))
            if fence is not None:
                out[int(uid)] = fence
        return out


# ------------------------------------------------------------ KV lease store
class KVLeaseStore:
    """The same lease algorithm over a key-value coordination service.
    ``kv`` is any object with the four-primitive protocol below (the
    JAX package adapts its coordination service to it; tests drive it
    with an in-memory fake).

    Protocol: ``put_new(key, value) -> bool`` (exclusive create; False
    when the key exists — the CAS), ``put(key, value)`` (overwrite),
    ``get(key) -> Optional[str]``, ``keys(prefix) -> List[str]``.
    """

    def __init__(self, kv: Any, prefix: str = "seist_tpu/fleet"):
        self.kv = kv
        self.prefix = prefix.rstrip("/")

    # -------------------------------------------------------------- keys
    def _unit_prefix(self, unit_id: int) -> str:
        return f"{self.prefix}/unit_{unit_id:05d}"

    def _fence_key(self, unit_id: int, fence: int) -> str:
        return f"{self._unit_prefix(unit_id)}/fence/{fence:06d}"

    def _done_key(self, unit_id: int) -> str:
        return f"{self._unit_prefix(unit_id)}/done"

    # ------------------------------------------------------------- reads
    def current_fence(self, unit_id: int) -> int:
        names = self.kv.keys(f"{self._unit_prefix(unit_id)}/fence/")
        fences = [int(n.rsplit("/", 1)[-1]) for n in sorted(names)]
        return max(fences) if fences else 0

    def peek(self, unit_id: int) -> Optional[LeaseRecord]:
        fence = self.current_fence(unit_id)
        if fence == 0:
            return None
        blob = self.kv.get(self._fence_key(unit_id, fence))
        if blob is None:
            return None
        return LeaseRecord.from_json(blob)

    def is_done(self, unit_id: int) -> bool:
        return self.kv.get(self._done_key(unit_id)) is not None

    def done_fence(self, unit_id: int) -> Optional[int]:
        blob = self.kv.get(self._done_key(unit_id))
        if blob is None:
            return None
        return int(json.loads(blob)["fence"])

    # ------------------------------------------------------------ writes
    def try_acquire(
        self, unit_id: int, owner: str, ttl_s: float, grace_s: float = 0.5
    ) -> Optional[LeaseRecord]:
        if self.is_done(unit_id):
            return None
        cur = self.peek(unit_id)
        if cur is not None and _wall_now() < cur.deadline + grace_s:
            return None
        fence = (cur.fence if cur is not None else 0) + 1
        rec = LeaseRecord(unit_id, fence, owner, _wall_now() + ttl_s)
        if self.kv.put_new(self._fence_key(unit_id, fence), rec.to_json()):
            return rec
        return None

    def renew(self, record: LeaseRecord, ttl_s: float) -> LeaseRecord:
        cur = self.current_fence(record.unit_id)
        if cur != record.fence:
            raise LeaseLost(
                f"unit {record.unit_id}: fence advanced to {cur} past "
                f"{record.fence} (lease reclaimed)"
            )
        done = self.done_fence(record.unit_id)
        if done is not None and done != record.fence:
            raise LeaseLost(
                f"unit {record.unit_id}: completed under fence {done}"
            )
        new = dataclasses.replace(record, deadline=_wall_now() + ttl_s)
        self.kv.put(self._fence_key(record.unit_id, record.fence), new.to_json())
        return new

    def release(self, record: LeaseRecord) -> None:
        if self.current_fence(record.unit_id) != record.fence:
            return
        expired = dataclasses.replace(record, deadline=0.0)
        self.kv.put(
            self._fence_key(record.unit_id, record.fence), expired.to_json()
        )

    def mark_done(self, unit_id: int, fence: int, owner: str) -> bool:
        blob = json.dumps(
            {"unit_id": unit_id, "fence": fence, "owner": owner},
            sort_keys=True,
        )
        return self.kv.put_new(self._done_key(unit_id), blob)

    def done_fences(self, unit_ids: Sequence[int]) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for uid in unit_ids:
            fence = self.done_fence(int(uid))
            if fence is not None:
                out[int(uid)] = fence
        return out


# ----------------------------------------------------------- guarded wrapper
class GuardedLeaseStore:
    """Every lease-store operation behind retry + jittered exponential
    backoff + an overall per-op deadline, with the batch fault injector
    hooked in front of each raw attempt (latency / error / partition
    windows). Owns the fleet's lease counters — bus counters for
    /metrics.json and a local mirror (:meth:`snapshot`) for worker
    verdict lines. No lock is ever held across a store call: the
    counter lock guards plain ints only."""

    #: transient per-attempt failures the retry loop absorbs
    _TRANSIENT = (OSError, LeaseStoreError)

    def __init__(
        self,
        store: Any,
        config: Optional[LeaseConfig] = None,
        faults: Optional[BatchFaultInjector] = None,
    ):
        self.store = store
        self.config = config or LeaseConfig.from_env()
        self.faults = faults if faults is not None else batch_faults()
        # The io_guard policy carries the repo's ONE rationale'd jitter
        # suppression — lease retries ride it rather than a fresh RNG.
        self._policy = RetryPolicy(
            attempts=self.config.retries,
            backoff_base_s=self.config.backoff_base_s,
            backoff_cap_s=self.config.backoff_cap_s,
        )
        self._counts_lock = threading.Lock()
        self._counts: Dict[str, int] = {
            "acquires": 0,
            "reclaims": 0,
            "renews": 0,
            "releases": 0,
            "expires": 0,
            "fence_rejects": 0,
            "double_commits": 0,
            "store_errors": 0,
            "parks": 0,
        }
        self._bus = {
            "acquires": BUS.counter("batch_lease_acquire"),
            "reclaims": BUS.counter("batch_lease_reclaim"),
            "renews": BUS.counter("batch_lease_renew"),
            "releases": BUS.counter("batch_lease_release"),
            "expires": BUS.counter("batch_lease_expire"),
            "fence_rejects": BUS.counter("batch_lease_fence_reject"),
            "double_commits": BUS.counter("batch_segment_double_commit"),
            "store_errors": BUS.counter("batch_lease_store_error"),
            "parks": BUS.counter("batch_lease_park"),
        }

    def bump(self, name: str, n: int = 1) -> None:
        with self._counts_lock:
            self._counts[name] += n
        self._bus[name].inc(n)

    def snapshot(self) -> Dict[str, int]:
        with self._counts_lock:
            return dict(self._counts)

    # ------------------------------------------------------------ guarded op
    def _call(self, op: str, fn: Callable, *args) -> Any:
        deadline = _monotonic() + self.config.op_timeout_s
        attempt = 0
        while True:
            try:
                self.faults.store_op(op)
                return fn(*args)
            except LeaseLost:
                raise  # authoritative, not transient
            except self._TRANSIENT as e:
                self.bump("store_errors")
                attempt += 1
                now = _monotonic()
                if attempt >= self.config.retries or now >= deadline:
                    raise LeaseStoreUnavailable(
                        f"lease store op '{op}' failed {attempt}x over "
                        f"{self.config.op_timeout_s:.1f}s: {e}"
                    ) from e
                time.sleep(
                    min(
                        self._policy.sleep_s(attempt - 1),
                        max(0.0, deadline - now),
                    )
                )

    # --------------------------------------------------------- protocol ops
    def try_acquire(self, unit_id: int, owner: str) -> Optional[LeaseRecord]:
        cfg = self.config
        before = self._call("peek", self.store.peek, unit_id)
        rec = self._call(
            "try_acquire",
            self.store.try_acquire,
            unit_id,
            owner,
            cfg.ttl_s,
            cfg.grace_s,
        )
        if rec is not None:
            self.bump("acquires")
            if rec.fence > 1:
                self.bump("reclaims")
            if before is not None and before.deadline <= _wall_now():
                self.bump("expires")  # took over an expired lease
        return rec

    def renew(self, record: LeaseRecord) -> LeaseRecord:
        new = self._call("renew", self.store.renew, record, self.config.ttl_s)
        self.bump("renews")
        return new

    def release(self, record: LeaseRecord) -> None:
        self._call("release", self.store.release, record)
        self.bump("releases")

    def mark_done(self, unit_id: int, fence: int, owner: str) -> bool:
        return self._call(
            "mark_done", self.store.mark_done, unit_id, fence, owner
        )

    def is_done(self, unit_id: int) -> bool:
        return self._call("is_done", self.store.is_done, unit_id)

    def done_fence(self, unit_id: int) -> Optional[int]:
        return self._call("done_fence", self.store.done_fence, unit_id)

    def current_fence(self, unit_id: int) -> int:
        return self._call("current_fence", self.store.current_fence, unit_id)


# --------------------------------------------------------------- held lease
class HeldLease:
    """One acquired lease + its heartbeat thread. The engine calls
    :meth:`check_commit` before every segment commit (the fence guard
    ladder) and reads :attr:`fence` for the segment sidecar; the
    heartbeat renews every ``config.heartbeat`` seconds and keeps the
    LOCAL validity anchor (`monotonic` at the last successful renew)
    that authorizes commits during a store partition. Store I/O always
    happens OUTSIDE the lock."""

    def __init__(self, guarded: GuardedLeaseStore, record: LeaseRecord):
        self.guarded = guarded
        self.config = guarded.config
        self._lock = threading.Lock()
        self._record = record
        self._last_renew_m = _monotonic()
        self._lost_reason: Optional[str] = None
        self._g_age = BUS.gauge("batch_lease_heartbeat_age_s")
        self._stop = threading.Event()
        self._hb = threading.Thread(
            target=self._heartbeat,
            name=f"lease-hb-u{record.unit_id}",
            daemon=True,
        )
        self._hb.start()

    # ------------------------------------------------------------- queries
    @property
    def record(self) -> LeaseRecord:
        with self._lock:
            return self._record

    @property
    def unit_id(self) -> int:
        return self.record.unit_id

    @property
    def fence(self) -> int:
        return self.record.fence

    def lost_reason(self) -> Optional[str]:
        with self._lock:
            return self._lost_reason

    def locally_valid(self) -> bool:
        """True while no peer CAN have reclaimed us: less than ``ttl_s``
        of monotonic time since the last successful renew (the store
        deadline peers compare against was written at that renew)."""
        with self._lock:
            if self._lost_reason is not None:
                return False
            return _monotonic() - self._last_renew_m < self.config.ttl_s

    # --------------------------------------------------------- commit guard
    def check_commit(self) -> None:
        """The commit guard ladder, in order of authority:

        1. heartbeat already proved the fence stale -> FenceRejected;
        2. store reachable -> synchronous fence check (advanced fence
           == a zombie commit attempt, rejected and counted);
        3. store partitioned -> commit allowed only while LOCALLY
           valid; past that window a peer may legitimately own the
           unit, so the segment is discarded (LeaseLost — resume
           recomputes it; content purity makes the redo identical).
        """
        reason = self.lost_reason()
        if reason is not None:
            self.guarded.bump("fence_rejects")
            raise FenceRejected(
                f"unit {self.unit_id}: commit refused, lease lost ({reason})"
            )
        rec = self.record
        try:
            cur = self.guarded.current_fence(rec.unit_id)
        except LeaseStoreUnavailable:
            if self.locally_valid():
                return  # partition + provably-unreclaimable == safe
            with self._lock:
                self._lost_reason = "locally expired during store partition"
            raise LeaseLost(
                f"unit {rec.unit_id}: lease store unreachable and the "
                f"lease's local {self.config.ttl_s:.1f}s validity window "
                "has passed — a peer may own this unit now; discarding "
                "the segment (the reclaimer recommits identical bytes)"
            ) from None
        if cur != rec.fence:
            with self._lock:
                self._lost_reason = f"fence advanced to {cur}"
            self.guarded.bump("fence_rejects")
            raise FenceRejected(
                f"unit {rec.unit_id}: commit with stale fence {rec.fence} "
                f"rejected (current fence {cur})"
            )

    # ----------------------------------------------------------- heartbeat
    def _heartbeat(self) -> None:
        try:
            while not self._stop.wait(self.config.heartbeat):
                with self._lock:
                    rec = self._record
                    if self._lost_reason is not None:
                        return
                    age = _monotonic() - self._last_renew_m
                self._g_age.set(age)
                try:
                    new = self.guarded.renew(rec)
                except LeaseLost as e:
                    with self._lock:
                        self._lost_reason = str(e)
                    return
                except LeaseStoreUnavailable:
                    # Partition: keep beating — local validity decays on
                    # its own and check_commit handles the rest.
                    continue
                now = _monotonic()
                with self._lock:
                    self._record = new
                    self._last_renew_m = now
                self._g_age.set(0.0)
        except Exception:  # record-and-die-visible: a silent heartbeat
            # death would look exactly like a partition; mark the lease
            # lost so the next commit refuses instead of trusting it.
            logger.exception(
                f"[fleet] heartbeat for unit {self.record.unit_id} died"
            )
            with self._lock:
                self._lost_reason = "heartbeat thread died"

    def stop(self) -> None:
        self._stop.set()
        self._hb.join(timeout=max(2.0, self.config.heartbeat * 4))


# -------------------------------------------------------------- fleet worker
class FleetWorker:
    """One worker's lease loop: scan the unit list (rotated by a worker
    offset so an N-worker fleet starts spread out), acquire one lease
    at a time, run it via ``run_unit_fn(unit, held_lease) -> stats``,
    mark it done, repeat until every unit carries a done marker.

    Degradation contract: a partitioned store parks the worker
    (jittered backoff, interruptible by ``stop_event``); a lost lease
    abandons the unit (a peer owns it); preemption (``stop_event``)
    drains the in-flight segment, releases the lease, and returns with
    ``preempted=True`` so the caller can exit 75. The loop never raises
    for store trouble — only :class:`DoubleCommit` (a broken invariant)
    and real engine errors propagate."""

    def __init__(
        self,
        store: Any,
        units: Sequence[Any],  # catalog.WorkUnit
        owner: str,
        run_unit_fn: Callable[[Any, HeldLease], Dict[str, Any]],
        *,
        config: Optional[LeaseConfig] = None,
        faults: Optional[BatchFaultInjector] = None,
        stop_event: Optional[threading.Event] = None,
        scan_offset: int = 0,
    ):
        self.guarded = (
            store
            if isinstance(store, GuardedLeaseStore)
            else GuardedLeaseStore(store, config=config, faults=faults)
        )
        self.config = self.guarded.config
        self.faults = self.guarded.faults
        self.units = list(units)
        self.owner = owner
        self.run_unit_fn = run_unit_fn
        self.stop_event = stop_event or threading.Event()
        self.scan_offset = int(scan_offset) % max(1, len(self.units))
        self._park_policy = RetryPolicy(
            attempts=1 << 30,
            backoff_base_s=self.config.park_s,
            backoff_cap_s=max(self.config.park_s, 10.0),
        )

    def _scan_order(self) -> List[Any]:
        return self.units[self.scan_offset:] + self.units[: self.scan_offset]

    def _park(self, stats: Dict[str, Any], attempt: int) -> None:
        """Partitioned: wait (jittered, growing, interruptible) and let
        the caller rescan. Parking is the NEVER-CRASH stance — the
        worker keeps its process, captured programs, and store connection
        warm for the heal."""
        self.guarded.bump("parks")
        stats["parks"] += 1
        delay = self._park_policy.sleep_s(min(attempt, 6))
        logger.warning(
            f"[fleet] {self.owner}: lease store unreachable — parked "
            f"{delay:.2f}s (park #{stats['parks']})"
        )
        self.stop_event.wait(timeout=delay)

    # ------------------------------------------------------------- one unit
    def _finish_unit(
        self, unit: Any, held: HeldLease, stats: Dict[str, Any]
    ) -> None:
        """Mark a COMPLETED unit done, parking through partitions until
        the marker lands (work is already durable in the segments; the
        marker must not be lost to a transient outage). A competing done
        marker under a different fence means a peer legitimately
        finished our reclaimed unit — the zombie-completion variant of a
        fence reject."""
        park_attempt = 0
        while not self.stop_event.is_set():
            try:
                if self.guarded.mark_done(
                    unit.unit_id, held.fence, self.owner
                ):
                    stats["units_done"] += 1
                    return
                done = self.guarded.done_fence(unit.unit_id)
                if done is not None and done != held.fence:
                    self.guarded.bump("fence_rejects")
                    stats["units_lost"] += 1
                    logger.warning(
                        f"[fleet] {self.owner}: unit {unit.unit_id} was "
                        f"completed under fence {done} while we held "
                        f"stale fence {held.fence} (zombie completion "
                        "rejected)"
                    )
                else:
                    stats["units_done"] += 1
                return
            except LeaseStoreUnavailable:
                self._park(stats, park_attempt)
                park_attempt += 1

    def _run_leased(
        self, unit: Any, rec: LeaseRecord, stats: Dict[str, Any]
    ) -> str:
        """-> 'done' | 'preempted' | 'lost'."""
        held = HeldLease(self.guarded, rec)
        try:
            out = self.run_unit_fn(unit, held)
        except (FenceRejected, LeaseLost) as e:
            stats["units_lost"] += 1
            logger.warning(f"[fleet] {self.owner}: {e}")
            return "lost"
        except DoubleCommit as e:
            # The last-resort publish guard fired: content is identical
            # (purity) but the fence ladder failed to stop a zombie —
            # surface it, count it, and abandon the unit to its owner.
            self.guarded.bump("double_commits")
            stats["units_lost"] += 1
            logger.error(f"[fleet] {self.owner}: DOUBLE COMMIT — {e}")
            return "lost"
        finally:
            held.stop()
        if out.get("preempted"):
            try:
                self.guarded.release(held.record)
            except (LeaseStoreUnavailable, LeaseLost):
                pass  # expiry hands the unit over anyway
            return "preempted"
        self._finish_unit(unit, held, stats)
        return "done"

    # ----------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {
            "owner": self.owner,
            "units_done": 0,
            "units_lost": 0,
            "parks": 0,
            "preempted": False,
        }
        done_local: Set[int] = set()
        acquired_ordinal = 0
        idle_rounds = 0
        park_attempt = 0
        while not self.stop_event.is_set():
            progressed = False
            open_units = 0
            parked = False
            for unit in self._scan_order():
                if unit.unit_id in done_local:
                    continue
                if self.stop_event.is_set():
                    break
                try:
                    if self.guarded.is_done(unit.unit_id):
                        done_local.add(unit.unit_id)
                        continue
                    rec = self.guarded.try_acquire(unit.unit_id, self.owner)
                except LeaseStoreUnavailable:
                    self._park(stats, park_attempt)
                    park_attempt += 1
                    parked = True
                    break
                park_attempt = 0
                if rec is None:
                    open_units += 1  # held by a live peer (or done-raced)
                    continue
                acquired_ordinal += 1
                self.faults.on_unit(acquired_ordinal)
                outcome = self._run_leased(unit, rec, stats)
                progressed = True
                if outcome == "done":
                    done_local.add(unit.unit_id)
                elif outcome == "preempted":
                    break
            if self.stop_event.is_set():
                break
            if parked:
                continue
            if open_units == 0 and len(done_local) == len(self.units):
                break  # every unit carries a done marker
            if not progressed:
                idle_rounds += 1
                self.stop_event.wait(
                    timeout=self._jittered_rescan(idle_rounds)
                )
            else:
                idle_rounds = 0
        stats["preempted"] = self.stop_event.is_set()
        stats["all_done"] = len(done_local) == len(self.units)
        stats["lease"] = self.guarded.snapshot()
        return stats

    def _jittered_rescan(self, idle_rounds: int) -> float:
        policy = RetryPolicy(
            attempts=1 << 30,
            backoff_base_s=self.config.rescan_s,
            backoff_cap_s=max(self.config.rescan_s, 2.0),
        )
        return policy.sleep_s(min(idle_rounds - 1, 3))
