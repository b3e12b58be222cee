"""Fault injection for the train, data, serving and streaming planes (the
port's copy of those parts of ``seist_tpu/utils/faults.py``).

The train worker consults :class:`FaultInjector` at every step boundary and
the data plane consults :class:`IoFaultInjector` on every sample read, so
the preempt, kill/resume, bad-update-guard, retry, quarantine and
stall-watchdog paths run end to end under real faults rather than mocks.

Knobs (all opt-in; absent means "never fire"). Steps are GLOBAL batch
indices (``epoch * steps_per_epoch + step``), the checkpoint numbering::

    SEIST_FAULT_NAN_STEP      corrupt the input batch to NaN at this step
    SEIST_FAULT_NAN_COUNT     ...and the following COUNT-1 steps (default 1)
    SEIST_FAULT_KILL_STEP     SIGKILL the process at this step (no handlers
                              run: a reclaimed machine)
    SEIST_FAULT_SIGTERM_STEP  SIGTERM self at this step (graceful preempt)
    SEIST_FAULT_SLOW_MS       sleep this long at each step start
    SEIST_FAULT_SLOW_STEP     ...restricted to this one step (default: all)
    SEIST_FAULT_STAMP         stamp file recording which faults already
                              fired, so each fires AT MOST ONCE across
                              relaunches (without it a relaunched run replays
                              the same step and dies again)

Data-plane knobs (sample indices are RAW post-split dataset indices)::

    SEIST_FAULT_IO_FLAKY_P      probability that a sample read raises a
                                transient OSError; a pure function of the
                                index, so a run whose retries succeed reads
                                the same bytes as a clean run
    SEIST_FAULT_IO_FLAKY_FAILS  consecutive failing attempts of a flaky read
                                (default 1)
    SEIST_FAULT_IO_CORRUPT      comma list of raw indices whose waveform is
                                treated as corrupt (-> quarantine)
    SEIST_FAULT_IO_STALL_BATCH  the Loader sleeps before producing this batch
    SEIST_FAULT_IO_STALL_SEC    stall duration in seconds (default 3600)

Serving-plane knobs (``serve/server.py``; request numbers are 1-based
per-process ``/predict`` ordinals)::

    SEIST_FAULT_SERVE_KILL_REQ        SIGKILL the replica when its k-th
                                      /predict arrives
    SEIST_FAULT_SERVE_SLOW_MS         sleep this long inside every flush's
                                      forward (the 504 deadline path)
    SEIST_FAULT_SERVE_BLACKHOLE_AFTER accept the requests after the k-th but
                                      never answer them (hold the socket)
    SEIST_FAULT_SERVE_BLACKHOLE_COUNT ...for this many requests (default:
                                      forever)
    SEIST_FAULT_SERVE_BLACKHOLE_HOLD_S how long a black-holed request is
                                      held (default 3600)
    SEIST_FAULT_SERVE_BAD_CANDIDATE   the model VERSION that is bad: a
                                      reload to it fails its gate, and a
                                      replica serving it answers every
                                      /predict with a 500
    SEIST_FAULT_SERVE_REPLICA         fire only in the replica whose
                                      SEIST_SERVE_REPLICA matches (-1 or
                                      absent: any)

Streaming-plane knobs (``/stream`` and ``stream/journal.py``; a packet's
fate is a pure function of (station, seq), the JAX package's, so a
schedule replays identically)::

    SEIST_FAULT_STREAM_DROP_P       probability a packet is swallowed
                                    server-side (the client sees success)
    SEIST_FAULT_STREAM_DUP_P        probability a packet is fed twice
    SEIST_FAULT_STREAM_REORDER_P    probability a packet is held and fed
                                    after the station's next one (it then
                                    arrives stale and is dropped)
    SEIST_FAULT_STREAM_KILL_PACKET  SIGKILL the replica when its k-th
                                    /stream packet arrives
    SEIST_FAULT_STREAM_JOURNAL_CORRUPT_P
                                    probability, one verdict per station,
                                    that every journal write of that
                                    station is truncated (torn journal ->
                                    fresh session)

The serving kill and the stream kill share ``SEIST_FAULT_STAMP`` with the
train plane, so each fires at most once across relaunches.
"""

from __future__ import annotations

import hashlib
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Set

import numpy as np
import torch

from seist_tpu_torch.utils.logger import logger


def _env_int(env: Mapping[str, str], key: str, default: int) -> int:
    raw = env.get(key, "")
    try:
        return int(raw) if raw else default
    except ValueError as e:
        raise ValueError(f"{key} must be an integer, got {raw!r}") from e


def _env_float(env: Mapping[str, str], key: str, default: float) -> float:
    raw = env.get(key, "")
    try:
        return float(raw) if raw else default
    except ValueError as e:
        raise ValueError(f"{key} must be a number, got {raw!r}") from e


@dataclass(frozen=True)
class FaultPlan:
    """Parsed fault schedule. ``-1`` step values mean "never"."""

    nan_step: int = -1
    nan_count: int = 1
    kill_step: int = -1
    sigterm_step: int = -1
    slow_ms: float = 0.0
    slow_step: int = -1
    stamp_path: str = ""

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "FaultPlan":
        env = os.environ if env is None else env
        return cls(
            nan_step=_env_int(env, "SEIST_FAULT_NAN_STEP", -1),
            nan_count=max(1, _env_int(env, "SEIST_FAULT_NAN_COUNT", 1)),
            kill_step=_env_int(env, "SEIST_FAULT_KILL_STEP", -1),
            sigterm_step=_env_int(env, "SEIST_FAULT_SIGTERM_STEP", -1),
            slow_ms=_env_float(env, "SEIST_FAULT_SLOW_MS", 0.0),
            slow_step=_env_int(env, "SEIST_FAULT_SLOW_STEP", -1),
            stamp_path=env.get("SEIST_FAULT_STAMP", ""),
        )

    @property
    def enabled(self) -> bool:
        return (
            self.nan_step >= 0
            or self.kill_step >= 0
            or self.sigterm_step >= 0
            or self.slow_ms > 0
        )


@dataclass(frozen=True)
class IoFaultPlan:
    """Parsed data-plane fault schedule (all inert by default)."""

    flaky_p: float = 0.0
    flaky_fails: int = 1
    corrupt: frozenset = frozenset()
    stall_batch: int = -1
    stall_sec: float = 3600.0

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "IoFaultPlan":
        env = os.environ if env is None else env
        raw_corrupt = env.get("SEIST_FAULT_IO_CORRUPT", "")
        try:
            corrupt = frozenset(int(tok) for tok in raw_corrupt.split(",") if tok.strip())
        except ValueError as e:
            raise ValueError(
                f"SEIST_FAULT_IO_CORRUPT must be a comma list of ints, got {raw_corrupt!r}"
            ) from e
        return cls(
            flaky_p=_env_float(env, "SEIST_FAULT_IO_FLAKY_P", 0.0),
            flaky_fails=max(1, _env_int(env, "SEIST_FAULT_IO_FLAKY_FAILS", 1)),
            corrupt=corrupt,
            stall_batch=_env_int(env, "SEIST_FAULT_IO_STALL_BATCH", -1),
            stall_sec=_env_float(env, "SEIST_FAULT_IO_STALL_SEC", 3600.0),
        )

    @property
    def enabled(self) -> bool:
        return self.flaky_p > 0 or bool(self.corrupt) or self.stall_batch >= 0


class IoFaultInjector:
    """Data-plane fault driver, consulted by the guarded read path
    (``io_guard.read_with_retry``) and the Loader.

    Flakiness is a pure function of the sample index, never of the clock
    or of call order, so a run with injected transient faults consumes the
    same bytes as a clean one once the retries succeed, whatever the
    worker scheduling."""

    def __init__(self, plan: Optional[IoFaultPlan] = None):
        self.plan = plan or IoFaultPlan()
        self._stalled = False

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "IoFaultInjector":
        return cls(IoFaultPlan.from_env(env))

    @property
    def enabled(self) -> bool:
        return self.plan.enabled

    def _is_flaky(self, key: int) -> bool:
        p = self.plan.flaky_p
        if p <= 0:
            return False
        u = np.random.default_rng(np.random.SeedSequence([0x10FA_17, int(key)])).random()
        return bool(u < p)

    def maybe_flaky_read(self, key: int, attempt: int) -> None:
        """Raise a transient OSError when sample ``key`` is flaky-selected
        and ``attempt`` (0-based) is still within the injected failure run.
        The retry loop calls this before every real read attempt."""
        if attempt < self.plan.flaky_fails and self._is_flaky(key):
            raise OSError(f"[faults] injected flaky read (sample {key}, attempt {attempt})")

    def is_corrupt(self, key: int) -> bool:
        return int(key) in self.plan.corrupt

    def maybe_stall(self, batch_index: int) -> None:
        """Sleep (once) before producing batch ``stall_batch``: a wedged
        loader, for the pipeline stall watchdog."""
        if self.plan.stall_batch < 0 or self._stalled:
            return
        if batch_index >= self.plan.stall_batch:
            self._stalled = True
            logger.warning(
                f"[faults] loader stall injected at batch {batch_index} ({self.plan.stall_sec}s)"
            )
            time.sleep(self.plan.stall_sec)


class _Stamps:
    """Fired-fault bookkeeping, optionally persisted to a stamp file so a
    fault fires at most once across relaunches. The stamp is read at
    construction and appended to, fsynced, just before the fault fires:
    even a SIGKILL cannot outrun it."""

    def __init__(self, path: str = ""):
        self.path = path
        self._fired: Set[str] = set()
        if path and os.path.exists(path):
            with open(path) as f:
                self._fired = {line.strip() for line in f if line.strip()}

    def armed(self, name: str) -> bool:
        return name not in self._fired

    def mark(self, name: str) -> None:
        self._fired.add(name)
        if self.path:
            with open(self.path, "a") as f:
                f.write(name + "\n")
                f.flush()
                os.fsync(f.fileno())


class FaultInjector:
    """Step-boundary fault driver. ``on_step`` fires the process-level
    faults (kill / sigterm / slow); ``corrupt_inputs`` the numeric one.

    Each named fault fires once per process; with a stamp file, once per
    run (surviving relaunches, see :class:`_Stamps`)."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self._stamps = _Stamps(self.plan.stamp_path)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "FaultInjector":
        return cls(FaultPlan.from_env(env))

    @property
    def enabled(self) -> bool:
        return self.plan.enabled

    def _armed(self, name: str) -> bool:
        return self._stamps.armed(name)

    def _mark(self, name: str) -> None:
        """Record a firing BEFORE acting on it: SIGKILL never returns, so
        the stamp must precede the kill or relaunches loop forever."""
        self._stamps.mark(name)

    def on_step(self, step: int, n_steps: int = 1) -> None:
        """Fire any process-level fault scheduled inside the global-step
        window ``[step, step + n_steps)``. Call at the START of the step,
        before dispatching compute."""
        p = self.plan

        def hit(target: int) -> bool:
            return step <= target < step + n_steps

        if p.slow_ms > 0 and (p.slow_step < 0 or hit(p.slow_step)):
            time.sleep(p.slow_ms / 1000.0)
        if p.sigterm_step >= 0 and hit(p.sigterm_step) and self._armed("sigterm"):
            self._mark("sigterm")
            logger.warning(f"[faults] SIGTERM self at step {p.sigterm_step}")
            os.kill(os.getpid(), signal.SIGTERM)
        if p.kill_step >= 0 and hit(p.kill_step) and self._armed("kill"):
            self._mark("kill")
            logger.warning(f"[faults] SIGKILL self at step {p.kill_step}")
            os.kill(os.getpid(), signal.SIGKILL)

    def nan_active(self, step: int) -> bool:
        p = self.plan
        return (
            p.nan_step >= 0
            and p.nan_step <= step < p.nan_step + p.nan_count
            and self._armed(f"nan@{step}")
        )

    def corrupt_inputs(self, step: int, inputs: Any, n_steps: int = 1) -> Any:
        """``inputs`` (a tensor, or a tuple or list of them) turned to NaN
        when any of the global steps ``[step, step + n_steps)`` falls in the
        NaN window. The NaN flows through forward and backward, so the
        bad-update guard meets it the way it meets a real blow-up."""
        hits = [s for s in range(step, step + n_steps) if self.nan_active(s)]
        if not hits:
            return inputs
        for s in hits:
            self._mark(f"nan@{s}")
        logger.warning(f"[faults] NaN batch injected at step(s) {hits}")
        if torch.is_tensor(inputs):
            return inputs * float("nan")
        return type(inputs)(x * float("nan") for x in inputs)


# --------------------------------------------------------------- serve plane
@dataclass(frozen=True)
class ServeFaultPlan:
    """Parsed serving-plane fault schedule (inert by default). Request
    numbers are 1-based per-process ``/predict`` ordinals."""

    kill_req: int = -1
    slow_ms: float = 0.0
    blackhole_after: int = -1
    blackhole_count: int = 1 << 30  # default: never recovers
    blackhole_hold_s: float = 3600.0
    bad_candidate_version: int = -1
    replica: int = -1  # only fire in this SEIST_SERVE_REPLICA; -1 = any
    stamp_path: str = ""

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "ServeFaultPlan":
        env = os.environ if env is None else env
        return cls(
            kill_req=_env_int(env, "SEIST_FAULT_SERVE_KILL_REQ", -1),
            slow_ms=_env_float(env, "SEIST_FAULT_SERVE_SLOW_MS", 0.0),
            blackhole_after=_env_int(env, "SEIST_FAULT_SERVE_BLACKHOLE_AFTER", -1),
            blackhole_count=max(1, _env_int(env, "SEIST_FAULT_SERVE_BLACKHOLE_COUNT", 1 << 30)),
            blackhole_hold_s=_env_float(env, "SEIST_FAULT_SERVE_BLACKHOLE_HOLD_S", 3600.0),
            bad_candidate_version=_env_int(env, "SEIST_FAULT_SERVE_BAD_CANDIDATE", -1),
            replica=_env_int(env, "SEIST_FAULT_SERVE_REPLICA", -1),
            stamp_path=env.get("SEIST_FAULT_STAMP", ""),
        )

    @property
    def enabled(self) -> bool:
        return (self.kill_req >= 0 or self.slow_ms > 0 or self.blackhole_after >= 0
                or self.bad_candidate_version >= 0)


class ServeFaultInjector:
    """Serving-plane fault driver of ``ServeService``: :meth:`on_request`
    at a request's arrival (kill, black hole), :meth:`forward_delay` inside
    the batcher's forward (the flush thread sleeps, so queued requests age
    as behind a slow card), :meth:`is_bad_candidate` at reloads and
    requests. A plan with ``replica >= 0`` fires only in the replica whose
    ``SEIST_SERVE_REPLICA`` matches."""

    def __init__(self, plan: Optional[ServeFaultPlan] = None,
                 replica_index: Optional[int] = None):
        self.plan = plan or ServeFaultPlan()
        if replica_index is None:
            replica_index = _env_int(os.environ, "SEIST_SERVE_REPLICA", -1)
        self.replica_index = replica_index
        self._stamps = _Stamps(self.plan.stamp_path)
        self._lock = threading.Lock()
        self._blackholed = 0

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "ServeFaultInjector":
        return cls(ServeFaultPlan.from_env(env))

    @property
    def enabled(self) -> bool:
        """True when a fault is scheduled AND targets this replica."""
        if not self.plan.enabled:
            return False
        return self.plan.replica < 0 or self.plan.replica == self.replica_index

    def on_request(self, n: int) -> None:
        """Fire the arrival faults of the ``n``-th (1-based) request. The
        kill fires at ``n >= k`` (concurrent arrivals cannot skip it), once
        across relaunches with a stamp file."""
        if not self.enabled:
            return
        p = self.plan
        if p.kill_req >= 0 and n >= p.kill_req and self._stamps.armed("serve_kill"):
            self._stamps.mark("serve_kill")
            logger.warning(f"[faults] serve SIGKILL at request {n}")
            os.kill(os.getpid(), signal.SIGKILL)
        if p.blackhole_after >= 0 and n > p.blackhole_after:
            with self._lock:
                fire = self._blackholed < p.blackhole_count
                if fire:
                    self._blackholed += 1
                    n_holed = self._blackholed
            if fire:
                logger.warning(f"[faults] serve black-hole: request {n} accepted, never "
                               f"answered ({n_holed}/{p.blackhole_count})")
                # The handler thread (and the client's socket) stays open and
                # silent: a wedged replica, as a health probe cannot see it.
                time.sleep(p.blackhole_hold_s)

    def forward_delay(self) -> None:
        """Sleep inside the model forward (the batcher's flush thread)."""
        if self.enabled and self.plan.slow_ms > 0:
            time.sleep(self.plan.slow_ms / 1000.0)

    def is_bad_candidate(self, version: int) -> bool:
        """``SEIST_FAULT_SERVE_BAD_CANDIDATE=<version>``: a reload to that
        version fails its gate, and an entry serving it answers every
        ``/predict`` with a 500."""
        return (self.enabled and self.plan.bad_candidate_version >= 0
                and int(version) == self.plan.bad_candidate_version)


# -------------------------------------------------------------- stream plane
@dataclass(frozen=True)
class StreamFaultPlan:
    """Parsed streaming-plane fault schedule (inert by default). Packet
    ordinals are 1-based per-process ``/stream`` counts."""

    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    kill_packet: int = -1
    journal_corrupt_p: float = 0.0
    replica: int = -1  # only fire in this SEIST_SERVE_REPLICA; -1 = any
    stamp_path: str = ""

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "StreamFaultPlan":
        env = os.environ if env is None else env
        return cls(
            drop_p=_env_float(env, "SEIST_FAULT_STREAM_DROP_P", 0.0),
            dup_p=_env_float(env, "SEIST_FAULT_STREAM_DUP_P", 0.0),
            reorder_p=_env_float(env, "SEIST_FAULT_STREAM_REORDER_P", 0.0),
            kill_packet=_env_int(env, "SEIST_FAULT_STREAM_KILL_PACKET", -1),
            journal_corrupt_p=_env_float(env, "SEIST_FAULT_STREAM_JOURNAL_CORRUPT_P", 0.0),
            replica=_env_int(env, "SEIST_FAULT_SERVE_REPLICA", -1),
            stamp_path=env.get("SEIST_FAULT_STAMP", ""),
        )

    @property
    def enabled(self) -> bool:
        return (self.drop_p > 0 or self.dup_p > 0 or self.reorder_p > 0
                or self.kill_packet >= 0 or self.journal_corrupt_p > 0)


class StreamFaultInjector:
    """Streaming-plane fault driver: ``ServeService.stream`` consults
    :meth:`on_packet` (kill) and :meth:`packet_fate` (drop, dup, reorder)
    per packet, ``stream/journal.py`` :meth:`corrupt_journal` per write.
    A fate is a pure function of (station id, seq), the same as the JAX
    package's: the station's SHA-1 key and a ``SeedSequence`` uniform."""

    def __init__(self, plan: Optional[StreamFaultPlan] = None,
                 replica_index: Optional[int] = None):
        self.plan = plan or StreamFaultPlan()
        if replica_index is None:
            replica_index = _env_int(os.environ, "SEIST_SERVE_REPLICA", -1)
        self.replica_index = replica_index
        self._stamps = _Stamps(self.plan.stamp_path)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "StreamFaultInjector":
        return cls(StreamFaultPlan.from_env(env))

    @property
    def enabled(self) -> bool:
        """True when a fault is scheduled AND targets this replica."""
        if not self.plan.enabled:
            return False
        return self.plan.replica < 0 or self.plan.replica == self.replica_index

    @staticmethod
    def _uniform(*key: int) -> float:
        return float(np.random.default_rng(
            np.random.SeedSequence([0x57F4_17, *[int(k) for k in key]])).random())

    @staticmethod
    def _station_key(station_id: str) -> int:
        digest = hashlib.sha1(str(station_id).encode()).digest()
        return int.from_bytes(digest[:8], "big")

    def on_packet(self, n: int) -> None:
        """Fire the arrival faults of the ``n``-th (1-based) packet (the
        kill at ``n >= k``, once across relaunches with a stamp file)."""
        if not self.enabled:
            return
        p = self.plan
        if p.kill_packet >= 0 and n >= p.kill_packet and self._stamps.armed("stream_kill"):
            self._stamps.mark("stream_kill")
            logger.warning(f"[faults] stream SIGKILL at packet {n}")
            os.kill(os.getpid(), signal.SIGKILL)

    def packet_fate(self, station_id: str, seq: Optional[int]) -> str:
        """'ok' | 'drop' | 'dup' | 'reorder': one uniform per (station,
        seq) against the three rates in that order, so the fates exclude
        each other. A packet without a seq is never faulted."""
        if not self.enabled or seq is None:
            return "ok"
        p = self.plan
        if p.drop_p <= 0 and p.dup_p <= 0 and p.reorder_p <= 0:
            return "ok"
        u = self._uniform(self._station_key(station_id), int(seq))
        if u < p.drop_p:
            return "drop"
        if u < p.drop_p + p.dup_p:
            return "dup"
        if u < p.drop_p + p.dup_p + p.reorder_p:
            return "reorder"
        return "ok"

    def corrupt_journal(self, station_id: str) -> bool:
        """One verdict per station id: every journal write of a selected
        station is truncated, so its restore takes the torn-file path."""
        if not self.enabled or self.plan.journal_corrupt_p <= 0:
            return False
        return self._uniform(self._station_key(station_id), 0x0C0_44) < self.plan.journal_corrupt_p


_STREAM_FAULTS: Optional[StreamFaultInjector] = None


def stream_faults() -> StreamFaultInjector:
    """The process's stream injector, read from the environment once:
    ``stream/journal.py`` and the server share it, and so its kill stamp."""
    global _STREAM_FAULTS
    if _STREAM_FAULTS is None:
        _STREAM_FAULTS = StreamFaultInjector.from_env()
    return _STREAM_FAULTS
