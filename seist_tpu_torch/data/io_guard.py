"""The data-plane guard: retries, corrupt-sample quarantine, stall watchdog
(the port's copy of ``seist_tpu/data/io_guard.py``).

Three mechanisms keep a days-long run alive on data read from a network
filesystem:

* **Retry with exponential backoff and jitter** (:func:`read_with_retry`)
  around every sample read. *Transient* faults (``OSError``: a flaky
  mount; the packed reader drops its memmap so the retry reopens) are
  retried; *permanent* ones (:class:`CorruptSampleError`: a short read, a
  bad shape, non-finite data) are not. A transient fault that outlives
  the budget becomes permanent (:class:`RetriesExhaustedError`).
* **Corrupt-sample quarantine** (:class:`Quarantine`): a permanently bad
  sample is benched and replaced by the first clean candidate of a
  sequence drawn from ``default_rng(SeedSequence([seed, epoch, idx,
  salt]))``, so batch shapes and the sample order stay fixed and the
  replacement does not depend on worker scheduling or resume point. Past
  ``--max-quarantine-frac`` the run aborts (:class:`QuarantineOverflowError`).
* **Pipeline stall watchdog** (:class:`StallWatchdog` + :func:`watch`):
  armed only while the train loop waits for the next host batch, so a
  step, a kernel build or a validation never counts; when no batch comes
  for ``timeout_s`` it dumps every thread's stack and exits with the
  preempt code 75, for a supervisor to relaunch from the newest
  checkpoint. A loader worker that raises something else surfaces as
  :class:`LoaderDeathError`, which the train worker turns into a
  checkpoint and the same exit.

Counters (reads, retries, reopens, quarantined, fallback reads, stall
trips, loader deaths) accumulate in :data:`COUNTERS` and reach the epoch
logs and the ``data_plane`` field of the test metrics JSON. The guard is on
by default; ``SEIST_IO_GUARD=0`` (or :func:`disabled`) restores the raw
read path. Fault injection lives in ``seist_tpu_torch/utils/faults.py``
(``SEIST_FAULT_IO_*``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE  # the watchdog's exit code
from seist_tpu_torch.utils.logger import logger


class CorruptSampleError(Exception):
    """Permanent per-sample fault: the bytes came back but the sample is
    unusable (short read, wrong shape/dtype, non-finite values, missing
    trace key). Never retried: the sample gets quarantined."""


class RetriesExhaustedError(CorruptSampleError):
    """A transient fault outlived the retry budget; quarantined like
    corruption, so the run keeps its shapes."""


class QuarantineOverflowError(RuntimeError):
    """The quarantined fraction crossed ``max_frac``: the dataset is
    rotted and training on fallback samples would be worse than dying.
    Ends the run; it is NOT turned into a preempt and relaunch."""


class LoaderDeathError(RuntimeError):
    """A loader worker raised something that is neither transient nor
    per-sample corruption (a bug, or an environment failure the retry
    ladder cannot absorb). The train worker turns it into a checkpoint and
    a preempt exit."""


class Counters:
    """Thread-safe monotonic counters of the data-plane guard."""

    _FIELDS = (
        "reads",
        "retries",
        "reopens",
        "quarantined",
        "fallback_reads",
        "stall_trips",
        "loader_deaths",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v: Dict[str, int] = {k: 0 for k in self._FIELDS}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._v[name] = self._v.get(name, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._v)

    def any_faults(self) -> bool:
        s = self.snapshot()
        return any(v for k, v in s.items() if k != "reads")


COUNTERS = Counters()

_ENABLED = os.environ.get("SEIST_IO_GUARD", "1") != "0"


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def disabled():
    """Bypass the guard (raw reads, no validation): for pricing its
    clean-path cost, not for training."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = prev


class RetryPolicy:
    """Exponential backoff with jitter: attempt k sleeps ``min(base *
    2**k, cap) * uniform(0.5, 1.5)``. The jitter decorrelates the loader
    threads' retries after a shared-filesystem hiccup; it shapes sleep
    time only, never sample content."""

    def __init__(
        self,
        attempts: Optional[int] = None,
        backoff_base_s: Optional[float] = None,
        backoff_cap_s: Optional[float] = None,
    ) -> None:
        env = os.environ
        self.attempts = max(
            1, int(attempts if attempts is not None else env.get("SEIST_IO_RETRIES", 3))
        )
        self.backoff_base_s = float(
            backoff_base_s if backoff_base_s is not None else env.get("SEIST_IO_BACKOFF_MS", 50)
        ) / (1.0 if backoff_base_s is not None else 1000.0)
        self.backoff_cap_s = float(
            backoff_cap_s if backoff_cap_s is not None else env.get("SEIST_IO_BACKOFF_CAP_MS", 2000)
        ) / (1.0 if backoff_cap_s is not None else 1000.0)

    def sleep_s(self, attempt: int) -> float:
        base = min(self.backoff_base_s * (2.0 ** attempt), self.backoff_cap_s)
        return base * random.uniform(0.5, 1.5)  # sleep time only, never data


_DEFAULT_POLICY: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
    global _DEFAULT_POLICY
    if _DEFAULT_POLICY is None:
        _DEFAULT_POLICY = RetryPolicy()
    return _DEFAULT_POLICY


def read_with_retry(
    fn: Callable[[], Any],
    *,
    desc: str = "read",
    fault_key: int = -1,
    injector=None,
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Call ``fn`` with transient-fault retries: ``OSError`` is counted,
    backed off and retried, and raises :class:`RetriesExhaustedError` once
    the budget is spent; :class:`CorruptSampleError` and anything else
    propagate at once (a bug is not a fault to absorb). ``injector`` and
    ``fault_key`` put the injected flaky failure inside the loop, where a
    real flaky filesystem fails."""
    policy = policy or default_policy()
    COUNTERS.inc("reads")
    last: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        try:
            if injector is not None:
                injector.maybe_flaky_read(fault_key, attempt)
            return fn()
        except CorruptSampleError:
            raise
        except OSError as e:
            last = e
            COUNTERS.inc("retries")
            if attempt + 1 < policy.attempts:
                logger.warning(
                    f"[io-guard] transient fault on {desc} "
                    f"(attempt {attempt + 1}/{policy.attempts}): {e!r}; retrying"
                )
                sleep(policy.sleep_s(attempt))
    raise RetriesExhaustedError(
        f"{desc} still failing after {policy.attempts} attempts: {last!r}"
    ) from last


def guarded_event_read(fn: Callable[[], Any], *, key: int, desc: str, injector=None) -> Any:
    """The one classification ladder of a sample read: transient retries
    (:func:`read_with_retry`), the injected-corruption hook, then ingest
    validation. ``fn`` returns ``(event, meta)``; every permanent fault
    surfaces as :class:`CorruptSampleError`."""
    event, meta = read_with_retry(fn, desc=desc, fault_key=key, injector=injector)
    if injector is not None and injector.is_corrupt(key):
        raise CorruptSampleError(f"[faults] injected corrupt sample {key}")
    validate_event(event, desc=desc)
    return event, meta


def validate_event(event: Any, *, desc: str = "sample") -> None:
    """Ingest validation, the permanent-fault classifier of a decoded
    event: raises :class:`CorruptSampleError` on a missing, empty,
    non-numeric or non-finite waveform or a shape that is not (C, L)."""
    try:
        data = event["data"]
    except (TypeError, KeyError, IndexError):
        raise CorruptSampleError(f"{desc}: event has no 'data' field") from None
    if type(data) is not np.ndarray:
        data = np.asarray(data)
    kind = data.dtype.kind
    if kind not in "fiu":
        raise CorruptSampleError(f"{desc}: non-numeric waveform dtype {data.dtype}")
    if data.ndim != 2:
        raise CorruptSampleError(f"{desc}: waveform must be (C, L), got shape {data.shape}")
    if data.shape[-1] == 0 or data.shape[0] == 0:
        raise CorruptSampleError(f"{desc}: empty waveform {data.shape}")
    if kind == "f" and not np.isfinite(data).all():
        bad = int(data.size - np.isfinite(data).sum())
        raise CorruptSampleError(f"{desc}: waveform has {bad} non-finite value(s)")


_FALLBACK_SALT = 0x5E15_7  # keys the fallback PRNG stream apart from others


class Quarantine:
    """Registry of benched raw sample indices and the deterministic
    replacement rule.

    ``candidates(raw, seed=, epoch=, idx=)`` yields the read order of one
    logical sample: the sample itself first (unless benched), then draws
    from ``default_rng(SeedSequence([seed, epoch, idx, salt]))``. The
    caller accepts the first candidate that reads cleanly and quarantines
    the others, so the replacement is a pure function of (seed, epoch,
    idx) and of the set of corrupt samples. ``add`` raises
    :class:`QuarantineOverflowError` once more than ``max_frac`` of the
    dataset is benched."""

    MAX_DRAWS = 64  # fallback draws per logical sample before giving up

    def __init__(self, n_total: int, max_frac: float = 0.05) -> None:
        if n_total <= 0:
            raise ValueError(f"n_total must be positive, got {n_total}")
        self.n_total = int(n_total)
        self.max_frac = float(max_frac)
        self._lock = threading.Lock()
        self._bad: Dict[int, str] = {}
        # Lock-free hot-path hint: False until the first add().
        self.active = False

    def __contains__(self, raw_idx: int) -> bool:
        with self._lock:
            return int(raw_idx) in self._bad

    def __len__(self) -> int:
        with self._lock:
            return len(self._bad)

    def add(self, raw_idx: int, reason: str) -> None:
        with self._lock:
            if int(raw_idx) in self._bad:
                return
            self._bad[int(raw_idx)] = str(reason)
            n_bad = len(self._bad)
            self.active = True
        COUNTERS.inc("quarantined")
        logger.warning(
            f"[io-guard] quarantined sample {raw_idx} ({n_bad}/{self.n_total}): {reason}"
        )
        if n_bad > self.max_frac * self.n_total:
            _flight_dump("quarantine_overflow", quarantined=n_bad, n_total=self.n_total)
            raise QuarantineOverflowError(
                f"{n_bad}/{self.n_total} samples quarantined exceeds "
                f"--max-quarantine-frac {self.max_frac}: the dataset is "
                "rotted; refusing to keep training on fallback samples"
            )

    def candidates(self, raw_idx: int, *, seed: int, epoch: int, idx: int) -> Iterator[int]:
        if raw_idx not in self:
            yield int(raw_idx)
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), int(epoch), int(idx), _FALLBACK_SALT])
        )
        for _ in range(self.MAX_DRAWS):
            cand = int(rng.integers(self.n_total))
            if cand == raw_idx or cand in self:
                continue
            yield cand

    # The owning SeismicDataset is pickled into loader worker processes;
    # locks don't pickle, so the plain state travels. Each worker process
    # then quarantines on its own: the content stays identical (the
    # corrupt set is a property of the data), but the parent's epoch
    # report covers thread loaders only.
    def __getstate__(self) -> Dict[str, Any]:
        with self._lock:
            return {"n_total": self.n_total, "max_frac": self.max_frac, "bad": dict(self._bad)}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__init__(state["n_total"], state["max_frac"])
        self._bad.update(state["bad"])
        self.active = bool(self._bad)

    def report(self) -> Dict[str, Any]:
        """JSON-able epoch-end report (logged by the train worker)."""
        with self._lock:
            bad = dict(self._bad)
        return {
            "quarantined": sorted(bad),
            "reasons": {str(k): bad[k] for k in sorted(bad)},
            "n_total": self.n_total,
            "frac": round(len(bad) / self.n_total, 6),
            "max_frac": self.max_frac,
        }


def _flight_dump(reason: str, **fields) -> None:
    """The record of a death path: one log line, and the installed flight
    recorder's dump (``obs/flight.py``; a no-op without one, as in library
    use outside the train worker). Never raises: the exit matters more
    than the artifact."""
    shown = {k: v for k, v in fields.items() if k not in ("dedup_s", "thread_stacks")}
    logger.error(f"[io-guard] {reason}: {shown}")
    try:
        from seist_tpu_torch.obs import flight

        flight.dump_on_death(reason, **fields)
    except Exception:  # noqa: BLE001 - a death path: the exit must proceed
        pass


def hard_exit(code: int) -> None:
    """Flush the log handlers and ``os._exit``: the only safe exit when
    non-daemon loader threads may be wedged, where ``sys.exit`` would hang
    in ``threading._shutdown`` joining a thread stuck inside a dead read.
    A function of its own so in-process tests can replace it."""
    # The funnel every hard death drains through: deduplicated against a
    # richer dump seconds before (a stall trip with its thread stacks).
    _flight_dump("hard_exit", dedup_s=5.0, exit_code=code)
    logging.shutdown()
    os._exit(code)


def dump_thread_stacks(to=None) -> str:
    """Every live thread's stack (the post-mortem a hung loader never
    gives), logged and returned."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for ident, frame in frames.items():
        header = f"--- thread {names.get(ident, '?')} ({ident}) ---"
        chunks.append(header + "\n" + "".join(traceback.format_stack(frame)))
    text = "\n".join(chunks)
    stream = to if to is not None else sys.stderr
    try:
        print(text, file=stream, flush=True)
    except Exception:  # noqa: BLE001 - a broken stderr must not mask the exit
        pass
    try:
        logger.error(f"[io-guard] thread stacks at stall:\n{text}")
    except Exception:  # noqa: BLE001 - same best-effort contract as above
        pass
    return text


class StallWatchdog:
    """Background thread that trips when the consumer has been *armed*
    (blocked waiting for a batch) longer than ``timeout_s``.

    :func:`watch` arms it around each ``next()`` only, so steps, kernel
    builds, validation compute and checkpoint saves never count. On a trip
    it dumps every thread's stack and hard-exits with the preempt code
    (a wedged loader may hold any lock, so a cooperative exit could hang
    too). ``exit_fn`` is injectable for tests."""

    def __init__(
        self,
        timeout_s: float,
        *,
        exit_code: int = PREEMPT_EXIT_CODE,
        exit_fn: Optional[Callable[[int], None]] = None,
        poll_s: Optional[float] = None,
    ) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.exit_code = int(exit_code)
        self._exit_fn = exit_fn if exit_fn is not None else hard_exit
        self._poll_s = float(poll_s) if poll_s else max(min(self.timeout_s / 4, 5.0), 0.01)
        self._armed_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tripped = False

    def start(self) -> "StallWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="seist-data-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll_s)
            self._thread = None

    def arm(self) -> None:
        self._armed_since = time.monotonic()

    def disarm(self) -> None:
        self._armed_since = None

    def _run(self) -> None:
        # A watchdog that dies silently IS the failure it guards against.
        try:
            while not self._stop.wait(self._poll_s):
                armed = self._armed_since
                if armed is None:
                    continue
                waited = time.monotonic() - armed
                if waited > self.timeout_s:
                    self._trip(waited)
                    return
        except Exception:
            logger.exception("[io-guard] stall watchdog thread died: stall protection is GONE")
            raise

    def _trip(self, waited: float) -> None:
        self.tripped = True
        COUNTERS.inc("stall_trips")
        logger.error(
            f"[io-guard] pipeline stall: no batch for {waited:.1f}s "
            f"(timeout {self.timeout_s}s); dumping thread stacks and "
            f"exiting {self.exit_code} for supervised relaunch"
        )
        stacks = dump_thread_stacks()
        # Dumped here (hard_exit would dump too) so the record carries the
        # stacks and the wait even under a test's exit_fn.
        _flight_dump("stall_watchdog", waited_s=round(waited, 1), thread_stacks=stacks)
        self._exit_fn(self.exit_code)


def watch(
    iterator,
    watchdog: Optional[StallWatchdog],
    on_death: Optional[Callable[[LoaderDeathError], None]] = None,
):
    """Wrap a batch iterator so the watchdog is armed exactly while
    blocked in ``next()``; ``watchdog=None`` leaves the arming out.
    ``on_death`` fires when the data plane raises
    :class:`LoaderDeathError`: the train worker checkpoints and
    preempt-exits at the batch position reached."""
    if watchdog is None and on_death is None:
        yield from iterator
        return
    it = iter(iterator)
    while True:
        if watchdog is not None:
            watchdog.arm()
        try:
            item = next(it)
        except StopIteration:
            return
        except LoaderDeathError as e:
            if on_death is not None:
                on_death(e)
            raise
        finally:
            if watchdog is not None:
                watchdog.disarm()
        yield item
