"""Profiler captures, the interval stopwatch and the step-time meters
(counterpart of ``seist_tpu/utils/profiling.py``).

:func:`trace_start` / :func:`trace_stop` (and :func:`trace` around a
block) run ``torch.profiler`` over the CPU and, on a card, CUDA
activities, and write the capture as a Chrome trace (``trace.json``, read
by Perfetto or ``chrome://tracing``) into the directory given, as
``jax.profiler`` writes its trace there. :func:`trace_stop` synchronises
the card first, as the JAX package blocks on the last step before it
stops, so the capture holds the device work of every step it saw.

A capture must not start while a CUDA graph is being captured
(``torch.profiler`` would enqueue work into the capture): the train
worker opens its window two calls after the step's graph capture
(``--profile-steps``), and :func:`trace_start` refuses otherwise.

:func:`device_memory_stats` snapshots each card's allocator statistics;
:class:`StepTimeSplit` splits a step into its host wait and its device
time (which ends at ``torch.cuda.synchronize``); :class:`ThroughputMeter`
counts waveforms/s after the warm-up steps. What the kernels of a step
take is ``obs/attribution.py``'s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

_ACTIVE = None  # (profiler, directory) of the capture in progress
TRACE_FILE = "trace.json"


def trace_start(logdir: str) -> None:
    """Begin a ``torch.profiler`` capture that :func:`trace_stop` writes
    into ``logdir``: the form for windows that span loop iterations."""
    global _ACTIVE
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _ACTIVE is not None:
        raise RuntimeError(f"a profiler capture is already running ({_ACTIVE[1]})")
    cuda = torch.cuda.is_available()
    if cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("cannot start a profiler capture during a CUDA graph capture")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    _ACTIVE = (prof, logdir)


def active() -> bool:
    """Whether a capture is running."""
    return _ACTIVE is not None


def trace_stop() -> Optional[str]:
    """Synchronise the card, stop the capture and write it; returns the
    trace file's path (None when no capture runs)."""
    global _ACTIVE
    import torch

    if _ACTIVE is None:
        return None
    prof, logdir = _ACTIVE
    _ACTIVE = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """``with trace(dir):`` captures everything inside."""
    trace_start(logdir)
    try:
        yield
    finally:
        trace_stop()


@contextlib.contextmanager
def stopwatch() -> Iterator[Callable[[], float]]:
    """``with stopwatch() as elapsed:``: ``elapsed()`` returns the seconds
    since entry, inside the block and after it; the metrics bus's clock
    (``obs/bus.py::stopwatch``)."""
    from seist_tpu_torch.obs.bus import stopwatch as _stopwatch

    with _stopwatch() as elapsed:
        yield elapsed


def device_memory_stats() -> List[Dict[str, float]]:
    """Per-card ``torch.cuda.memory_stats`` (bytes and counts); an empty
    list without a card."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [{"device": str(torch.device("cuda", i)),
             **{k: float(v) for k, v in torch.cuda.memory_stats(i).items()}}
            for i in range(torch.cuda.device_count())]


def _synchronize() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimeSplit:
    """Per-step host wait against device time.

    ``host_wait`` is what the step loop spends before the card can start:
    fetching and stacking the batch and staging it on the device;
    ``device_time`` runs from the dispatch to ``torch.cuda.synchronize``.
    ``input_bound_fraction`` (host / (host + device)) says whether
    training waits on its input: ~0 when the card sets the pace, ~1 when it
    idles behind the loader. The first ``skip_first`` steps (the capture,
    the warm-up) are left out of the summary."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = int(skip_first)
        self.host_s: List[float] = []
        self.device_s: List[float] = []
        self._pending_host: Optional[float] = None

    def step(self, host_s: float, device_s: float) -> None:
        self.host_s.append(float(host_s))
        self.device_s.append(float(device_s))

    @contextlib.contextmanager
    def host(self) -> Iterator[None]:
        """Time the host half of one step on the bus's stopwatch; pair with
        :meth:`device`, which records the step."""
        with stopwatch() as elapsed:
            yield
        self._pending_host = elapsed()

    @contextlib.contextmanager
    def device(self) -> Iterator[None]:
        """Time the device half (dispatch to synchronize) and record the
        step with the host time of :meth:`host`."""
        with stopwatch() as elapsed:
            yield
            _synchronize()
        self.step(self._pending_host or 0.0, elapsed())
        self._pending_host = None

    def summary(self) -> Dict[str, object]:
        h = self.host_s[self.skip_first:]
        d = self.device_s[self.skip_first:]
        if not h:
            return {"steps": 0, "host_wait_ms_per_step": None, "device_time_ms_per_step": None,
                    "input_bound_fraction": None, "per_step_host_wait_ms": [],
                    "per_step_device_time_ms": []}
        hm = sum(h) / len(h)
        dm = sum(d) / len(d)
        return {
            "steps": len(h),
            "host_wait_ms_per_step": round(hm * 1e3, 3),
            "device_time_ms_per_step": round(dm * 1e3, 3),
            "input_bound_fraction": round(hm / max(hm + dm, 1e-12), 4),
            "per_step_host_wait_ms": [round(x * 1e3, 3) for x in h],
            "per_step_device_time_ms": [round(x * 1e3, 3) for x in d],
        }


class ThroughputMeter:
    """Waveforms/s over a run, the first ``warmup_steps`` left out."""

    def __init__(self, warmup_steps: int = 2):
        self._warmup = warmup_steps
        self._count = 0
        self._items = 0
        self._start: Optional[float] = None

    def step(self, n_items: int) -> None:
        self._count += 1
        if self._count == self._warmup + 1:
            self._start = time.perf_counter()
            self._items = 0
        if self._count > self._warmup:
            self._items += n_items

    @property
    def items_per_sec(self) -> float:
        if self._start is None or self._items == 0:
            return 0.0
        dt = time.perf_counter() - self._start
        return self._items / dt if dt > 0 else 0.0
