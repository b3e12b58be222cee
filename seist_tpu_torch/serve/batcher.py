"""Micro-batcher: coalesce concurrent single-trace requests into bucketed
fixed-shape forwards (the port's copy of ``seist_tpu/serve/batcher.py``,
without the tracing, shedding and multi-task hooks).

Requests queue, and one worker thread flushes when ``max_batch`` requests
wait, when the oldest has waited ``max_delay_ms``, or when draining. A
flush pads the n collected traces up to the smallest bucket ``>= n``
(powers of two up to ``max_batch``) by repeating the last trace, so the
device sees a handful of shapes, each run once at warm-up. The queue is
bounded (``QueueFull``); requests that expire while queued are dropped
before the forward (``DeadlineExceeded``).

The forward runs on the worker thread under ``torch.inference_mode()``;
its output stays where the model put it, and each caller gets its own
row (a view with a leading dimension of 1).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from seist_tpu_torch.serve.protocol import (
    DeadlineExceeded,
    QueueFull,
    ServeError,
    ShuttingDown,
)
from seist_tpu_torch.utils.meters import LatencyHistogram


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (always including it)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


@dataclass
class BatcherConfig:
    max_batch: int = 8
    max_delay_ms: float = 10.0
    max_queue: int = 64


class _Pending:
    __slots__ = ("x", "enqueued_at", "deadline", "event", "result", "error", "abandoned")

    def __init__(self, x: np.ndarray, deadline: float):
        self.x = x
        self.enqueued_at = time.monotonic()
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.abandoned = False  # caller gave up; skip at flush time


class MicroBatcher:
    """See module docstring. ``forward`` maps a ``(B, ...)`` stacked numpy
    batch (B always one of the buckets) to a tensor with leading dimension
    B; :meth:`submit` returns the caller's row."""

    def __init__(
        self,
        forward: Callable[[np.ndarray], Any],
        config: Optional[BatcherConfig] = None,
        name: str = "default",
    ):
        self._forward = forward
        self.config = config or BatcherConfig()
        self.buckets = default_buckets(self.config.max_batch)
        self.name = name
        self._queue: List[_Pending] = []
        self._cond = threading.Condition()
        self._stopping = False
        self._fatal: Optional[BaseException] = None
        # Counters (guarded by self._cond's lock):
        self._submitted = 0
        self._rejected = 0
        self._expired = 0
        self._completed = 0
        self._failed = 0
        self._forwards = 0
        self._batch_items = 0  # real traces forwarded
        self._batch_slots = 0  # bucket slots forwarded (incl. padding)
        self.latency_ms = LatencyHistogram()
        self._thread = threading.Thread(
            target=self._loop, name=f"batcher-{name}", daemon=True
        )
        self._thread.start()

    def submit(self, x: np.ndarray, timeout_ms: float = 5000.0) -> Any:
        """Block until the trace's batch is served; returns the caller's
        output row. Raises QueueFull / DeadlineExceeded / ShuttingDown."""
        t0 = time.monotonic()
        item = _Pending(np.asarray(x), deadline=t0 + timeout_ms / 1000.0)
        with self._cond:
            if self._fatal is not None:
                raise ServeError(f"batcher {self.name} worker died: {self._fatal!r}")
            if self._stopping:
                raise ShuttingDown(f"batcher {self.name} is draining")
            if len(self._queue) >= self.config.max_queue:
                self._rejected += 1
                raise QueueFull(
                    f"batcher {self.name} queue full ({self.config.max_queue} waiting)"
                )
            self._submitted += 1
            self._queue.append(item)
            self._cond.notify_all()
        if not item.event.wait(timeout=timeout_ms / 1000.0 + 0.05):
            # Decide success-vs-expired once, under the lock the worker
            # counts under, so every request lands in exactly one bucket.
            with self._cond:
                expired = not item.event.is_set()
                if expired:
                    item.abandoned = True
                    self._expired += 1
            if expired:
                raise DeadlineExceeded(f"request not served within {timeout_ms:.0f} ms")
        if item.error is not None:
            raise item.error
        self.latency_ms.observe((time.monotonic() - t0) * 1000.0)
        return item.result

    def _loop(self) -> None:
        try:
            with torch.inference_mode():
                self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — record, fail everyone waiting
            with self._cond:
                self._fatal = e
                err = ServeError(f"batcher {self.name} worker died: {e!r}")
                for item in self._queue:
                    item.error = err
                    item.event.set()
                self._queue.clear()
            raise

    def _loop_inner(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._queue:
                        age = time.monotonic() - self._queue[0].enqueued_at
                        budget = self.config.max_delay_ms / 1000.0
                        if (
                            len(self._queue) >= self.config.max_batch
                            or age >= budget
                            or self._stopping
                        ):
                            break
                        self._cond.wait(budget - age)
                    elif self._stopping:
                        return
                    else:
                        self._cond.wait()
                take = min(len(self._queue), self.config.max_batch)
                pending = self._queue[:take]
                del self._queue[:take]
            self._run_batch(pending)

    def _run_batch(self, pending: List[_Pending]) -> None:
        now = time.monotonic()
        live: List[_Pending] = []
        with self._cond:
            for item in pending:
                if item.abandoned:
                    continue  # caller already raised DeadlineExceeded
                if item.deadline < now:
                    self._expired += 1
                    item.error = DeadlineExceeded("expired while queued (server overloaded?)")
                    item.event.set()
                    continue
                live.append(item)
        if not live:
            return
        n = len(live)
        bucket = next(b for b in self.buckets if b >= n)
        batch = np.stack([item.x for item in live], axis=0)
        if bucket > n:  # pad by repeating the last trace: same warm shape
            batch = np.concatenate([batch, np.repeat(batch[-1:], bucket - n, axis=0)])
        try:
            out = self._forward(batch)
        except Exception as e:  # noqa: BLE001 — a failed forward fails its batch only
            err = e if isinstance(e, ServeError) else ServeError(f"forward failed: {e!r}")
            with self._cond:
                for item in live:
                    item.error = err
                    if not item.abandoned:
                        self._failed += 1
                    item.event.set()
            return
        with self._cond:
            self._forwards += 1
            self._batch_items += n
            self._batch_slots += bucket
            for i, item in enumerate(live):
                item.result = out[i : i + 1]
                if not item.abandoned:
                    self._completed += 1
                item.event.set()

    def shutdown(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop accepting work; with ``drain`` the queued requests are
        still served, otherwise they fail ShuttingDown."""
        with self._cond:
            self._stopping = True
            if not drain:
                for item in self._queue:
                    item.error = ShuttingDown("batcher shut down")
                    item.event.set()
                self._queue.clear()
            self._cond.notify_all()
        self._thread.join(timeout=timeout_s)

    @property
    def healthy(self) -> bool:
        """False once the worker thread has died."""
        with self._cond:
            return self._fatal is None and (self._stopping or self._thread.is_alive())

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            slots = self._batch_slots
            return {
                "queue_depth": len(self._queue),
                "healthy": self.healthy,
                "submitted": self._submitted,
                "completed": self._completed,
                "rejected": self._rejected,
                "expired": self._expired,
                "failed": self._failed,
                "forwards": self._forwards,
                "batch_fill_ratio": self._batch_items / slots if slots else 0.0,
                "buckets": list(self.buckets),
                "latency_ms": self.latency_ms.summary(),
            }
