"""Micro-batcher: coalesce concurrent single-trace requests into bucketed
fixed-shape forwards (the port's copy of ``seist_tpu/serve/batcher.py``).

Requests queue, and one worker thread flushes when ``max_batch`` requests
wait, when the oldest has waited ``max_delay_ms``, or when draining. A
flush pads the n collected traces up to the smallest bucket ``>= n``
(powers of two up to ``max_batch``) by repeating the last trace, so the
device sees a handful of shapes, each run once at warm-up. The queue is
bounded (``QueueFull``); requests that expire while queued are dropped
before the forward (``DeadlineExceeded``).

The queue is rank-ordered: each request carries a rank (the server maps
its tier, ``alert`` < ``interactive`` < ``batch``, through
``protocol.PRIORITIES``), and a flush takes the lowest ranks first, FIFO
within a rank, so low-tier work admitted before the shedder tripped never
stands ahead of an alert. :meth:`MicroBatcher.queue_delay_ms` is the
overload signal ``serve/shed.py`` sheds on: the head of the queue's age
plus the flush waves queued behind it at the EWMA of a flush's time.

The forward runs on the worker thread under ``torch.inference_mode()``;
its output is copied to the host once per flush, and each caller gets its
own row (a view with a leading dimension of 1) of a tensor, of each tensor
of a tuple, or of each task's outputs of a task group's ``{task:
outputs}``.

Tracing: a request submitted with a ``trace`` (``obs/trace.py``) gets a
``queue_wait`` span (enqueue to flush start, with the flush's number,
bucket and fill; ``expired`` when it expired queued) and a ``forward``
span (flush start until the outputs are on the host, with what the pool
annotated on the flush's scope: program, replayed graph or not, variant).
The batcher's stats are a collector on the metrics bus
(``seist_serve_batcher_*{model=...}``), and a death of its worker thread
dumps the flight recorder (``batcher_flush_death``).

Task groups batch by input shape, not by task: a flush runs the union of
its items' ``tasks`` (the shared trunk once, then each head in the union),
calling ``forward(batch, tasks)``; each caller decodes the tasks it asked
for.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seist_tpu_torch.obs import trace as obs_trace
from seist_tpu_torch.obs.bus import BUS
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
    buckets: Optional[Sequence[int]] = None  # None = default_buckets

    def resolved_buckets(self) -> Tuple[int, ...]:
        if self.buckets is None:
            return default_buckets(self.max_batch)
        buckets = tuple(sorted(set(int(b) for b in self.buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bad buckets {self.buckets}")
        if buckets[-1] != self.max_batch:
            raise ValueError(f"largest bucket {buckets[-1]} != max_batch {self.max_batch}")
        return buckets


class _Pending:
    __slots__ = ("x", "rank", "tasks", "trace", "enqueued_at", "deadline", "event", "result",
                 "error", "abandoned")

    def __init__(self, x: np.ndarray, deadline: float, rank: int = 1,
                 tasks: Optional[frozenset] = None, trace: Optional[Any] = None):
        self.x = x
        self.rank = rank  # flush order: lower rank first, FIFO within
        self.tasks = tasks  # a task group's heads this caller wants
        self.trace = trace  # obs.trace.RequestTrace (None: untraced)
        self.enqueued_at = time.monotonic()
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.abandoned = False  # caller gave up; skip at flush time


class MicroBatcher:
    """See module docstring. ``forward`` maps a ``(B, ...)`` stacked numpy
    batch (B always one of the buckets) to a tensor with leading dimension
    B, a tuple of them, or (``forward(batch, tasks)`` when the items name
    tasks) a ``{task: outputs}`` dict; :meth:`submit` returns the caller's
    row of it."""

    def __init__(
        self,
        forward: Callable[[np.ndarray], Any],
        config: Optional[BatcherConfig] = None,
        name: str = "default",
    ):
        self._forward = forward
        self.config = config or BatcherConfig()
        self.buckets = self.config.resolved_buckets()
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
        self._flush_ewma_ms = 0.0  # EWMA of a flush's wall time
        self.latency_ms = LatencyHistogram()
        # Keyed by the batcher's name only: a fresh batcher replaces the
        # registration of the one it succeeds (two with identical labels
        # would render duplicate series, which Prometheus refuses).
        self._collector_key = f"serve_batcher:{name}"
        BUS.register_collector(self._collector_key, self.stats, name="serve_batcher", model=name)
        self._thread = threading.Thread(
            target=self._loop, name=f"batcher-{name}", daemon=True
        )
        self._thread.start()

    def submit(self, x: np.ndarray, timeout_ms: float = 5000.0,
               tasks: Optional[frozenset] = None, trace: Optional[Any] = None,
               rank: int = 1) -> Any:
        """Block until the trace's batch is served; returns the caller's
        output row. ``rank`` orders the queue (lower first, FIFO within a
        rank); ``tasks`` (task groups only) names the heads this caller
        wants; ``trace`` records the request's ``queue_wait`` and
        ``forward`` spans (module docstring). Raises QueueFull /
        DeadlineExceeded / ShuttingDown."""
        t0 = time.monotonic()
        item = _Pending(np.asarray(x), deadline=t0 + timeout_ms / 1000.0, rank=rank,
                        tasks=tasks, trace=trace)
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
            # Stable rank-ordered insert, scanning from the tail: a burst is
            # mostly of the same or a lower rank, so this is short.
            pos = len(self._queue)
            while pos > 0 and self._queue[pos - 1].rank > item.rank:
                pos -= 1
            self._queue.insert(pos, item)
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
            # A dead worker ends the replica (the server exits 1): leave the
            # record the train plane's deaths leave (a no-op with no recorder).
            from seist_tpu_torch.obs import flight

            flight.dump_on_death("batcher_flush_death", batcher=self.name, error=repr(e))
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
            flush_id = self._forwards + 1
            for item in pending:
                if item.abandoned:
                    continue  # caller already raised DeadlineExceeded
                if item.deadline < now:
                    self._expired += 1
                    if item.trace is not None:
                        item.trace.add_child("queue_wait", (now - item.enqueued_at) * 1e3,
                                             expired=True)
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
        # A group's flush runs the union of its items' heads: the trunk once.
        task_sets = [item.tasks for item in live if item.tasks is not None]
        union = frozenset().union(*task_sets) if task_sets else None
        t_fwd0 = time.monotonic()
        for item in live:
            if item.trace is not None:
                item.trace.add_child("queue_wait", (t_fwd0 - item.enqueued_at) * 1e3,
                                     flush=flush_id, bucket=bucket, batch_n=n)
        try:
            # The scope carries the members' traces through the forward, so
            # the pool annotates their shared span.
            with obs_trace.flush_scope([item.trace for item in live]) as scope:
                out = self._forward(batch) if union is None else self._forward(batch, union)
                out = to_host(out)
        except Exception as e:  # noqa: BLE001 — a failed forward fails its batch only
            err = e if isinstance(e, ServeError) else ServeError(f"forward failed: {e!r}")
            for item in live:
                if item.trace is not None:
                    item.trace.add_child("forward", (time.monotonic() - t_fwd0) * 1e3,
                                         flush=flush_id, error=type(e).__name__)
            with self._cond:
                for item in live:
                    item.error = err
                    if not item.abandoned:
                        self._failed += 1
                    item.event.set()
            return
        flush_ms = (time.monotonic() - t_fwd0) * 1e3
        for item in live:
            if item.trace is not None:
                item.trace.add_child("forward", flush_ms, flush=flush_id, bucket=bucket,
                                     occupancy=round(n / bucket, 3), **scope.annotations)
        with self._cond:
            self._forwards += 1
            self._batch_items += n
            self._batch_slots += bucket
            # The service time behind queue_delay_ms; the first flush seeds it.
            self._flush_ewma_ms = (flush_ms if self._flush_ewma_ms == 0.0
                                   else 0.8 * self._flush_ewma_ms + 0.2 * flush_ms)
            for i, item in enumerate(live):
                item.result = slice_outputs(out, i)
                if not item.abandoned:
                    self._completed += 1
                item.event.set()

    def queue_delay_ms(self) -> float:
        """The queueing delay a request admitted now would see: the head of
        the queue's age (grows without bound under sustained overload,
        clears after a burst) plus the flush waves queued ahead at the
        EWMA flush time. An empty queue reads 0."""
        with self._cond:
            if not self._queue:
                return 0.0
            head_age_ms = (time.monotonic() - self._queue[0].enqueued_at) * 1e3
            waves = -(-len(self._queue) // self.config.max_batch)
            return head_age_ms + waves * self._flush_ewma_ms

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
        BUS.unregister_collector(self._collector_key, fn=self.stats)

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
                "queue_delay_ms": round(self.queue_delay_ms(), 3),
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


def to_host(out: Any) -> Any:
    """The flush's outputs on the host, structure kept (a tensor, a tuple
    or list of them, or a group's ``{task: outputs}``): one copy per
    tensor, so the callers' rows are host views."""
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(to_host(o) for o in out)
    return out.cpu() if torch.is_tensor(out) else out


def slice_outputs(out: Any, i: int) -> Any:
    """Row ``i`` (leading dimension 1) of a tensor, of each tensor of a
    tuple or list, or of each value of a task group's ``{task: outputs}``."""
    if isinstance(out, dict):
        return {k: slice_outputs(v, i) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(o[i : i + 1] for o in out)
    return out[i : i + 1]
