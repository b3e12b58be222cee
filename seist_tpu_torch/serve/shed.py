"""Tiered admission: priority tiers and queue-delay load shedding, per
replica (the port's copy of ``seist_tpu/serve/shed.py``).

* Requests carry a tier (``options.priority``): ``alert`` > ``interactive``
  (the default) > ``batch`` (``protocol.PRIORITIES``).
* The overload signal is the micro-batcher's estimated queue delay
  (``MicroBatcher.queue_delay_ms``: the head of the queue's age plus the
  queued flush waves at the EWMA flush time).
* Each tier has a delay threshold. Above it the tier is shed with a 503
  and ``Retry-After`` (``protocol.Overloaded``, code ``shed``); QueueFull's
  429 stays the hard bound for whatever is admitted. Hysteresis (re-admit
  only below ``threshold * hysteresis``) keeps the decision from flapping.
* Every decision is counted, and the controller's stats are a collector on
  the metrics bus (``seist_serve_shed_*{model=...}``).

One controller per model; ``ServeService`` consults it before it parses a
request's waveform.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.serve.protocol import DEFAULT_PRIORITY, PRIORITIES, Overloaded


@dataclass(frozen=True)
class ShedConfig:
    """Per-tier queue-delay thresholds (ms). ``float('inf')``: the tier is
    never shed by policy (it can still meet the queue's 429)."""

    batch_delay_ms: float = 50.0
    interactive_delay_ms: float = 250.0
    #: alerts are shed only above this (default never: a missed alert is a
    #: missed event)
    alert_delay_ms: float = float("inf")
    #: re-admit a shed tier only once the delay < threshold * hysteresis
    hysteresis: float = 0.5
    #: the floor of the computed Retry-After (seconds)
    min_retry_after_s: float = 1.0

    def threshold_ms(self, tier: str) -> float:
        return {
            "alert": self.alert_delay_ms,
            "interactive": self.interactive_delay_ms,
            "batch": self.batch_delay_ms,
        }[tier]


@dataclass
class _TierState:
    shedding: bool = False
    admitted: int = 0
    shed: int = 0
    final_exempt: int = 0  # releasing requests admitted through a shed


class AdmissionController:
    """The tiered queue-delay gate of one model. :meth:`admit` returns (the
    request goes on to the batcher, which may still 429) or raises
    :class:`Overloaded` with a ``Retry-After`` from the current delay.
    Thread-safe; the delay callable is read outside the lock (it takes the
    batcher's)."""

    def __init__(self, delay_ms_fn: Callable[[], float], config: Optional[ShedConfig] = None,
                 model: str = "default"):
        self._delay_ms = delay_ms_fn
        self.config = config or ShedConfig()
        self.model = model
        self._lock = threading.Lock()
        self._tiers: Dict[str, _TierState] = {t: _TierState() for t in PRIORITIES}
        # Keyed by model: a restarted service's controller replaces this one.
        self._collector_key = f"serve_shed:{model}"
        BUS.register_collector(self._collector_key, self.stats, name="serve_shed", model=model)

    def admit(self, priority: str = DEFAULT_PRIORITY, final: bool = False) -> None:
        """Admit or shed one request of tier ``priority``. A tier starts
        shedding above its threshold and stops below ``threshold *
        hysteresis``. ``final=True`` marks a request that releases
        capacity (a stream's ``end=true`` packet, which frees a station
        slot): it updates the tier's state but is always admitted."""
        if priority not in PRIORITIES:
            priority = DEFAULT_PRIORITY  # protocol validation rejects these first
        delay_ms = self._delay_ms()
        threshold = self.config.threshold_ms(priority)
        with self._lock:
            state = self._tiers[priority]
            if state.shedding:
                if delay_ms < threshold * self.config.hysteresis:
                    state.shedding = False
            elif delay_ms > threshold:
                state.shedding = True
            if state.shedding and final:
                state.final_exempt += 1
            elif state.shedding:
                state.shed += 1
                retry_after_s = max(self.config.min_retry_after_s, 2.0 * delay_ms / 1e3)
                raise Overloaded(
                    f"tier '{priority}' shed: queue delay {delay_ms:.0f} ms > "
                    f"{threshold:.0f} ms budget (model '{self.model}')",
                    retry_after_s=retry_after_s,
                )
            state.admitted += 1

    def shed_level(self) -> int:
        """The number of tiers shedding (0: open; 3: even alerts shed)."""
        with self._lock:
            return sum(1 for s in self._tiers.values() if s.shedding)

    def stats(self) -> Dict[str, Any]:
        delay_ms = self._delay_ms()
        with self._lock:
            return {
                "queue_delay_ms": round(delay_ms, 3),
                "level": sum(1 for s in self._tiers.values() if s.shedding),
                "tiers": {
                    t: {"shedding": s.shedding, "admitted": s.admitted, "shed": s.shed,
                        "final_exempt": s.final_exempt}
                    for t, s in self._tiers.items()
                },
            }

    def close(self) -> None:
        """Unregister the bus collector (a successor's stays)."""
        BUS.unregister_collector(self._collector_key, fn=self.stats)
