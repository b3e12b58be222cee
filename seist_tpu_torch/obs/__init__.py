"""The telemetry plane of the port (counterpart of ``seist_tpu/obs/``).

* **Metrics bus** (:mod:`~seist_tpu_torch.obs.bus`): process-wide
  counters, gauges and histograms and the span API, Prometheus text
  exposition and the JSONL event log.
* **Flight recorder** (:mod:`~seist_tpu_torch.obs.flight`): a ring of the
  last N steps' records and spans, dumped to JSON on every death path.
* **Request tracing** (:mod:`~seist_tpu_torch.obs.trace`): W3C
  ``traceparent`` IDs, per-request spans with tail-based retention,
  ``Server-Timing`` and ``GET /traces``.
* :mod:`~seist_tpu_torch.obs.http` serves the bus on the train worker's
  ``--metrics-port``.
* **Fleet pane** (:mod:`~seist_tpu_torch.obs.fleet`): the fleet
  supervisor's merge of every replica's bus snapshot and the router's,
  ``GET /fleet/metrics[.json]``.

* **Step attribution** (:mod:`~seist_tpu_torch.obs.attribution`, imported
  on its own: it needs torch, which this package's front-tier users do
  not load): ``attribute_step`` and ``op_costs``, the JAX walk's FLOP and
  byte rules over a recording of the ATen ops of one call, the kernels'
  launches charged by their wrappers; ``measured_kernels`` and
  ``kernels_in_trace``, the profiler's kernel table.

Metric names, span names, header formats and JSON shapes are the JAX
package's, so one scraper reads both.
"""

from seist_tpu_torch.obs import flight, trace
from seist_tpu_torch.obs.bus import (
    BUS,
    EventLog,
    MetricsBus,
    register_default_collectors,
    render_prometheus,
    stopwatch,
    timed_iter,
)
from seist_tpu_torch.obs.flight import FlightRecorder
from seist_tpu_torch.obs.http import (
    MetricsHTTPServer,
    ProfileTrigger,
    start_metrics_server,
)
from seist_tpu_torch.obs.trace import RequestTrace, TraceBuffer

__all__ = [
    "BUS",
    "EventLog",
    "FlightRecorder",
    "MetricsBus",
    "MetricsHTTPServer",
    "ProfileTrigger",
    "RequestTrace",
    "TraceBuffer",
    "flight",
    "register_default_collectors",
    "render_prometheus",
    "start_metrics_server",
    "stopwatch",
    "timed_iter",
    "trace",
]
