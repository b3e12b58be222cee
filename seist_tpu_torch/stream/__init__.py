"""Continuous-stream early-warning engine (the port's copy of
``seist_tpu/stream``).

Three layers on top of the offline ``ops/stream.annotate`` path:

* :mod:`seist_tpu_torch.stream.session` — per-station :class:`StreamSession`
  carrying overlap context between packets so each packet costs one
  stride of model compute, with picks provably identical to offline
  ``annotate`` on the concatenated record (the parity pin).
* :mod:`seist_tpu_torch.stream.mux` — :class:`StationMux` funnels thousands
  of sessions' due windows through the serve replica's MicroBatcher and
  its captured programs as one tenant (nothing new is captured).
* :mod:`seist_tpu_torch.stream.assoc` — :class:`Associator` clusters
  co-detections across stations into event hypotheses and emits alerts
  with per-stage latency stamps.

Serve endpoint: ``POST /stream`` (seist_tpu_torch/serve/server.py); on
the card, ``chip_smoke.py`` phase 13.
"""

from seist_tpu_torch.stream.assoc import Alert, Associator, AssocConfig
from seist_tpu_torch.stream.mux import MuxConfig, StationMux
from seist_tpu_torch.stream.session import DueWindow, SessionConfig, StreamSession

__all__ = [
    "Alert",
    "Associator",
    "AssocConfig",
    "DueWindow",
    "MuxConfig",
    "SessionConfig",
    "StationMux",
    "StreamSession",
]
