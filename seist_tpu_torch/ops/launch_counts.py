"""Launch counting shared by the kernel wrappers and the CUDA graphs.

Each wrapper keeps its counts as module globals (``ops/pooled_attention.py``:
``launches``, ``bf16_launches``, ...; ``ops/threefry.py``: ``launches``) and
adds one through :func:`bump` right where it launches its kernel. Several
threads launch at once in serving (one batcher thread per model and
variant), so the additions take a lock.

A graph replay launches the kernels it captured without passing through
the wrappers. ``train/graph.py`` runs a capture, and the warm-up runs
before it, on a side stream inside :func:`diverted`, which sends every
launch made on that stream to a tally of its own instead of the globals:
from the capturing thread and from autograd's device thread alike (a
backward runs on its forward's stream), while launches on other streams
go on counting. Each replay then adds the captured tally with :func:`add`.
"""

from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Sequence, Tuple

import torch

_LOCK = threading.Lock()
_DIVERTED: Dict[int, Dict["Counter", int]] = {}  # stream handle -> tally

Counter = Tuple[str, str]  # (module name, global name)


def bump(module_name: str, device: torch.device, *names: str) -> None:
    """Add one to each counter ``names`` of the module ``module_name`` for
    a launch on ``device``'s current stream, or to that stream's tally
    inside :func:`diverted`."""
    stream = torch.cuda.current_stream(device).cuda_stream
    module = sys.modules[module_name]
    with _LOCK:
        tally = _DIVERTED.get(stream)
        for name in names:
            if tally is not None:
                tally[(module_name, name)] = tally.get((module_name, name), 0) + 1
            else:
                setattr(module, name, getattr(module, name) + 1)


def add(counters: Sequence[Counter], values: Sequence[int]) -> None:
    """Add ``values`` to ``counters`` (a replay's captured launches)."""
    with _LOCK:
        for (module_name, name), value in zip(counters, values):
            if value:
                module = sys.modules[module_name]
                setattr(module, name, getattr(module, name) + value)


@contextmanager
def diverted(stream: "torch.cuda.Stream") -> Iterator[Dict[Counter, int]]:
    """Count the launches on ``stream`` into the yielded tally, not the
    globals."""
    handle = stream.cuda_stream
    with _LOCK:
        if handle in _DIVERTED:
            raise RuntimeError("this stream's launches are diverted already")
        tally = _DIVERTED[handle] = {}
    try:
        yield tally
    finally:
        with _LOCK:
            del _DIVERTED[handle]
