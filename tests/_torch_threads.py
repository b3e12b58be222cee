"""Caps torch's intra-op threads in a port test process and in the
subprocesses its tests start.

The tier-1 command runs the suite in several pytest workers at once
(``-n 6``); without a cap each worker, and each ``python -m
seist_tpu_torch`` child a test starts, opens one thread per core, and the
host runs many times more threads than it has cores. Every ``tests/test_torch_*.py`` imports this module first:
the workers' threads share the cores (at least one each), and children
inherit ``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS`` (a value already set in
the environment wins)."""

from __future__ import annotations

import os

import torch

#: The pytest workers of the tier-1 command.
WORKERS = 6
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, str(THREADS))
if torch.get_num_threads() > THREADS:
    torch.set_num_threads(THREADS)
