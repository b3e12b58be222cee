"""Batch (archive-scale) inference, the throughput-bound twin of ``serve/``
(the port's counterpart of ``seist_tpu/batch/``):

    seist_tpu_torch.batch.catalog  deterministic work units over a packed
                                   archive, segment-committed, resumable,
                                   byte-identical catalog output
    seist_tpu_torch.batch.engine   straight-line device feed: double-buffered
                                   PackedRawStore fills against ONE
                                   multi-batch CUDA graph (trunk-once head
                                   fan-out for groups), batched decode ->
                                   catalog rows
    seist_tpu_torch.batch.fleet    the lease plane of the fault-tolerant
                                   multi-worker fleet

Command line: ``python -m seist_tpu_torch repick`` (worker, driver, merge and
fleet roles) and ``python -m seist_tpu_torch supervise-repick``.
"""

from seist_tpu_torch.batch.catalog import (  # noqa: F401
    WorkUnit,
    merge_catalog,
    plan_units,
)
from seist_tpu_torch.batch.engine import RepickEngine  # noqa: F401
