"""The ranks of a run as a ``(data, model, seq)`` mesh (counterpart of
``seist_tpu/parallel/mesh.py``).

Axes, in this order: ``data`` (the batch is split over it; gradients and
BatchNorm statistics are reduced over it; the loader is sharded by it),
``model`` (fixed at 1, as in the JAX package's runs) and ``seq`` (every
SeisT attention runs as a ring over it, ``ops/ring_attention.py``;
``--seq-shards``). A rank's coordinates follow JAX's device order,
``rank = (d * model + m) * seq + s``, so the ranks of one seq group are
neighbours. :func:`make_mesh` creates the process subgroups of both axes
(every rank creates every group, in one order).

There is no device-mesh object beyond :class:`Mesh`: a rank holds its own
rows of the global batch (:func:`shard_batch`, :func:`to_local`), and the
ranks of one seq group hold the same rows. Models read the active mesh
(:func:`set_active_mesh`, :func:`use_mesh`) while they run.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
MESH_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SEQ)


def rank_layout(data: int, model: int = 1, seq: int = 1) -> np.ndarray:
    """The ``(data, model, seq)`` array of ranks, JAX's device order."""
    return np.arange(data * model * seq).reshape(data, model, seq)


@dataclass
class Mesh:
    """This rank's place in the mesh and the groups it reduces over.
    ``distributed`` is True when a process group exists (also for one
    rank): the train step then all-reduces its gradients."""

    data: int = 1
    model: int = 1
    seq: int = 1
    rank: int = 0
    distributed: bool = False
    data_group: Any = field(default=None, repr=False)
    seq_group: Any = field(default=None, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(MESH_AXES, (self.data, self.model, self.seq)))

    @property
    def world(self) -> int:
        return self.data * self.model * self.seq

    @property
    def coords(self) -> tuple:
        d, m, s = np.unravel_index(self.rank, (self.data, self.model, self.seq))
        return int(d), int(m), int(s)

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def seq_index(self) -> int:
        return self.coords[2]


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1,
              world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The mesh over the process group's ranks (one rank without a group).
    ``data=None`` takes the ranks left after ``model * seq``; any other
    shape must cover the ranks exactly."""
    from seist_tpu_torch.parallel import dist

    distributed = dist.is_dist_avail_and_initialized()
    world = dist.process_count() if world is None else int(world)
    rank = dist.process_index() if rank is None else int(rank)
    if model != 1:
        raise ValueError(f"the model axis is fixed at 1, got {model}")
    if data is None:
        if world % (model * seq):
            raise ValueError(f"{world} ranks not divisible by model*seq={model * seq}")
        data = world // (model * seq)
    if data * model * seq != world:
        raise ValueError(f"mesh shape {(data, model, seq)} != rank count {world}")
    mesh = Mesh(data, model, seq, rank, distributed)
    if distributed and world > 1:
        import torch.distributed as tdist

        layout = rank_layout(data, model, seq)
        # Every rank creates every group, in the same order.
        for m in range(model):
            for s in range(seq):
                ranks = [int(r) for r in layout[:, m, s]]
                g = tdist.new_group(ranks)
                if rank in ranks:
                    mesh.data_group = g
        for d in range(data):
            for m in range(model):
                ranks = [int(r) for r in layout[d, m, :]]
                g = tdist.new_group(ranks)
                if rank in ranks:
                    mesh.seq_group = g
    return mesh


# The mesh the running model reads (None: one rank, no reductions). Set by
# the train worker or scoped with use_mesh.
_ACTIVE_MESH: list = [None]


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    _ACTIVE_MESH[0] = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH[0]


@contextmanager
def use_mesh(mesh: Optional[Mesh]):
    old = _ACTIVE_MESH[0]
    _ACTIVE_MESH[0] = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH[0] = old


def data_parallel(mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """The active mesh when its data axis has more than one rank, else None."""
    mesh = active_mesh() if mesh is None else mesh
    return mesh if mesh is not None and mesh.data > 1 else None


def seq_parallel(mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """The active mesh when its seq axis has more than one rank, else None."""
    mesh = active_mesh() if mesh is None else mesh
    return mesh if mesh is not None and mesh.seq > 1 else None


def shard_batch(mesh: Optional[Mesh], batch: Any) -> Any:
    """This rank's rows of a global batch (arrays or tensors, or tuples and
    lists of them): the ``data_index``-th of ``mesh.data`` equal slices of
    the leading axis."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    if mesh is None or mesh.data == 1:
        return batch
    n = batch.shape[0]
    if n % mesh.data:
        raise ValueError(f"global batch {n} not divisible by the data axis {mesh.data}")
    b = n // mesh.data
    return batch[mesh.data_index * b:(mesh.data_index + 1) * b]


def to_local(x: Any) -> np.ndarray:
    """This rank's rows as numpy: a rank only ever holds its own rows, so
    this is the host copy of ``x``."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
