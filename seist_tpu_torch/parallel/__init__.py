"""Parallelism layer: the process group, the rank mesh and the collectives
of multi-rank training (counterpart of ``seist_tpu/parallel/``, whose
HLO report ``collectives.py`` stays with the JAX package)."""

from seist_tpu_torch.parallel.comm import (  # noqa: F401
    all_gather,
    all_reduce,
    rotate,
)
from seist_tpu_torch.parallel.dist import (  # noqa: F401
    all_gather_object,
    barrier,
    broadcast_object,
    init_distributed_mode,
    is_dist_avail_and_initialized,
    is_main_process,
    process_count,
    process_index,
)
from seist_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_SEQ,
    MESH_AXES,
    active_mesh,
    make_mesh,
    set_active_mesh,
    shard_batch,
    to_local,
    use_mesh,
)
