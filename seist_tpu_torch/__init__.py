"""seist_tpu_torch — the PyTorch/CUDA port of seist_tpu.

A package of its own beside ``seist_tpu``: it imports ``torch`` and never
``jax``, ``flax``, anything of ``seist_tpu``, ``pandas`` or ``h5py``.
Plain tensor code is PyTorch; the pooled-KV attention's forward and
backward are CUDA C++ written for Hopper (``csrc/``), built with ``nvcc``
at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line)::

    python -m seist_tpu_torch serve --model seist_l_dpk[=WEIGHTS.pt] --window 8192
    python -m seist_tpu_torch train --model-name seist_l_dpk --dataset-name packed --data PACK ...
    python -m seist_tpu_torch pack --dataset synthetic --out PACK ...
    python -m seist_tpu_torch supervise -- python -m seist_tpu_torch train ...
    python -m seist_tpu_torch router --replica 127.0.0.1:18100 --replica 127.0.0.1:18101
    python -m seist_tpu_torch supervise-fleet --replicas 2 -- python -m seist_tpu_torch serve ...
"""

from __future__ import annotations


def load_all() -> None:
    """Import the model and dataset modules so their names register in
    :data:`seist_tpu_torch.registry.MODELS` and ``DATASETS``."""
    from seist_tpu_torch.data import packed, synthetic  # noqa: F401
    from seist_tpu_torch.models import (  # noqa: F401
        baz_network,
        distpt_network,
        ditingmotion,
        eqtransformer,
        magnet,
        phasenet,
        seist,
    )
