"""seist_tpu_torch — the PyTorch/CUDA port of seist_tpu.

A package of its own beside ``seist_tpu``: it imports ``torch`` and never
``jax``, ``flax`` or anything of ``seist_tpu``. Plain tensor code is
PyTorch; the one kernel on the serving path (pooled-KV attention) is CUDA
C++ written for Hopper (``csrc/``), built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line)::

    python -m seist_tpu_torch serve --model seist_l_dpk[=WEIGHTS.pt] --window 8192
"""

from __future__ import annotations


def load_all() -> None:
    """Import the model modules so their names register in
    :data:`seist_tpu_torch.registry.MODELS`."""
    from seist_tpu_torch.models import seist  # noqa: F401
