"""Mixed-precision policy: bf16 compute, fp32 parameters, optimizer state
and BatchNorm statistics (counterpart of ``seist_tpu/train/precision.py``).

Step-level casting, not per-module dtype threading: the train and eval
steps cast the parameters and inputs to the compute dtype inside the step
(``torch.func.functional_call`` over the cast parameters, so gradients flow
back through the cast to the fp32 master parameters) and cast the outputs
back to fp32 before the loss. What the cast cannot reach, because it is
created inside the forward, takes its dtype from the activations or from
the active policy: ``models/common.py::BatchNorm`` computes its statistics
in fp32 and casts its output to :func:`policy_dtype`, so its fp32
running statistics do not promote every product after it back to fp32.
The attention kernels take bf16 q, k, v and keep their softmax in fp32.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Optional

import torch


class _Policy(threading.local):
    """Per-thread active policy: a serving thread that runs an fp32
    forward while another runs under bf16 must not pick up its dtype."""

    dtype: Optional[torch.dtype] = None


_POLICY = _Policy()


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """CLI dtype name -> torch dtype (None = full fp32)."""
    if name is None:
        return None
    key = str(name).lower()
    if key in ("fp32", "float32", "f32", "none"):
        return None
    if key in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"Unknown compute dtype '{name}' (use fp32 or bf16)")


def policy_dtype() -> Optional[torch.dtype]:
    """The active compute dtype (None outside a :func:`precision_policy`)."""
    return _POLICY.dtype


@contextmanager
def precision_policy(dtype: Optional[torch.dtype]):
    """Activate a compute dtype for a forward on this thread."""
    old = _POLICY.dtype
    _POLICY.dtype = dtype
    try:
        yield
    finally:
        _POLICY.dtype = old


def cast_floating(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """Cast the floating tensors of a tensor, tuple, list or dict; leave
    integer, bool and other leaves as they are."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def cast_to_float32(tree: Any) -> Any:
    return cast_floating(tree, torch.float32)
