"""Shared helpers of the tests/test_torch_*.py parity tests: one seeded
set of flax variables for the JAX package, converted for the port.

Variables are drawn with numpy over ``param_shapes`` (an ``eval_shape``:
no init compile). Kernels have std 0.5/sqrt(fan_in) and the BatchNorm
statistics are random, so activations stay O(1) through the depth and a
swapped mean/var or a transposed kernel shows in the outputs; the JAX
package's std-0.02 init shrinks the output to exactly 0.5 everywhere.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import numpy as np
import torch


def random_flax_variables(shapes: Any, seed: int) -> Any:
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (0.5 * rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError(f"unexpected leaf {name}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def model_pair(name: str, window: int, seed: int = 0, **kw) -> Tuple[Any, Any, torch.nn.Module]:
    """(flax module, its variables, the port's model with them loaded)."""
    import seist_tpu
    from seist_tpu.models import api as japi

    from seist_tpu_torch.models import api as tapi
    from seist_tpu_torch.models.convert import state_dict_from_flax

    seist_tpu.load_all()
    jm = japi.create_model(name, in_channels=3, in_samples=window, **kw)
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=window), seed)
    tm = tapi.create_model(name, in_channels=3, in_samples=window, **kw)
    tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
    return jm, variables, tm
