"""Flax variables of the JAX package -> this port's ``state_dict``.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts
of numpy arrays (``jax.device_get`` of the JAX package's variables). The
port's modules carry the flax module names, so each leaf's path maps to
one ``state_dict`` key; only the leaf names and layouts change:

* Dense ``kernel`` (in, out)                  -> Linear ``weight`` (out, in)
* Conv ``kernel`` (K, Cin/g, Cout)            -> ``weight`` (Cout, Cin/g, K)
  (depthwise ``(K, 1, C)`` -> ``(C, 1, K)`` is the same rule)
* ``bias``                                    -> ``bias``
* BatchNorm ``scale`` / ``bias``              -> ``weight`` / ``bias``
* BatchNorm ``mean`` / ``var`` (batch_stats)  -> ``running_mean`` / ``running_var``

A leaf no rule maps raises. Loading the result with
``load_state_dict(strict=True)`` checks names and shapes against the model.

:func:`train_state_from_optax` carries a whole JAX ``TrainState`` across:
parameters and ``batch_stats`` as above, and optax Adam's ``mu`` / ``nu``
through the same layout rule as the parameter each belongs to, into a
``torch.optim.Adam`` state whose step is optax's ``count``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert_param(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    module, leaf = ".".join(path[:-1]), path[-1]
    if leaf == "kernel" and arr.ndim == 2:
        return f"{module}.weight", arr.T
    if leaf == "kernel" and arr.ndim == 3:
        return f"{module}.weight", arr.transpose(2, 1, 0)
    if leaf == "bias" and arr.ndim == 1:
        return f"{module}.bias", arr
    if leaf == "scale" and arr.ndim == 1:
        return f"{module}.weight", arr
    raise KeyError(f"no rule maps param '{'/'.join(path)}' of shape {arr.shape}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's variables; raises on any unmapped leaf."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(variables.get("params", {})):
        key, value = _convert_param(path, np.asarray(arr, dtype=np.float32))
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    for path, arr in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in _STATS:
            raise KeyError(f"no rule maps batch_stats '{'/'.join(path)}'")
        key = ".".join(path[:-1] + (_STATS[path[-1]],))
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def save_torch_weights(variables: Mapping[str, Any], path: str) -> None:
    """``torch.save`` the converted ``state_dict``: the ``.pt`` file that
    ``serve --model NAME=WEIGHTS.pt`` loads."""
    torch.save(state_dict_from_flax(variables), path)


def train_state_from_optax(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    variables: Mapping[str, Any],
    mu: Mapping[str, Any],
    nu: Mapping[str, Any],
    count: int,
) -> int:
    """Load a JAX ``TrainState`` into ``model`` and its ``torch.optim.Adam``
    (or AdamW) ``optimizer``, which must be built over
    ``model.parameters()``: ``variables`` = ``{"params", "batch_stats"}``,
    ``mu`` / ``nu`` the Adam moments (trees shaped like ``params``),
    ``count`` the applied-update count. Returns ``count``: the train
    state's step, from which the schedule continues."""
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    moments = {}
    for tree, slot in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
        for path, arr in _leaves(tree):
            key, value = _convert_param(path, np.asarray(arr, dtype=np.float32))
            moments.setdefault(key, {})[slot] = torch.from_numpy(
                np.array(value, dtype=np.float32, order="C"))
    names = [name for name, _ in model.named_parameters()]
    if set(names) != set(moments):
        raise KeyError(
            f"optimizer moments do not match the parameters: "
            f"{sorted(set(names) ^ set(moments))[:5]}"
        )
    sd = optimizer.state_dict()
    if len(sd["param_groups"]) != 1 or len(sd["param_groups"][0]["params"]) != len(names):
        raise ValueError("the optimizer must hold exactly model.parameters(), one group")
    step = torch.tensor(float(count))
    sd["state"] = {
        i: {"step": step.clone(), **moments[name]}
        for i, name in enumerate(names)
    }
    optimizer.load_state_dict(sd)
    return int(count)
