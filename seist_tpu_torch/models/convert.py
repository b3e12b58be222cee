"""Flax variables of the JAX package -> this port's ``state_dict``.

``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts
of numpy arrays (``jax.device_get`` of the JAX package's variables). The
port's modules carry the flax module names, so each leaf's path maps to
one ``state_dict`` key; only the leaf names and layouts change:

* Dense ``kernel`` (in, out)                  -> Linear ``weight`` (out, in)
  (a Dense over (N, L, C) is the same rule)
* Conv ``kernel`` (K, Cin/g, Cout)            -> ``weight`` (Cout, Cin/g, K)
  (depthwise ``(K, 1, C)`` -> ``(C, 1, K)`` is the same rule)
* ConvTranspose ``kernel`` (K, Cin, Cout) of a module named ``convt``
  (PhaseNet's)                                -> ``weight`` (Cin, Cout, K),
  flipped: ``weight[i, o, t] = kernel[K-1-t, i, o]`` (``common.ConvTranspose1d``)
* ``bias``                                    -> ``bias``
* BatchNorm / LayerNorm ``scale`` / ``bias``  -> ``weight`` / ``bias``
* BatchNorm ``mean`` / ``var`` (batch_stats)  -> ``running_mean`` / ``running_var``
* EQTransformer attention ``Wx``, ``Wt``, ``bh``, ``Wa``, ``ba`` -> the same
  names and layouts
* an ``OptimizedLSTMCell_0`` (``{ii,if,ig,io}/kernel`` (in, H) and
  ``{hi,hf,hg,ho}/{kernel,bias}``) of an ``LSTM`` ``X``, or of the ``fwd``
  / ``bwd`` cells of a ``BiLSTM`` ``X`` -> ``X.weight_ih_l0`` (4H, in),
  ``X.weight_hh_l0`` (4H, H), ``X.bias_hh_l0`` (4H), ``_reverse`` for
  ``bwd``: transposed and stacked in the gate order (i, f, g, o). flax
  has no input bias; the port's ``bias_ih`` is a zero buffer
  (``common.LSTM``)

A leaf no rule maps raises. Loading the result with
``load_state_dict(strict=True)`` checks names and shapes against the model.

:func:`train_state_from_optax` carries a whole JAX ``TrainState`` across:
parameters and ``batch_stats`` as above, and optax Adam's ``mu`` / ``nu``
through the same layout rule as the parameter each belongs to, into a
``torch.optim.Adam`` state whose step is optax's ``count``.
:func:`save_torch_train_state` writes such a state, with the JAX
checkpoint's resume meta, as the port's checkpoint pair
(``train/checkpoint.py``), from which ``train --checkpoint`` resumes at the
same data position and update count.
"""

from __future__ import annotations

import os
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


#: Parameters kept under their flax names and layouts (EQTransformer's attention).
_RAW = ("Wx", "Wt", "bh", "Wa", "ba")
_LSTM_CELL = "OptimizedLSTMCell_0"
_GATES = "ifgo"  # torch's gate order, flax's cell names (i, f, g, o)


def _convert_param(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    module, leaf = ".".join(path[:-1]), path[-1]
    if leaf in _RAW:
        return f"{module}.{leaf}", arr
    if leaf == "kernel" and arr.ndim == 3 and path[-2] == "convt":
        return f"{module}.weight", arr[::-1].transpose(1, 2, 0)
    if leaf == "kernel" and arr.ndim == 2:
        return f"{module}.weight", arr.T
    if leaf == "kernel" and arr.ndim == 3:
        return f"{module}.weight", arr.transpose(2, 1, 0)
    if leaf == "bias" and arr.ndim == 1:
        return f"{module}.bias", arr
    if leaf == "scale" and arr.ndim == 1:
        return f"{module}.weight", arr
    raise KeyError(f"no rule maps param '{'/'.join(path)}' of shape {arr.shape}")


def flax_last_axis(key: str, ndim: int) -> int:
    """The axis of the ``state_dict`` leaf ``key`` (of ``ndim`` axes) that
    holds the last axis of the flax leaf it converts from: the output
    channel of a kernel, over which the JAX package's weight-only int8
    takes its scales. The layout rules above, inverted: a Dense or Conv
    ``weight`` has it first, PhaseNet's ``convt`` second (Cin, Cout, K), a
    leaf kept as it is (``_RAW``) last, and an LSTM's stacked ``weight_ih`` /
    ``weight_hh`` first (row ``g * H + j`` is gate g's output j)."""
    module, _, leaf = key.rpartition(".")
    if leaf in _RAW:
        return ndim - 1
    if leaf.startswith(("weight_ih_l0", "weight_hh_l0")) and ndim == 2:
        return 0
    if leaf == "weight" and ndim == 3 and module.rpartition(".")[2] == "convt":
        return 1
    if leaf == "weight" and ndim in (2, 3):
        return 0
    raise KeyError(f"no rule maps the output axis of '{key}' ({ndim} axes)")


def _lstm_params(cells: Dict[Tuple[str, ...], Dict[str, np.ndarray]]
                 ) -> Iterator[Tuple[str, np.ndarray]]:
    """The torch leaves of the gathered LSTM cells (module docstring)."""
    for owner, leaves in cells.items():
        module, suffix = owner, ""
        if owner[-1] in ("fwd", "bwd"):
            module, suffix = owner[:-1], ("_reverse" if owner[-1] == "bwd" else "")
        prefix = ".".join(module)
        expected = {f"i{g}/kernel" for g in _GATES} | {
            f"h{g}/{leaf}" for g in _GATES for leaf in ("kernel", "bias")}
        if set(leaves) != expected:
            raise KeyError(f"LSTM cell '{'/'.join(owner)}': leaves {sorted(leaves)}, "
                           f"expected {sorted(expected)}")
        yield (f"{prefix}.weight_ih_l0{suffix}",
               np.concatenate([leaves[f"i{g}/kernel"].T for g in _GATES]))
        yield (f"{prefix}.weight_hh_l0{suffix}",
               np.concatenate([leaves[f"h{g}/kernel"].T for g in _GATES]))
        yield f"{prefix}.bias_hh_l0{suffix}", np.concatenate([leaves[f"h{g}/bias"] for g in _GATES])


def _convert_tree(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Every parameter leaf of ``tree`` (params, or an optimizer moment
    shaped like them) as torch ``state_dict`` entries; raises on an
    unmapped leaf."""
    out: Dict[str, np.ndarray] = {}
    cells: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for path, arr in _leaves(tree):
        arr = np.asarray(arr, dtype=np.float32)
        if _LSTM_CELL in path:
            at = path.index(_LSTM_CELL)
            cells.setdefault(path[:at], {})["/".join(path[at + 1:])] = arr
            continue
        key, value = _convert_param(path, arr)
        out[key] = value
    out.update(_lstm_params(cells))
    return out


_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's variables; raises on any unmapped leaf."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {
        key: torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
        for key, value in _convert_tree(variables.get("params", {})).items()
    }
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
        for key, value in _convert_tree(tree).items():
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


def _adam_state(opt_state: Any) -> Any:
    """The node of an optax state tree that holds Adam's ``mu`` and ``nu``
    (``ScaleByAdamState``), found by its fields, so optax is not needed."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for node in opt_state:
            found = _adam_state(node)
            if found is not None:
                return found
    return None


def save_torch_train_state(
    state: Any, meta: Mapping[str, Any], run_dir: str, step: int, *, model_name: str
) -> str:
    """Write a JAX train state as the port's checkpoint ``step`` in
    ``run_dir/checkpoints``; returns the weights path to pass to
    ``train --checkpoint``.

    ``state`` is ``jax.device_get`` of the JAX package's ``TrainState``:
    its ``params``, ``batch_stats`` and ``opt_state`` as numpy. The
    optimizer must be Adam, whose ``mu``, ``nu`` and ``count`` are found in
    ``opt_state``. ``meta`` is the JAX checkpoint's
    resume meta (``seist_tpu/train/checkpoint.py::_RESUME_META``), whose
    data position and batch geometry the port's resume reads."""
    from seist_tpu_torch.models import api
    from seist_tpu_torch.train.checkpoint import CheckpointManager
    from seist_tpu_torch.train.optim import build_optimizer
    from seist_tpu_torch.train.step import TrainState

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu) in opt_state: only Adam states convert")
    model = api.create_model(model_name)
    optimizer = build_optimizer("adam", model.parameters())
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    count = train_state_from_optax(model, optimizer, variables, adam.mu, adam.nu, int(adam.count))
    return CheckpointManager(os.path.join(run_dir, "checkpoints")).save(
        int(step),
        TrainState(model, optimizer, step=count),
        epoch=int(meta["epoch"]),
        data_epoch=int(meta["data_epoch"]),
        data_batch_offset=int(meta["data_batch_offset"]),
        seed=int(meta["seed"]),
        steps_per_epoch=int(meta["steps_per_epoch"]),
        batch_size=int(meta["batch_size"]),
        loss=float(meta["loss"]),
    )
