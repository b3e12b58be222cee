"""The reference's published PyTorch weights (``.pth``) -> this port's
``state_dict``, without JAX.

The reference (SeisT's own repository) ships its weights as raw torch
state dicts in its own module layout. The JAX package maps that layout
onto its flax variables in ``tools/parity.py``; this module keeps numpy
copies of that mapping, under the same names (:func:`torch_key_to_flax`,
:func:`_fit_leaf`, :func:`collect_lstm_leaf`, :func:`_convert_lstm_group`,
:func:`convert_state_dict`), and composes it with
``convert.state_dict_from_flax``:

    reference key -> flax path -> flax leaf (layout per rank) -> port key

The flax target tree is not built: its leaf shapes are derived from the
port model's own ``state_dict()`` by the inverse of ``convert.py``'s layout
rule, applied to shapes only (:func:`flax_target_shapes`).

:func:`state_dict_from_reference` is what ``python -m seist_tpu_torch
import-pretrained`` runs: it unwraps what ``tools/import_pretrained.py``
unwraps (a nested ``model_dict``, the prefixes ``module.`` and
``_orig_mod.``), converts, and raises
:class:`~seist_tpu_torch.serve.protocol.IncompatibleCheckpoint` naming the
key when a reference key maps nowhere or a port leaf is not covered.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from seist_tpu_torch.models.convert import _LSTM_CELL, _RAW, _GATES, state_dict_from_flax
from seist_tpu_torch.serve.protocol import IncompatibleCheckpoint

FlatTarget = Dict[Tuple[str, Tuple[str, ...]], Tuple[int, ...]]

_BN_MAP = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}
_BN_LEAVES = set(_BN_MAP) | {"num_batches_tracked"}

# The reference's list modules -> the flax per-index prefix
# (list.{k}.* -> prefix{k}/*), as tools/parity.py's table.
_LIST_MODULES = {
    "blocks": "block",
    "conv_blocks": "block",
    "clarity_side_layers": "clarity_side",
    "polarity_side_layers": "polarity_side",
    "fuse_clarity": "fuse_clarity",
    "fuse_polarity": "fuse_polarity",
    "res_convs": "resconv",
    "bilstms": "bilstm",
    "transformers": "transformer",
    "decoders": "decoder",
    "upsamplings": "up",
    "down_convs": "down",
    "up_convs": "up",
}


def torch_key_to_flax(key: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """Map one reference state-dict key to (collection, flax path), or None
    for a key that carries nothing (``num_batches_tracked``)."""
    parts = key.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    # Norm leaves re-route by collection: modules named "norm", "norm{k}",
    # "out_norm", "bn*", "ln{k}", or entries of a "norms" list.
    collection = "params"
    if parent.isdigit():
        norm_parent = len(parts) > 2 and parts[-3] == "norms"
    else:
        norm_parent = (
            parent == "out_norm"
            or bool(re.fullmatch(r"norm\d*", parent))
            or bool(re.fullmatch(r"bn\w*", parent))
            or bool(re.fullmatch(r"ln\d*", parent))
        )
    is_norm_leaf = leaf in _BN_LEAVES and bool(norm_parent)
    if leaf == "num_batches_tracked":
        return None
    if is_norm_leaf:
        collection, leaf = _BN_MAP[leaf]
    elif leaf == "weight":
        leaf = "kernel"

    out: list = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if p == "stem":
            out.append(f"stem{parts[i + 1]}")
            i += 2
        elif p == "encoder_layers":
            stage, blk = int(parts[i + 1]), int(parts[i + 2])
            out.append(f"stage{stage}_aggr" if blk == 0 else f"stage{stage}_block{blk - 1}")
            i += 3
        elif p == "out_head":
            out.append("out_head")
            i += 1
        elif p == "up_layers":
            # up_layers.{k}.conv -> conv{k}; up_layers.{k}.norm -> norm{k}
            out.append(f"{parts[i + 2]}{parts[i + 1]}")
            i += 3
        elif p in ("convs", "norms", "projs") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{p[:-1]}{parts[i + 1]}")
            i += 2
            # DiTingMotion wraps each conv in a Sequential (convs.{a}.0.weight):
            # only slot 0 carries parameters; any other slot stays unmapped.
            if i < len(parts) - 1 and parts[i] == "0":
                i += 1
        elif p == "conv_layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            # Inside a DiTingMotion block the j-th CombConvLayer (comb{j}); at
            # MagNet's top level the j-th ConvBlock (conv{j}).
            kind = "comb" if (out and out[-1].startswith("block")) else "conv"
            out.append(f"{kind}{parts[i + 1]}")
            i += 2
        elif p in _LIST_MODULES and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{_LIST_MODULES[p]}{parts[i + 1]}")
            i += 2
        elif (p == "layers" and i + 2 < len(parts) and parts[i + 1].isdigit()
              and parts[i + 2] == "0"):
            # BAZNetwork's wave branch: layers.{k} is Sequential(conv, act).
            out.append(f"wave_conv{parts[i + 1]}")
            i += 3
        else:
            out.append(p)
            i += 1
    out.append(leaf)
    return collection, tuple(out)


def _fit_leaf(value: np.ndarray, target_shape: Tuple[int, ...], key: str) -> np.ndarray:
    """A reference tensor in the flax leaf's layout, decided by ranks (a
    square Linear would pass a shape test untransposed): 2-D and 3-D
    weights are transposed, 1-D vectors pass; EQTransformer's raw ``Wx``,
    ``Wt``, ``Wa`` keep their orientation; PhaseNet's ``convt`` (in, out, k)
    becomes (k, in, out) with the spatial axis flipped."""
    v = np.asarray(value)
    leaf_name = key.split(".")[-1]
    if leaf_name in ("Wx", "Wt", "Wa"):
        t = v
    elif v.ndim <= 1:
        t = v
    elif ".convt." in f".{key}." and v.ndim == 3:
        t = v.transpose(2, 0, 1)[::-1]
    elif len(target_shape) == 3 and v.ndim == 3:
        t = v.transpose(2, 1, 0)  # (out, in, k) -> (k, in, out)
    elif len(target_shape) == 2:
        if v.ndim == 3 and v.shape[-1] == 1:
            v = v[:, :, 0]  # a 1x1 Conv1d used as a Linear
        t = v.T
    else:
        t = v
    if tuple(t.shape) != tuple(target_shape):
        raise ValueError(
            f"Cannot fit '{key}' {np.asarray(value).shape} into flax leaf {target_shape}")
    return t


_LSTM_LEAF_RE = re.compile(r"(weight|bias)_(ih|hh)_l0(_reverse)?")


def collect_lstm_leaf(path: Tuple[str, ...], value: np.ndarray,
                      groups: Dict[Tuple[Tuple[str, ...], str], Dict[str, np.ndarray]]) -> bool:
    """Stash a fused torch LSTM leaf of the mapped ``path`` in ``groups``,
    keyed by (module prefix, direction), and return True; False for any
    other leaf."""
    m = _LSTM_LEAF_RE.fullmatch(path[-1])
    if not m:
        return False
    direction = "bwd" if m.group(3) else "fwd"
    groups.setdefault((path[:-1], direction), {})[f"{m.group(1)}_{m.group(2)}"] = np.asarray(value)
    return True


def _convert_lstm_group(prefix: Tuple[str, ...], direction: str, leaves: Dict[str, np.ndarray],
                        flat_target: FlatTarget) -> Dict[Tuple[str, Tuple[str, ...]], np.ndarray]:
    """A torch ``nn.LSTM`` direction -> flax ``OptimizedLSTMCell`` leaves:
    the (4H, *) rows split in the gate order (i, f, g, o), input kernels
    ``i{g}`` without bias, recurrent kernels ``h{g}`` with the SUM of
    torch's ``bias_ih`` and ``bias_hh`` (they are always added together).
    A ``_reverse`` direction is the ``bwd`` cell of a BiLSTM."""
    cell = _LSTM_CELL
    cand_a = prefix + (direction, cell)
    cand_b = prefix + (cell,)
    if prefix and prefix[-1] == "lstm" and not any(
        ("params", prefix + tail + ("ii", "kernel")) in flat_target
        for tail in ((direction, cell), (cell,))
    ):
        # MagNet names its bidirectional torch module `lstm`; flax's is `bilstm`.
        alt = prefix[:-1] + ("bilstm",)
        if ("params", alt + (direction, cell, "ii", "kernel")) in flat_target:
            prefix = alt
            cand_a = prefix + (direction, cell)
            cand_b = prefix + (cell,)
    if ("params", cand_a + ("ii", "kernel")) in flat_target:
        base = cand_a
    elif ("params", cand_b + ("ii", "kernel")) in flat_target:
        if direction == "bwd":
            raise KeyError(f"reverse LSTM weights for {'/'.join(prefix)} but the flax "
                           "module is unidirectional")
        base = cand_b
    else:
        raise KeyError(f"no flax LSTM cell found under {'/'.join(prefix)}")

    required = {"weight_ih", "weight_hh", "bias_ih", "bias_hh"}
    if set(leaves) != required:
        raise KeyError(f"incomplete torch LSTM group {'/'.join(prefix)} ({direction}): "
                       f"{sorted(leaves)}")

    out: Dict[Tuple[str, Tuple[str, ...]], np.ndarray] = {}
    w_ih = np.split(leaves["weight_ih"], 4, axis=0)
    w_hh = np.split(leaves["weight_hh"], 4, axis=0)
    b = np.split(leaves["bias_ih"] + leaves["bias_hh"], 4, axis=0)
    for k, g in enumerate(_GATES):
        for path, val in (
            (base + (f"i{g}", "kernel"), w_ih[k].T),
            (base + (f"h{g}", "kernel"), w_hh[k].T),
            (base + (f"h{g}", "bias"), b[k]),
        ):
            tgt = flat_target.get(("params", path))
            if tgt is None:
                raise KeyError(f"unknown flax LSTM leaf {'/'.join(path)}")
            if tuple(val.shape) != tuple(tgt):
                raise ValueError(f"LSTM leaf {'/'.join(path)}: {val.shape} != {tgt}")
            out[("params", path)] = val
    return out


def _numpy(value: Any) -> np.ndarray:
    if torch.is_tensor(value):
        return value.detach().cpu().float().numpy()
    return np.asarray(value)


def convert_state_dict(state_dict: Mapping[str, Any], flat_target: FlatTarget
                       ) -> Dict[str, Any]:
    """A reference state dict -> ``{'params', 'batch_stats'}`` nested dicts
    of numpy arrays whose leaves are exactly ``flat_target``'s; raises
    ``KeyError`` on a key that maps to no target leaf or a target leaf
    the dict does not cover."""
    converted: Dict[Tuple[str, Tuple[str, ...]], np.ndarray] = {}
    lstm_groups: Dict[Tuple[Tuple[str, ...], str], Dict[str, np.ndarray]] = {}
    for tkey, tval in state_dict.items():
        mapped = torch_key_to_flax(tkey)
        if mapped is None:
            continue
        coll, path = mapped
        val = _numpy(tval)
        if collect_lstm_leaf(path, val, lstm_groups):
            continue
        if (coll, path) not in flat_target:
            raise KeyError(
                f"torch key '{tkey}' mapped to unknown flax leaf {coll}/{'/'.join(path)}")
        converted[(coll, path)] = _fit_leaf(val, flat_target[(coll, path)], tkey)
    for (prefix, direction), leaves in lstm_groups.items():
        converted.update(_convert_lstm_group(prefix, direction, leaves, flat_target))

    missing = set(flat_target) - set(converted)
    if missing:
        raise KeyError(f"flax leaves not covered by checkpoint: {sorted(missing)[:8]}")

    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for (coll, path), val in converted.items():
        node = out[coll]
        for piece in path[:-1]:
            node = node.setdefault(piece, {})
        node[path[-1]] = val
    if not out["batch_stats"]:
        out.pop("batch_stats")
    return out


_LSTM_KEY = re.compile(r"^(weight_ih|weight_hh|bias_hh)_l0(_reverse)?$")


def flax_target_shapes(model: torch.nn.Module) -> FlatTarget:
    """The flax leaves (collection, path) -> shape that ``model``'s
    ``state_dict`` converts from: ``convert.py``'s layout rules inverted,
    on shapes only."""
    sd = model.state_dict()
    bidirectional = {k.rpartition(".")[0] for k in sd if k.endswith("_l0_reverse")}
    out: FlatTarget = {}
    for key, value in sd.items():
        module, _, leaf = key.rpartition(".")
        mpath = tuple(module.split(".")) if module else ()
        shape = tuple(value.shape)
        m = _LSTM_KEY.match(leaf)
        if m:
            cell = mpath + ((("bwd",) if m.group(2) else ("fwd",)) if module in bidirectional
                            else ()) + (_LSTM_CELL,)
            h = shape[0] // 4
            for g in _GATES:
                if m.group(1) == "weight_ih":
                    out[("params", cell + (f"i{g}", "kernel"))] = (shape[1], h)
                elif m.group(1) == "weight_hh":
                    out[("params", cell + (f"h{g}", "kernel"))] = (h, h)
                else:
                    out[("params", cell + (f"h{g}", "bias"))] = (h,)
        elif leaf == "running_mean":
            out[("batch_stats", mpath + ("mean",))] = shape
        elif leaf == "running_var":
            out[("batch_stats", mpath + ("var",))] = shape
        elif leaf in _RAW:
            out[("params", mpath + (leaf,))] = shape
        elif leaf == "weight" and len(shape) == 1:
            out[("params", mpath + ("scale",))] = shape
        elif leaf == "weight" and len(shape) == 2:
            out[("params", mpath + ("kernel",))] = shape[::-1]
        elif leaf == "weight" and len(shape) == 3 and mpath[-1:] == ("convt",):
            out[("params", mpath + ("kernel",))] = (shape[2], shape[0], shape[1])
        elif leaf == "weight" and len(shape) == 3:
            out[("params", mpath + ("kernel",))] = shape[::-1]
        elif leaf == "bias" and len(shape) == 1:
            out[("params", mpath + ("bias",))] = shape
        else:
            raise KeyError(f"no rule maps the port leaf '{key}' of shape {shape}")
    return out


def unwrap(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """What ``tools/import_pretrained.py`` unwraps: a training checkpoint's
    nested ``model_dict``, and the ``module.`` (DataParallel) and
    ``_orig_mod.`` (``torch.compile``) prefixes."""
    if "model_dict" in sd:
        sd = sd["model_dict"]
    return {k.removeprefix("module.").removeprefix("_orig_mod."): v for k, v in sd.items()}


def state_dict_from_reference(sd: Mapping[str, Any], model: torch.nn.Module, *,
                              checkpoint: str = "<state dict>",
                              model_name: str = "") -> Dict[str, torch.Tensor]:
    """Convert a reference state dict for ``model`` (a port model of the
    same name and widths); the result loads with ``strict=True``. Raises
    :class:`IncompatibleCheckpoint` naming the key that maps nowhere or
    the leaf the file does not cover."""
    from seist_tpu_torch.serve.pool import validate_checkpoint

    name = model_name or type(model).__name__
    try:
        variables = convert_state_dict(unwrap(sd), flax_target_shapes(model))
    except (KeyError, ValueError) as e:
        msg = e.args[0] if e.args else str(e)
        raise IncompatibleCheckpoint(
            f"checkpoint '{checkpoint}' does not fit model '{name}': {msg}") from e
    out = state_dict_from_flax(variables)
    validate_checkpoint(model.state_dict(), out, model_name=name, checkpoint=checkpoint)
    return out
