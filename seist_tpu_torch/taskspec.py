"""Task specifications: the io-item catalog and the task table (the port's
copy of ``seist_tpu/taskspec.py``).

Data layout convention, as in the JAX package: waveforms are channels-last
``(N, L, C)`` and dense outputs are ``(N, L, C)``. Each row carries its
loss factory (``seist_tpu/taskspec.py:186-264``): the five baseline rows
(phasenet, eqtransformer, magnet, baz_network, ditingmotion) and SeisT's.
DistPTNetwork has no row, as in the JAX package. A row's
``targets_transform_for_loss`` (baz's degrees to (cos, sin)) is applied
inside the loss its factory makes, where the JAX step applies it.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from seist_tpu_torch.models import losses

SOFT = "soft"
VALUE = "value"
ONEHOT = "onehot"
_IO_KINDS = (SOFT, VALUE, ONEHOT)

AVAILABLE_METRICS = (
    "precision",
    "recall",
    "f1",
    "mean",
    "rmse",
    "mae",
    "mape",
    "r2",
)


@dataclass(frozen=True)
class IOItem:
    """One io-item (model input or label)."""

    name: str
    kind: str
    metrics: Tuple[str, ...] = ()
    num_classes: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _IO_KINDS:
            raise ValueError(f"Unknown io-item kind '{self.kind}' for '{self.name}'")
        unknown = set(self.metrics) - set(AVAILABLE_METRICS)
        if unknown:
            raise ValueError(f"Unknown metrics {unknown} for io-item '{self.name}'")
        if self.kind == ONEHOT and not self.num_classes:
            raise ValueError(f"onehot io-item '{self.name}' needs num_classes")


_WAVE_METRICS = ("mean", "rmse", "mae")
_PICK_METRICS = ("precision", "recall", "f1", "mean", "rmse", "mae", "mape")
_VALUE_METRICS = ("mean", "rmse", "mae", "mape", "r2")
_REGR_METRICS = ("mean", "rmse", "mae", "r2")
_CLS_METRICS = ("precision", "recall", "f1")

IO_ITEMS: Dict[str, IOItem] = {
    item.name: item
    for item in [
        IOItem("z", SOFT, _WAVE_METRICS),
        IOItem("n", SOFT, _WAVE_METRICS),
        IOItem("e", SOFT, _WAVE_METRICS),
        IOItem("dz", SOFT, _WAVE_METRICS),
        IOItem("dn", SOFT, _WAVE_METRICS),
        IOItem("de", SOFT, _WAVE_METRICS),
        IOItem("non", SOFT, ()),
        IOItem("det", SOFT, _CLS_METRICS),
        IOItem("ppk", SOFT, _PICK_METRICS),
        IOItem("spk", SOFT, _PICK_METRICS),
        IOItem("ppk+", SOFT, ()),
        IOItem("spk+", SOFT, ()),
        IOItem("det+", SOFT, ()),
        IOItem("ppks", VALUE, _VALUE_METRICS),
        IOItem("spks", VALUE, _VALUE_METRICS),
        IOItem("emg", VALUE, _REGR_METRICS),
        IOItem("smg", VALUE, _REGR_METRICS),
        IOItem("baz", VALUE, _REGR_METRICS),
        IOItem("dis", VALUE, _REGR_METRICS),
        IOItem("pmp", ONEHOT, _CLS_METRICS, num_classes=2),
        IOItem("clr", ONEHOT, _CLS_METRICS, num_classes=2),
    ]
}


def get_io_items(kind: Optional[str] = None) -> List[str]:
    if kind is None:
        return list(IO_ITEMS)
    return [k for k, v in IO_ITEMS.items() if v.kind == kind]


def get_kind(name: str) -> str:
    return IO_ITEMS[name].kind


def get_metrics(name: str) -> List[str]:
    if name not in IO_ITEMS:
        raise KeyError(f"Unknown io-item '{name}', supported: {list(IO_ITEMS)}")
    return list(IO_ITEMS[name].metrics)


IOName = Union[str, Tuple[str, ...]]


def flatten_io_names(names: Sequence[IOName]) -> List[str]:
    """Grouped io-names expanded into a flat list."""
    out: List[str] = []
    for n in names:
        out.extend(n) if isinstance(n, (tuple, list)) else out.append(n)
    return out


# Results/target transforms of the non-SeisT families (torch versions of
# seist_tpu/taskspec.py:132-154).
def baz_targets_to_cos_sin(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """baz scalar degrees -> (cos, sin) pair."""
    r = x * (math.pi / 180.0)
    return torch.cos(r), torch.sin(r)


def baz_outputs_to_deg(x: Sequence[torch.Tensor]) -> torch.Tensor:
    """(cos, sin) pair -> degrees via atan2."""
    return torch.atan2(x[1], x[0]) * (180.0 / math.pi)


def magnet_results(x: torch.Tensor) -> torch.Tensor:
    """Keep only the mean prediction (drop log-variance)."""
    return x[:, 0].reshape(-1, 1)


def softmax_each(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Softmax every element of a tuple of outputs."""
    return [torch.exp(x) / torch.sum(torch.exp(x), dim=-1, keepdim=True) for x in xs]


@dataclass(frozen=True)
class TaskSpec:
    """Task configuration for one model family."""

    pattern: str
    inputs: Tuple[IOName, ...]
    labels: Tuple[IOName, ...]
    eval: Tuple[str, ...]
    outputs_transform_for_results: Optional[Callable] = None
    #: Zero-arg factory of ``loss(preds, targets) -> scalar`` (models/losses.py).
    loss: Optional[Callable] = None
    targets_transform_for_loss: Optional[Callable] = None

    def matches(self, model_name: str) -> bool:
        return bool(re.findall(self.pattern, model_name))

    def make_loss(self) -> Callable:
        """The row's loss, with its targets transform applied first."""
        loss = self.loss()
        if self.targets_transform_for_loss is None:
            return loss
        return _TransformedTargets(loss, self.targets_transform_for_loss)


class _TransformedTargets:
    """``loss(preds, transform(targets))``, keeping the loss's reduction."""

    def __init__(self, loss: Callable, transform: Callable):
        self.loss, self.transform = loss, transform
        self.reduction = getattr(loss, "reduction", "mean")

    def __call__(self, preds, targets):
        return self.loss(preds, self.transform(targets))


_ZNE = (("z", "n", "e"),)

TASK_SPECS: Tuple[TaskSpec, ...] = (
    TaskSpec("phasenet", _ZNE, (("non", "ppk", "spk"),), ("ppk", "spk"),
             loss=lambda: losses.CELoss(weight=[1.0, 1.0, 1.0])),
    TaskSpec("eqtransformer", _ZNE, (("det", "ppk", "spk"),), ("det", "ppk", "spk"),
             loss=lambda: losses.BCELoss(weight=[0.5, 1.0, 1.0])),
    TaskSpec("magnet", _ZNE, ("emg",), ("emg",), magnet_results, loss=losses.MousaviLoss),
    TaskSpec("baz_network", _ZNE, ("baz",), ("baz",), baz_outputs_to_deg,
             loss=lambda: losses.CombinationLoss(losses=[losses.MSELoss, losses.MSELoss]),
             targets_transform_for_loss=baz_targets_to_cos_sin),
    TaskSpec("ditingmotion", (("z", "dz"),), ("clr", "pmp"), ("pmp",), softmax_each,
             loss=lambda: losses.CombinationLoss(losses=[losses.FocalLoss, losses.FocalLoss])),
    TaskSpec("seist_.*?_dpk.*", _ZNE, (("det", "ppk", "spk"),), ("det", "ppk", "spk"),
             loss=lambda: losses.BCELoss(weight=[0.5, 1.0, 1.0])),
    TaskSpec("seist_.*?_pmp", _ZNE, ("pmp",), ("pmp",),
             loss=lambda: losses.CELoss(weight=[1.0, 1.0])),
    TaskSpec("seist_.*?_emg", _ZNE, ("emg",), ("emg",), loss=losses.HuberLoss),
    TaskSpec("seist_.*?_baz", _ZNE, ("baz",), ("baz",), loss=losses.HuberLoss),
    TaskSpec("seist_.*?_dis", _ZNE, ("dis",), ("dis",), loss=losses.HuberLoss),
)


def get_task_spec(model_name: str) -> TaskSpec:
    """Resolve the unique TaskSpec for a model name."""
    from seist_tpu_torch.registry import MODELS

    if len(MODELS) and model_name not in MODELS:
        raise KeyError(
            f"Unknown model: '{model_name}', registered: {MODELS.names()}"
        )
    hits = [s for s in TASK_SPECS if s.matches(model_name)]
    if not hits:
        raise KeyError(f"Missing task spec for model '{model_name}'")
    if len(hits) > 1:
        raise KeyError(
            f"Model '{model_name}' matches multiple task specs: "
            f"{[s.pattern for s in hits]}"
        )
    return hits[0]


def get_num_inchannels(model_name: str) -> int:
    """Number of waveform input channels."""
    spec = get_task_spec(model_name)
    for inp in spec.inputs:
        if isinstance(inp, (tuple, list)) and IO_ITEMS[inp[0]].kind == SOFT:
            return len(inp)
    raise ValueError(f"Incorrect input channels for model '{model_name}': {spec.inputs}")


def get_num_classes(name: str) -> int:
    item = IO_ITEMS[name]
    if item.kind != ONEHOT:
        raise ValueError(f"io-item '{name}' is '{item.kind}', not onehot")
    return int(item.num_classes)


def make_loss(model_name: str):
    """Instantiate the loss for a model (its targets transform applied)."""
    return get_task_spec(model_name).make_loss()
