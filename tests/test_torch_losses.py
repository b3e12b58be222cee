"""The port's eight losses against ``seist_tpu.models.losses`` on the same
numpy inputs, and the SeisT rows' loss factories against the JAX task
table. Tolerance 1e-6 relative: the same fp32 formula, reduced in another
order."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import numpy as np
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.models import losses as jl

import seist_tpu_torch
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models import losses as tl


def _probs(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.01, 0.99, shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


DENSE = (3, 40, 3)
CLS = (5, 2)


@pytest.mark.parametrize(
    "name,kwargs,shape",
    [
        ("CELoss", {"weight": [1.0, 1.0, 1.0]}, DENSE),
        ("CELoss", {"weight": [[0.5], [1], [2]]}, DENSE),
        ("CELoss", {}, CLS),
        ("BCELoss", {"weight": [0.5, 1.0, 1.0]}, DENSE),
        ("BCELoss", {}, CLS),
        ("FocalLoss", {}, CLS),
        ("FocalLoss", {"gamma": 1.5, "has_softmax": False, "weight": [1.0, 2.0]}, CLS),
        ("BinaryFocalLoss", {"gamma": 2.0, "alpha": 0.7}, DENSE),
        ("MSELoss", {"weight": [1.0, 0.5, 2.0]}, DENSE),
        ("HuberLoss", {}, (6, 1)),
        ("HuberLoss", {"delta": 0.3}, DENSE),
    ],
)
def test_loss_matches_jax(name, kwargs, shape):
    preds, targets = _probs(shape, 1), _probs(shape, 2)
    if name == "HuberLoss":
        preds, targets = preds * 4.0, targets * 4.0  # both branches of delta
    want = getattr(jl, name)(**kwargs)(preds, targets)
    got = getattr(tl, name)(**kwargs)(torch.from_numpy(preds), torch.from_numpy(targets))
    _close(got, want)


def test_combination_and_mousavi_losses():
    p = (_probs((4, 1), 3), _probs((4, 1), 4))
    t = (_probs((4, 1), 5), _probs((4, 1), 6))
    want = jl.CombinationLoss(losses=[jl.MSELoss, jl.HuberLoss], losses_weights=[0.3, 2.0])(p, t)
    comb = tl.CombinationLoss(losses=[tl.MSELoss, tl.HuberLoss], losses_weights=[0.3, 2.0])
    got = comb(tuple(map(torch.from_numpy, p)), tuple(map(torch.from_numpy, t)))
    _close(got, want)
    assert comb.reduction == "mean"
    with pytest.raises(ValueError):
        tl.CombinationLoss(losses=[tl.MSELoss])
    preds = np.random.default_rng(7).standard_normal((6, 2)).astype(np.float32)
    targets = _probs((6, 1), 8)
    _close(tl.MousaviLoss()(torch.from_numpy(preds), torch.from_numpy(targets)),
           jl.MousaviLoss()(preds, targets))
    assert tl.MousaviLoss.reduction == "sum"
    assert tl.CombinationLoss(losses=[tl.MSELoss, tl.MousaviLoss]).reduction == "sum"


@pytest.mark.parametrize("model", ["seist_s_dpk", "seist_m_pmp", "seist_l_emg",
                                   "seist_s_baz", "seist_m_dis"])
def test_task_loss_factories_match_jax(model):
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    spec = tts.get_task_spec(model)
    shape = DENSE if spec.labels[0] == ("det", "ppk", "spk") else (
        CLS if spec.labels[0] == "pmp" else (5, 1))
    preds, targets = _probs(shape, 9), _probs(shape, 10)
    want = jts.make_loss(model)(preds, targets)
    got = tts.make_loss(model)(torch.from_numpy(preds), torch.from_numpy(targets))
    assert type(tts.make_loss(model)).__name__ == type(jts.make_loss(model)).__name__
    _close(got, want)


def test_losses_are_differentiable():
    preds = torch.from_numpy(_probs(DENSE, 11)).requires_grad_()
    tl.BCELoss(weight=[0.5, 1.0, 1.0])(preds, torch.from_numpy(_probs(DENSE, 12))).backward()
    assert preds.grad is not None and torch.isfinite(preds.grad).all()
