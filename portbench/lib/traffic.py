"""The one traffic generator: seeded three-component waveforms, each with a
P/S-like burst pair, and their label curves, made on the device in a few
large calls from a traffic file's parameters.

A trace is unit noise plus two bursts: at the P arrival ``p`` (uniform in
``p_range`` of the window) and the S arrival ``s = p + d`` (``d`` uniform
in ``sp_samples``), each a decaying envelope ``exp(-(t - t0) / tau)``
(``tau`` uniform in ``decay_samples``) times fresh Gaussian noise, scaled
by ``10 ** u`` (``u`` uniform in ``amp_log10``; S's times
``s_amp_factor``). Labels: Gaussians of width ``label_sigma`` samples at
P and S, and a detection box from P to ``s + coda * d``; PhaseNet's
``non`` is ``1 - ppk - spk`` clipped at 0. Every seed gets the same sizes;
only the values move.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from one run seed of any size."""
    words = np.random.SeedSequence(int(seed) & (2**128 - 1)).generate_state(n, np.uint64)
    return [int(w) >> 1 for w in words]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def traces(g: torch.Generator, n: int, tr: Dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, C, L) float32 traces and their (n, 2) P and S sample indices."""
    c, length = tr["channels"], tr["window"]
    p = (_uniform(g, n, *tr["p_range"], device) * length).long()
    d = _uniform(g, n, *tr["sp_samples"], device).long()
    s = torch.clamp(p + d, max=length - 2)
    t = torch.arange(length, device=device, dtype=torch.float32)
    x = torch.randn(n, c, length, generator=g, device=device)
    for t0, factor in ((p, 1.0), (s, tr["s_amp_factor"])):
        tau = _uniform(g, n, *tr["decay_samples"], device)
        amp = factor * torch.pow(10.0, _uniform(g, n, *tr["amp_log10"], device))
        rel = t[None, :] - t0[:, None].float()
        env = torch.where(rel >= 0, torch.exp(-rel.clamp(min=0) / tau[:, None]), 0.0)
        x.add_((amp[:, None] * env)[:, None, :]
               * torch.randn(n, c, length, generator=g, device=device))
    return x, torch.stack([p, s], 1)


def standardize(x: torch.Tensor) -> torch.Tensor:
    """(n, C, L) -> channels-last (n, L, C), each channel z-scored."""
    x = x - x.mean(dim=2, keepdim=True)
    return (x / x.std(dim=2, keepdim=True, correction=0).clamp(min=1e-12)).transpose(1, 2)


def labels(ps: torch.Tensor, names: Sequence[str], tr: Dict) -> torch.Tensor:
    """(n, L, len(names)) label curves for (det | non, ppk, spk)."""
    length = tr["window"]
    t = torch.arange(length, device=ps.device, dtype=torch.float32)[None, :]
    p, s = ps[:, :1].float(), ps[:, 1:].float()
    sig = float(tr["label_sigma"])
    ppk = torch.exp(-((t - p) ** 2) / (2 * sig * sig))
    spk = torch.exp(-((t - s) ** 2) / (2 * sig * sig))
    curves = {"ppk": ppk, "spk": spk,
              "det": ((t >= p) & (t <= s + tr["coda"] * (s - p))).float(),
              "non": torch.clamp(1.0 - ppk - spk, min=0.0)}
    return torch.stack([curves[k] for k in names], -1)


def train_pool(seed: int, tr: Dict, label_names: Sequence[str], device,
               batch: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``tr['pool_batches']`` distinct batches of (inputs (B, L, C),
    labels (B, L, 3)), resident on the device."""
    g = generator(seed, device)
    pool = []
    for _ in range(int(tr["pool_batches"])):
        x, ps = traces(g, batch, tr, device)
        pool.append((standardize(x).contiguous(), labels(ps, label_names, tr).contiguous()))
        del x
    return pool
