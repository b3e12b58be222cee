"""Waveform / prediction plotting: the port's copy of
``seist_tpu/utils/visualization.py`` (ref utils/visualization.py:18-186).

The reference's two figures: a stacked waveform/pred/target panel and the
phase-picking figure (channels and probability curves with true-pick
vlines). matplotlib is imported lazily, inside the functions, with the Agg
backend, so a headless host never needs a display and importing this
module needs no matplotlib; without it a plot raises ``ImportError``.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def vis_waves_preds_targets(
    waveforms: np.ndarray,
    preds: np.ndarray,
    targets: np.ndarray,
    sampling_rate: Optional[int] = None,
    save_dir: str = "./",
    format: str = "png",
) -> str:
    """Stacked rows: each waveform channel, each pred curve, each target
    curve (ref visualization.py:18-101). Returns the saved path."""
    plt = _plt()
    waveforms, preds, targets = (
        np.asarray(waveforms),
        np.asarray(preds),
        np.asarray(targets),
    )
    groups = [("Channel", waveforms), ("Pred", preds), ("Target", targets)]
    num_row = sum(g.shape[0] for _, g in groups)
    fig, axes = plt.subplots(num_row, 1, figsize=(8, 1.2 * num_row), squeeze=False)
    row = 0
    for label, group in groups:
        for idx, curve in enumerate(group):
            ax = axes[row][0]
            x = (
                np.arange(len(curve)) / sampling_rate
                if sampling_rate
                else np.arange(len(curve))
            )
            ax.plot(x, curve, "-", color="k", linewidth=0.15, alpha=0.8)
            ax.text(
                0.001,
                0.95,
                f"{label}-{idx}",
                ha="left",
                va="top",
                transform=ax.transAxes,
                fontsize="small",
            )
            ax.set_ylim(-1, 1)
            ax.set_yticks([])
            row += 1
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{_timestamp()}.{format}")
    fig.savefig(path, dpi=300)
    plt.close(fig)
    return path


def vis_phase_picking(
    waveforms: np.ndarray,
    waveforms_labels: Sequence[str],
    preds: np.ndarray,
    true_phase_idxs: Sequence[float],
    true_phase_labels: Sequence[str],
    pred_phase_labels: Sequence[str],
    sampling_rate: Optional[int] = None,
    save_name: str = "",
    save_dir: str = "./",
    formats: Sequence[str] = ("png",),
) -> List[str]:
    """Channels with true P/S vlines + a probability-curve row
    (ref visualization.py:104-186). Returns the saved paths."""
    plt = _plt()
    waveforms = np.asarray(waveforms)
    preds = np.asarray(preds)
    x = (
        np.arange(waveforms.shape[-1]) / sampling_rate
        if sampling_rate
        else np.arange(waveforms.shape[-1])
    )
    num_row = waveforms.shape[0] + 1
    lo, hi = float(np.min(waveforms)), float(np.max(waveforms))
    fig, axes = plt.subplots(
        num_row, 1, figsize=(10 / 2.54, 10 / 2.54), squeeze=False
    )
    for idx, wave in enumerate(waveforms):
        ax = axes[idx][0]
        ax.plot(x, wave, "-", color="k", linewidth=1, alpha=0.8,
                label=waveforms_labels[idx])
        if idx == 0 and len(true_phase_idxs):
            colors = ["C1", "C5"]
            for i, (pidx, plabel) in enumerate(
                zip(true_phase_idxs, true_phase_labels)
            ):
                # pick indices arrive in samples; the x axis is seconds
                # whenever sampling_rate is given
                ax.vlines(
                    x=[pidx / sampling_rate if sampling_rate else pidx],
                    ymin=lo * 1.1,
                    ymax=hi * 1.1,
                    colors=[colors[i % 2]],
                    linestyles="solid",
                    label=plabel,
                )
        ax.set_ylim(lo * 1.2, hi * 1.2)
        ax.set_ylabel("Amplitude")
        ax.set_yticks([])
        ax.set_xticks([])
        ax.legend(loc="upper right", fontsize=8)
    ax = axes[-1][0]
    styles = ["-.C0", "--C1", "--C5"]
    for i, label in enumerate(pred_phase_labels):
        ax.plot(x, preds[i], styles[i % 3], linewidth=1, alpha=0.8, label=label)
    ax.set_ylabel("Probability")
    ax.set_xlabel("Time (s)" if sampling_rate else "Samples")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()

    os.makedirs(save_dir, exist_ok=True)
    if isinstance(formats, str):
        formats = [formats]
    paths = []
    stem = os.path.join(save_dir, _timestamp() + save_name)
    for fmt in formats:
        p = f"{stem}.{fmt}"
        fig.savefig(p, dpi=400)
        paths.append(p)
    plt.close(fig)
    return paths
