"""The reference training step: plain forward, loss, autograd backward and
Adam, in float32 with TF32 off (or on, for the control).

The losses consume probabilities, with eps 1e-6 inside the logs, as
SeisT's code base defines them: binary cross entropy with per-channel
weights, mean over every element (``seist_*_dpk``: det 0.5, ppk 1, spk 1);
cross entropy summed over the classes and averaged over the rest
(PhaseNet). Adam follows Kingma & Ba with optax's placement of epsilon
(outside the square root); the learning rate follows torch's CyclicLR in
``exp_range`` mode, as the reference trainer schedules it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference.dropout import StepDraws, set_draws
from portbench.reference.phasenet import PhaseNet
from portbench.reference.seist import SeisT

EPS = 1e-6


def build_model(cfg: Dict) -> torch.nn.Module:
    """The reference model of a configuration file."""
    arch = cfg["architecture"]
    if arch == "seist":
        return SeisT(cfg)
    if arch == "phasenet":
        return PhaseNet(cfg)
    raise ValueError(f"no reference for architecture {arch!r}")


def loss_fn(cfg: Dict) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    kind, weight = cfg["loss"]["kind"], cfg["loss"]["weight"]

    def bce(p, t):
        w = torch.tensor(weight, dtype=p.dtype, device=p.device)
        return (-(t * torch.log(p + EPS) + (1 - t) * torch.log(1 - p + EPS)) * w).mean()

    def ce(p, t):
        w = torch.tensor(weight, dtype=p.dtype, device=p.device)
        return (-t * torch.log(p + EPS) * w).sum(-1).mean()

    return {"bce": bce, "ce": ce}[kind]


def cyclic_lr(t: int, sched: Dict) -> float:
    """torch's CyclicLR (``exp_range``) at update count ``t``, with the
    reference trainer's gamma ``base ** (1 / (2 * total_steps))``, in
    float32 as the trainer's schedule tensor holds it."""
    f32 = np.float32
    base, peak = f32(sched["base_lr"]), f32(sched["max_lr"])
    up, down = f32(sched["warmup_steps"]), f32(sched["down_steps"])
    gamma = f32(float(sched["base_lr"]) ** ((sched["total_steps"] * 2) ** -1))
    total = up + down
    tt = f32(t)
    cycle = np.floor(f32(1.0) + tt / total)
    x = f32(1.0) + tt / total - cycle
    ratio = up / total
    scale = x / ratio if x <= ratio else (x - f32(1.0)) / (ratio - f32(1.0))
    return float(base + (peak - base) * f32(scale) * np.power(gamma, tt, dtype=np.float32))


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for cuBLAS and cuDNN on (the control) or off (the reference)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def leaf_norms(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    return torch.stack([t.detach().double().norm() for t in tensors]).cpu().numpy()


def train_steps(cfg: Dict, weights: Dict[str, torch.Tensor], batches: Sequence, *,
                draw_seed: int, device, allow_tf32: bool = False,
                loss_override: Optional[Callable] = None) -> Dict:
    """``len(batches)`` reference updates from ``weights``: each step's
    loss, every leaf's first gradient norm, and every leaf's change after
    the last step, by parameter name. Update ``t`` applies the dropout
    masks of ``StepDraws(draw_seed, t)``. ``loss_override`` (a fault for
    the control runs) replaces the loss."""
    model = build_model(cfg).to(device)
    model.load_state_dict(weights, strict=True)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    opt = cfg["optimizer"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lossf = loss_override or loss_fn(cfg)
    losses: List[float] = []
    first: Optional[np.ndarray] = None
    with tf32(allow_tf32):
        for t, (x, y) in enumerate(batches):
            for p in params:
                p.grad = None
            set_draws(model, StepDraws(draw_seed, t, device))
            loss = lossf(model(x), y)
            set_draws(model, None)
            loss.backward()
            losses.append(float(loss.detach()))
            grads = [p.grad for p in params]
            if first is None:
                first = leaf_norms(grads)
            lr = cyclic_lr(t, cfg["schedule"])
            with torch.no_grad():
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = mi / (1 - b1 ** (t + 1))
                    vhat = vi / (1 - b2 ** (t + 1))
                    p.sub_(lr * mhat / (vhat.sqrt() + eps))
    change = leaf_norms([p - s for p, s in zip(params, start)])
    out = {"names": names, "losses": losses, "grad_norms": first, "change_norms": change}
    del model, params, start, m, v
    return out


def leaf_gaps(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """|prog - ref| / max(ref, median(ref)) of each kept leaf."""
    med = float(np.median(ref[keep]))
    return np.abs(prog[keep] - ref[keep]) / np.maximum(ref[keep], med)


def compare(prog: Dict, ref: Dict, floor: float) -> Dict[str, float]:
    """The numbers a train cell can compare (a cell's ``limits`` choose):

    * ``loss_gap``: the largest of the three steps' loss gaps, relative to
      the reference's loss; ``loss_gap_first``: the first step's alone;
    * ``grad_gap``: the first gradient's norm gap by the worst leaf, each
      leaf's gap over its reference norm or the median leaf's, whichever
      is larger;
    * ``change_gap``: the same for the change after the last step, by the
      worst leaf; ``change_gap_median``: by the median leaf.

    Leaves whose reference gradient is under ``floor`` times the median
    leaf's are rounding noise (a bias under a softmax or a BatchNorm) and
    are left out of the change."""
    if list(prog["names"]) != list(ref["names"]):
        raise ValueError("program and reference leaves differ")
    steps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["losses"], ref["losses"])]
    if not all(math.isfinite(x) for x in prog["losses"]):
        steps = [float("inf")] * len(steps)
    g_ref = np.asarray(ref["grad_norms"])
    live = g_ref >= floor * float(np.median(g_ref))
    grad = leaf_gaps(np.asarray(prog["grad_norms"]), g_ref, np.ones_like(live))
    change = leaf_gaps(np.asarray(prog["change_norms"]), np.asarray(ref["change_norms"]), live)
    names = np.asarray(prog["names"])
    return {"loss_gap": max(steps), "loss_gap_first": steps[0],
            "grad_gap": float(grad.max()), "change_gap": float(change.max()),
            "change_gap_median": float(np.median(change)),
            "worst_grad_leaf": str(names[int(grad.argmax())]),
            "worst_change_leaf": str(names[live][int(change.argmax())]),
            "loss_gaps": steps}
