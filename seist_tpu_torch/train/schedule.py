"""Learning-rate schedules (counterpart of ``seist_tpu/train/schedule.py``).

The reference trains every model with torch ``CyclicLR``: warmup of
``step_size_up`` steps from base_lr to max_lr, then ``step_size_down`` back,
cycling; mode one of triangular / triangular2 / exp_range, with
``gamma = base_lr ** (1 / (2 * steps))`` computed by the caller. The JAX
package evaluates that as an fp32 ``step -> lr`` function; this module
evaluates the same formula in fp32 torch scalars, so both frameworks give
the same learning rate for update ``t``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Schedule = Callable[[int], float]


def cyclic_lr(
    base_lr: float,
    max_lr: float,
    step_size_up: int,
    step_size_down: Optional[int] = None,
    mode: str = "triangular",
    gamma: float = 1.0,
) -> Schedule:
    """torch.optim.lr_scheduler.CyclicLR semantics (cycle_momentum=False)."""
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"Unknown CyclicLR mode: {mode}")
    step_size_up = float(step_size_up)
    step_size_down = float(step_size_down if step_size_down is not None else step_size_up)
    total_size = step_size_up + step_size_down
    step_ratio = step_size_up / total_size

    def schedule(count: int) -> float:
        t = torch.tensor(count, dtype=torch.float32)
        cycle = torch.floor(1.0 + t / total_size)
        x = 1.0 + t / total_size - cycle
        scale_factor = torch.where(
            x <= step_ratio, x / step_ratio, (x - 1.0) / (step_ratio - 1.0)
        )
        height = (max_lr - base_lr) * scale_factor
        if mode == "triangular":
            lr = base_lr + height
        elif mode == "triangular2":
            lr = base_lr + height * torch.pow(torch.tensor(2.0), -(cycle - 1.0))
        else:
            lr = base_lr + height * torch.pow(torch.tensor(gamma, dtype=torch.float32), t)
        return float(lr)

    return schedule


def reference_gamma(base_lr: float, total_steps: int) -> float:
    """``gamma = base_lr ** ((steps * 2) ** -1)``: the exp_range envelope
    decays to ~sqrt(base_lr) over the run."""
    return float(base_lr ** ((total_steps * 2) ** -1))


def build_cyclic_schedule(
    base_lr: float,
    max_lr: float,
    total_steps: int,
    warmup_steps: float = 2000,
    down_steps: float = 3000,
    mode: str = "exp_range",
) -> Schedule:
    """The reference train worker's construction: warmup/down values < 1
    are ratios of total steps."""
    up = warmup_steps if warmup_steps >= 1 else max(1, int(warmup_steps * total_steps))
    down = down_steps if down_steps >= 1 else max(1, int(down_steps * total_steps))
    return cyclic_lr(
        base_lr=base_lr,
        max_lr=max_lr,
        step_size_up=int(up),
        step_size_down=int(down),
        mode=mode,
        gamma=reference_gamma(base_lr, total_steps),
    )


def constant(lr: float) -> Schedule:
    """The schedule of ``--use-lr-scheduler false``."""
    return lambda count: float(lr)
