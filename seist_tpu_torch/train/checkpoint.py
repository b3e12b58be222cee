"""The port's checkpoints: step-granular, atomic, with keep-last-K + best
retention (counterpart of ``seist_tpu/train/checkpoint.py``'s
``TrainCheckpointManager``; orbax is not read).

A checkpoint at ``step`` (the run's global batch counter,
``epoch * steps_per_epoch + batches_done``) is two files in the run's
``checkpoints/`` directory:

* ``model_<step>.pt``: the model's bare ``state_dict`` (parameters and
  BatchNorm running statistics), the file ``serve --model NAME=FILE`` and
  ``--mode test --checkpoint FILE`` load;
* ``state_<step>.pt``: what a resume needs beside it, a dict of
  ``optimizer`` (its ``state_dict``: Adam's moments and step), ``step``
  (applied updates: the learning-rate schedule's position), ``meta`` (the
  fields of :data:`RESUME_META`: where in the data the run stood) and the
  early-stopping record ``best_loss`` and ``patience``.

Each file is written to a temporary name and moved into place with
``os.replace``; the state file goes first, so a checkpoint whose weights
file exists is whole. A save at a step that exists replaces it. The
best-val step is kept in ``best.json`` (atomic too), so retention never
deletes it after a resume.

A preempted run (SIGTERM, a loader death, a stalled loader) exits with
:data:`PREEMPT_EXIT_CODE` after its checkpoint is durable;
:func:`find_newest_checkpoint` is where a supervisor resumes it. torch is
imported inside the functions that use it, so the supervisor
(``python -m seist_tpu_torch supervise``), which needs only those two
names, stays stdlib-only.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from seist_tpu_torch.utils.logger import logger

#: sysexits EX_TEMPFAIL: "checkpointed, relaunch me" (the JAX package's
#: ``seist_tpu/train/checkpoint.py`` value and ``tools/supervise.py``'s
#: contract).
PREEMPT_EXIT_CODE = 75

#: The resume meta: ``data_epoch`` / ``data_batch_offset`` are the NEXT
#: batch to consume (the shuffle order is a pure function of (seed,
#: data_epoch)); ``seed``, ``steps_per_epoch`` and ``batch_size`` are the
#: geometry the offset is expressed in, checked on a mid-epoch resume.
RESUME_META = {
    "epoch": 0,
    "loss": 0.0,
    "step": 0,
    "data_epoch": 0,
    "data_batch_offset": 0,
    "total_batches": 0,
    "seed": 0,
    "steps_per_epoch": 0,
    "batch_size": 0,
}

_WEIGHTS = re.compile(r"^model_(\d+)\.pt$")


def find_newest_checkpoint(log_base: str) -> Optional[str]:
    """The newest ``*/checkpoints/model_<step>.pt`` under ``log_base``
    whose ``state_<step>.pt`` exists, by mtime (the step number breaks
    ties within one mtime); None when there is none. Only a whole
    checkpoint counts: the state file is written first."""
    newest: Optional[str] = None
    newest_key: Tuple[float, int] = (-1.0, -1)
    for dirpath, _, filenames in os.walk(log_base):
        if os.path.basename(dirpath) != "checkpoints":
            continue
        names = set(filenames)
        for name in filenames:
            m = _WEIGHTS.match(name)
            if not m or f"state_{m.group(1)}.pt" not in names:
                continue
            path = os.path.join(dirpath, name)
            key = (os.path.getmtime(path), int(m.group(1)))
            if key > newest_key:
                newest, newest_key = path, key
    return newest


def _to_cpu(obj: Any) -> Any:
    import torch

    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _atomic_torch_save(obj: Any, path: str) -> None:
    import torch

    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def state_path_for(weights_path: str) -> str:
    """``.../model_<step>.pt`` -> ``.../state_<step>.pt``."""
    d, name = os.path.split(weights_path)
    m = _WEIGHTS.match(name)
    if not m:
        raise ValueError(f"not a checkpoint weights file (model_<step>.pt): {weights_path}")
    return os.path.join(d, f"state_{m.group(1)}.pt")


def load_weights(path: str) -> Dict[str, Any]:
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(weights_path: str, state) -> Dict[str, Any]:
    """Restore ``model_<step>.pt`` and its ``state_<step>.pt`` into the
    train state ``state`` (model, optimizer, step); returns the state
    record (``meta``, ``best_loss``, ``patience``)."""
    spath = state_path_for(weights_path)
    if not os.path.exists(spath):
        raise FileNotFoundError(
            f"{weights_path} has no train state beside it ({spath}): a weights-only "
            "file can be tested or served, not resumed"
        )
    import torch

    record = torch.load(spath, map_location="cpu", weights_only=True)
    state.model.load_state_dict(load_weights(weights_path), strict=True)
    from seist_tpu_torch.train.optim import load_state

    load_state(state.optimizer, record["optimizer"])  # in place: captured steps read it
    state.step = int(record["step"])
    return record


class CheckpointManager:
    """Saves, retention and restore of one run's ``checkpoints/`` dir."""

    def __init__(self, directory: str, *, keep_last: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep_last = max(1, int(keep_last))
        os.makedirs(self.directory, exist_ok=True)
        self._best_file = os.path.join(self.directory, "best.json")
        self._best_step: Optional[int] = None
        self._best_loss = float("inf")
        try:
            with open(self._best_file) as f:
                best = json.load(f)
            self._best_step, self._best_loss = int(best["step"]), float(best["loss"])
        except FileNotFoundError:
            pass

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"model_{step}.pt")

    def all_steps(self) -> List[int]:
        """Steps whose weights and state files both exist."""
        steps = []
        for name in os.listdir(self.directory):
            m = _WEIGHTS.match(name)
            if m and os.path.exists(os.path.join(self.directory, f"state_{m.group(1)}.pt")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @property
    def best_step(self) -> Optional[int]:
        return self._best_step

    def save(
        self,
        step: int,
        state,
        *,
        epoch: int,
        data_epoch: int,
        data_batch_offset: int,
        seed: int,
        steps_per_epoch: int,
        batch_size: int,
        loss: float = float("inf"),
        val_loss: Optional[float] = None,
        best_loss: float = float("inf"),
        patience: int = 0,
    ) -> str:
        """Write checkpoint ``step`` of the train state ``state`` (model,
        optimizer, step); returns the weights path. ``data_epoch`` /
        ``data_batch_offset`` are the NEXT batch to consume; ``val_loss``,
        when the save follows a validation, feeds best-step retention."""
        record = {
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "step": int(state.step),
            "meta": {
                "epoch": int(epoch),
                "loss": float(loss if val_loss is None else val_loss),
                "step": int(state.step),
                "data_epoch": int(data_epoch),
                "data_batch_offset": int(data_batch_offset),
                "total_batches": int(step),
                "seed": int(seed),
                "steps_per_epoch": int(steps_per_epoch),
                "batch_size": int(batch_size),
            },
            "best_loss": float(best_loss),
            "patience": int(patience),
        }
        path = self.step_path(step)
        _atomic_torch_save(record, os.path.join(self.directory, f"state_{step}.pt"))
        _atomic_torch_save(_to_cpu(state.model.state_dict()), path)
        if val_loss is not None and float(val_loss) < self._best_loss:
            self._best_step, self._best_loss = int(step), float(val_loss)
            tmp = self._best_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": self._best_step, "loss": self._best_loss}, f)
            os.replace(tmp, self._best_file)
        self._gc(protect=step)
        logger.info(
            f"Checkpoint saved: step {step} (epoch {epoch}, data position "
            f"{data_epoch}:{data_batch_offset}) -> {path}"
        )
        return path

    def _gc(self, protect: int) -> None:
        """Keep the last ``keep_last`` steps and the best-val one."""
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:]) | {protect}
        if self._best_step is not None:
            keep.add(self._best_step)
        for s in steps:
            if s in keep:
                continue
            logger.info(
                f"Checkpoint GC: deleting step {s} — retention keeps the last "
                f"{self.keep_last} + best ({self._best_step})"
            )
            os.remove(self.step_path(s))
            os.remove(os.path.join(self.directory, f"state_{s}.pt"))

    def restore(self, state, step: Optional[int] = None) -> Dict[str, Any]:
        """Restore checkpoint ``step`` (default: the latest) into ``state``;
        returns its state record."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        return load_checkpoint(self.step_path(step), state)
