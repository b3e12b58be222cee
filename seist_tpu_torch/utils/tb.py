"""Scalar logging: TensorBoard event files, or ``scalars.jsonl`` where the
``tensorboard`` package does not import (counterpart of
``seist_tpu/utils/tb.py``; the train worker's ``--use-tensorboard``)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarWriter:
    def __init__(self, logdir: str):
        self._logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
            mode = "tensorboard event files"
        # tensorboard is optional: any import or set-up failure (a missing
        # package, a protobuf clash, an unwritable file) takes the JSONL
        # sink rather than stopping a training run over a diagnostics writer.
        except Exception:  # noqa: BLE001
            self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
            mode = "JSONL fallback (tensorboard unavailable)"
        from seist_tpu_torch.utils.logger import logger

        logger.info(f"ScalarWriter: {mode} -> {logdir}")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                          "ts": time.time()}) + "\n")

    def add_scalars(self, prefix: str, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.add_scalar(f"{prefix}/{k}", v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
