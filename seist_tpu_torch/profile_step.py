"""Trace the captured train step on the card with ``torch.profiler``
(counterpart of ``tools/profile_step.py``)::

    python -m seist_tpu_torch profile-step --model-name seist_l_dpk --batch 256 \\
        --steps 10 --out TRACE_DIR

Builds the JAX tool's state (seed-0 weights, Adam on the cyclic schedule
from 8e-5 to 1e-3 over 10,000 steps, x standard normal from numpy's seed
0, y one P and one S spike per trace), captures the step as the train
worker captures it (``train/graph.py``), runs 3 warm steps after the
capture's, then traces
``--steps`` steps into ``TRACE_DIR/trace.json`` (a Chrome trace: Perfetto,
``chrome://tracing``) and prints the device kernels of that trace that
take most (``obs/attribution.py::kernels_in_trace``), per step. Runs on
``cuda`` unless ``--device cpu`` is given, and raises without a GPU.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m seist_tpu_torch profile-step",
                                description="train-step profiler")
    p.add_argument("--model-name", default="seist_l_dpk")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--in-samples", type=int, default=8192)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "seist_trace"))
    p.add_argument("--device", default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from seist_tpu_torch import taskspec
    from seist_tpu_torch.models import api
    from seist_tpu_torch.obs import attribution
    from seist_tpu_torch.train.graph import capture_train_step
    from seist_tpu_torch.train.optim import build_optimizer
    from seist_tpu_torch.train.schedule import build_cyclic_schedule
    from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source
    from seist_tpu_torch.train.worker import _disable_tf32
    from seist_tpu_torch.utils import profiling

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to profile on the CPU")
    _disable_tf32(device)  # as the train worker: fp32 products stay fp32
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""), flush=True)

    model = api.create_model(args.model_name, in_samples=args.in_samples).to(device)
    state = TrainState(model, build_optimizer("adam", model.parameters()),
                       build_cyclic_schedule(8e-5, 1e-3, total_steps=10_000))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((args.batch, args.in_samples, 3))
                         .astype(np.float32)).to(device)
    y = np.zeros((args.batch, args.in_samples, 3), np.float32)
    y[:, args.in_samples // 4, 1] = 1.0
    y[:, args.in_samples // 2, 2] = 1.0
    y[..., 0] = 1.0 - y[..., 1] - y[..., 2]
    y = torch.from_numpy(y).to(device)

    step = capture_train_step(make_train_step(taskspec.make_loss(args.model_name), guard=False,
                                              compute_dtype=args.dtype))

    def run(i: int) -> None:
        step(state, x, y, step_random_source(0, 0, i, device))

    t0 = time.time()
    run(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"captured in {time.time() - t0:.1f}s", flush=True)
    for i in range(1, 4):
        run(i)
    with profiling.trace(args.out):
        for i in range(args.steps):
            run(4 + i)
    path = os.path.join(args.out, profiling.TRACE_FILE)
    print(f"trace written to {path}", flush=True)
    table = attribution.kernels_in_trace(path, calls=args.steps)
    print(f"{table['kernels']:g} kernels/step, device busy {table['busy_ms']:.3f} ms/step; "
          f"the kernels that take most:", flush=True)
    for line in attribution.kernel_lines(table, "step"):
        print(f"  {line}", flush=True)
