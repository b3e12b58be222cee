"""A test and smoke harness, not a user command: a few train steps of one
model on seeded global batches, on one rank or on the ranks of a launch,
to hold a multi-rank step against one rank's on the same rows. The CPU
tests (``tests/test_torch_parallel.py``) and ``chip_smoke.py`` run it as
``python -m seist_tpu_torch.parallel.check SPEC.json``; users train with
``python -m seist_tpu_torch train``.

The launch is the train entry's (``parallel/dist.py``: the JAX package's
env contract or torchrun's; without one, a single rank). The spec:

    {"model": "seist_l_dpk", "window": 8192, "device": "cuda", "seed": 0,
     "out": "DIR or null",
     "runs": [{"seq": 1, "global_batch": 16, "steps": 3, "lr": 1e-3,
               "drop": {"attn_drop_rate": 0.3, ...},
               "inputs": "x.npz or null", "weights": "w.pt or null"}, ...]}

Each run builds a ``(data, 1, seq)`` mesh over the ranks, the model with
the run's drop rates (seeded weights, or ``weights``), Adam at a constant
``lr``, and runs ``steps`` guarded train steps, captured as CUDA graphs
where the train worker would capture them. Step ``i``'s global batch is
``inputs``' ``x[i]``, ``y[i]`` (else seeded normals and uniforms), its
randomness ``step_random_source(seed, 0, i)``, or the attention seeds of
``inputs``' ``attention_seeds[i]`` when given; a rank takes its rows of
the batch (``mesh.shard_batch``). Rank 0 prints one JSON line per run:
the losses, every rank's parameter checksum, the attention kernels'
launches and whether the steps were captured; with ``out``, each rank
writes ``run<i>_rank<r>.pt`` (losses, the last step's gradients and
outputs, the state dict).
"""

from __future__ import annotations

import json
import os
import sys
import contextlib
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from seist_tpu_torch.parallel import dist
from seist_tpu_torch.parallel import mesh as mesh_lib


def global_batches(model: str, window: int, batch: int, steps: int, seed: int):
    """(x, y): ``steps`` seeded global batches of normals and uniform
    targets in the model's loss-target shape."""
    from seist_tpu_torch import taskspec

    rng = np.random.default_rng([seed, batch, steps])
    c_in = taskspec.get_num_inchannels(model)
    x = rng.standard_normal((steps, batch, window, c_in)).astype(np.float32)
    y = rng.uniform(0.0, 1.0, (steps, batch, window, 3)).astype(np.float32)
    return x, y


def run_steps(spec: Dict[str, Any], run: Dict[str, Any], device) -> Dict[str, Any]:
    """One run of the spec (module docstring) on this rank; returns its
    record (losses, checksum, launches, gradients, outputs, state)."""
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.models import api
    from seist_tpu_torch.models.common import RandomSource
    from seist_tpu_torch.ops import pooled_attention as pa
    from seist_tpu_torch.train.graph import capture_train_step
    from seist_tpu_torch.train.optim import build_optimizer
    from seist_tpu_torch.train.schedule import constant
    from seist_tpu_torch.train.step import TrainState, make_train_step, step_random_source

    name, window, seed = spec["model"], int(spec["window"]), int(spec.get("seed", 0))
    mesh = mesh_lib.make_mesh(seq=int(run.get("seq", 1)))
    steps, batch = int(run["steps"]), int(run["global_batch"])
    seeds = None
    if run.get("inputs"):
        with np.load(run["inputs"]) as f:
            x, y = f["x"][:steps], f["y"][:steps]
            seeds = f["attention_seeds"][:steps] if "attention_seeds" in f else None
    else:
        x, y = global_batches(name, window, batch, steps, seed)
    model = api.create_model(name, in_samples=window, seed=seed, **run.get("drop", {}))
    if run.get("weights"):
        model.load_state_dict(torch.load(run["weights"], map_location="cpu"), strict=True)
    model = model.to(device)
    lr = float(run.get("lr", 1e-3))
    state = TrainState(model, build_optimizer("adam", model.parameters()), constant(lr))
    step = make_train_step(taskspec.get_task_spec(name).make_loss(), guard=True)
    step = capture_train_step(step)
    losses, outputs = [], None
    before = pa.counts()
    with mesh_lib.use_mesh(mesh):
        for i in range(steps):
            xi = torch.from_numpy(mesh_lib.shard_batch(mesh, x[i])).to(device)
            yi = torch.from_numpy(mesh_lib.shard_batch(mesh, y[i])).to(device)
            rng = step_random_source(seed, 0, i, device)
            if seeds is not None:
                rng = RandomSource(rng.generator, rng.seed_generator)
                rng.attention_seeds = torch.as_tensor(seeds[i], dtype=torch.int32).to(device)
            loss, outputs, diag = step(state, xi, yi, rng, keep_outputs=True)
            if not bool(diag["applied"]):
                raise RuntimeError(f"step {i} was skipped by the guard (loss {float(loss)})")
            losses.append(float(loss))
    counts = [a - b for a, b in zip(pa.counts(), before)]
    return {
        "seq": mesh.seq, "data": mesh.data, "global_batch": batch, "losses": losses,
        "checksum": dist.checksum(model), "captured": bool(step.graphs.by_key),
        "launches": dict(zip(("K1", "K2", "K1_bf16", "K2_bf16"), counts)),
        "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
        "outputs": outputs.detach().cpu() if torch.is_tensor(outputs) else outputs,
        "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
    }


def flat_tensors(x) -> List[torch.Tensor]:
    """The tensors of nested tuples and lists, in order."""
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flat_tensors(y)]
    return [x]


def ranks_order(ranks: int, batch: int):
    """A stand-in for ``pipeline._epoch_order`` in a one-rank reference of
    a ``data=ranks`` train run: each train batch of ``ranks * batch`` rows
    is the data ranks' batches of ``batch`` side by side (the shards of
    ``_shard_order``), so one rank's global batch holds the rows the ranks
    train on together, in the ranks' order, and each dropout mask's rows
    fall where the ranks' do. Unshuffled (eval) orders pass through."""
    from seist_tpu_torch.data import pipeline

    real = pipeline._epoch_order

    def order(n, *, shuffle, num_shards=1, shard_index=0, **kw):
        if not shuffle or num_shards != 1:
            return real(n, shuffle=shuffle, num_shards=num_shards, shard_index=shard_index, **kw)
        full = real(n, shuffle=shuffle, **kw)
        shards = [pipeline._shard_order(full, ranks, r) for r in range(ranks)]
        steps = len(shards[0]) // batch
        return np.concatenate([shards[r][b * batch:(b + 1) * batch]
                               for b in range(steps) for r in range(ranks)])

    return order


@contextlib.contextmanager
def first_processed_batch() -> Iterator[list]:
    """The train worker's device-augmentation processor wrapped so that
    its first call's outputs are kept (the list yielded gets one list of
    CPU tensors, :func:`flat_tensors` order)."""
    from seist_tpu_torch.train import worker

    kept: list = []
    real = worker.capture_processor

    def keeping(process, device, resident=0):
        run = real(process, device, resident)

        def first(*args):
            out = run(*args)
            if not kept:
                kept.append([t.detach().cpu().clone() for t in flat_tensors(out)])
            return out

        return first

    worker.capture_processor = keeping
    try:
        yield kept
    finally:
        worker.capture_processor = real


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        spec = json.load(f)
    import seist_tpu_torch
    from seist_tpu_torch.serve.pool import resolve_device

    device = resolve_device(spec.get("device", "cuda"))
    started = dist.init_distributed_mode(device=str(device))
    try:
        seist_tpu_torch.load_all()
        device = dist.rank_device(device)
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        for i, run in enumerate(spec["runs"]):
            rec = run_steps(spec, run, device)
            sums = dist.all_gather_object(rec["checksum"])
            if spec.get("out"):
                os.makedirs(spec["out"], exist_ok=True)
                torch.save(rec, os.path.join(spec["out"], f"run{i}_rank{dist.process_index()}.pt"))
            if dist.is_main_process():
                print(json.dumps({"run": i, "ranks": dist.process_count(), "seq": rec["seq"],
                                  "data": rec["data"], "global_batch": rec["global_batch"],
                                  "losses": rec["losses"], "checksums": sums,
                                  "captured": rec["captured"], "launches": rec["launches"]}),
                      flush=True)
    finally:
        if started:
            dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
