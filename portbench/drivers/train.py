"""The training lane: the train entry's captured step on a device-resident
pool of seeded batches.

Set-up builds ONE train state (the configuration's model with the
benchmark's seeded weights, the train entry's default Adam and cyclic
schedule, the guard on) and ONE captured step
(``train/graph.py::capture_train_step(train/step.py::make_train_step)``),
drives it through its first three updates on three distinct batches, and
hands that same state and step to the window. After update 1 it reads
every leaf's first gradient from Adam's first moment (``m = (1 - b1) g``),
after update 3 every leaf's change: the numbers the reference is held to
once the window has closed. Update ``i`` draws its dropout from
``step_random_source(seed, 0, i)``, as the train entry's step ``i`` of
epoch 0 does; the reference redraws the same masks from the same seed.

The window replays the step on the pool's batches in turn, the host at
most two steps ahead of the device, until ``seconds`` have passed; the
rate is every waveform of every update over the window's wall time.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.lib import traffic as gen
from portbench.lib import weights as wlib
from portbench.lib.harness import Check, Outcome, sync
from portbench.reference import train as ref

FIRST_STEPS = 3


def build(ctx, w: Dict[str, torch.Tensor]):
    """The program's train state and captured step, as the train entry
    builds them."""
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.models import api
    from seist_tpu_torch.train import optim
    from seist_tpu_torch.train.graph import capture_train_step
    from seist_tpu_torch.train.schedule import build_cyclic_schedule
    from seist_tpu_torch.train.step import TrainState, make_train_step

    cfg = ctx.config
    kwargs = {k: cfg[k] for k in cfg["program_kwargs"]}
    model = api.create_model(cfg["program_model"], in_channels=cfg["in_channels"],
                             in_samples=cfg["window"], seed=0, **kwargs)
    model.load_state_dict({k: v.cpu() for k, v in w.items()}, strict=True)
    model = model.to(ctx.device)
    s = cfg["schedule"]
    schedule = build_cyclic_schedule(s["base_lr"], s["max_lr"], s["total_steps"],
                                     s["warmup_steps"], s["down_steps"], s["mode"])
    opt = optim.build_optimizer(cfg["optimizer"]["name"], model.parameters(),
                                weight_decay=cfg["optimizer"]["weight_decay"])
    state = TrainState(model, opt, schedule)
    step = capture_train_step(make_train_step(
        taskspec.get_task_spec(cfg["program_model"]).make_loss(), guard=True))
    return state, step


def run(ctx) -> Outcome:
    from seist_tpu_torch.train.step import step_random_source

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if dev.type == "cuda":  # the train entry's precision (train/worker.py)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    batch = int(tr["batch"])
    s_weights, s_traffic, s_steps = gen.sub_seeds(ctx.seed, 3)
    ref_model = ref.build_model(cfg)
    w = wlib.make_weights(ref_model, s_weights, dev)
    names = [n for n, _ in ref_model.named_parameters()]
    del ref_model
    pool = gen.train_pool(s_traffic, tr, cfg["labels"], dev, batch)
    state, step = build(ctx, w)
    params = dict(state.model.named_parameters())
    ordered = [params[n] for n in names]
    start = [p.detach().clone() for p in ordered]

    def rng(i: int):
        return step_random_source(s_steps, 0, i, dev)

    losses: List[torch.Tensor] = []
    grad_norms = None
    b1 = cfg["optimizer"]["b1"]
    for i in range(FIRST_STEPS):
        x, y = pool[i]
        losses.append(step(state, x, y, rng(i))[0])
        if i == 0:
            grad_norms = ref.leaf_norms(
                [state.optimizer.state[p]["exp_avg"] / (1.0 - b1) for p in ordered])
    change_norms = ref.leaf_norms([p - s for p, s in zip(ordered, start)])
    first_losses = [float(v) for v in losses]
    del start
    sync(dev)
    setup_s = time.time() - ctx.t_start

    # The window.
    pending: collections.deque = collections.deque()
    i, n_steps = FIRST_STEPS, 0
    t0 = time.perf_counter()
    while True:
        x, y = pool[i % len(pool)]
        losses.append(step(state, x, y, rng(i))[0])
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
        i += 1
        n_steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    wall = time.perf_counter() - t0
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()

    run_info: Dict[str, Any] = {
        "lane": "train", "wall_s": wall, "steps": n_steps, "batch": batch,
        "waveforms": n_steps * batch, "config": cfg, "peaks": ctx.peaks,
    }
    device: Dict[str, Any] = {}
    if ctx.trace:
        from portbench.lib import trace

        k = [i]

        def one():
            x, y = pool[k[0] % len(pool)]
            step(state, x, y, rng(k[0]))
            k[0] += 1

        calls = int(tr["trace_steps"])
        expect = {p: int(n) for p, n in ctx.spec.get("trace_expect", {}).items()}
        summary = trace.profile_calls(one, calls, lambda: sync(dev), ctx.tmpdir, expect)
        run_info["trace"] = summary
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
    if dev.type == "cuda":
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))

    # The program's state is freed before the reference runs.
    t_check = time.perf_counter()
    del state, step, params, ordered
    batches = [pool[j] for j in range(FIRST_STEPS)]
    del pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prog = {"names": names, "losses": first_losses, "grad_norms": grad_norms,
            "change_norms": change_norms}
    reference = ref.train_steps(cfg, w, batches, draw_seed=s_steps, device=dev)
    limits = ctx.spec["limits"]
    nums = ref.compare(prog, reference, ctx.spec["live_leaf_floor"])
    checks = [Check(k, nums[k], float(v)) for k, v in limits.items()]
    extra: Dict[str, Any] = {"numbers": nums, "check_s": time.perf_counter() - t_check}
    if ctx.readings:
        extra["readings"] = control_readings(ctx, w, batches, s_steps, reference)
    return Outcome(
        attempted=FIRST_STEPS + n_steps, failed=int((~finite).sum()), checks=checks,
        e2e={"setup_s": setup_s, "train_waveforms_per_s": n_steps * batch / wall},
        run=run_info, device=device, extra=extra)


def control_readings(ctx, w, batches, draw_seed, reference) -> Dict[str, Dict[str, float]]:
    """What the control and the planted faults read against the reference
    (``control.py``; the benchmark's own runs do not run this): the
    reference in TF32 in the program's place; the reference with the loss
    averaged over half of each batch. A state left unchanged reads 1 on
    the change by construction."""
    cfg, floor = ctx.config, ctx.spec["live_leaf_floor"]
    out = {"control_tf32": ref.compare(
        ref.train_steps(cfg, w, batches, draw_seed=draw_seed, device=ctx.device,
                        allow_tf32=True), reference, floor)}
    full = ref.loss_fn(cfg)

    def half(p, t):
        n = p.shape[0] // 2
        return full(p[:n], t[:n])

    out["fault_half_batch"] = ref.compare(
        ref.train_steps(cfg, w, batches, draw_seed=draw_seed, device=ctx.device,
                        loss_override=half), reference, floor)
    out["fault_state_unchanged"] = ref.compare(
        {**reference, "change_norms": np.zeros_like(reference["change_norms"])}, reference, floor)
    return out

