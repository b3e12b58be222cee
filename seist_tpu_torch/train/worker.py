"""The training run on one card (counterpart of the single-device path of
``seist_tpu/train/worker.py::train_worker``).

Per epoch: the seeded train loader feeds the guarded train step (loss
logged every ``--log-step`` steps), then the validation loader feeds the
masked eval step; a lower val loss writes the model's ``state_dict`` as
``checkpoints/model_<step>.pt`` under the run's log directory — the file
``serve --model NAME=WEIGHTS.pt`` loads — and ``--patience`` epochs
without improvement stop the run. ``--steps > 0`` overrides ``--epochs``
with the whole epochs that cover it, as the JAX package does.

Not ported: validation metrics and ``--mode test``, rollback after
repeated guard skips, resume from a checkpoint, interval and preemption
saves, and the telemetry plane. The guard only skips.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Iterable, Iterator, List

import numpy as np
import torch

from seist_tpu_torch import taskspec
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.models import api
from seist_tpu_torch.serve.pool import resolve_device
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.schedule import build_cyclic_schedule, constant
from seist_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_train_step,
    move_batch,
    step_random_source,
)
from seist_tpu_torch.utils.logger import logger


def _build_loader(args: Any, spec: taskspec.TaskSpec, mode: str) -> pipeline.Loader:
    sds = pipeline.from_task_spec(
        spec,
        args.dataset_name,
        mode,
        seed=args.seed,
        data_dir=args.data,
        in_samples=args.in_samples,
        augmentation=args.augmentation,
        shuffle=args.shuffle,
        data_split=args.data_split,
        train_size=args.train_size,
        val_size=args.val_size,
        max_event_num=args.max_event_num,
        min_snr=args.min_snr,
        p_position_ratio=args.p_position_ratio,
        coda_ratio=args.coda_ratio,
        norm_mode=args.norm_mode,
        add_event_rate=args.add_event_rate,
        add_noise_rate=args.add_noise_rate,
        add_gap_rate=args.add_gap_rate,
        drop_channel_rate=args.drop_channel_rate,
        scale_amplitude_rate=args.scale_amplitude_rate,
        pre_emphasis_rate=args.pre_emphasis_rate,
        pre_emphasis_ratio=args.pre_emphasis_ratio,
        generate_noise_rate=args.generate_noise_rate,
        shift_event_rate=args.shift_event_rate,
        mask_percent=args.mask_percent,
        noise_percent=args.noise_percent,
        min_event_gap_sec=args.min_event_gap,
        soft_label_shape=args.label_shape,
        label_width=args.label_width,
        dataset_kwargs=args.dataset_kwargs,
    )
    return pipeline.Loader(
        sds,
        batch_size=args.batch_size,
        shuffle=(mode == "train" and args.shuffle),
        drop_last=(mode == "train"),
        num_workers=args.workers,
        seed=args.seed,
    )


def _prefetch(batches: Iterable, depth: int = 2) -> Iterator:
    """Assemble the next ``depth`` batches on a thread while the device
    runs the current step. The loader's exception is re-raised here; a
    consumer that stops early stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for b in batches:
                if not put(b):
                    return
            put(done)
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    t = threading.Thread(target=produce, name="seist-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=30)


def validate(state: TrainState, eval_step, loader: pipeline.Loader, device) -> float:
    """Mean val loss over the real (unpadded) samples."""
    total, count = 0.0, 0
    for batch in loader:
        mask = torch.from_numpy(batch.mask).to(device)
        loss, _ = eval_step(
            state, move_batch(batch.inputs, device), move_batch(batch.loss_targets, device), mask
        )
        valid = int(batch.mask.sum())
        total += float(loss) * max(valid, 1)
        count += max(valid, 1)
    return total / max(count, 1)


def train_worker(args: Any) -> str:
    """The full run; returns the best checkpoint's path."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 training: cuDNN convolutions default to TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    spec = taskspec.get_task_spec(args.model_name)
    loss_fn = spec.loss()

    train_loader = _build_loader(args, spec, "train")
    val_loader = _build_loader(args, spec, "val")
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError("Train split is empty — check data_dir / split sizes")
    epochs = args.epochs
    if args.steps > 0:  # whole epochs that cover --steps
        epochs = max(1, int(np.ceil(args.steps / steps_per_epoch)))
    total_steps = steps_per_epoch * epochs

    in_channels = taskspec.get_num_inchannels(args.model_name)
    model = api.create_model(
        args.model_name, in_channels=in_channels, in_samples=args.in_samples, seed=args.seed
    ).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"{args.model_name} params: {n_params:,} on {device}")
    if args.use_lr_scheduler:
        schedule = build_cyclic_schedule(
            base_lr=args.base_lr,
            max_lr=args.max_lr,
            total_steps=total_steps,
            warmup_steps=args.warmup_steps,
            down_steps=args.down_steps,
            mode=args.lr_scheduler_mode,
        )
    else:
        schedule = constant(args.max_lr)
    optimizer = build_optimizer(
        args.optim, model.parameters(), weight_decay=args.weight_decay, momentum=args.momentum
    )
    state = TrainState(model, optimizer, schedule)
    train_step = make_train_step(loss_fn, guard=args.bad_step_guard)
    eval_step = make_eval_step(loss_fn)

    ckpt_dir = os.path.join(args.log_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    best_loss, best_path, patience = float("inf"), "", 0
    train_losses: List[float] = []
    val_losses: List[float] = []
    skipped = 0
    for epoch in range(args.start_epoch, epochs):
        t_epoch = time.perf_counter()
        train_loader.set_epoch(epoch)
        epoch_losses: List[torch.Tensor] = []
        for step, batch in enumerate(_prefetch(train_loader)):
            rng = step_random_source(args.seed, epoch, state.step, device)
            loss, _, diag = train_step(
                state,
                move_batch(batch.inputs, device),
                move_batch(batch.loss_targets, device),
                rng,
            )
            epoch_losses.append(loss)
            if diag and not diag["applied"]:
                skipped += 1
                logger.warning(
                    f"Bad-update guard skipped step {epoch * steps_per_epoch + step} "
                    f"(loss {float(loss):.4e}, grad-norm {diag['grad_norm']:.4e})"
                )
            if step % args.log_step == 0:
                logger.info(
                    f"{args.model_name}_train epoch {epoch} step {step}/{steps_per_epoch} "
                    f"loss {float(loss):.4e} lr {schedule(max(state.step - 1, 0)):.3e}"
                )
        losses = [float(x) for x in torch.stack(epoch_losses).cpu()]
        train_losses.extend(losses)
        finite = [x for x in losses if np.isfinite(x)]
        epoch_train_loss = float(np.mean(finite)) if finite else 0.0

        val_loss = validate(state, eval_step, val_loader, device)
        val_losses.append(val_loss)
        if val_loss < best_loss:
            best_loss, patience = val_loss, 0
            best_path = os.path.join(ckpt_dir, f"model_{state.step}.pt")
            sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            torch.save(sd, best_path)
            logger.info(f"Best val loss {val_loss:.4e}: saved {best_path}")
        else:
            patience += 1
            if patience > args.patience:
                logger.info(
                    f"Early stopping at epoch {epoch} "
                    f"(no val improvement in {args.patience} epochs)"
                )
                break
        logger.info(
            f"Epoch {epoch}: train-loss {epoch_train_loss:.4e} val-loss {val_loss:.4e} "
            f"best {best_loss:.4e} time {time.perf_counter() - t_epoch:.1f} s"
        )
    if skipped:
        logger.warning(f"Bad-update guard skipped {skipped} non-finite update(s) this run")
    np.save(os.path.join(args.log_dir, "train_losses.npy"), np.asarray(train_losses))
    np.save(os.path.join(args.log_dir, "val_losses.npy"), np.asarray(val_losses))
    train_loader.close()
    val_loader.close()
    return best_path

