"""The training and test runs on one card (counterpart of the
single-device paths of ``seist_tpu/train/worker.py::train_worker`` and
``test_worker``).

Per epoch: the seeded train loader feeds the guarded train step, then
:func:`validate` runs the masked
eval step over the validation split, decodes each batch's outputs and
accumulates the per-task metrics (logged as ``[val] <model> <task>:
...``). A lower val loss writes a checkpoint (``train/checkpoint.py``:
``checkpoints/model_<step>.pt``, the weights ``serve`` and ``--mode test``
load, beside ``state_<step>.pt``); ``--patience`` epochs without
improvement stop the run. ``--steps > 0`` overrides ``--epochs`` with the
whole epochs that cover it, as the JAX package does.

The step: on CUDA every train and eval step runs as a captured CUDA graph
(``train/graph.py``), on the CPU eagerly; neither reads the device back.
A call takes one batch, or a group of k (``--steps-per-call k``: k
updates; ``--grad-accum-steps k``: one update from their mean gradient),
stacked in pinned host memory by the loader's thread
(``pipeline.group_batches``); a tail of fewer than k batches is dropped
and logged. The host reads each call's loss and the guard's verdict two
calls late (:class:`_BadUpdateMonitor`, as the JAX worker does): the loss
lines of every ``--log-step`` calls print then, and the host mirrors the
update count from the verdicts read, from which it keys each update's
randomness (:func:`~seist_tpu_torch.train.step.step_random_source`).
Saves, preemption exits and rollbacks happen at call boundaries.

Fault tolerance: ``--save-interval-steps N`` checkpoints every N batches;
``--checkpoint`` resumes from one at its exact data position (mid-epoch
too), refusing a mid-epoch resume under another seed or batch geometry;
after ``--max-bad-steps`` consecutive updates skipped by the guard the run
rolls back to the latest checkpoint, or raises when there is none; with
the verdicts read two calls late, the rollback lands on the JAX worker's
step. After a skipped update whose verdict is still unread, the next
calls key their randomness by a count one too high (the JAX package
reads the true count on the device): a NaN-free run is not affected.

:func:`test_worker` loads ``--checkpoint``'s weights, runs
:func:`validate` over the test split and writes
``test_results_<split>.csv`` and ``test_metrics_<dataset>.json`` to the
run's log directory without overwriting earlier ones.

Preemption and the data plane: SIGTERM (a cluster manager's notice) only
sets a flag; at the next step boundary, once the step's device work is
done, the run saves ``model_<step>.pt`` and ``state_<step>.pt`` and exits
with :data:`~seist_tpu_torch.train.checkpoint.PREEMPT_EXIT_CODE` (75), for
``python -m seist_tpu_torch supervise`` to relaunch from that checkpoint.
The flag is read before each step's dispatch as well as after it, so a
SIGTERM that arrives while the loop waits for a batch (or the injected
``SEIST_FAULT_SIGTERM_STEP=k``) checkpoints at step k with k updates done;
the JAX package reads it after the step only. A loader death
(``io_guard.LoaderDeathError``) checkpoints the position reached and
exits 75 through ``os._exit``, since wedged pool threads could hang a
normal exit. The stall watchdog (``--data-watchdog-sec``) is armed only
while the loop waits on the prefetch queue: never during a step, a kernel
build or a save. Each epoch logs the quarantine report and the guard's
counters; the test metrics JSON carries them as ``data_plane``. The
``SEIST_FAULT_*`` injector (``utils/faults.py``) fires at step starts.

Device augmentation (``--device-aug step|cached``, ``--ingest``): the
mode is resolved as the JAX worker resolves it (:func:`_resolve_device_aug`,
each fallback one warning). ``step`` feeds raw rows (from a resident
``RawStore``, or straight from a pack's shards) gathered by a thread into
pinned memory; ``cached`` holds the raw epoch on the device and a call
receives only its (k, B) indices, k = ``--steps-per-call`` (auto: min(32,
steps per epoch)). On CUDA the processor (``data/device_aug.py``, whose
draws are the kernel K3) runs as its own captured graph, then the train
step's graph (``train/graph.py``); the randomness of the augmentation is
keyed by (seed, epoch, sample index), that of the step as on the host path.
Saves, preemption and mid-epoch resume work as on the host path.

Telemetry (``obs/``, as ``seist_tpu/train/worker.py:874-912`` sets it
up): a flight recorder of the last ``--flight-steps`` steps, dumped to
``<log dir>/flight/`` on every death path (an uncaught exception, a
rollback, a preemption, the data-plane guard's deaths); ``events.jsonl``;
the metrics bus's spans (``train_epoch``, ``log_interval``, ``host_wait``
around each batch wait, ``step_dispatch`` around each call's dispatch,
``validate``, ``checkpoint_save``) and gauges (``train_loss``,
``waveforms_per_sec``, ``epoch``, ``global_step``, ``val_loss``), served
on ``--metrics-port``; ``--profile-steps N`` captures N steady-state
updates with ``torch.profiler`` from the third call on (after the step's
graph capture), re-armed by SIGUSR2 or ``POST /profile``. None of it reads
the device: the ``step_dispatch`` span times the host's dispatch of an
asynchronous call, and ``train_loss`` is the late-read loss.

Train-time task metrics: on the host path with one batch per update, the
outputs of every ``--log-step`` call are copied on the device (the
captured step's are graph buffers the next replay overwrites), then
decoded (``ops/postprocess.py``) and scored against the batch's metrics
targets when the call's loss is read, two calls late. The per-batch
metrics and their running sum go to the log and to the ``ScalarWriter``
(``--use-tensorboard``: ``train-loss/step``, ``train.<task>.metrics/step``
and the epoch's scalars); ``--steps-per-call`` and ``--grad-accum-steps``
runs log the loss only, as in the JAX package.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import signal
import sys
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from seist_tpu_torch import taskspec
from seist_tpu_torch.data import device_aug as da
from seist_tpu_torch.data import ingest as ingest_lib
from seist_tpu_torch.data import io_guard, pipeline
from seist_tpu_torch.models import api
from seist_tpu_torch.ops.metrics import Metrics
from seist_tpu_torch.ops.postprocess import process_outputs
from seist_tpu_torch.ops.results import ResultSaver
from seist_tpu_torch.serve.pool import resolve_device
from seist_tpu_torch.train.checkpoint import (
    PREEMPT_EXIT_CODE,
    CheckpointManager,
    load_checkpoint,
    load_weights,
)
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.schedule import build_cyclic_schedule, constant
from seist_tpu_torch.train.graph import (
    capture_accum_step,
    capture_eval_step,
    capture_processor,
    capture_train_step,
)
from seist_tpu_torch.train.step import (
    TrainState,
    make_cached_train_call,
    make_device_aug_train_step,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
    move_batch,
    step_random_source,
)
from seist_tpu_torch import obs
from seist_tpu_torch.utils import faults as faults_lib
from seist_tpu_torch.utils import logger as logger_mod
from seist_tpu_torch.utils import profiling
from seist_tpu_torch.utils.logger import logger
from seist_tpu_torch.utils.misc import get_safe_path
from seist_tpu_torch.utils.tb import ScalarWriter


class _PreemptionHandler:
    """SIGTERM -> checkpoint at the next step boundary -> exit 75.

    The handler only sets a flag; the train loop reads it between steps.
    A context manager; outside the main thread (a test driving the worker
    from a thread) no handler can be installed and it stays inert."""

    def __init__(self):
        self.triggered = False
        self._prev = None
        self._installed = False

    def __enter__(self) -> "_PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            def _on_term(signum, frame):
                self.triggered = True
                logger.warning(
                    "SIGTERM received: will checkpoint at the next step "
                    f"boundary and exit {PREEMPT_EXIT_CODE}"
                )

            self._prev = signal.signal(signal.SIGTERM, _on_term)
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False


class _BadUpdateMonitor:
    """Host-side tracking of consecutive updates skipped by the guard
    (``seist_tpu/train/worker.py::_BadUpdateMonitor``).

    Reading a step's verdict at once would make the host wait for the
    device after every step, so verdicts are read ``lag`` calls late: by
    then the device has long finished that step and the read costs
    nothing. The rollback decision therefore comes at most ``lag`` calls
    late; the guard already kept every skipped update off the parameters.
    :attr:`total_skipped` counts the skips of the verdicts read so far, from
    which the host mirrors the update count."""

    def __init__(self, max_bad: int, lag: int = 2):
        self.max_bad = int(max_bad)
        self.lag = max(0, int(lag))
        self.bad_run = 0  # consecutive skipped updates at the tail
        self.total_skipped = 0
        self._pending: "collections.deque" = collections.deque()

    def push(self, applied_dev) -> bool:
        """Queue one call's verdict (a scalar, or the ordered (k,) mask of a
        call of k updates); returns True when the consecutive-bad run has
        reached ``max_bad`` (rollback needed)."""
        self._pending.append(applied_dev)
        while len(self._pending) > self.lag:
            self._eval(self._pending.popleft())
        return self.exceeded

    def flush(self) -> bool:
        while self._pending:
            self._eval(self._pending.popleft())
        return self.exceeded

    def reset(self) -> None:
        self.bad_run = 0
        self._pending.clear()

    @property
    def exceeded(self) -> bool:
        return bool(self.max_bad) and self.bad_run >= self.max_bad

    def _eval(self, applied_dev) -> None:
        if torch.is_tensor(applied_dev):
            applied_dev = applied_dev.cpu().numpy()
        mask = np.atleast_1d(np.asarray(applied_dev)).astype(np.int64)
        skipped = int(mask.size - mask.sum())
        self.total_skipped += skipped
        if skipped == 0:
            self.bad_run = 0
        else:
            # Only the trailing skips extend a consecutive run: a call that
            # ends in an applied update breaks the run.
            trailing = 0
            for v in mask[::-1]:
                if v:
                    break
                trailing += 1
            self.bad_run = self.bad_run + trailing if trailing == mask.size else trailing
            logger.warning(
                f"Bad-update guard: skipped {skipped} non-finite update(s) "
                f"(consecutive run: {self.bad_run})"
            )


def _mixture_temperature(args: Any, mode: str) -> float:
    """--mixture-temperature applies to TRAIN sampling only: evaluation
    walks every split plainly, so its metrics stay comparable."""
    return float(args.mixture_temperature or 0.0) if mode == "train" else 0.0


def _start_watchdog(args: Any) -> Optional[io_guard.StallWatchdog]:
    timeout = float(args.data_watchdog_sec or 0.0)
    return io_guard.StallWatchdog(timeout).start() if timeout > 0 else None


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
        max_quarantine_frac=float(args.max_quarantine_frac),
    )
    return pipeline.Loader(
        sds,
        batch_size=args.batch_size,
        shuffle=(mode == "train" and args.shuffle),
        drop_last=(mode == "train"),
        num_workers=args.workers,
        # Processes only where throughput matters: a second resident pool,
        # each child holding the dataset, is memory cost for the short
        # eval passes.
        worker_processes=int(args.loader_processes or 0) if mode == "train" else 0,
        seed=args.seed,
        mixture_temperature=_mixture_temperature(args, mode),
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


def _make_metrics(args: Any, tasks: List[str], fs: int) -> Dict[str, Metrics]:
    return {
        task: Metrics(
            task=task,
            metric_names=taskspec.get_metrics(task),
            sampling_rate=fs,
            time_threshold=args.time_threshold,
            num_samples=args.in_samples,
        )
        for task in tasks
    }


def _postprocess_batch(args: Any, spec: taskspec.TaskSpec, outputs, fs: int):
    if spec.outputs_transform_for_results is not None:
        outputs = spec.outputs_transform_for_results(outputs)
    return process_outputs(
        outputs,
        spec.labels,
        sampling_rate=fs,
        ppk_threshold=args.ppk_threshold,
        spk_threshold=args.spk_threshold,
        det_threshold=args.det_threshold,
        min_peak_dist=args.min_peak_dist,
        max_detect_event_num=args.max_detect_event_num,
    )


def _update_task_metrics(metrics_merged: Dict[str, Metrics], batch_metrics: Dict[str, Metrics],
                         results: Dict[str, Any], metrics_targets: Dict[str, np.ndarray],
                         valid: int) -> None:
    """Score one batch into fresh per-batch metrics and add them to the
    running ones (``seist_tpu/train/worker.py::_update_task_metrics``);
    ``valid`` trims padding rows."""
    for task, m in batch_metrics.items():
        prd = results[task][:valid]
        if prd.ndim < 2:
            prd = prd[:, None]
        m.compute(metrics_targets[task][:valid], prd)
        metrics_merged[task].add(m)


#: Teardown callbacks of the running train worker (its telemetry plane),
#: drained on every way out of it (:func:`_dump_flight_on_exception`).
_OBS_CLEANUP: List[Any] = []


def _dump_flight_on_exception(fn):
    """An uncaught exception out of the wrapped worker leaves a flight
    dump (reason ``exception``, deduplicated against a managed death that
    dumped seconds before) before it propagates; every exit, exceptions
    and ``SystemExit`` included, tears the telemetry plane down, so a
    crashed run leaks no metrics port, events file or SIGUSR2 handler into
    the process's next run."""
    import functools

    @functools.wraps(fn)
    def wrapper(*a, **k):
        try:
            return fn(*a, **k)
        except Exception as e:
            obs.flight.dump_on_death("exception", dedup_s=5.0, error=repr(e))
            raise
        finally:
            while _OBS_CLEANUP:
                cb = _OBS_CLEANUP.pop()
                try:
                    cb()
                except Exception:  # noqa: BLE001 - must not mask the exception propagating
                    pass

    return wrapper


def validate(
    args: Any,
    state: TrainState,
    eval_step,
    spec: taskspec.TaskSpec,
    loader: pipeline.Loader,
    device: torch.device,
    *,
    testing: bool = False,
    save_results: bool = False,
    watchdog: Optional[io_guard.StallWatchdog] = None,
) -> Tuple[float, Dict[str, Metrics]]:
    """Mean loss over the real (unpadded) samples and the per-task metrics
    of the decoded outputs, trimmed to those samples; at test time,
    optionally the results CSV in ``args.log_dir``. ``watchdog`` is armed
    while the loop waits for a batch."""
    tasks = list(spec.eval)
    fs = loader.dataset.sampling_rate()
    metrics = _make_metrics(args, tasks, fs)
    saver = ResultSaver(item_names=tasks) if save_results else None
    total, count = 0.0, 0
    for batch in io_guard.watch(_prefetch(loader), watchdog):
        mask = torch.from_numpy(batch.mask).to(device)
        loss, outputs = eval_step(
            state, move_batch(batch.inputs, device), move_batch(batch.loss_targets, device), mask
        )
        valid = int(batch.mask.sum())
        total += float(loss) * max(valid, 1)  # one host read per batch, as the JAX package
        count += max(valid, 1)
        results = _postprocess_batch(args, spec, outputs, fs)
        for task, m in metrics.items():
            prd = results[task][:valid]
            m.compute(batch.metrics_targets[task][:valid], prd if prd.dim() >= 2 else prd[:, None])
        if saver is not None:
            metas = [json.loads(m) for m in batch.meta[:valid]]
            meta_cols = {k: [m[k] for m in metas] for k in metas[0]} if metas else {}
            saver.append(
                meta_cols,
                {t: batch.metrics_targets[t][:valid] for t in tasks},
                {t: results[t][:valid] for t in tasks},
            )
    if saver is not None:
        out_csv = get_safe_path(
            os.path.join(args.log_dir, f"test_results_{loader.dataset.name()}.csv")
        )
        saver.save_as_csv(out_csv)
        logger.info(f"Test results saved: {out_csv}")
    phase = "test" if testing else "val"
    for task, m in metrics.items():
        logger.info(f"[{phase}] {args.model_name} {task}: {m}")
    return total / max(count, 1), metrics


def _first(tree):
    """Batch 0 of a group of one (``pipeline.group_batches``)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_first(t) for t in tree)
    return tree[0]


def _disable_tf32(device: torch.device) -> None:
    if device.type == "cuda":
        # fp32 products stay fp32: cuDNN convolutions default to TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _l1_terms(args: Any) -> List[Tuple[float, Any]]:
    """``--conv-kernel-l1-alpha`` / ``--conv-bias-l1-alpha`` as the train
    state's L1 terms: EQTransformer's encoder and decoder convs
    (``models/eqtransformer.py::l1_param_mask``); any other model raises,
    as the JAX worker does (``seist_tpu/train/worker.py:495-508``)."""
    alphas = ((float(args.conv_kernel_l1_alpha), "kernel"),
              (float(args.conv_bias_l1_alpha), "bias"))
    if not any(alpha for alpha, _ in alphas):
        return []
    if args.model_name != "eqtransformer":
        raise ValueError(
            "--conv-{kernel,bias}-l1-alpha apply only to eqtransformer "
            f"(got --model-name {args.model_name})"
        )
    from seist_tpu_torch.models.eqtransformer import l1_param_mask

    return [(alpha, l1_param_mask(kind)) for alpha, kind in alphas if alpha]


def _resolve_device_aug(args: Any, sds: pipeline.SeismicDataset, device: torch.device,
                        gas: int, spc: int) -> Tuple[str, Optional[pipeline.RawStore], int]:
    """``--device-aug`` and ``--ingest`` resolved as the JAX worker resolves
    them (``seist_tpu/train/worker.py:589-715``): an unsupported
    configuration falls back to the host path ('off'), a 'cached' epoch over
    the memory budget to 'step', and ``--ingest auto`` on a pack takes the
    direct shard feed; each fallback logs one warning. Returns (mode, the
    raw store or None, steps per call)."""
    device_req, ingest_req = args.device_aug, args.ingest
    if ingest_req == "direct" and device_req == "off":
        raise ValueError("--ingest direct feeds the device-aug step path; run with "
                         "--device-aug step")
    if device_req == "off":
        return "off", None, spc
    if gas > 1:
        raise ValueError("--device-aug is incompatible with --grad-accum-steps (accumulation "
                         "stacks host batches)")
    reasons = da.unsupported_reasons(sds.preprocessor, sds.input_names, sds.label_names)
    budget = da.hbm_budget_bytes(float(args.device_aug_hbm_gb or 0.0), device)
    est = 0
    if not reasons:
        try:
            est = pipeline.RawStore.estimate_bytes(sds)
        except ValueError as e:  # a corrupt probe sample: the host path quarantines it
            reasons = [str(e)]
    mode, why = da.select_device_aug_mode(device_req, est, budget, reasons)
    if mode != device_req:
        logger.warning(f"--device-aug {device_req} -> {mode}: {why}")
    if ingest_req == "direct" and mode != "step":
        raise ValueError(f"--ingest direct requires the device-aug step path; the run resolved "
                         f"--device-aug to '{mode}' ({why})")
    store = None
    if mode != "off":
        # The cached mode keeps the RawStore: its point is residency.
        direct = mode == "step" and ingest_req != "host" and (
            ingest_req == "direct" or ingest_lib.packed_dataset_of(sds) is not None)
        if direct:
            try:
                store = ingest_lib.PackedRawStore.build(
                    sds, batch_size=args.batch_size, reuse_staging=device.type == "cuda")
                logger.info(ingest_lib.describe(store))
            except ValueError as e:
                if ingest_req == "direct":
                    raise
                logger.warning(f"packed direct ingest unavailable ({e}); uploading a resident "
                               "RawStore instead")
                direct = False
        if not direct:
            try:
                store = pipeline.RawStore.build(sds)
            except ValueError as e:
                logger.warning(f"--device-aug {mode} -> off: {e}")
                mode = "off"
    if mode == "step" and spc > 1:
        # An explicit 'step' with packing is a configuration error; a
        # 'cached' request that fell back to 'step' drops its packing.
        if device_req == "step":
            raise ValueError("--steps-per-call > 1 requires --device-aug cached (the step mode "
                             "feeds one raw batch per call)")
        logger.warning(f"--steps-per-call {spc} ignored on the device-aug step fallback path")
        spc = 1
    if mode != "off" and faults_lib.FaultInjector.from_env().plan.nan_step >= 0:
        raise ValueError("SEIST_FAULT_NAN_STEP corrupts host-fed input batches, which the "
                         "device-aug paths never make; use --device-aug off for NaN-injection "
                         "runs (SIGTERM, kill and slow faults work on every path)")
    return mode, (store if mode != "off" else None), spc


@_dump_flight_on_exception
def train_worker(args: Any) -> str:
    """The full run; returns the best checkpoint's weights path."""
    logger_mod.set_logdir(args.log_dir)
    device = resolve_device(args.device)
    _disable_tf32(device)
    spec = taskspec.get_task_spec(args.model_name)
    loss_fn = spec.make_loss()
    l1 = _l1_terms(args)

    train_loader = _build_loader(args, spec, "train")
    val_loader = _build_loader(args, spec, "val")
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise ValueError("Train split is empty — check data_dir / split sizes")
    epochs = args.epochs
    if args.steps > 0:  # whole epochs that cover --steps
        epochs = max(1, int(np.ceil(args.steps / steps_per_epoch)))
    total_steps = steps_per_epoch * epochs
    # Gradient accumulation: k loader batches -> ONE update; the count, and
    # the schedule that follows it, counts updates.
    gas = max(1, int(args.grad_accum_steps or 1))
    # 0 (the default) means "auto": 1, or min(32, steps per epoch) under
    # --device-aug cached, where no host work is left to overlap.
    spc_auto = int(args.steps_per_call or 0) <= 0
    spc = max(1, int(args.steps_per_call or 0))
    if spc > 1 and gas > 1:
        raise ValueError(
            "--steps-per-call and --grad-accum-steps are mutually exclusive (both "
            "consume stacked micro-batches, with different update semantics)"
        )
    sds_train = train_loader.dataset
    device_mode, dev_store, spc = _resolve_device_aug(args, sds_train, device, gas, spc)
    if device_mode == "cached" and spc_auto:
        spc = max(1, min(32, steps_per_epoch))
    if gas > 1:
        if steps_per_epoch // gas == 0:
            raise ValueError(
                f"--grad-accum-steps {gas} exceeds steps_per_epoch {steps_per_epoch}: "
                "every epoch would apply ZERO updates"
            )
        total_steps = (steps_per_epoch // gas) * epochs
    if spc > 1 and steps_per_epoch // spc == 0:
        raise ValueError(
            f"--steps-per-call {spc} exceeds steps_per_epoch {steps_per_epoch}: every "
            "epoch would train ZERO steps (trailing part-groups are dropped)"
        )
    kpack = gas if gas > 1 else spc  # loader batches per call
    updates_per_call = 1 if gas > 1 else spc

    in_channels = taskspec.get_num_inchannels(args.model_name)
    model = api.create_model(
        args.model_name, in_channels=in_channels, in_samples=args.in_samples, seed=args.seed
    ).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"{args.model_name} params: {n_params:,} on {device}, compute {args.dtype}")
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
    state = TrainState(model, optimizer, schedule, l1=l1)
    guard = bool(args.bad_step_guard)
    # On CUDA each step is a captured graph (train/graph.py); on the CPU
    # the same functions run eagerly.
    if gas > 1:
        if steps_per_epoch % gas:
            logger.warning(f"grad_accum_steps={gas} drops {steps_per_epoch % gas} trailing "
                           f"batch(es) per epoch ({steps_per_epoch} steps)")
        train_call = capture_accum_step(loss_fn, gas, guard=guard, compute_dtype=args.dtype)
        logger.info(f"grad_accum_steps={gas}: effective batch {args.batch_size * gas}, "
                    f"{steps_per_epoch // gas} updates/epoch")
    else:
        if spc > 1 and steps_per_epoch % spc:
            logger.warning(f"steps_per_call={spc} drops {steps_per_epoch % spc} trailing "
                           f"batch(es) per epoch ({steps_per_epoch} steps)")
        single = capture_train_step(make_train_step(loss_fn, guard=guard,
                                                    compute_dtype=args.dtype))
        if device_mode == "off":
            train_call = make_multi_train_step(loss_fn, spc, guard=guard,
                                               compute_dtype=args.dtype, step=single)
            if spc > 1:
                logger.info(f"steps_per_call={spc}: {spc} updates per call")
        else:
            cfg = da.AugConfig.from_preprocessor(sds_train.preprocessor, seed=args.seed,
                                                 raw_len=dev_store.raw_len,
                                                 phase_slots=dev_store.phase_slots)
            names = (cfg, sds_train.input_names, sds_train.label_names)
        if device_mode == "cached":
            dev_cache = pipeline.DeviceEpochCache(dev_store, device)
            logger.info(f"device-aug cached: {len(dev_store)} epoch samples resident "
                        f"({dev_cache.nbytes / 2**20:.1f} MiB on {device}), steps_per_call={spc}")
            process = capture_processor(
                da.make_cache_processor(*names, n_raw=dev_store.n_raw,
                                        augmentation=dev_store.augmentation),
                device, resident=1)
            train_call = make_cached_train_call(loss_fn, process, spc, guard=guard, step=single)
        elif device_mode == "step":
            logger.info("device-aug step: augmentation + labels inside the step on "
                        f"{device}; host feeds raw rows only")
            process = capture_processor(da.make_row_processor(*names), device)
            train_call = make_device_aug_train_step(loss_fn, process, guard=guard, step=single)
    eval_step = capture_eval_step(make_eval_step(loss_fn, compute_dtype=args.dtype))

    ckpt_mgr = CheckpointManager(
        os.path.join(args.log_dir, "checkpoints"), keep_last=args.keep_checkpoints
    )
    best_loss, best_path, patience = float("inf"), "", 0
    start_epoch, start_batch = args.start_epoch, 0
    if args.checkpoint:
        record = load_checkpoint(args.checkpoint, state)
        meta = record["meta"]
        if record["weights_only"]:
            # The JAX package's params-only restore: meta epoch -1, so the run
            # starts at epoch 0, batch 0, with the fresh optimizer.
            start_epoch, start_batch = int(meta["epoch"]) + 1, 0
        else:
            start_epoch, start_batch = int(meta["data_epoch"]), int(meta["data_batch_offset"])
        if start_batch >= steps_per_epoch:
            start_epoch, start_batch = start_epoch + 1, 0
        # The offset is expressed in the saving run's (seed, batch geometry):
        # resuming mid-epoch under another would replay some samples and
        # skip others. (The JAX package reads a saved 0 as "not recorded",
        # so it lets a run saved with seed 0 resume under any seed; the
        # port's checkpoints always record all three.)
        for field, current in (
            ("seed", int(args.seed)),
            ("steps_per_epoch", steps_per_epoch),
            ("batch_size", int(args.batch_size)),
        ):
            saved = int(meta.get(field, current))
            if saved == current:
                continue
            if start_batch > 0:
                raise ValueError(
                    f"{field} {current} does not match the checkpoint's {field} {saved}; "
                    f"a mid-epoch resume (batch offset {start_batch}) would replay/skip "
                    f"data. Relaunch with the original {field}."
                )
            logger.warning(
                f"{field} {current} differs from the checkpoint's {saved}: epoch "
                "boundaries/shuffles will not match the original run"
            )
        best_loss, patience = float(record["best_loss"]), int(record["patience"])
        if ckpt_mgr.best_step is not None:
            best_path = ckpt_mgr.step_path(ckpt_mgr.best_step)
        logger.info(
            f"Resumed from {args.checkpoint} (epoch {start_epoch}, batch offset "
            f"{start_batch}, loss {float(meta['loss']):.4f}, update step {state.step})"
        )
        resume_at = start_epoch * steps_per_epoch + start_batch
        ahead = [s for s in ckpt_mgr.all_steps() if s > resume_at]
        if ahead:
            logger.warning(
                f"Checkpoint dir has steps {ahead} ahead of the resume position "
                f"({resume_at}); this run's saves at those steps replace them"
            )

    save_every = int(args.save_interval_steps)
    max_bad = int(args.max_bad_steps)
    faults = faults_lib.FaultInjector.from_env()
    if faults.enabled:
        logger.warning(f"Fault injection ACTIVE: {faults.plan}")
    watchdog = _start_watchdog(args)

    # -- the telemetry plane (module docstring) ---------------------------
    fsteps = int(getattr(args, "flight_steps", 0) or 0)
    recorder = obs.FlightRecorder(capacity=fsteps if fsteps > 0 else 256)
    obs.flight.install(recorder)
    obs.register_default_collectors()
    events = obs.EventLog(os.path.join(args.log_dir, "events.jsonl"))
    writer = (ScalarWriter(os.path.join(args.log_dir, "tensorboard"))
              if getattr(args, "use_tensorboard", False) else None)
    # --metrics-port: > 0 binds that loopback port, -1 an ephemeral one
    # (logged), 0 none.
    profile_trigger = obs.ProfileTrigger()
    mport = int(getattr(args, "metrics_port", 0) or 0)
    metrics_server = (obs.start_metrics_server(mport, profile_trigger=profile_trigger)
                      if mport else None)
    prev_usr2 = None
    if threading.current_thread() is threading.main_thread() and hasattr(signal, "SIGUSR2"):
        def _on_usr2(signum, frame):
            # The trigger is lock-free: the interrupted thread may be inside
            # its consume().
            profile_trigger.request()
            logger.info("[obs] SIGUSR2: profiler capture requested "
                        f"({obs.http.DEFAULT_PROFILE_STEPS} steps)")

        prev_usr2 = signal.signal(signal.SIGUSR2, _on_usr2)
    obs_closed = [False]

    def obs_close() -> None:
        """Tear the telemetry plane down (idempotent): uninstalling the
        recorder unhooks its span sink, so runs in one process never stack
        sinks."""
        if obs_closed[0]:
            return
        obs_closed[0] = True
        if profiling.active():
            profiling.trace_stop()
        obs.flight.install(None)
        events.close()
        if writer is not None:
            writer.close()
        if metrics_server is not None:
            metrics_server.shutdown()
            metrics_server.server_close()
        if prev_usr2 is not None:
            try:
                signal.signal(signal.SIGUSR2, prev_usr2)
            except ValueError:  # not the main thread any more
                pass

    _OBS_CLEANUP.append(obs_close)

    def emit_event(kind: str, **fields) -> None:
        recorder.record_event(kind, **fields)
        events.emit(kind, **fields)

    def save(gstep: int, epoch: int, batches_done: int, val_loss: Optional[float] = None) -> str:
        """Checkpoint at global batch ``gstep``; the data position saved is
        the NEXT batch to consume."""
        if batches_done >= steps_per_epoch:
            d_epoch, d_off = epoch + 1, 0
        else:
            d_epoch, d_off = epoch, batches_done
        with obs.BUS.span("checkpoint_save"):
            return ckpt_mgr.save(
                gstep, state, epoch=epoch, data_epoch=d_epoch, data_batch_offset=d_off,
                seed=args.seed, steps_per_epoch=steps_per_epoch,
                batch_size=int(args.batch_size), val_loss=val_loss, best_loss=best_loss,
                patience=patience,
            )

    def preempt_exit(epoch: int, batches_done: int, hard: bool = False) -> None:
        """Make the checkpoint of the position reached durable, then exit
        75. ``hard`` (a loader death) ends in ``os._exit``: the loader's
        pool threads are not daemons, and one wedged in a dead read would
        hang ``sys.exit``; the watchdog stays armed in case the save
        wedges too."""
        if watchdog is not None and not hard:
            watchdog.stop()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gstep = epoch * steps_per_epoch + batches_done
        path = save(gstep, epoch, batches_done)
        logger.warning(f"Preempted: checkpoint step {gstep} durable ({path}); "
                       f"exiting {PREEMPT_EXIT_CODE}")
        emit_event("preempt", gstep=int(gstep), hard=bool(hard))
        obs.flight.dump_on_death("preempt", gstep=int(gstep))
        obs_close()
        if hard:
            io_guard.hard_exit(PREEMPT_EXIT_CODE)
        sys.exit(PREEMPT_EXIT_CODE)

    def loader_death_exit(e: io_guard.LoaderDeathError, epoch: int, batches_done: int) -> None:
        """The device and the weights are healthy: checkpoint and exit 75
        so a relaunch starts with a fresh data plane."""
        logger.error(f"Loader worker death: {e}; dumping thread stacks and "
                     "preempt-exiting for supervised relaunch")
        io_guard.dump_thread_stacks()
        if watchdog is not None:
            watchdog.arm()  # the escalation if the save below hangs
        preempt_exit(epoch, batches_done, hard=True)

    train_losses: List[float] = []
    val_losses: List[float] = []
    monitor = _BadUpdateMonitor(max_bad if guard else 0)
    # The host's mirror of the update count, which keys each update's
    # randomness: the count at the last read, plus the updates dispatched
    # since, less the skips among them whose verdicts have been read.
    mirror = {"base": state.step, "dispatched": 0, "skipped": 0}

    def next_count() -> int:
        return (mirror["base"] + mirror["dispatched"]
                - (monitor.total_skipped - mirror["skipped"]))

    def rollback() -> None:
        step_r = ckpt_mgr.latest_step()
        if step_r is None:
            raise RuntimeError(
                f"{monitor.bad_run} consecutive non-finite updates and no checkpoint to "
                "roll back to — aborting (enable --save-interval-steps for rollback coverage)"
            )
        logger.warning(
            f"Bad-update guard: {monitor.bad_run} consecutive non-finite updates; "
            f"rolling back to checkpoint step {step_r}"
        )
        # The run goes on, but the steps into the rollback are what a
        # post-mortem wants; the dump is not fatal, so it arms no dedup that
        # could swallow the record of a crash seconds later.
        emit_event("bad_update_rollback", rollback_to_step=int(step_r),
                    consecutive_bad=int(monitor.bad_run))
        obs.flight.dump_on_death("bad_update_rollback", arm_dedup=False,
                                 rollback_to_step=int(step_r))
        ckpt_mgr.restore(state, step_r)
        monitor.reset()
        mirror.update(base=state.step, dispatched=0, skipped=monitor.total_skipped)

    def random_sources(epoch: int):
        """The call's randomness: update j's (seed, epoch, count + j), or
        micro-batch i's (seed, epoch, count, i) of an accumulated update."""
        count = next_count()
        if gas > 1:
            return [step_random_source(args.seed, epoch, count, device, micro=i)
                    for i in range(gas)]
        rngs = [step_random_source(args.seed, epoch, count + j, device) for j in range(spc)]
        return rngs if spc > 1 else rngs[0]

    pin = device.type == "cuda"
    mixture_t = _mixture_temperature(args, "train")
    src_ids = sds_train.source_ids() if mixture_t > 0 else None
    # Train-time task metrics need each update's outputs and the host
    # batch's metrics targets: the host path with one batch per call.
    task_metrics = device_mode == "off" and kpack == 1
    tasks = list(spec.eval)
    fs = sds_train.sampling_rate()

    def epoch_calls(epoch: int, skip: int, on_death):
        """The epoch's calls from batch ``skip`` on: an iterator of what
        each call consumes, and ``dispatch(item, gstep, rngs, keep)``
        running the call (``keep``: return a copy of the step's outputs).
        Host path: stacked loader batches (the NaN injector corrupts them)
        with the metrics targets of each. Step mode: raw rows gathered by a
        thread, copied to pinned memory, two batches ahead. Cached mode:
        (k, B) index arrays."""
        epoch_t = torch.tensor(epoch, dtype=torch.int32)
        order = dict(seed=args.seed, shuffle=args.shuffle, batch_size=args.batch_size,
                     start_batch=skip, source_ids=src_ids, mixture_temperature=mixture_t)
        if device_mode == "cached":
            chunks = dev_cache.epoch_index_chunks(epoch, steps_per_call=kpack, **order)
            items = (torch.from_numpy(c).pin_memory() if pin else torch.from_numpy(c)
                     for c in chunks)
            return items, lambda idx_k, gstep, rngs, keep: train_call(
                state, dev_cache.arrays, idx_k, epoch_t, rngs)
        if device_mode == "step":
            raw = pipeline.iter_raw_batches(dev_store, epoch, **order)
            items = _prefetch(pipeline.raw_batch_tensors(item, pin) for item in raw)
            return io_guard.watch(items, watchdog), lambda item, gstep, rngs, keep: train_call(
                state, *item, epoch_t, rngs)

        def host(item, gstep, rngs, keep):
            (xk, yk), _ = item
            xk = faults.corrupt_inputs(gstep, xk, n_steps=kpack)
            if kpack > 1:
                return train_call(state, xk, yk, rngs)
            return train_call(state, _first(xk), _first(yk), rngs, keep_outputs=keep)

        def with_targets():
            """The loader's groups, each with its batches' metrics targets
            (read on the prefetch thread, in the order the groups form)."""
            targets: "collections.deque" = collections.deque()

            def noted(batches):
                for b in batches:
                    targets.append(b.metrics_targets)
                    yield b

            for group in pipeline.group_batches(noted(train_loader), kpack, pin=pin):
                yield group, [targets.popleft() for _ in range(kpack)]

        return io_guard.watch(_prefetch(with_targets()), watchdog, on_death=on_death), host

    # --profile-steps N: torch.profiler over N steady-state updates from the
    # third call on, after the step's graph capture; SIGUSR2 and POST
    # /profile re-arm it. Counted in updates (a call makes updates_per_call).
    profile_steps = int(getattr(args, "profile_steps", 0) or 0)
    profile_from = 2 * updates_per_call
    trace_dir = ""

    def maybe_trace(opt_step: int) -> None:
        """After a call's dispatch; ``opt_step``: the updates before it."""
        nonlocal profile_steps, profile_from, trace_dir
        if not profiling.active():
            # A request that lands mid-capture waits in the trigger and
            # opens its own window once this one closes.
            req = profile_trigger.consume()
            if req:
                profile_steps, profile_from = req, opt_step + updates_per_call
                emit_event("profile_requested", steps=req)
        if not profile_steps:
            return
        if not profiling.active() and opt_step >= profile_from:
            trace_dir = get_safe_path(os.path.join(
                args.log_dir, "profile", f"{time.strftime('%Y%m%d-%H%M%S')}_p{os.getpid()}"))
            profiling.trace_start(trace_dir)
        elif profiling.active() and opt_step >= profile_from + profile_steps:
            profiling.trace_stop()
            profile_steps = 0  # one-shot; the trigger re-arms it
            logger.info(f"Profiler trace saved: {trace_dir}")

    # Bus handles resolved once: a gauge set per call is one lock.
    g_loss = obs.BUS.gauge("train_loss")
    g_wps = obs.BUS.gauge("waveforms_per_sec")
    g_epoch = obs.BUS.gauge("epoch")
    g_gstep = obs.BUS.gauge("global_step")

    preempt = _PreemptionHandler().__enter__()
    try:
        for epoch in range(start_epoch, epochs):
            t_epoch = time.perf_counter()
            epoch_span = obs.BUS.begin("train_epoch")
            g_epoch.set(epoch)
            train_loader.set_epoch(epoch)
            skip = start_batch if epoch == start_epoch else 0
            if skip and skip % kpack:
                # A checkpoint of the single-step path may sit off a call
                # boundary of the grouped paths.
                logger.warning(
                    f"Resume offset {skip} is not a multiple of the packed group {kpack}; "
                    f"rounding down (re-trains {skip % kpack} batch(es))"
                )
                skip -= skip % kpack
            if skip:
                if device_mode == "off":
                    train_loader.set_start_batch(skip)
                logger.info(f"Mid-epoch resume: epoch {epoch} from batch {skip}")
            epoch_losses: List[torch.Tensor] = []
            late_logs: "collections.deque" = collections.deque()
            metrics_merged = _make_metrics(args, tasks, fs)
            batches_done = skip
            rate_span = obs.BUS.begin("log_interval")

            def on_death(e: io_guard.LoaderDeathError) -> None:
                loader_death_exit(e, epoch, batches_done)

            def log_late(upto: Optional[int]) -> None:
                """Print the loss lines (and score the task metrics) of calls
                before ``upto`` (all when None): their losses are read once
                the device is past them."""
                while late_logs and (upto is None or late_logs[0][0] < upto):
                    _, prefix, gstep_l, loss_t, lr, outputs, targets = late_logs.popleft()
                    loss_f = float(loss_t)
                    g_loss.set(loss_f)
                    logger.info(f"{prefix} loss {loss_f:.4e} lr {lr:.3e}")
                    if writer is not None:
                        writer.add_scalar("train-loss/step", loss_f, gstep_l)
                    if outputs is None:
                        continue
                    batch_metrics = _make_metrics(args, tasks, fs)
                    _update_task_metrics(metrics_merged, batch_metrics,
                                         _postprocess_batch(args, spec, outputs, fs), targets,
                                         args.batch_size)
                    for task, m in batch_metrics.items():
                        logger.info(f"{prefix} [train] {task}: {m}")
                        if writer is not None:
                            writer.add_scalars(f"train.{task}.metrics/step",
                                               m.get_all_metrics(), gstep_l)

            calls, dispatch = epoch_calls(epoch, skip, on_death)
            for call, item in enumerate(obs.timed_iter(calls, "host_wait"), start=skip // kpack):
                first_b = call * kpack
                gstep = epoch * steps_per_epoch + first_b
                log_call = call % args.log_step == 0
                recorder.record_step(gstep)  # before this call's spans end
                g_gstep.set(gstep)
                faults.on_step(gstep, n_steps=kpack)
                if preempt.triggered:  # before this call's dispatch
                    preempt_exit(epoch, first_b)
                with obs.BUS.span("step_dispatch"):
                    loss, outputs, diag = dispatch(item, gstep, random_sources(epoch),
                                                   task_metrics and log_call)
                mirror["dispatched"] += updates_per_call
                batches_done = first_b + kpack
                epoch_losses.append(loss)
                if diag and monitor.push(diag["applied"]):
                    rollback()
                maybe_trace(call * updates_per_call)
                if save_every and batches_done // save_every > (batches_done - kpack) // save_every:
                    save(epoch * steps_per_epoch + batches_done, epoch, batches_done)
                if preempt.triggered:  # SIGTERM during the call
                    preempt_exit(epoch, batches_done)
                if log_call:
                    interval = rate_span.end()
                    rate_span = obs.BUS.begin("log_interval")
                    calls_done = min(args.log_step, call) or 1
                    g_wps.set(args.batch_size * kpack * calls_done / max(interval, 1e-9))
                    keep = task_metrics and outputs is not None
                    late_logs.append((call, f"{args.model_name}_train epoch {epoch} step "
                                      f"{first_b}/{steps_per_epoch}", gstep, loss,
                                      schedule(max(next_count() - 1, 0)),
                                      outputs if keep else None, item[1][0] if keep else None))
                log_late(call - monitor.lag)
            log_late(None)
            if profiling.active():  # an epoch shorter than the capture window
                profiling.trace_stop()
                profile_steps = 0
                logger.info(f"Profiler trace saved (short epoch): {trace_dir}")
            if monitor.flush():  # the verdicts of the epoch's last calls
                rollback()
            losses = [float(x) for x in torch.stack(epoch_losses).cpu()] if epoch_losses else []
            train_s = time.perf_counter() - t_epoch  # the losses read: the device is done
            train_losses.extend(losses)
            finite = [x for x in losses if np.isfinite(x)]
            epoch_train_loss = float(np.mean(finite)) if finite else 0.0
            if task_metrics:
                for task, m in metrics_merged.items():
                    logger.info(f"[train] {args.model_name} {task}: {m}")

            # The data plane's epoch report: a slowly rotting dataset shows
            # long before --max-quarantine-frac aborts the run.
            q_report = train_loader.dataset.quarantine_report()
            if q_report["quarantined"]:
                logger.warning(
                    f"[data-plane] epoch {epoch} quarantine report: {json.dumps(q_report)}"
                )
                emit_event("quarantine_report", epoch=epoch,
                           quarantined=len(q_report["quarantined"]), frac=q_report["frac"])
            if io_guard.COUNTERS.any_faults():
                logger.info(f"[data-plane] counters: {io_guard.COUNTERS.snapshot()}")

            try:
                with obs.BUS.span("validate"):
                    val_loss, val_metrics = validate(args, state, eval_step, spec, val_loader,
                                                     device, watchdog=watchdog)
            except io_guard.LoaderDeathError as e:
                loader_death_exit(e, epoch, steps_per_epoch)
            obs.BUS.gauge("val_loss").set(val_loss)
            val_losses.append(val_loss)
            if writer is not None:
                writer.add_scalar("train-loss/epoch", epoch_train_loss, epoch)
                writer.add_scalar("val-loss/epoch", val_loss, epoch)
                if task_metrics:
                    for task, m in metrics_merged.items():
                        writer.add_scalars(f"train.{task}.metrics/epoch", m.get_all_metrics(),
                                           epoch)
                for task, m in val_metrics.items():
                    writer.add_scalars(f"val.{task}.metrics/epoch", m.get_all_metrics(), epoch)
            if val_loss < best_loss:
                best_loss, patience = val_loss, 0
                best_path = save((epoch + 1) * steps_per_epoch, epoch, steps_per_epoch, val_loss)
                logger.info(f"Best val loss {val_loss:.4e}: saved {best_path}")
            else:
                patience += 1
                if patience > args.patience:
                    logger.info(
                        f"Early stopping at epoch {epoch} "
                        f"(no val improvement in {args.patience} epochs)"
                    )
                    break
            if preempt.triggered:  # SIGTERM during validation
                preempt_exit(epoch, steps_per_epoch)
            epoch_s = epoch_span.end()
            logger.info(
                f"Epoch {epoch}: train-loss {epoch_train_loss:.4e} val-loss {val_loss:.4e} "
                f"best {best_loss:.4e} time {time.perf_counter() - t_epoch:.1f} s (train "
                f"{train_s:.3f} s, {len(losses) * updates_per_call} steps)"
            )
            emit_event("epoch_summary", epoch=epoch, train_loss=round(epoch_train_loss, 6),
                       val_loss=round(float(val_loss), 6), best_loss=round(float(best_loss), 6),
                       epoch_time_s=round(epoch_s, 3), wps=round(g_wps.value, 1),
                       data_plane=io_guard.COUNTERS.snapshot())
    finally:
        preempt.__exit__()
        if watchdog is not None:
            watchdog.stop()
        train_loader.close()
        val_loader.close()
    if io_guard.COUNTERS.any_faults():
        logger.info(f"[data-plane] run counters: {io_guard.COUNTERS.snapshot()}")
    if monitor.total_skipped:
        logger.warning(f"Bad-update guard skipped {monitor.total_skipped} non-finite "
                       "update(s) this run")
    np.save(os.path.join(args.log_dir, "train_losses.npy"), np.asarray(train_losses))
    np.save(os.path.join(args.log_dir, "val_losses.npy"), np.asarray(val_losses))
    emit_event("train_done", best_loss=round(float(best_loss), 6))
    obs_close()
    return best_path


def test_worker(args: Any) -> float:
    """Test ``--checkpoint``'s weights on the held-out split; writes the
    results CSV (with ``--save-test-results``) and the metrics JSON, with
    the data plane's counters over the test run, to ``args.log_dir``;
    returns the test loss."""
    if not args.checkpoint:
        raise ValueError("test mode requires --checkpoint")
    device = resolve_device(args.device)
    _disable_tf32(device)
    spec = taskspec.get_task_spec(args.model_name)
    loss_fn = spec.make_loss()
    test_loader = _build_loader(args, spec, "test")
    in_channels = taskspec.get_num_inchannels(args.model_name)
    model = api.create_model(args.model_name, in_channels=in_channels,
                             in_samples=args.in_samples, seed=args.seed)
    model.load_state_dict(load_weights(args.checkpoint), strict=True)
    logger.info(f"Loaded checkpoint: {args.checkpoint}")
    state = TrainState(model.to(device))
    eval_step = capture_eval_step(make_eval_step(loss_fn, compute_dtype=args.dtype))
    # The same stall protection as training; a loader death here simply
    # propagates: there is no train state to checkpoint.
    watchdog = _start_watchdog(args)
    start = io_guard.COUNTERS.snapshot()
    try:
        loss, metrics = validate(args, state, eval_step, spec, test_loader, device,
                                 testing=True, save_results=args.save_test_results,
                                 watchdog=watchdog)
    finally:
        if watchdog is not None:
            watchdog.stop()
    payload = {
        "model": args.model_name,
        "dataset": args.dataset_name,
        "loss": float(loss),
        "metrics": {task: m.get_metrics(m.metric_names()) for task, m in metrics.items()},
        # The guard's counters over this test run, and the test split's
        # quarantine report.
        "data_plane": {
            "counters": {k: v - start[k] for k, v in io_guard.COUNTERS.snapshot().items()},
            "quarantine": test_loader.dataset.quarantine_report(),
        },
    }
    out_json = get_safe_path(os.path.join(args.log_dir, f"test_metrics_{args.dataset_name}.json"))
    with open(out_json, "w") as f:
        json.dump(payload, f, indent=1)
    logger.info(f"Test metrics saved: {out_json}")
    test_loader.close()
    return loss
