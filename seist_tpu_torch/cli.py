"""``python -m seist_tpu_torch train ...``: the port's training and test
command line.

Flag names and defaults are the JAX CLI's (``seist_tpu/cli.py``) for what
the port runs, plus ``--device`` (default ``cuda``; it raises without a
card unless ``--device cpu`` is given). ``--mode`` is ``train``, ``test``
or ``train_test`` (the default): after training, the test run takes the
best checkpoint. With ``--checkpoint`` the log directory is that
checkpoint's run directory (:func:`run_dir_of`), and a train run resumes
from it; a weights file alone (``import-pretrained``'s) starts a fine-tune
from its weights with a fresh optimizer at epoch 0, step 0.

Datasets: ``synthetic`` and ``packed`` (``--data`` a pack directory, from
``python -m seist_tpu_torch pack`` or the JAX package's ``python -m
tools.pack_dataset``). The HDF5 datasets (DiTing, PNW, SOS) are read only
through a pack: naming one raises with the command that packs it.
``--mixture-temperature`` samples a mixture pack's sources;
``--loader-processes`` assembles train batches in worker processes;
``--max-quarantine-frac`` and ``--data-watchdog-sec`` set the data-plane
guard (``data/io_guard.py``). A preempted run exits 75 after its
checkpoint (``python -m seist_tpu_torch supervise`` relaunches it).

``--steps-per-call k`` trains k batches per call, k updates one after
another (0, the default, means 1); ``--grad-accum-steps k`` makes one
update from the mean gradient of k batches (``--batch-size 100
--grad-accum-steps 5`` is the reference's batch-500 recipe). The two
exclude each other; a tail of fewer than k batches per epoch is dropped
and logged. On CUDA every train and eval step runs as a captured CUDA
graph (``train/graph.py``).

``--conv-kernel-l1-alpha`` and ``--conv-bias-l1-alpha`` add L1 sign decay
to EQTransformer's encoder and decoder convolutions (any other model
raises, as in the JAX package).

``--device-aug step|cached`` augments and labels the train batches on
the device (``data/device_aug.py``; ``cached`` holds the raw epoch there,
its budget ``--device-aug-hbm-gb``); ``--ingest auto|direct|host`` chooses
how the step mode's raw rows arrive (straight from a pack's shards, or a
resident store). Both resolve and fall back as in the JAX package.

Telemetry (``obs/``, ``train/worker.py``): ``--metrics-port`` serves the
metrics bus (``/metrics``, ``/metrics.json``, ``/flight``, ``/traces``,
``POST /profile``), ``--flight-steps`` sizes the flight recorder dumped on
every death path, ``--profile-steps`` captures steady-state updates with
``torch.profiler``, ``--use-tensorboard`` writes the loss and the train and
val task metrics as scalars.

Several ranks, one process each (``parallel/``): the JAX CLI's env
contract ``COORDINATOR_ADDRESS=host:port NUM_PROCESSES=W PROCESS_ID=i``,
or ``torchrun --nproc-per-node W -m seist_tpu_torch train ...``, starts a
process group (``nccl`` on ``cuda``, ``gloo`` on ``cpu``; ``DIST_BACKEND=gloo``
lets ranks share one card, with eager steps). ``--batch-size`` is each
data rank's; ``--seq-shards S`` runs every SeisT attention as a ring over
S ranks, which hold the same rows (the data axis is W / S). Rank 0 picks
the log directory and writes the run's files. With the env given, a group
that cannot start raises: a rank never runs alone.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

_MODES = ("train", "test", "train_test")
_DATASETS = ("synthetic", "packed")
#: The JAX package's HDF5 readers (h5py and pandas, which the port does
#: not import): their data reaches the port as a pack.
_HDF5_DATASETS = ("diting", "diting_light", "pnw", "pnw_light", "sos")


def bool_(x) -> bool:
    return False if str(x).strip().lower() in ("0", "false", "f", "no", "n") else bool(x)


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m seist_tpu_torch train",
        description="seist_tpu_torch model training (one card, or one rank per card)",
    )
    ap.add_argument("--mode", default="train_test", type=str,
                    help="train/test/train_test (default: 'train_test')")
    ap.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")

    # Model
    ap.add_argument("--model-name", default="seist_m_dpk", type=str)
    ap.add_argument("--checkpoint", default="", type=str,
                    help="model_<step>.pt: resume (train) or the weights to test; a "
                    "weights file alone: fine-tune from it (train)")
    ap.add_argument("--seq-shards", default=1, type=int, dest="seq_shards",
                    help="ranks of the sequence-parallel (ring attention) axis; the rest "
                    "of the ranks form the data axis. Default 1")
    ap.add_argument("--conv-kernel-l1-alpha", default=0.0, type=float,
                    dest="conv_kernel_l1_alpha",
                    help="L1 (sign) regularization strength on eqtransformer's "
                    "encoder/decoder conv kernels (ref eqtransformer.py "
                    "conv_kernel_l1_regularization)")
    ap.add_argument("--conv-bias-l1-alpha", default=0.0, type=float,
                    dest="conv_bias_l1_alpha",
                    help="as --conv-kernel-l1-alpha, for conv biases")
    ap.add_argument("--dtype", default="fp32", type=str, choices=["fp32", "bf16"],
                    help="compute dtype of the train/eval steps: bf16 keeps fp32 "
                    "parameters, optimizer state, BatchNorm statistics and loss")
    ap.add_argument("--loader-processes", default=0, type=int, dest="loader_processes",
                    help="assemble train batches in this many worker processes instead of "
                    "the --workers threads (batches are identical); 0 = threads")
    ap.add_argument("--steps-per-call", default=0, type=int, dest="steps_per_call")
    ap.add_argument("--grad-accum-steps", default=1, type=int, dest="grad_accum_steps")
    ap.add_argument("--device-aug", default="off", type=str,
                    choices=["off", "step", "cached"], dest="device_aug",
                    help="device-side augmentation and label synthesis. 'step': the step "
                    "augments raw rows the host feeds; 'cached': the raw epoch lives on the "
                    "card and a call receives sample indices; falls back to 'step' over the "
                    "memory budget, to 'off' on unsupported configs (both logged). Default off")
    ap.add_argument("--device-aug-hbm-gb", default=0.0, type=float, dest="device_aug_hbm_gb",
                    help="device memory budget (GiB) of the --device-aug cached epoch. 0 = "
                    "auto: half the card's memory, or 4 GiB on the CPU")
    ap.add_argument("--ingest", default="auto", type=str, choices=["auto", "direct", "host"],
                    help="raw-row feed of the device-aug step path. 'auto': straight from the "
                    "shards when the dataset is packed; 'host': always a resident RawStore; "
                    "'direct': demand the shard feed, error instead of falling back. Default auto")

    ap.add_argument("--profile-steps", default=0, type=int, dest="profile_steps",
                    help="capture a torch.profiler trace of this many steady-state train "
                    "steps (first epoch, from the third call, after the step's graph "
                    "capture) into a unique <logdir>/profile/<timestamp>_p<pid> dir (a "
                    "relaunched supervise attempt never clobbers the previous capture); "
                    "a Chrome trace (trace.json). Later captures can be re-armed live via "
                    "SIGUSR2 or POST /profile on --metrics-port. Default 0 = off")
    ap.add_argument("--metrics-port", default=0, type=int, dest="metrics_port",
                    help="serve the telemetry plane on this loopback port: GET /metrics is "
                    "Prometheus text exposition of the metrics bus (step spans, loss/wps "
                    "gauges, data-plane counters), /metrics.json + /flight are JSON views, "
                    "POST /profile triggers an on-demand torch.profiler capture. -1 binds "
                    "an ephemeral port (logged). Default 0 = off")
    ap.add_argument("--flight-steps", default=256, type=int, dest="flight_steps",
                    help="flight-recorder ring size: the last N steps' metrics and span "
                    "events are dumped to <logdir>/flight/*.json on every death path "
                    "(rollback, stall, preempt, quarantine overflow, crash). Default 256")

    ap.add_argument("--seed", default=0, type=int)

    # Logs
    ap.add_argument("--log-base", default="./logs", type=str)
    ap.add_argument("--log-step", default=4, type=int)
    ap.add_argument("--use-tensorboard", default=True, type=bool_)

    # Save results
    ap.add_argument("--save-test-results", default=True, type=bool_)

    # Dataset
    ap.add_argument("--data", default="", type=str, help="path to dataset")
    ap.add_argument("--dataset-name", default="diting_light", type=str,
                    help="'synthetic' or 'packed' (--data: a pack directory)")
    ap.add_argument("--data-split", type=bool_, default=True)
    ap.add_argument("--train-size", type=float, default=0.8)
    ap.add_argument("--val-size", type=float, default=0.1)
    ap.add_argument("--mixture-temperature", default=0.0, type=float,
                    dest="mixture_temperature",
                    help="temperature-weighted TRAIN sampling over a mixture pack's "
                    "sources: p_s ∝ (n_s/N)^(1/T); 0 = the plain shuffle")

    # Data loader
    ap.add_argument("--shuffle", type=bool_, default=True)
    ap.add_argument("--workers", default=8, type=int)

    # Data preprocess
    ap.add_argument("--in-samples", default=8192, type=int)
    ap.add_argument("--label-width", type=float, default=0.5,
                    help="width of soft label (seconds)")
    ap.add_argument("--label-shape", type=str, default="gaussian",
                    help="'gaussian' 'triangle' 'box' or 'sigmoid'")
    ap.add_argument("--coda-ratio", default=2.0, type=float)
    ap.add_argument("--norm-mode", default="std", type=str)
    ap.add_argument("--min-snr", type=float, default=-float("inf"))
    ap.add_argument("--p-position-ratio", type=float, default=-1)

    # Data augmentation
    ap.add_argument("--augmentation", type=bool_, default=True)
    ap.add_argument("--add-event-rate", default=0.0, type=float)
    ap.add_argument("--max-event-num", default=1, type=int)
    ap.add_argument("--shift-event-rate", default=0.2, type=float)
    ap.add_argument("--add-noise-rate", default=0.4, type=float)
    ap.add_argument("--add-gap-rate", default=0.4, type=float)
    ap.add_argument("--min-event-gap", default=0.5, type=float,
                    help="minimum event gap (seconds)")
    ap.add_argument("--drop-channel-rate", default=0.4, type=float)
    ap.add_argument("--scale-amplitude-rate", default=0.4, type=float)
    ap.add_argument("--pre-emphasis-rate", default=0.4, type=float)
    ap.add_argument("--pre-emphasis-ratio", default=0.97, type=float)
    ap.add_argument("--generate-noise-rate", default=0.05, type=float)
    ap.add_argument("--mask-percent", default=0, type=int)
    ap.add_argument("--noise-percent", default=0, type=int)

    # Train
    ap.add_argument("--epochs", default=200, type=int)
    ap.add_argument("--patience", default=30, type=int)
    ap.add_argument("--steps", default=0, type=int, help="if steps > 0, epochs is ignored")
    ap.add_argument("--start-epoch", default=0, type=int)
    ap.add_argument("--batch-size", default=500, type=int)
    ap.add_argument("--optim", default="Adam", type=str)
    ap.add_argument("--momentum", default=0.9, type=float)
    ap.add_argument("--weight_decay", default=0.0, type=float)
    ap.add_argument("--save-interval-steps", default=0, type=int, dest="save_interval_steps",
                    help="checkpoint every N batches (0 = best-val checkpoints only)")
    ap.add_argument("--keep-checkpoints", default=3, type=int, dest="keep_checkpoints",
                    help="retention: the last K step checkpoints plus the best-val one")
    ap.add_argument("--bad-step-guard", default=True, type=bool_, dest="bad_step_guard")
    ap.add_argument("--max-bad-steps", default=3, type=int, dest="max_bad_steps",
                    help="consecutive guard-skipped updates before rolling back to the "
                    "last checkpoint; 0 disables rollback")
    ap.add_argument("--max-quarantine-frac", default=0.05, type=float,
                    dest="max_quarantine_frac",
                    help="abort once more than this fraction of the dataset has been "
                    "quarantined by the data-plane guard. Default 0.05")
    ap.add_argument("--data-watchdog-sec", default=600.0, type=float, dest="data_watchdog_sec",
                    help="exit 75 (after dumping thread stacks) when the loop waits longer "
                    "than this for the next host batch; steps, kernel builds and "
                    "validation compute do not count. 0 disables. Default 600")
    ap.add_argument("--use-lr-scheduler", default=True, type=bool_)
    ap.add_argument("--lr-scheduler-mode", default="exp_range", type=str,
                    help="'triangular', 'triangular2' or 'exp_range'")
    ap.add_argument("--base-lr", default=8e-5, type=float)
    ap.add_argument("--max-lr", default=1e-3, type=float)
    ap.add_argument("--warmup-steps", default=2000, type=float,
                    help="<1 means ratio of total steps")
    ap.add_argument("--down-steps", default=3000, type=float,
                    help="<1 means ratio of total steps")

    # Val/Test
    ap.add_argument("--time-threshold", default=0.1, type=float,
                    help="pick residual threshold (seconds)")
    ap.add_argument("--min-peak-dist", default=1.0, type=float,
                    help="minimum peak distance (seconds)")
    ap.add_argument("--ppk-threshold", default=0.3, type=float)
    ap.add_argument("--spk-threshold", default=0.3, type=float)
    ap.add_argument("--det-threshold", default=0.5, type=float)
    ap.add_argument("--max-detect-event-num", default=1, type=int)

    ap.add_argument("--synthetic-events", default=0, type=int,
                    help="synthetic dataset size (0 = default)")

    args = ap.parse_args(argv)
    _refuse_unported(args)
    if not 0 <= args.p_position_ratio <= 1:
        args.p_position_ratio = -1
    args.log_base = os.path.abspath(args.log_base)
    if args.data:
        args.data = os.path.abspath(args.data)
    if args.checkpoint:
        args.checkpoint = os.path.abspath(args.checkpoint)
    args.dataset_kwargs = None
    if args.dataset_name == "synthetic" and args.synthetic_events:
        args.dataset_kwargs = {"num_events": args.synthetic_events}
    return args


def _refuse_unported(args: argparse.Namespace) -> None:
    if args.mode not in _MODES:
        raise ValueError(f"`mode` must be 'train', 'test' or 'train_test', got '{args.mode}'")
    if args.dataset_name in _HDF5_DATASETS:
        raise NotImplementedError(
            f"--dataset-name {args.dataset_name!r} is an HDF5 dataset, which the port reads "
            "only as a pack: pack it once with the JAX package on a machine with h5py "
            f"(python -m tools.pack_dataset --dataset {args.dataset_name} --data-dir DIR "
            "--out PACK), then train with --dataset-name packed --data PACK"
        )
    if args.dataset_name not in _DATASETS:
        raise NotImplementedError(
            f"not ported yet (queued in ROADMAP.md): --dataset-name {args.dataset_name!r}"
        )


def run_dir_of(checkpoint: str) -> str:
    """The run directory of ``<run>/checkpoints/model_<step>.pt``. For a
    weights file outside a ``checkpoints`` directory (an imported one), a
    directory named after the file: ``W.pt`` -> ``W/``, as the JAX package
    logs into the imported checkpoint's own directory
    (``checkpoint.split("checkpoints")[0]``)."""
    parent = os.path.dirname(checkpoint)
    if os.path.basename(parent) == "checkpoints":
        return os.path.dirname(parent)
    return os.path.splitext(checkpoint)[0]


def main(argv: Optional[List[str]] = None) -> str:
    """Parse, start the process group when a multi-rank launch is
    described, set up the log directory, then train and/or test. Returns
    the best checkpoint's weights path (the tested one for ``--mode
    test``)."""
    import logging

    import seist_tpu_torch
    from seist_tpu_torch.parallel import dist
    from seist_tpu_torch.train.worker import test_worker, train_worker
    from seist_tpu_torch.utils.logger import logger

    args = get_args(argv)
    args.distributed = dist.init_distributed_mode(device=args.device)
    level = logger.level
    try:
        seist_tpu_torch.load_all()
        args.log_dir = (
            run_dir_of(args.checkpoint) if args.checkpoint else os.path.join(
                args.log_base,
                f"{time.strftime('%Y%m%d-%H%M%S')}_{args.model_name}_{args.dataset_name}",
            )
        )
        # Every rank takes rank 0's directory (the ranks' clocks may
        # straddle a second; seist_tpu/cli.py:327-329).
        args.log_dir = dist.broadcast_object(args.log_dir)
        os.makedirs(args.log_dir, exist_ok=True)
        if not dist.is_main_process():
            logger.setLevel(logging.WARNING)  # rank 0 tells the run's story
        logger.info(f"pid: {os.getpid()} log dir: {args.log_dir}")
        logger.info("\n" + "\n".join(f"  {k}: {v}" for k, v in sorted(vars(args).items())))
        mode = args.mode.split("_")
        if "train" in mode:
            args.checkpoint = train_worker(args)
            logger.info(f"best checkpoint: {args.checkpoint}")
        if "test" in mode:
            test_worker(args)
        return args.checkpoint
    finally:
        logger.setLevel(level)
        if args.distributed:
            dist.shutdown()
