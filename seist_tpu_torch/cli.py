"""``python -m seist_tpu_torch train ...``: the port's training command line.

Flag names and defaults are the JAX CLI's (``seist_tpu/cli.py``) for what
the port runs, plus ``--device`` (default ``cuda``; it raises without a
card unless ``--device cpu`` is given). A flag of the JAX CLI whose
non-default value the port does not run yet raises and names
``ROADMAP.md``; flags of the telemetry plane and the fault-tolerance
machinery are not accepted at all.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

#: JAX-CLI flags the port accepts only at the value it runs: dest -> value.
_UNPORTED = {
    "checkpoint": "",
    "dtype": "fp32",
    "grad_accum_steps": 1,
    "device_aug": "off",
    "seq_shards": 1,
    "loader_processes": 0,
    "mixture_temperature": 0.0,
    "save_interval_steps": 0,
}


def bool_(x) -> bool:
    return False if str(x).strip().lower() in ("0", "false", "f", "no", "n") else bool(x)


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m seist_tpu_torch train",
        description="seist_tpu_torch model training (one card)",
    )
    ap.add_argument("--mode", default="train", type=str,
                    help="train (test and train_test are not ported yet)")
    ap.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")

    # Model
    ap.add_argument("--model-name", default="seist_m_dpk", type=str)
    ap.add_argument("--checkpoint", default="", type=str)
    ap.add_argument("--seq-shards", default=1, type=int, dest="seq_shards")
    ap.add_argument("--dtype", default="fp32", type=str, choices=["fp32", "bf16"])
    ap.add_argument("--loader-processes", default=0, type=int, dest="loader_processes")
    ap.add_argument("--steps-per-call", default=0, type=int, dest="steps_per_call")
    ap.add_argument("--grad-accum-steps", default=1, type=int, dest="grad_accum_steps")
    ap.add_argument("--device-aug", default="off", type=str,
                    choices=["off", "step", "cached"], dest="device_aug")

    ap.add_argument("--seed", default=0, type=int)

    # Logs
    ap.add_argument("--log-base", default="./logs", type=str)
    ap.add_argument("--log-step", default=4, type=int)

    # Dataset
    ap.add_argument("--data", default="", type=str, help="path to dataset")
    ap.add_argument("--dataset-name", default="diting_light", type=str,
                    help="only 'synthetic' is ported")
    ap.add_argument("--data-split", type=bool_, default=True)
    ap.add_argument("--train-size", type=float, default=0.8)
    ap.add_argument("--val-size", type=float, default=0.1)
    ap.add_argument("--mixture-temperature", default=0.0, type=float,
                    dest="mixture_temperature")

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
    ap.add_argument("--save-interval-steps", default=0, type=int, dest="save_interval_steps")
    ap.add_argument("--bad-step-guard", default=True, type=bool_, dest="bad_step_guard")
    ap.add_argument("--use-lr-scheduler", default=True, type=bool_)
    ap.add_argument("--lr-scheduler-mode", default="exp_range", type=str,
                    help="'triangular', 'triangular2' or 'exp_range'")
    ap.add_argument("--base-lr", default=8e-5, type=float)
    ap.add_argument("--max-lr", default=1e-3, type=float)
    ap.add_argument("--warmup-steps", default=2000, type=float,
                    help="<1 means ratio of total steps")
    ap.add_argument("--down-steps", default=3000, type=float,
                    help="<1 means ratio of total steps")

    ap.add_argument("--synthetic-events", default=0, type=int,
                    help="synthetic dataset size (0 = default)")

    args = ap.parse_args(argv)
    _refuse_unported(args)
    if not 0 <= args.p_position_ratio <= 1:
        args.p_position_ratio = -1
    args.log_base = os.path.abspath(args.log_base)
    if args.data:
        args.data = os.path.abspath(args.data)
    args.dataset_kwargs = None
    if args.dataset_name == "synthetic" and args.synthetic_events:
        args.dataset_kwargs = {"num_events": args.synthetic_events}
    return args


def _refuse_unported(args: argparse.Namespace) -> None:
    bad = [
        f"--{dest.replace('_', '-')} {getattr(args, dest)!r}"
        for dest, ok in _UNPORTED.items()
        if getattr(args, dest) != ok
    ]
    if args.steps_per_call > 1:
        bad.append(f"--steps-per-call {args.steps_per_call}")
    if args.mode != "train":
        bad.append(f"--mode {args.mode!r}")
    if args.dataset_name != "synthetic":
        bad.append(f"--dataset-name {args.dataset_name!r}")
    if bad:
        raise NotImplementedError(
            f"not ported yet (queued in ROADMAP.md): {', '.join(bad)}"
        )


def main(argv: Optional[List[str]] = None) -> str:
    """Parse, set up the run's log directory, train; returns the best
    checkpoint's path."""
    import seist_tpu_torch
    from seist_tpu_torch.train.worker import train_worker
    from seist_tpu_torch.utils.logger import logger

    args = get_args(argv)
    seist_tpu_torch.load_all()
    args.log_dir = os.path.join(
        args.log_base,
        f"{time.strftime('%Y%m%d-%H%M%S')}_{args.model_name}_{args.dataset_name}",
    )
    os.makedirs(args.log_dir, exist_ok=True)
    logger.info(f"pid: {os.getpid()} log dir: {args.log_dir}")
    logger.info("\n" + "\n".join(f"  {k}: {v}" for k, v in sorted(vars(args).items())))
    best = train_worker(args)
    logger.info(f"best checkpoint: {best}")
    return best
