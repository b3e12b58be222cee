"""``python -m seist_tpu_torch supervise``: relaunch a training command on
failure, resuming from its newest checkpoint (the port's copy of
``tools/supervise.py``)::

    python -m seist_tpu_torch supervise --retries 3 --backoff 30 -- \
        python -m seist_tpu_torch train --mode train --model-name seist_l_dpk \
        --dataset-name packed --data /data/diting_packed --log-base logs/run1

On a nonzero exit it finds the newest whole checkpoint under the command's
``--log-base`` (``*/checkpoints/model_<step>.pt`` beside its
``state_<step>.pt``, :func:`~seist_tpu_torch.train.checkpoint.find_newest_checkpoint`)
and relaunches the same command with ``--checkpoint`` set to it.

Exit-code contract:

* ``PREEMPT_EXIT_CODE`` (75) — the trainer checkpointed and exited on
  SIGTERM, a loader death or a stalled loader. Relaunched at once, and the
  retry budget is untouched, but only when the checkpoint advanced since
  the last launch: a trainer that exits 75 without progress spends the
  budget like a crash.
* any other nonzero — a crash. Relaunched after ``--backoff`` seconds, at
  most ``--retries`` times; the budget resets whenever the newest
  checkpoint has changed, since progress means the job is healthy and the
  environment flaky.

A run with no checkpoint yet restarts from scratch. The exit code is the
last attempt's. Only the standard library is imported here (torch is not:
the supervisor outlives every relaunch).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import List, Optional

from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE, find_newest_checkpoint


def _arg_value(cmd: List[str], flag: str) -> Optional[str]:
    """Value of ``flag`` in ``cmd``, in both ``--flag v`` and ``--flag=v``."""
    for i, tok in enumerate(cmd):
        if tok == flag:
            return cmd[i + 1] if i + 1 < len(cmd) else None
        if tok.startswith(flag + "="):
            return tok[len(flag) + 1:]
    return None


def with_checkpoint(cmd: List[str], ckpt: str) -> List[str]:
    """``cmd`` with ``--checkpoint ckpt`` set, replacing a prior value in
    either form."""
    cmd = list(cmd)
    for i, tok in enumerate(cmd):
        if tok == "--checkpoint":
            if i + 1 < len(cmd):
                cmd[i + 1] = ckpt
                return cmd
            return cmd[:i] + ["--checkpoint", ckpt]
        if tok.startswith("--checkpoint="):
            cmd[i] = f"--checkpoint={ckpt}"
            return cmd
    return cmd + ["--checkpoint", ckpt]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m seist_tpu_torch supervise",
        description="relaunch-on-failure wrapper with checkpoint resume",
        usage="python -m seist_tpu_torch supervise [--retries N] [--backoff S] -- <command...>",
    )
    ap.add_argument("--retries", type=int, default=3,
                    help="max relaunches after a crash WITHOUT checkpoint progress "
                    "(default 3); progress resets the budget")
    ap.add_argument("--backoff", type=float, default=30.0,
                    help="seconds to wait before a crash relaunch (default 30); "
                    "clean preempts relaunch immediately")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="the training command, after `--`")
    args = ap.parse_args(argv)

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (use: supervise [opts] -- python -m seist_tpu_torch train ...)")

    log_base = _arg_value(cmd, "--log-base") or "./logs"

    def _log(msg: str) -> None:
        print(f"[supervise] {msg}", file=sys.stderr, flush=True)

    failures = 0  # crash relaunches since the last checkpoint progress
    attempt = 0
    prev_ckpt = find_newest_checkpoint(log_base)
    while True:
        attempt += 1
        _log(f"attempt {attempt} (budget {failures}/{args.retries} used): {' '.join(cmd)}")
        rc = subprocess.call(cmd)
        if rc == 0:
            return 0
        ckpt = find_newest_checkpoint(log_base)
        # Progress = the newest checkpoint CHANGED: comparing step numbers
        # across log_base would let an old run's higher step mask this
        # run's progress.
        progressed = ckpt is not None and ckpt != prev_ckpt
        if progressed:
            failures = 0
        if rc == PREEMPT_EXIT_CODE and progressed:
            _log(f"clean preempt (rc={rc}), checkpoint advanced to {ckpt}: "
                 "immediate relaunch, retry budget untouched")
        else:
            failures += 1
            _log(f"exited rc={rc} ({'no checkpoint progress' if not progressed else 'crash'}); "
                 f"budget {failures}/{args.retries} used")
            if failures > args.retries:
                return rc
            time.sleep(args.backoff)
        if ckpt:
            cmd = with_checkpoint(cmd, ckpt)
            _log(f"resuming from {ckpt}")
        else:
            _log("no checkpoint yet; restarting fresh")
        prev_ckpt = ckpt


if __name__ == "__main__":
    sys.exit(main())
