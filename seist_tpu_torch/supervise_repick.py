"""Batch-fleet supervisor: N lease-based repick workers, relaunched through
preemption and crashes, then a fence-audited merge (the port's copy of
``tools/supervise_repick.py``). A model-free host process: it takes no
device and imports neither torch nor numpy.

It spawns N ``python -m seist_tpu_torch repick --fleet`` workers over one
shared lease directory and keeps the fleet converging:

* **exit 75** (SIGTERM -> drain the current segment -> release the lease
  -> exit) schedules a RELAUNCH after ``--rejoin-delay-s`` and does not
  spend the crash budget; meanwhile peers reclaim the worker's released
  or expired leases, and on rejoin it steals whatever is still open;
* **any other nonzero exit** (SIGKILL, OOM, a bug) spends one of that
  worker's ``--retries`` and relaunches at once; a worker that uses up
  its budget is ABANDONED. The fleet still finishes, because its leases
  expire and peers reclaim them; the supervisor fails only when every
  worker is gone;
* after the last worker ends, the reduce runs (``repick --merge-only``,
  a child process) with the lease store's done-fence ledger, so the merge
  audits every segment's fence sidecar (``batch/catalog.py``).

``--fault-env i:KEY=VALUE`` (repeatable) passes a ``SEIST_FAULT_BATCH_*``
knob to worker ``i`` alone; every worker also gets
``SEIST_BATCH_WORKER=<i>`` and a stamp file of its own, so a kill or a
preempt fires once across that worker's relaunches. Worker output goes to
per-incarnation logs under ``<out>/logs/``, and the verdict sums the
lease counters of every incarnation::

    python -m seist_tpu_torch supervise-repick --archive A --out O \\
        --model seist_l_dpk --workers 3 --lease-dir O/leases [--device cpu]

Prints ONE JSON verdict line (role "supervisor").
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE

#: The lease counters summed across every worker incarnation.
_LEASE_KEYS = (
    "acquires", "reclaims", "renews", "releases", "expires",
    "fence_rejects", "double_commits", "store_errors", "parks",
)


#: repick's decode flags and their defaults.
DECODE_FLAGS = (("--ppk-threshold", 0.3), ("--spk-threshold", 0.3), ("--det-threshold", 0.5),
                ("--min-peak-dist", 1.0), ("--max-events", 8))


def get_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m seist_tpu_torch supervise-repick", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archive", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="")
    ap.add_argument("--model-group", default="")
    ap.add_argument("--tasks", default="")
    ap.add_argument("--variant", default="fp32", choices=("fp32", "bf16", "int8"))
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--batches-per-call", type=int, default=4)
    ap.add_argument("--commit-every", type=int, default=4)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="the workers' device: cuda or cpu")
    ap.add_argument("--workers", type=int, default=3, help="fleet size (indices 0..N-1)")
    ap.add_argument("--lease-dir", required=True,
                    help="shared lease-store directory (created if absent)")
    ap.add_argument("--retries", type=int, default=2,
                    help="crash-relaunch budget per worker (exit-75 relaunches never "
                    "spend it)")
    ap.add_argument("--rejoin-delay-s", type=float, default=0.5,
                    help="delay before relaunching a preempted (exit-75) worker, the window "
                    "in which peers reclaim its units")
    ap.add_argument("--fault-env", action="append", default=[], metavar="I:KEY=VALUE",
                    help="KEY=VALUE in worker I's environment only (repeatable)")
    # The workers' decode options (repick's defaults); the JAX tool's fleet
    # always decodes at the defaults.
    for flag, default in DECODE_FLAGS:
        ap.add_argument(flag, type=type(default), default=default)
    ap.add_argument("--compile-gate", action="store_true")
    ap.add_argument("--no-merge", action="store_true")
    ap.add_argument("--timeout-s", type=float, default=900.0,
                    help="overall fleet deadline (a wedged fleet fails, it does not hang)")
    args = ap.parse_args(argv)
    if bool(args.model) == bool(args.model_group):
        ap.error("exactly one of --model / --model-group is required")
    return args


def _parse_fault_env(specs: List[str], n_workers: int) -> Dict[int, Dict[str, str]]:
    out: Dict[int, Dict[str, str]] = {i: {} for i in range(n_workers)}
    for spec in specs:
        head, sep, val = spec.partition("=")
        idx_s, sep2, key = head.partition(":")
        if not sep or not sep2 or not key:
            raise SystemExit(f"bad --fault-env '{spec}' (want I:KEY=VALUE)")
        idx = int(idx_s)
        if idx not in out:
            raise SystemExit(f"--fault-env '{spec}': worker {idx} out of range (fleet has "
                             f"{n_workers})")
        out[idx][key] = val
    return out


def _worker_cmd(args, i: int) -> List[str]:
    cmd = [
        sys.executable, "-m", "seist_tpu_torch", "repick",
        "--archive", args.archive, "--out", args.out,
        "--variant", args.variant,
        "--batch-size", str(args.batch_size),
        "--batches-per-call", str(args.batches_per_call),
        "--commit-every", str(args.commit_every),
        "--prefetch", str(args.prefetch),
        "--seed", str(args.seed),
        "--device", args.device,
        "--fleet", "--lease-dir", args.lease_dir,
        "--lease-store", "dir",
        "--worker-index", str(i),
        "--worker-id", f"w{i}",
        "--no-merge",
    ]
    if args.model:
        cmd += ["--model", args.model]
    if args.model_group:
        cmd += ["--model-group", args.model_group]
    if args.tasks:
        cmd += ["--tasks", args.tasks]
    if args.compile_gate:
        cmd += ["--compile-gate"]
    for flag, default in DECODE_FLAGS:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != default:
            cmd += [flag, str(value)]
    return cmd


def _merge_cmd(args) -> List[str]:
    """The reduce, a child process: the supervisor itself imports no
    numpy, which reading the archive's index needs."""
    return [sys.executable, "-m", "seist_tpu_torch", "repick", "--archive", args.archive,
            "--out", args.out, "--merge-only", "--lease-dir", args.lease_dir]


class _Worker:
    """One worker slot: its process, crash budget, incarnation logs and,
    after an exit 75, its rejoin time."""

    def __init__(self, index: int, budget: int, fault_env: Dict[str, str], log_dir: str,
                 stamp_dir: str):
        self.index = index
        self.budget = budget
        self.fault_env = fault_env
        self.log_dir = log_dir
        self.stamp = os.path.join(stamp_dir, f"w{index}.stamp")
        self.incarnation = 0
        self.proc: Optional[subprocess.Popen] = None
        self.log_f = None
        self.logs: List[str] = []
        self.rejoin_at: Optional[float] = None  # monotonic
        self.done = False
        self.failed = False
        self.relaunches = 0
        self.preempts = 0
        self.crashes = 0

    def launch(self, args) -> None:
        self.incarnation += 1
        if self.incarnation > 1:
            self.relaunches += 1
        path = os.path.join(self.log_dir, f"w{self.index}.{self.incarnation:02d}.log")
        self.logs.append(path)
        env = dict(os.environ)
        env["SEIST_BATCH_WORKER"] = str(self.index)
        if self.fault_env:
            env["SEIST_FAULT_STAMP"] = self.stamp
            env.update(self.fault_env)
        self.log_f = open(path, "w")
        self.proc = subprocess.Popen(_worker_cmd(args, self.index), stdout=self.log_f,
                                     stderr=subprocess.STDOUT, env=env)
        self.rejoin_at = None

    def close_log(self) -> None:
        if self.log_f is not None:
            self.log_f.close()
            self.log_f = None


def _verdicts(paths: List[str], role: str) -> List[dict]:
    """Every ``role`` verdict line in the files ``paths`` (a SIGKILLed
    incarnation prints none)."""
    out = []
    for path in paths:
        try:
            with open(path) as f:
                for line in f:
                    try:
                        d = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(d, dict) and d.get("role") == role:
                        out.append(d)
        except FileNotFoundError:
            pass
    return out


def main(argv=None) -> int:
    args = get_args(argv)
    t0 = time.monotonic()
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.lease_dir, exist_ok=True)
    log_dir = os.path.join(args.out, "logs")
    os.makedirs(log_dir, exist_ok=True)
    fault_env = _parse_fault_env(args.fault_env, args.workers)

    workers = [_Worker(i, args.retries, fault_env[i], log_dir, log_dir)
               for i in range(args.workers)]
    for w in workers:
        w.launch(args)

    deadline = t0 + args.timeout_s
    while True:
        live = [w for w in workers if w.proc is not None]
        waiting = [w for w in workers if w.rejoin_at is not None]
        if not live and not waiting:
            break
        if time.monotonic() > deadline:
            for w in live:
                w.proc.kill()
                w.proc.wait()
                w.close_log()
            print(json.dumps({"ok": False, "role": "supervisor",
                              "error": f"fleet deadline {args.timeout_s}s exceeded"}))
            return 1
        now = time.monotonic()
        for w in waiting:
            if now >= w.rejoin_at:
                w.launch(args)
        for w in live:
            rc = w.proc.poll()
            if rc is None:
                continue
            w.proc = None
            w.close_log()
            if rc == 0:
                w.done = True
            elif rc == PREEMPT_EXIT_CODE:
                w.preempts += 1
                w.rejoin_at = time.monotonic() + args.rejoin_delay_s
            elif w.budget > 0:
                w.budget -= 1
                w.crashes += 1
                w.launch(args)
            else:
                w.crashes += 1
                w.failed = True
        time.sleep(0.1)

    finished = [w for w in workers if w.done]
    if not finished:
        print(json.dumps({"ok": False, "role": "supervisor",
                          "error": "every worker exhausted its relaunch budget",
                          "crashes": sum(w.crashes for w in workers)}))
        return 1

    lease = {k: 0 for k in _LEASE_KEYS}
    verdicts = _verdicts([p for w in workers for p in w.logs], "fleet-worker")
    for v in verdicts:
        for k in _LEASE_KEYS:
            lease[k] += int(v.get("lease", {}).get(k, 0))
    verdict: Dict[str, Any] = {
        "ok": True,
        "role": "supervisor",
        "workers": args.workers,
        "finished": len(finished),
        "abandoned": [w.index for w in workers if w.failed],
        "relaunches": sum(w.relaunches for w in workers),
        "preempts": sum(w.preempts for w in workers),
        "crashes": sum(w.crashes for w in workers),
        "worker_verdicts": len(verdicts),
        "lease": lease,
    }
    if args.compile_gate:
        verdict["compiles_after_warmup"] = sum(int(v.get("compiles_after_warmup", 0))
                                               for v in verdicts)
    if not args.no_merge:
        merge_log = os.path.join(log_dir, "merge.log")
        with open(merge_log, "w") as f:
            rc = subprocess.call(_merge_cmd(args), stdout=f, stderr=subprocess.STDOUT)
        merged = _verdicts([merge_log], "merge")
        if rc != 0 or not merged:
            print(json.dumps({"ok": False, "role": "supervisor",
                              "error": f"merge failed (rc={rc}, log {merge_log})"}))
            return 1
        verdict["rows"] = merged[-1]["rows"]
        verdict["units"] = merged[-1]["units"]
        verdict["fence_audit"] = merged[-1].get("fence_audit")
    verdict["wall_s"] = round(time.monotonic() - t0, 2)
    print(json.dumps(verdict), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
