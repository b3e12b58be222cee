"""Re-pick a packed waveform archive as a map-reduce batch job (the port's
counterpart of ``tools/repick_archive.py``, with the same flags, roles
and verdict lines).

* **map**: the archive's packed shards become deterministic work units;
  worker i owns ``units[i::num_workers]`` and runs the straight-line
  device feed of ``batch/engine.py`` (double-buffered ``PackedRawStore``
  fills against ONE multi-batch CUDA graph; trunk-once head fan-out for
  task groups), committing catalog segments atomically every
  ``--commit-every`` device calls;
* **resume**: a SIGKILLed worker restarts at its exact segment offset
  (the committed segments are the durable state; ``worker_<i>.json`` is
  the advisory progress record); SIGTERM drains the current segment and
  exits 75;
* **fleet** (``--fleet``): workers take work-unit leases with heartbeat
  and fencing tokens (``batch/fleet.py``) from a shared directory, or from
  the process group's TCP store, so any number of them, joining and dying
  at any time, converge on one catalog;
* **reduce**: ``--merge-only`` (or the driver, once its workers are done)
  concatenates the segments in (unit, segment) order into
  ``catalog.jsonl`` and ``catalog_meta.json`` (written last). The merged
  catalog is byte-identical across worker counts and kill/resume
  histories.

Under the env contract of a multi-process launch (``COORDINATOR_ADDRESS``
/ ``NUM_PROCESSES`` / ``PROCESS_ID``, or torchrun's), each process joins
the process group (``parallel/dist.py::init_distributed_mode``, gloo: the
group carries no device collective, so its workers may share a card), as
the JAX tool's processes join the runtime ``jax.distributed.initialize``
starts from the same variables. Its worker index and count are the
process's. A ``--workers`` driver and its ``--worker-index`` children
(and ``supervise-repick``'s) never join: the children inherit the
driver's environment, not a rank of their own. ``--lease-store kv`` (and ``auto``, which prefers it) then
keeps the leases in the TCP store that process 0 serves, as the JAX
package's coordination service lives in process 0. The group is a fixed
set: a member that dies is not relaunched into it, and process 0 must
outlive the others' store calls, so every member waits for all at the
end; process 0 then merges the catalog if every member succeeded. ``kv``
without a group raises; ``auto`` without one takes ``--lease-dir``
(``tools/repick_archive.py::_lease_store``).

On the card unless ``--device cpu``; without a GPU the default raises::

    python -m seist_tpu_torch repick --archive PACK --out CAT \\
        --model seist_l_dpk[=WEIGHTS.pt] --batch-size 64 --batches-per-call 2
    python -m seist_tpu_torch repick --archive PACK --out CAT \\
        --model-group seist_s=dpk:W1.pt,emg:W2.pt --workers 2 --variant int8
    python -m seist_tpu_torch repick --archive PACK --out CAT --merge-only

Prints ONE JSON verdict line per role (worker, fleet-worker, driver,
merge).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
from typing import Any, Dict, List, Tuple

import numpy as np


def get_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m seist_tpu_torch repick", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archive", required=True, help="packed archive dir (pack's output)")
    ap.add_argument("--out", required=True, help="catalog output dir")
    ap.add_argument("--model", default="", metavar="NAME[=WEIGHTS]",
                    help="single-task model (seeded weights without =WEIGHTS)")
    ap.add_argument("--model-group", default="", metavar="PREFIX=TASK[:WEIGHTS],...",
                    help="SeisT task group run on ONE shared trunk")
    ap.add_argument("--tasks", default="", help="comma-separated subset of a group's heads")
    ap.add_argument("--variant", default="fp32", choices=("fp32", "bf16", "int8"),
                    help="weight variant (parity-gated against fp32 at warm-up; a failing "
                    "gate refuses the run)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--batches-per-call", type=int, default=4,
                    help="micro-batches per device call (one CUDA graph runs them all)")
    ap.add_argument("--commit-every", type=int, default=4,
                    help="segment commit granularity in device calls")
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0, help="seeded-weight seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workers", type=int, default=0,
                    help="driver mode: spawn N worker subprocesses, then merge "
                    "(0 = everything in this process)")
    ap.add_argument("--worker-index", type=int, default=-1,
                    help="worker mode: this worker's index (the driver sets it)")
    ap.add_argument("--num-workers", type=int, default=1,
                    help="worker mode: total workers (the driver sets it)")
    ap.add_argument("--retries", type=int, default=2,
                    help="driver: crash-relaunch budget per worker (preempt exits never "
                    "spend it)")
    ap.add_argument("--fleet", action="store_true",
                    help="lease-based fleet worker (batch/fleet.py): acquire work-unit "
                    "leases with heartbeat and fencing token, reclaim peers' expired "
                    "leases, park through lease-store partitions")
    ap.add_argument("--lease-dir", default="",
                    help="shared-directory lease store (fleet mode; lets --merge-only audit "
                    "segment fences against the done ledger)")
    ap.add_argument("--worker-id", default="",
                    help="fleet mode: this worker's lease owner id (default "
                    "worker<index>@<pid>)")
    ap.add_argument("--lease-store", default="auto", choices=("auto", "dir", "kv"),
                    help="fleet lease store: 'dir' = shared directory (--lease-dir), 'kv' = "
                    "the process group's TCP store (a multi-process launch), 'auto' = kv "
                    "inside a process group, else dir")
    ap.add_argument("--no-merge", action="store_true", help="skip the reduce step")
    ap.add_argument("--merge-only", action="store_true",
                    help="reduce only: merge committed segments into catalog.jsonl "
                    "(no model)")
    ap.add_argument("--compile-gate", action="store_true",
                    help="report compiles_after_warmup: programs built and eager forwards "
                    "after warm-up (must be 0)")
    ap.add_argument("--ppk-threshold", type=float, default=0.3)
    ap.add_argument("--spk-threshold", type=float, default=0.3)
    ap.add_argument("--det-threshold", type=float, default=0.5)
    ap.add_argument("--min-peak-dist", type=float, default=1.0)
    ap.add_argument("--max-events", type=int, default=8)
    ap.add_argument("--station-meta", default="", metavar="FILE",
                    help="JSON file mapping waveform key -> station metadata {'id', "
                    "'network', 'lat', 'lon'}; matched rows carry a 'station' field")
    args = ap.parse_args(argv)
    if args.merge_only:
        # The reduce is model-free: the plan file records the model.
        if args.model or args.model_group:
            ap.error("--merge-only takes no --model/--model-group (the plan file records "
                     "them)")
    elif bool(args.model) == bool(args.model_group):
        ap.error("exactly one of --model / --model-group is required")
    if args.fleet and args.lease_store != "kv" and not args.lease_dir:
        ap.error("--fleet needs --lease-dir (or --lease-store kv in a process group)")
    return args


def _archive_index(archive: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta.json, the index columns planning needs): the model-free
    merge role reads no more."""
    from seist_tpu_torch.data import packed as packed_mod

    with open(os.path.join(archive, packed_mod._META)) as f:
        meta = json.load(f)
    with np.load(os.path.join(archive, packed_mod._INDEX), allow_pickle=False) as z:
        cols = {"shard": z["shard"], "n_samp": z["n_samp"]}
    return meta, cols


def _units_from_cols(cols):
    from seist_tpu_torch.batch import catalog

    return catalog.plan_units(cols["shard"])


def _parse_group(spec: str) -> Tuple[str, List[Tuple[str, str]]]:
    """PREFIX=TASK[:WEIGHTS],... (serve's --model-group grammar)."""
    prefix, sep, rest = spec.partition("=")
    if not sep or not prefix or not rest:
        raise SystemExit(f"bad --model-group '{spec}' (want PREFIX=TASK[:WEIGHTS],...)")
    tasks: List[Tuple[str, str]] = []
    for part in rest.split(","):
        task, _, weights = part.partition(":")
        if not task:
            raise SystemExit(f"empty task in --model-group '{spec}'")
        tasks.append((task, weights))
    return prefix, tasks


def _decode_opts(args) -> Dict[str, Any]:
    return {
        "ppk_threshold": args.ppk_threshold,
        "spk_threshold": args.spk_threshold,
        "det_threshold": args.det_threshold,
        "min_peak_dist": args.min_peak_dist,
        "max_events": args.max_events,
    }


def _plan_dict(args, meta, n_rows: int, n_units: int) -> Dict[str, Any]:
    """Everything that fixes segment boundaries and row content: the
    resume guard (``catalog.write_or_check_plan``), the JAX tool's keys."""
    return {
        "format_version": 1,
        "source": meta.get("source", ""),
        "dtype": meta.get("dtype", "float32"),
        "n_rows": n_rows,
        "n_units": n_units,
        "model": args.model or args.model_group,
        "tasks": args.tasks,
        "variant": args.variant,
        "batch_size": args.batch_size,
        "batches_per_call": args.batches_per_call,
        "commit_every": args.commit_every,
        "sampling_rate": int(meta["sampling_rate"]),
        "decode": _decode_opts(args),
    }


def _merge(args, meta, units, print_verdict: bool = True, lease_store=None) -> Dict[str, Any]:
    from seist_tpu_torch.batch import catalog

    # Segment geometry and model identity come from the RECORDED plan,
    # never from this invocation's flags (other defaults would count
    # fewer segments and drop rows).
    plan = catalog.read_plan(args.out)
    rows_per_call = int(plan["batch_size"]) * int(plan["batches_per_call"])
    # A fleet merge audits every segment's fence sidecar against the lease
    # store's done ledger; catalog.jsonl's bytes are the same either way.
    fences = None
    if lease_store is not None:
        fences = lease_store.done_fences([u.unit_id for u in units])
    elif args.lease_dir and os.path.isdir(args.lease_dir):
        from seist_tpu_torch.batch import fleet

        fences = fleet.DirLeaseStore(args.lease_dir).done_fences([u.unit_id for u in units])
    out_meta = catalog.merge_catalog(
        args.out, units, rows_per_call, int(plan["commit_every"]),
        meta={
            "archive_source": meta.get("source", ""),
            "sampling_rate": int(meta["sampling_rate"]),
            "model": plan["model"],
            "variant": plan["variant"],
            "plan": plan,
        },
        fences=fences,
    )
    verdict = {"ok": True, "role": "merge", "out": args.out, "rows": out_meta["n_rows"],
               "units": out_meta["n_units"]}
    if fences is not None:
        verdict["fence_audit"] = out_meta["fleet"]
    if print_verdict:
        print(json.dumps(verdict), flush=True)
    return verdict


def _load_entry(args, window: int):
    from seist_tpu_torch.serve.pool import load_group_entry, load_model_entry

    variants = (args.variant,)
    if args.model_group:
        prefix, task_entries = _parse_group(args.model_group)
        return load_group_entry(prefix, task_entries, window=window, seed=args.seed,
                                device=args.device, variants=variants)
    name, _, weights = args.model.partition("=")
    return load_model_entry(name, weights, window=window, seed=args.seed, device=args.device,
                            variants=variants)


def _load_station_meta(path: str):
    """--station-meta FILE -> {key: station dict} or None, each block
    checked by serve's ``parse_station`` (one schema with /stream's)."""
    if not path:
        return None
    from seist_tpu_torch.serve.protocol import BadRequest, parse_station

    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise SystemExit(f"--station-meta {path}: want a JSON object mapping waveform key -> "
                         "station metadata")
    out = {}
    for key, st in raw.items():
        try:
            out[str(key)] = parse_station(st, required=True)
        except BadRequest as e:
            raise SystemExit(f"--station-meta {path}: key {key!r}: {e}")
    return out


def build_engine(args):
    """(engine, work units) for one worker: the whole archive in pack
    order as a :class:`PackedRawStore` (no shuffle, no split, no labels),
    the entry on ``args.device``, the engine over both; the plan file is
    written or checked first."""
    from seist_tpu_torch.batch import catalog
    from seist_tpu_torch.batch.engine import RepickEngine
    from seist_tpu_torch.data import pipeline
    from seist_tpu_torch.data.ingest import PackedRawStore, packed_dataset_of
    from seist_tpu_torch.serve.pool import resolve_device

    device = resolve_device(args.device)
    meta, cols = _archive_index(args.archive)
    units = _units_from_cols(cols)
    if not units:
        raise SystemExit(f"archive {args.archive} has no rows")
    raw_len = int(cols["n_samp"][0])
    rows_per_call = args.batch_size * args.batches_per_call
    os.makedirs(args.out, exist_ok=True)
    catalog.write_or_check_plan(args.out, _plan_dict(args, meta, len(cols["shard"]), len(units)))
    sds = pipeline.SeismicDataset(
        "packed", "train", seed=0, data_dir=args.archive, input_names=[], label_names=[],
        task_names=[], in_samples=raw_len, augmentation=False, shuffle=False,
        data_split=False)
    pds = packed_dataset_of(sds)
    # An int8 pack feeds the device-dequant path: rows stay int8 through
    # staging and the copy to the card. On the card the engine copies each
    # fill into pinned memory, so one staging slab serves every call; on
    # the CPU a call's tensors alias its slab, so each fill gets its own.
    store = PackedRawStore.build(sds, batch_size=rows_per_call,
                                 reuse_staging=device.type == "cuda",
                                 stage_raw=pds.dtype == "int8")
    entry = _load_entry(args, raw_len)
    engine = RepickEngine(
        entry, store, sampling_rate=int(meta["sampling_rate"]), batch_size=args.batch_size,
        batches_per_call=args.batches_per_call, variant=args.variant,
        decode_opts=_decode_opts(args), keys=np.asarray(pds._meta_data["key"]),
        stations=_load_station_meta(args.station_meta), prefetch=args.prefetch,
        tasks=[t for t in args.tasks.split(",") if t] or None)
    return engine, units


def run_worker(args, worker_index: int, num_workers: int) -> int:
    """One map worker: store, entry and engine, this worker's units, and
    SIGTERM drained at a segment boundary with exit 75."""
    from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE, ProgressFile

    engine, units = build_engine(args)
    stop = threading.Event()
    # The handler only sets a flag: the drain runs on the main thread at
    # the next segment boundary.
    previous = signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    try:
        if args.fleet:
            return _run_fleet_worker(args, worker_index, units, engine, stop)
        mine = list(units)[worker_index::num_workers]
        progress = ProgressFile(os.path.join(args.out, f"worker_{worker_index}.json"))
        engine.warmup()
        stats = engine.run_units(mine, args.out, commit_every=args.commit_every,
                                 stop_event=stop, compile_gate=args.compile_gate,
                                 progress=progress)
    finally:
        signal.signal(signal.SIGTERM, previous)
    verdict = {
        "ok": not stats["preempted"],
        "role": "worker",
        "worker": worker_index,
        "num_workers": num_workers,
        "units_assigned": len(mine),
        **stats,
        **{f"warmup_{k}": v for k, v in engine.warmup_report.items()},
    }
    print(json.dumps(verdict), flush=True)
    return PREEMPT_EXIT_CODE if stats["preempted"] else 0


def _lease_store(args):
    """The configured lease store (``tools/repick_archive.py:358-370``):
    'auto' prefers the KV store over the process group's TCP store and
    falls back to the directory store outside a group; 'kv' raises
    :class:`~seist_tpu_torch.batch.fleet.LeaseStoreError` there."""
    from seist_tpu_torch.batch import fleet

    if args.lease_store in ("auto", "kv"):
        try:
            return fleet.KVLeaseStore.from_runtime()
        except fleet.LeaseStoreError:
            if args.lease_store == "kv":
                raise
    return fleet.DirLeaseStore(args.lease_dir)


def _run_fleet_worker(args, worker_index, units, engine, stop) -> int:
    """One FLEET worker: every unit is a candidate (work-stealing over
    leases, the scan rotated by the worker index); each leased unit runs
    with the fence check before every segment commit. Exits 75 on
    preemption; the supervisor relaunches it and it re-joins whatever work
    is still open."""
    from seist_tpu_torch.batch import fleet
    from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE, ProgressFile

    owner = args.worker_id or f"worker{max(worker_index, 0)}@{os.getpid()}"
    store = _lease_store(args)
    progress = ProgressFile(os.path.join(args.out, f"fleet_{max(worker_index, 0)}.json"))
    engine.warmup()  # build the program BEFORE any lease's TTL is ticking
    totals = {"rows": 0, "calls": 0, "segments": 0}

    def run_one(unit, held):
        u = engine.run_unit(unit, args.out, commit_every=args.commit_every, stop_event=stop,
                            lease=held)
        for k in totals:
            totals[k] += u[k]
        progress.save({"owner": owner, "unit": unit.unit_id, "fence": held.fence,
                       "preempted": u["preempted"], **totals})
        return u

    worker = fleet.FleetWorker(store, units, owner, run_one, stop_event=stop,
                               scan_offset=max(worker_index, 0))
    builds0 = engine.builds()
    stats = worker.run()
    verdict = {
        "ok": stats["all_done"] or stats["preempted"],
        "role": "fleet-worker",
        "worker": worker_index,
        "owner": owner,
        "store": type(store).__name__,
        **{k: stats[k] for k in ("units_done", "units_lost", "parks", "preempted",
                                 "all_done")},
        **totals,
        "lease": stats["lease"],
        "program_calls": engine.program_calls,
        **{f"warmup_{k}": v for k, v in engine.warmup_report.items()},
    }
    if args.compile_gate:
        verdict["compiles_after_warmup"] = engine.builds() - builds0
        verdict["xla_compiles_after_warmup"] = 0
    print(json.dumps(verdict), flush=True)
    if stats["preempted"] and not stats["all_done"]:
        return PREEMPT_EXIT_CODE
    return 0 if verdict["ok"] else 1


def _worker_cmd(args, worker_index: int) -> List[str]:
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
        "--worker-index", str(worker_index),
        "--num-workers", str(args.workers),
        "--no-merge",
        "--ppk-threshold", str(args.ppk_threshold),
        "--spk-threshold", str(args.spk_threshold),
        "--det-threshold", str(args.det_threshold),
        "--min-peak-dist", str(args.min_peak_dist),
        "--max-events", str(args.max_events),
    ]
    if args.model:
        cmd += ["--model", args.model]
    if args.model_group:
        cmd += ["--model-group", args.model_group]
    if args.tasks:
        cmd += ["--tasks", args.tasks]
    if args.compile_gate:
        cmd += ["--compile-gate"]
    if args.station_meta:
        cmd += ["--station-meta", args.station_meta]
    return cmd


def run_driver(args) -> int:
    """Map-reduce driver: spawn the workers, relaunch preempted or crashed
    ones (a preempt exit never spends the crash budget), then reduce."""
    from seist_tpu_torch.obs.bus import monotonic
    from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE

    t0 = monotonic()
    meta, cols = _archive_index(args.archive)
    units = _units_from_cols(cols)
    budget = {i: args.retries for i in range(args.workers)}
    pending = list(range(args.workers))
    failed: List[int] = []
    while pending:
        procs = {i: subprocess.Popen(_worker_cmd(args, i)) for i in pending}
        pending = []
        for i, p in procs.items():
            rc = p.wait()
            if rc == 0:
                continue
            if rc == PREEMPT_EXIT_CODE:
                pending.append(i)  # resume, budget untouched
            elif budget[i] > 0:
                budget[i] -= 1
                pending.append(i)
            else:
                failed.append(i)
    if failed:
        print(json.dumps({"ok": False, "role": "driver",
                          "error": f"worker(s) {failed} exhausted the relaunch budget"}))
        return 1
    verdict: Dict[str, Any] = {"ok": True, "role": "driver", "workers": args.workers,
                               "units": len(units), "wall_s": round(monotonic() - t0, 2)}
    if not args.no_merge:
        merged = _merge(args, meta, units, print_verdict=False)
        verdict["rows"] = merged["rows"]
        verdict["out"] = args.out
    print(json.dumps(verdict), flush=True)
    return 0


def main(argv=None) -> int:
    args = get_args(argv)
    import seist_tpu_torch

    seist_tpu_torch.load_all()
    if args.merge_only:
        meta, cols = _archive_index(args.archive)
        _merge(args, meta, _units_from_cols(cols))
        return 0
    if args.workers > 0:
        return run_driver(args)
    if args.worker_index >= 0:
        # A driver's or a supervisor's child: it inherits their env, but
        # its index and count are its own, so it never joins a group.
        return run_worker(args, args.worker_index, args.num_workers)
    from seist_tpu_torch.parallel import dist

    if dist.init_distributed_mode(device="cpu"):
        return _run_group_member(args)
    # Inline: one process maps every unit, then reduces.
    rc = run_worker(args, 0, 1)
    if rc == 0 and not args.no_merge:
        meta, cols = _archive_index(args.archive)
        _merge(args, meta, _units_from_cols(cols))
    return rc


def _run_group_member(args) -> int:
    """One process of a multi-process launch (module docstring): its
    worker (index and count the group's), then every member's exit code
    gathered, then process 0's merge, audited against the KV store's done
    ledger when the fleet kept its leases there."""
    from seist_tpu_torch.parallel import dist

    try:
        rc = run_worker(args, dist.process_index(), dist.process_count())
        codes = dist.all_gather_object(rc)  # every member waits for all
        if dist.is_main_process() and not args.no_merge and not any(codes):
            meta, cols = _archive_index(args.archive)
            kv = None
            if args.fleet and args.lease_store != "dir":  # the fleet's leases are in the group
                from seist_tpu_torch.batch import fleet

                kv = fleet.KVLeaseStore.from_runtime()
            _merge(args, meta, _units_from_cols(cols), lease_store=kv)
        return rc
    finally:
        dist.shutdown()


if __name__ == "__main__":
    sys.exit(main())
