"""The re-picking lane: ``batch/engine.py::RepickEngine.run_units`` over a
packed archive written at set-up, with the ``repick`` entry's defaults.

Set-up draws the archive's traces on the device from the seed, packs them
with the program's packer at the ``pack`` entry's defaults (float32,
shards of up to 512 MB: 2,048 traces make one shard) under the run's
``TMPDIR`` (in the page cache from then on), makes the weights (the benchmark's
seeded draw, with every BatchNorm's running statistics set by the
reference from the first ``calibration_rows`` traces, so that the outputs
follow the waveform), loads them through ``serve/pool.py::load_model_entry``
as ``repick`` does, builds the engine, warms it up and runs one whole
pass untimed.

The window runs whole passes over the archive, each into a fresh catalog
directory (the one before is deleted, but the first pass's, which the
check reads), until ``seconds`` have passed; the rate is every catalog row
committed over the window's wall time. In the first pass alone the rows
of a sample drawn from the seed have their output curves kept on the
device as the engine hands them to its decode (a hook on the engine's
decode, removed after that pass).

The check, once the window has closed: the reference's normalisation and
forward of the sampled traces against the kept curves (``curve_gap``); the
reference picker on the kept curves against the committed catalog rows
(``row_mismatch``, exact); every row of every pass committed, by the
engine's count and by the first pass's catalog files (``rows_missing``).
"""

from __future__ import annotations

import gc
import glob
import json
import os
import shutil
import time
from typing import Any, Dict

import numpy as np
import torch

from portbench.lib import traffic as gen
from portbench.lib import weights as wlib
from portbench.lib.harness import Check, Outcome, sync
from portbench.reference import picker
from portbench.reference import train as ref


class _Archive:
    """The generated traces as the packer's source: ``(event, row)`` per
    index, ``data`` (C, L)."""

    def __init__(self, data: np.ndarray, fs: int):
        self.data, self.fs = data, fs

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, j):
        return {"data": self.data[j]}, {"key": f"pb{j:06d}"}

    def channels(self):
        return ["z", "n", "e"][: self.data.shape[1]]

    def sampling_rate(self):
        return self.fs

    def name(self):
        return "portbench"


def write_archive(data: np.ndarray, out: str, fs: int) -> None:
    """The traces packed as the ``pack`` entry packs an archive: its default
    shard size and float32."""
    from seist_tpu_torch.data.packed import PackSource, pack_sources

    pack_sources([PackSource(dataset=_Archive(data, fs))], out, resume=False, dtype="float32")


def calibrate(cfg: Dict, w: Dict[str, torch.Tensor], raw: torch.Tensor) -> None:
    """Every BatchNorm's running statistics, in place: the batch statistics
    of the reference's forward over ``raw`` (B, C, L) with its BatchNorms in
    training mode (and no dropout)."""
    model = ref.build_model(cfg).to(raw.device)
    model.load_state_dict(w, strict=True)
    model.eval()
    for m in model.modules():
        if hasattr(m, "running_var"):
            m.train()
            m.momentum = 1.0  # the running statistics become this batch's
    with torch.no_grad(), ref.tf32(False):
        model(picker.normalize(raw))
    state = model.state_dict()
    for k in w:
        if k.endswith(("running_mean", "running_var")):
            w[k] = state[k].detach().clone()
    del model


def reference_curves(cfg: Dict, w: Dict[str, torch.Tensor], raw: torch.Tensor, block: int,
                     allow_tf32: bool = False) -> torch.Tensor:
    model = ref.build_model(cfg).to(raw.device)
    model.load_state_dict(w, strict=True)
    model.eval()
    outs = []
    with torch.no_grad(), ref.tf32(allow_tf32):
        for lo in range(0, raw.shape[0], block):
            outs.append(model(picker.normalize(raw[lo:lo + block])))
    del model
    return torch.cat(outs)


def _rows(path: str) -> Dict[int, Dict[str, Any]]:
    rows = {}
    for seg in sorted(glob.glob(os.path.join(path, "*.jsonl"))):
        with open(seg) as f:
            for line in f:
                r = json.loads(line)
                rows[int(r["row"])] = r
    return rows


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    fs = int(cfg["sampling_rate"])
    n = int(tr["traces"])
    s_weights, s_traffic, s_sample = gen.sub_seeds(ctx.seed, 3)
    work = os.path.join(ctx.tmpdir, "portbench_repick")
    shutil.rmtree(work, ignore_errors=True)
    archive = os.path.join(work, "archive")
    os.makedirs(archive)
    try:
        raw, _ = gen.traces(gen.generator(s_traffic, dev), n, tr, dev)
        write_archive(raw.cpu().numpy(), archive, fs)
        ref_model = ref.build_model(cfg)
        w = wlib.make_weights(ref_model, s_weights, dev)
        del ref_model
        calibrate(cfg, w, raw[: int(tr["calibration_rows"])])
        weights_path = os.path.join(work, "weights.pt")
        torch.save({k: v.cpu() for k, v in w.items()}, weights_path)
        sample = np.sort(np.random.default_rng(s_sample).choice(
            n, int(tr["sample_rows"]), replace=False))
        return _run(ctx, raw, w, weights_path, archive, work, sample)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(ctx, raw, w, weights_path, archive, work, sample) -> Outcome:
    from seist_tpu_torch.batch import catalog
    from seist_tpu_torch.batch.engine import RepickEngine
    from seist_tpu_torch.data import pipeline
    from seist_tpu_torch.data.ingest import PackedRawStore, packed_dataset_of
    from seist_tpu_torch.serve.pool import load_model_entry

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n = raw.shape[0]
    opts = {k: tr[k] for k in ("ppk_threshold", "spk_threshold", "det_threshold",
                               "min_peak_dist_s", "max_events")}
    opts["sampling_rate"] = int(cfg["sampling_rate"])
    sds = pipeline.SeismicDataset(
        "packed", "train", seed=0, data_dir=archive, input_names=[], label_names=[],
        task_names=[], in_samples=cfg["window"], augmentation=False, shuffle=False,
        data_split=False)
    pds = packed_dataset_of(sds)
    rows_per_call = int(tr["batch"]) * int(tr["batches_per_call"])
    store = PackedRawStore.build(sds, batch_size=rows_per_call,
                                 reuse_staging=dev.type == "cuda")
    entry = load_model_entry(cfg["program_model"], weights_path, window=cfg["window"],
                             device=str(dev))
    engine = RepickEngine(
        entry, store, sampling_rate=int(cfg["sampling_rate"]), batch_size=int(tr["batch"]),
        batches_per_call=int(tr["batches_per_call"]), variant="fp32",
        decode_opts={"ppk_threshold": opts["ppk_threshold"],
                     "spk_threshold": opts["spk_threshold"],
                     "det_threshold": opts["det_threshold"],
                     "min_peak_dist": opts["min_peak_dist_s"],
                     "max_events": opts["max_events"]},
        keys=np.asarray(pds._meta_data["key"]), prefetch=int(tr["prefetch"]))
    units = catalog.plan_units(np.asarray(pds._meta_data["shard"]))
    commit_every = int(tr["commit_every"])

    kept: Dict[int, torch.Tensor] = {}

    def keep_then_decode(out, *, n_valid, row_lo):
        for task_out in out.values():
            flat = task_out.reshape((rows_per_call,) + tuple(task_out.shape[2:]))
            for r in sample[(sample >= row_lo) & (sample < row_lo + n_valid)]:
                kept[int(r)] = flat[int(r) - row_lo].clone()
        return RepickEngine._decode_call(engine, out, n_valid=n_valid, row_lo=row_lo)

    engine.warmup()
    warm = os.path.join(work, "warm")
    os.makedirs(warm)
    engine.run_units(units, warm, commit_every=commit_every)
    shutil.rmtree(warm)
    sync(dev)
    setup_s = time.time() - ctx.t_start

    first = os.path.join(work, "pass0")
    passes, rows_done, rows_missing = 0, 0, 0
    stage0 = dict(engine.stage)
    calls0 = engine.program_calls
    previous = None
    t0 = time.perf_counter()
    while True:
        out = first if passes == 0 else os.path.join(work, f"pass{passes}")
        os.makedirs(out)
        if passes == 0:  # the first pass's curves of the sampled rows, for the check
            engine._decode_call = keep_then_decode
        stats = engine.run_units(units, out, commit_every=commit_every)
        if passes == 0:
            del engine._decode_call  # the engine's own decode again
        rows_done += int(stats["rows"])
        rows_missing += n - int(stats["rows"])
        if previous is not None and previous != first:
            shutil.rmtree(previous)
        previous = out
        passes += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    calls = engine.program_calls - calls0
    stage = {k: engine.stage[k] - stage0[k] for k in stage0}

    run_info: Dict[str, Any] = {
        "lane": "repick", "wall_s": wall, "waveforms": rows_done, "passes": passes,
        "calls": calls, "stage_s": stage, "batch": int(tr["batch"]),
        "batches_per_call": int(tr["batches_per_call"]), "config": cfg, "peaks": ctx.peaks,
    }
    device: Dict[str, Any] = {}
    if ctx.trace:
        from portbench.lib import trace
        from seist_tpu_torch.obs.bus import BUS

        k = [0]

        def one():
            d = os.path.join(work, f"traced{k[0]}")
            os.makedirs(d)
            engine.run_units(units, d, commit_every=commit_every)
            shutil.rmtree(d)
            k[0] += 1

        per_pass = calls // passes  # device calls of one whole pass
        expect = {p: int(c) * per_pass for p, c in ctx.spec.get("trace_expect", {}).items()}
        summary = trace.profile_calls(one, int(tr["trace_passes"]), lambda: sync(dev),
                                      ctx.tmpdir, expect, span_bus=BUS)
        run_info["trace"] = summary
        run_info["trace_calls"] = int(tr["trace_passes"]) * per_pass
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
    if dev.type == "cuda":
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))

    # The check, with the program's state freed.
    t_check = time.perf_counter()
    committed = _rows(first)
    rows_missing += n - len(committed)
    curves = {r: kept[r].float().cpu().numpy() for r in kept}
    del engine, entry, store, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    idx = torch.as_tensor(sample, device=raw.device)
    want = reference_curves(ctx.config, w, raw[idx], int(tr["reference_block"]))
    want = want.cpu().numpy()
    gap, mismatched = 0.0, 0
    for j, r in enumerate(sample):
        r = int(r)
        if r not in curves or r not in committed:
            gap, mismatched = float("inf"), mismatched + 1
            continue
        gap = max(gap, float(np.max(np.abs(curves[r] - want[j]))))
        row = committed[r]
        if {k: row.get(k) for k in ("det", "ppk", "spk")} != picker.pick_row(curves[r], opts):
            mismatched += 1
    limits = ctx.spec["limits"]
    checks = [Check("curve_gap", gap, float(limits["curve_gap"])),
              Check("row_mismatch", float(mismatched), float(limits["row_mismatch"])),
              Check("rows_missing", float(rows_missing), float(limits["rows_missing"]))]
    extra: Dict[str, Any] = {}
    if ctx.readings:
        ctrl = reference_curves(ctx.config, w, raw[idx], int(tr["reference_block"]),
                                allow_tf32=True).cpu().numpy()
        extra["readings"] = {"control_tf32": {"curve_gap": float(np.max(np.abs(ctrl - want)))}}
    picks = sum(len(committed[int(r)].get(k, [])) for r in sample if int(r) in committed
                for k in ("ppk", "spk", "det"))
    extra["sampled_picks"] = picks
    extra["check_s"] = time.perf_counter() - t_check
    return Outcome(
        attempted=rows_done, failed=mismatched, checks=checks,
        e2e={"setup_s": setup_s, "repick_waveforms_per_s": rows_done / wall},
        run=run_info, device=device, extra=extra)


