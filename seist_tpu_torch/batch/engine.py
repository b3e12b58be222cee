"""Archive re-picking: a straight-line device feed (the port's counterpart
of ``seist_tpu/batch/engine.py``).

Serving answers one trace in milliseconds; this engine answers the
opposite traffic: re-pick a whole packed archive when a model improves,
purely throughput-bound. It is not a client of the serving stack (no
HTTP, no micro-batcher, no per-request decode). Per work unit (one packed
shard, ``batch/catalog.py``):

* **fill**: :class:`~seist_tpu_torch.data.ingest.PackedRawStore` fills a
  staging batch (one copy per sample out of the shard's memmap) on a
  producer thread, ahead of the device through
  ``data/pipeline.py::_double_buffer``. The transform (:meth:`_put`)
  copies the slab into pinned memory and starts its host-to-device copy
  with ``non_blocking=True`` on a copy stream of its own, recording an
  event the consumer's stream waits on before the replay: no host
  synchronisation on the way in. The data-plane guard's retries and
  ``(seed=0, epoch=0, row)``-keyed quarantine fallbacks apply, so resume
  stays byte-identical under injected corruption. An int8 pack with
  ``stage_raw`` crosses the bus as int8 with a per-row scale.
* **device**: ONE program per engine (``serve/aot.py::aot_compile_multi``):
  ``batches_per_call`` full batches enter with a leading step axis, and
  one CUDA graph runs [:func:`dequant_rows` ->] :func:`normalize_transpose`
  -> forward (or trunk -> requested heads for a task group) over each of
  them: the counterpart of the JAX package's ``lax.map`` program, K1
  inside every SeisT forward. On the CPU the same program runs eagerly.
* **decode**: ``ops/postprocess.py::decode_head_batch`` on the device,
  then ONE device-to-host copy per call (every head's results packed into
  one byte buffer), then ``ops/results.py::catalog_rows``;
* **write**: rows committed per segment by ``catalog.commit_segment``
  (temporary file and rename), the resume granularity.

Variants: the program is built under the serving weight conventions
(``aot.variant_compute`` / ``transform_variables``); a non-fp32 variant
is parity-gated at warm-up against the engine's own fp32 program, per
head for groups, and a failing gate refuses the run.

Straight-line check (``run_units(compile_gate=True)``): the JAX package
counts XLA traces and compiles after warm-up. The port compiles nothing;
what would break the contract is a new graph capture or an eager forward
(an entry's ``fallback_runs`` included), and their count after warm-up is
reported as ``compiles_after_warmup`` (0 expected);
``xla_compiles_after_warmup`` is 0 by construction.

Telemetry: the bus counters ``batch_infer_{batches,calls,waveforms,bytes}``,
the spans ``batch_infer_{fill,device,decode,write}``, the prefetch
backpressure ``batch_infer_backpressure_s``; the same stage budget is kept
in :attr:`RepickEngine.stage`.

Faults: ``SEIST_FAULT_REPICK_SLOW_MS`` sleeps that long per device call
(a SIGKILL then lands mid-unit).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from seist_tpu_torch.batch import catalog
from seist_tpu_torch.obs.bus import BUS, monotonic
from seist_tpu_torch.ops.postprocess import decode_head_batch
from seist_tpu_torch.ops.results import catalog_row_lines, catalog_rows
from seist_tpu_torch.serve import aot
from seist_tpu_torch.train.graph import _flat, _unflat
from seist_tpu_torch.utils.logger import logger

#: Decode thresholds (``serve/protocol.py::PredictOptions``' defaults).
DEFAULT_DECODE = {
    "ppk_threshold": 0.3,
    "spk_threshold": 0.3,
    "det_threshold": 0.5,
    "min_peak_dist": 1.0,
    "max_events": 8,
}


def normalize_transpose(raw: torch.Tensor) -> torch.Tensor:
    """In-program input preparation: (B, C, L) float32 -> normalised
    channels-last (B, L, C), the 'std' z-score serving applies on the host
    (mean removed, divided by the population std, a zero std by 1)."""
    x = raw - raw.mean(dim=2, keepdim=True)
    std = raw.std(dim=2, keepdim=True, correction=0)
    x = x / torch.where(std == 0, torch.ones_like(std), std)
    return x.transpose(1, 2)


def dequant_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """In-program dequantisation of int8 rows: (B, C, L) int8 and per-row,
    per-channel (B, C) float32 scales -> float32 waveforms, widened on the
    device. The z-score of :func:`normalize_transpose` is invariant to a
    per-channel scale, so int8 storage differs from float32 by rounding
    alone."""
    return q.to(torch.float32) * scale[:, :, None]


def _to_host(tree: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """Every tensor of ``{task: {name: tensor}}`` on the host through ONE
    copy: their bytes packed into one buffer on the device, copied, and
    split back into arrays of their dtypes and shapes."""
    leaves = [(task, name, t.contiguous()) for task, outs in tree.items()
              for name, t in outs.items()]
    if not leaves:
        return {}
    blob = torch.cat([t.reshape(-1).view(torch.uint8) for _, _, t in leaves]).cpu().numpy()
    out: Dict[str, Dict[str, np.ndarray]] = {task: {} for task in tree}
    at = 0
    for task, name, t in leaves:
        n = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[task][name] = blob[at:at + n].view(dtype).reshape(tuple(t.shape))
        at += n
    return out


class RepickEngine:
    """One worker's archive re-picking loop: a loaded pool entry
    (``ModelEntry`` or ``MultiTaskEntry``) driven at full batch straight
    off a :class:`~seist_tpu_torch.data.ingest.PackedRawStore`."""

    def __init__(
        self,
        entry: Any,
        store: Any,
        *,
        sampling_rate: int,
        batch_size: int = 64,
        batches_per_call: int = 4,
        variant: str = "fp32",
        decode_opts: Optional[Dict[str, Any]] = None,
        keys: Optional[Sequence[str]] = None,
        stations: Optional[Dict[str, Dict[str, Any]]] = None,
        prefetch: int = 2,
        tasks: Optional[Sequence[str]] = None,
    ) -> None:
        if entry.window != store.raw_len:
            raise ValueError(
                f"model window {entry.window} != archive trace length {store.raw_len}; the "
                "repick engine feeds one archive row per window (load the entry with "
                "window=raw_len)")
        if entry.in_channels != store.n_ch:
            raise ValueError(f"model wants {entry.in_channels} channels, archive has {store.n_ch}")
        if variant not in aot.VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; use one of {aot.VARIANTS}")
        if not entry.is_group and hasattr(entry.model, "captured_inputs") \
                and entry.device.type == "cuda":
            raise ValueError(
                f"model '{entry.name}' computes part of its input on the host before a "
                "replay (captured_inputs); the repick program normalises inside the graph, "
                "so it runs on the CPU only")
        self.entry = entry
        self.store = store
        self.device = entry.device
        self.sampling_rate = int(sampling_rate)
        self.batch_size = int(batch_size)
        self.batches_per_call = int(batches_per_call)
        self.rows_per_call = self.batch_size * self.batches_per_call
        self.variant = variant
        self.decode_opts = {**DEFAULT_DECODE, **(decode_opts or {})}
        self.keys = np.asarray(keys) if keys is not None else None
        # {key: station metadata} for the catalog's provenance blocks.
        self.stations = dict(stations) if stations else None
        self.prefetch = int(prefetch)
        self.tasks = (tuple(tasks) if tasks is not None
                      else (tuple(entry.tasks) if entry.is_group else (entry.name,)))
        if entry.is_group:
            unknown = [t for t in self.tasks if t not in entry.heads]
            if unknown:
                raise ValueError(f"group '{entry.name}' does not serve tasks {unknown}; "
                                 f"available: {list(entry.tasks)}")
        # int8 end to end: a stage_raw store hands over int8 rows and their
        # resident scales; the program dequantises on the device.
        self.stage_raw = bool(getattr(store, "stage_raw", False))
        self._program: Optional[aot.Program] = None
        self._warm = False
        self._slow_ms = float(os.environ.get("SEIST_FAULT_REPICK_SLOW_MS", "0") or 0)
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self.stage = {"fill": 0.0, "device": 0.0, "decode": 0.0, "write": 0.0}
        self.warmup_report: Dict[str, Any] = {}
        self._c_batches = BUS.counter("batch_infer_batches")
        self._c_calls = BUS.counter("batch_infer_calls")
        self._c_waveforms = BUS.counter("batch_infer_waveforms")
        self._c_bytes = BUS.counter("batch_infer_bytes")

    # ------------------------------------------------------------ programs
    def _step_fn(self, variant: str):
        """One micro-batch's program body: [dequant ->] prep -> forward
        (single model) or trunk -> requested heads (group fan-out), under
        the serving variant conventions, the variant's weights made once
        here. stage_raw stores add the (B, C) scale argument."""
        entry = self.entry
        if not entry.is_group:
            apply = aot.make_variant_apply(lambda m, x: m(x), entry.model, variant)
            task = self.tasks[0]

            def body(x):
                return {task: apply(x)}

        else:
            trunk = aot.make_variant_apply(lambda m, x: m.backbone(x), entry.trunk_model,
                                           variant, cast_outputs=False)
            compute = aot.head_variant_compute(variant)
            heads = {t: aot.transform_variables(entry.heads[t].head, variant)
                     for t in self.tasks}
            window = entry.window

            def body(x):
                feats = trunk(x)
                return {t: compute(heads[t], feats, window) for t in self.tasks}

        if self.stage_raw:
            def step(raw, scale):
                return body(normalize_transpose(dequant_rows(raw, scale)))
        else:
            def step(raw):
                return body(normalize_transpose(raw))
        return step

    def _arg_shapes(self):
        """The per-step signature: stage_raw programs take the int8 rows as
        stored and their scales."""
        b, c, n = self.batch_size, self.store.n_ch, self.store.raw_len
        if self.stage_raw:
            return [((b, c, n), torch.int8), ((b, c), torch.float32)]
        return [((b, c, n), torch.float32)]

    def _attention_flops(self) -> float:
        model = self.entry.trunk_model if self.entry.is_group else self.entry.model
        return aot.attention_flops(model, self.batch_size, self.entry.window)

    def _compile(self, variant: str) -> aot.Program:
        key = (f"repick/{self.entry.name}/b{self.batch_size}x{self.batches_per_call}/{variant}"
               + ("+i8shards" if self.stage_raw else ""))
        return aot.aot_compile_multi(key, self._step_fn(variant), self._arg_shapes(),
                                     steps=self.batches_per_call, device=self.device,
                                     attention=self._attention_flops())

    def _call_args(self, raw: np.ndarray, scale: Optional[np.ndarray]) -> List[torch.Tensor]:
        args = [torch.from_numpy(raw).to(self.device)]
        if self.stage_raw:
            args.append(torch.from_numpy(scale).to(self.device))
        return args

    def warmup(self) -> Dict[str, Any]:
        """Build the full-batch program (gating a non-fp32 variant against
        the engine's own fp32 program) and push one call through the whole
        path (replay, decode, the copy to the host), so nothing is built
        after this returns."""
        t0 = monotonic()
        mem0 = 0
        if self.device.type == "cuda":
            # A capture empties the allocator's cache first, so the
            # baseline leaves out cached free blocks as well.
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved(self.device)
        program = self._compile(self.variant)
        if self.variant != "fp32":
            ref_prog = self._compile("fp32")
            self._gate_variant(ref_prog, program)
            del ref_prog
        self._program = program
        shape = (self.batches_per_call, self.batch_size, self.store.n_ch, self.store.raw_len)
        if self.stage_raw:
            args = self._call_args(np.zeros(shape, np.int8), np.ones(shape[:3], np.float32))
        else:
            args = self._call_args(np.zeros(shape, np.float32), None)
        out = program(*args)
        self._decode_call(out, n_valid=1, row_lo=0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = True
        self.stage = {k: 0.0 for k in self.stage}
        graph_mib = ((torch.cuda.memory_reserved(self.device) - mem0) / 2**20
                     if self.device.type == "cuda" else 0.0)
        self.warmup_report = {
            "program": program.key,
            # The JAX package's compile time; here the program's build
            # (FLOP count, warm-up runs, capture).
            "compile_ms": round(program.capture_s * 1e3, 1),
            "capture_s": round(program.capture_s, 3),
            "graph_memory_mib": round(graph_mib, 1),
            "flops_per_call": program.flops,
            "k1_launches_per_call": program.launches[0],
            "warmup_s": round(monotonic() - t0, 2),
        }
        logger.info(f"[repick] program {program.key} ({program.capture_s:.2f} s, "
                    f"{program.flops:.3g} flops/call, K1 launches per call "
                    f"{program.launches[0]})")
        return self.warmup_report

    def _gate_variant(self, ref_prog: aot.Program, var_prog: aot.Program) -> None:
        """Decision-level parity of the variant program against fp32 on a
        deterministic probe, per head for groups. A failing head refuses
        the run: re-picking an archive wrong is worse than slower."""
        rng = np.random.default_rng(0)
        probe = rng.standard_normal(
            (self.batches_per_call, self.batch_size, self.store.n_ch, self.store.raw_len)
        ).astype(np.float32)
        if self.stage_raw:
            # The pack-time quantizer, so both programs see the archive's
            # inputs and differ by the weight variant alone.
            from seist_tpu_torch.data import packed

            k, b, c, n = probe.shape
            q, sc = packed.quantize_rows(probe.reshape(-1, n))
            args = self._call_args(q.reshape(k, b, c, n), sc.reshape(k, b, c))
        else:
            args = self._call_args(probe, None)
        ref = ref_prog(*args)
        out = var_prog(*args)
        failed = []
        for task in self.tasks:
            spec = self.entry.heads[task].spec if self.entry.is_group else self.entry.spec
            # head_scale: on the TaskHead for groups, on the model for a
            # single-task entry (ModelEntry.head_scale reads the model).
            scale_owner = self.entry.heads[task] if self.entry.is_group else self.entry
            kind, _ = aot.parity_kind(spec)
            scale = float(getattr(scale_owner, "head_scale", 1.0) or 1.0)
            ok, err = aot.variant_parity(_first_leaf(ref[task]), _first_leaf(out[task]),
                                         self.variant, kind=kind, scale=scale)
            logger.info(f"[repick] variant gate {self.entry.name}/{task}/{self.variant}: "
                        f"{'ok' if ok else 'FAILED'} (err={err:.2g}, {kind})")
            if not ok:
                failed.append(task)
        if failed:
            raise RuntimeError(
                f"variant '{self.variant}' failed the parity gate for task(s) {failed}: "
                "refusing to re-pick the archive with divergent outputs (run fp32, or fix "
                "the variant)")

    # -------------------------------------------------------------- decode
    def _decode_call(self, out: Any, *, n_valid: int, row_lo: int) -> List[Dict[str, Any]]:
        n_rows = self.rows_per_call
        leaves = [t.reshape((n_rows,) + tuple(t.shape[2:])) for t in _flat(out)]
        flat = _unflat(out, leaves)
        decoded = {}
        with torch.inference_mode():
            for task in self.tasks:
                head = self.entry.heads[task] if self.entry.is_group else self.entry
                decoded[task] = decode_head_batch(
                    head.spec, flat[task], is_picker=head.is_picker,
                    sampling_rate=self.sampling_rate, **self.decode_opts)
            host = _to_host(decoded)
        row_ids = np.arange(row_lo, row_lo + n_valid, dtype=np.int64)
        keys = self.keys[row_lo:row_lo + n_valid] if self.keys is not None else None
        return catalog_rows(host, n_valid=n_valid, row_ids=row_ids, keys=keys,
                            stations=self.stations)

    # ---------------------------------------------------------------- feed
    def _fill_calls(self, unit: catalog.WorkUnit, start_call: int,
                    stop_event: Optional[threading.Event],
                    abort: Optional[threading.Event] = None):
        """The producer's call feed: one staging fill per device call,
        reshaped (free) to the program's (K, B, C, L). The tail call pads
        by repeating the last row (a pure function of the plan, so resume
        stays byte-identical); decode drops pad rows through n_valid."""
        n_calls = catalog.calls_per_unit(unit, self.rows_per_call)
        for c in range(start_call, n_calls):
            if stop_event is not None and stop_event.is_set():
                return
            if abort is not None and abort.is_set():
                return
            lo = unit.row_lo + c * self.rows_per_call
            hi = min(lo + self.rows_per_call, unit.row_hi)
            ids = np.arange(lo, hi, dtype=np.int64)
            n_valid = ids.size
            if n_valid < self.rows_per_call:
                ids = np.concatenate([ids, np.repeat(ids[-1], self.rows_per_call - n_valid)])
            t0 = monotonic()
            with BUS.span("batch_infer_fill"):
                rows = self.store.row_batch_at(ids, epoch=0, idx=ids)
                k, b = self.batches_per_call, self.batch_size
                x = rows["data"].reshape(k, b, self.store.n_ch, self.store.raw_len)
                # Resident scales ride the same fallback gather as the
                # labels: row and scale stay paired through quarantine.
                args = ((x, rows["data_scale"].reshape(k, b, self.store.n_ch))
                        if self.stage_raw else (x,))
            yield c, args, n_valid, lo, monotonic() - t0

    def _put(self, item):
        """The double buffer's transform, on the producer thread: on the
        card, the slab copied into pinned memory (so the store may refill
        it at once) and its host-to-device copy started on the copy
        stream, with the event the consumer waits on; on the CPU, tensors
        over the (fresh per fill) slab."""
        c, args, n_valid, lo, fill_s = item
        if self._copy_stream is None:
            return c, [torch.from_numpy(np.ascontiguousarray(a)) for a in args], n_valid, lo, \
                fill_s, None
        with torch.cuda.stream(self._copy_stream):
            dev = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                   .to(self.device, non_blocking=True) for a in args]
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return c, dev, n_valid, lo, fill_s, ready

    # ----------------------------------------------------------------- run
    def _device_call(self, args: List[torch.Tensor], ready: Optional[Any]) -> Any:
        if ready is None:
            return self._program(*args)
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        for a in args:  # allocated on the copy stream, read on this one
            a.record_stream(stream)
        out = self._program(*args)
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()  # the device stage's end, as the JAX engine blocks
        return out

    def run_unit(self, unit: catalog.WorkUnit, out_dir: str, *, commit_every: int = 4,
                 stop_event: Optional[threading.Event] = None,
                 lease: Optional[Any] = None) -> Dict[str, Any]:
        """Re-pick one work unit, committing a segment every
        ``commit_every`` device calls; resumes at the first missing
        segment. ``stop_event`` (SIGTERM) is honoured at segment
        boundaries: the current segment commits, later ones stay holes.

        Under a fleet ``lease`` every commit first passes
        ``lease.check_commit()`` (raises ``FenceRejected`` / ``LeaseLost``
        once this worker no longer owns the unit) and the segment is
        published exclusively with the lease's fence; an existing segment
        file raises ``fleet.DoubleCommit``."""
        from seist_tpu_torch.data.pipeline import _double_buffer

        if not self._warm:
            self.warmup()
        n_calls = catalog.calls_per_unit(unit, self.rows_per_call)
        total_seg = catalog.segments_per_unit(unit, self.rows_per_call, commit_every)
        start_seg = catalog.first_missing_segment(out_dir, unit, self.rows_per_call,
                                                  commit_every)
        stats = {"unit": unit.unit_id, "rows": 0, "calls": 0, "segments": 0,
                 "segments_skipped": start_seg, "preempted": False}
        if start_seg >= total_seg:
            return stats
        # The engine's own stop flag beside the caller's: set in the
        # finally-drain, so a consumer-side exception halts the producer at
        # its next fill instead of reading the rest of the unit.
        abort = threading.Event()
        gen = _double_buffer(self._fill_calls(unit, start_seg * commit_every, stop_event, abort),
                             self._put, self.prefetch, account="batch_infer")
        lines: List[str] = []
        seg = start_seg
        try:
            for c, args, n_valid, row_lo, fill_s, ready in gen:
                self.stage["fill"] += fill_s
                if self._slow_ms:
                    time.sleep(self._slow_ms / 1e3)
                t0 = monotonic()
                with BUS.span("batch_infer_device"):
                    out = self._device_call(args, ready)
                self.stage["device"] += monotonic() - t0
                t0 = monotonic()
                with BUS.span("batch_infer_decode"):
                    rows = self._decode_call(out, n_valid=n_valid, row_lo=row_lo)
                    lines.extend(catalog_row_lines(rows))
                self.stage["decode"] += monotonic() - t0
                self._c_calls.inc()
                self._c_batches.inc(self.batches_per_call)
                self._c_waveforms.inc(n_valid)
                self._c_bytes.inc(n_valid * self.store.row_nbytes)
                stats["rows"] += n_valid
                stats["calls"] += 1
                if (c + 1) == min((seg + 1) * commit_every, n_calls):
                    t0 = monotonic()
                    with BUS.span("batch_infer_write"):
                        self._commit(unit, seg, lines, out_dir, lease)
                    self.stage["write"] += monotonic() - t0
                    lines = []
                    seg += 1
                    stats["segments"] += 1
                    if stop_event is not None and stop_event.is_set():
                        stats["preempted"] = True
                        break
        finally:
            # A stopped consumer drains the bounded queue so the producer
            # sees the abort and ends (at most `prefetch` filled items).
            abort.set()
            for _ in gen:
                pass
        if stats["calls"] < n_calls - start_seg * commit_every and not stats["preempted"]:
            # The producer stopped early (stop_event raced a fill): the
            # unit is not complete and says so.
            stats["preempted"] = True
        return stats

    @staticmethod
    def _commit(unit: catalog.WorkUnit, seg: int, lines: List[str], out_dir: str,
                lease: Optional[Any]) -> None:
        if lease is None:
            catalog.commit_segment(out_dir, unit.unit_id, seg, lines)
            return
        lease.check_commit()
        try:
            catalog.commit_segment(out_dir, unit.unit_id, seg, lines, fence=lease.fence)
        except FileExistsError as e:
            # Counted by the fleet worker's guarded store (one source for
            # the bus and the verdict line).
            from seist_tpu_torch.batch import fleet

            raise fleet.DoubleCommit(
                f"unit {unit.unit_id} seg {seg}: already committed — fence {lease.fence} "
                "raced past its check") from e

    @property
    def program_calls(self) -> int:
        """Calls of the engine's program so far (warm-up included): on the
        card, its replays."""
        return self._program.calls if self._program is not None else 0

    def builds(self) -> int:
        """Programs built and eager forwards run so far: after warm-up,
        each one breaks the straight-line contract."""
        return aot.programs_built() + int(getattr(self.entry, "fallback_runs", 0))

    def run_units(self, units: Sequence[catalog.WorkUnit], out_dir: str, *,
                  commit_every: int = 4, stop_event: Optional[threading.Event] = None,
                  compile_gate: bool = False, progress: Optional[Any] = None,
                  unit_retries: int = 0) -> Dict[str, Any]:
        """Re-pick a worker's unit list. With ``compile_gate`` the stats
        report ``compiles_after_warmup``, the programs built and eager
        forwards run after warm-up (module docstring; 0 expected).

        A unit that raises is retried up to ``unit_retries`` times (the
        resume makes a retry start at the unit's first hole), and every
        failed attempt is recorded: ``batch_unit_error{unit=,exc=}`` on
        the bus and a ``unit_errors`` entry in the stats. With the default
        ``unit_retries=0`` the exception still propagates after that."""
        if not self._warm:
            self.warmup()
        builds0 = self.builds()
        t0 = monotonic()
        stats: Dict[str, Any] = {
            "units": 0, "units_skipped": 0, "rows": 0, "calls": 0,
            "segments": 0, "segments_skipped": 0, "preempted": False,
            "unit_errors": [],
        }
        for unit in units:
            attempt = 0
            while True:
                try:
                    u = self.run_unit(unit, out_dir, commit_every=commit_every,
                                      stop_event=stop_event)
                    break
                except Exception as e:  # recorded, then retried or re-raised
                    stats["unit_errors"].append(
                        {"unit": unit.unit_id, "exc": type(e).__name__, "retries": attempt})
                    BUS.counter("batch_unit_error", unit=str(unit.unit_id),
                                exc=type(e).__name__).inc()
                    logger.warning(f"[batch] unit {unit.unit_id} attempt {attempt + 1} "
                                   f"failed: {type(e).__name__}: {e}")
                    if attempt >= unit_retries:
                        raise
                    attempt += 1
            for k in ("rows", "calls", "segments", "segments_skipped"):
                stats[k] += u[k]
            if u["rows"] == 0 and u["segments_skipped"]:
                stats["units_skipped"] += 1
            else:
                stats["units"] += 1
            if progress is not None:
                progress.save({
                    "unit": unit.unit_id,
                    "next_segment": u["segments_skipped"] + u["segments"],
                    "preempted": u["preempted"],
                    **{k: stats[k] for k in ("rows", "calls", "segments")},
                })
            if u["preempted"]:
                stats["preempted"] = True
                break
        wall = monotonic() - t0
        stats["wall_s"] = round(wall, 3)
        stats["waveforms_per_sec"] = round(stats["rows"] / wall, 2) if wall > 0 else 0.0
        stats["stage_seconds"] = {k: round(v, 3) for k, v in self.stage.items()}
        if stats["rows"]:
            stats["stage_ms_per_wf"] = {k: round(v * 1e3 / stats["rows"], 4)
                                        for k, v in self.stage.items()}
        stats["program_calls"] = self.program_calls
        if compile_gate:
            stats["compiles_after_warmup"] = self.builds() - builds0
            stats["xla_compiles_after_warmup"] = 0  # the port compiles no XLA
        return stats


def _first_leaf(out: Any) -> Any:
    return out[0] if isinstance(out, (tuple, list)) else out
