"""Model pool: load servable entries, capture every serving program, gate
the variants, hot-reload, decode outputs.

Counterpart of ``seist_tpu/serve/pool.py``. Two kinds of entry:

* :class:`ModelEntry`: one single-task model (any registered name);
* :class:`MultiTaskEntry`: one SeisT task group (e.g. ``seist_l`` =
  dpk + emg + dis): ONE shared trunk (``SeismogramTransformer.backbone``,
  the first listed task's weights) and each task's head (its
  ``out_head``). A request runs the trunk once per trace and fans its
  features out to every requested head.

:meth:`ModelPool.warmup` builds every (bucket x program x enabled variant)
before the server takes traffic (``serve/aot.py``: a CUDA graph each on
the card) and parity-gates the bf16 / int8 variants against fp32. A
request at a batch shape with no program (none is built before warm-up,
and the batcher only forms bucket shapes) runs the same function eagerly
on the entry's device, through K1 on the card, and is counted in
``fallback_runs``. :meth:`ModelPool.reload` swaps one entry for a
candidate only after the candidate passes the same gates.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from seist_tpu_torch import taskspec
from seist_tpu_torch.obs import trace as obs_trace
from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.ops.postprocess import process_outputs
from seist_tpu_torch.serve import aot
from seist_tpu_torch.serve.batcher import slice_outputs
from seist_tpu_torch.train.graph import _flat, _unflat
from seist_tpu_torch.serve.protocol import (
    BadRequest,
    IncompatibleCheckpoint,
    ParityGateFailed,
    PredictOptions,
    ReloadFailed,
    ServeError,
    UnknownModel,
)
from seist_tpu_torch.utils.logger import logger

#: The five SeisT task heads: detection and picking, first-motion
#: polarity, magnitude, back-azimuth, epicentral distance. A task group
#: ``<prefix>`` serves the ``<prefix>_<task>`` heads on one shared trunk.
TASKS = ("dpk", "pmp", "emg", "baz", "dis")


def resolve_device(device: str) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (there is no
    silent CPU path: the caller asks for the CPU by name)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' requested but CUDA is not available; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}' (cuda or cpu)")
    return dev


def validate_checkpoint(expected: Mapping[str, torch.Tensor], restored: Any, *,
                        model_name: str, checkpoint: str) -> None:
    """Diff a loaded state dict against the model's and raise
    :class:`IncompatibleCheckpoint` naming the FIRST mismatch (in key
    order): a missing or unexpected key, a value that is not a tensor, a
    shape or a dtype."""

    def fail(kind: str, key: str, detail: str = "") -> None:
        raise IncompatibleCheckpoint(
            f"checkpoint '{checkpoint}' does not fit model '{model_name}': {kind} at "
            f"'{key}'" + (f" ({detail})" if detail else "")
        )

    if not isinstance(restored, Mapping):
        fail("not a state dict", "", f"got {type(restored).__name__}")
    for key in sorted(set(expected) | set(restored)):
        if key not in restored:
            fail("missing key", key)
        if key not in expected:
            fail("unexpected key", key)
        want, got = expected[key], restored[key]
        if not torch.is_tensor(got):
            fail("not a tensor", key, f"got {type(got).__name__}")
        if tuple(got.shape) != tuple(want.shape):
            fail("shape mismatch", key,
                 f"model wants {tuple(want.shape)}, checkpoint has {tuple(got.shape)}")
        if got.dtype != want.dtype:
            fail("dtype mismatch", key, f"model wants {want.dtype}, checkpoint has {got.dtype}")


def _load_parts(model_name: str, weights: str, *, window: int, seed: int,
                device: torch.device) -> Tuple[torch.nn.Module, Any, int]:
    """One model for inference on ``device``, with seeded weights or a
    ``.pt`` state dict checked by :func:`validate_checkpoint`:
    (model, spec, in_channels)."""
    from seist_tpu_torch.models import api

    spec = taskspec.get_task_spec(model_name)
    in_channels = taskspec.get_num_inchannels(model_name)
    model = api.create_model(model_name, in_channels=in_channels, in_samples=window, seed=seed)
    if weights:
        state = torch.load(weights, map_location="cpu", weights_only=True)
        validate_checkpoint(model.state_dict(), state, model_name=model_name, checkpoint=weights)
        model.load_state_dict(state, strict=True)
    return model.to(device).eval(), spec, in_channels


def _channel0(spec: Any) -> Optional[str]:
    """A picking head's first channel, ``'non'`` or ``'det'`` (its dense
    per-sample (non|det, ppk, spk) outputs decode to picks); None for every
    other head."""
    first = spec.labels[0]
    if isinstance(first, tuple) and len(first) == 3 and first[0] in ("non", "det"):
        return first[0]
    return None


def _is_picker(spec: Any) -> bool:
    return _channel0(spec) is not None


def _head_scale(model: torch.nn.Module) -> float:
    cfg = getattr(model, "cfg", None)
    return float(getattr(cfg, "head_scale", 1.0) or 1.0)


def _probe_input(b: int, window: int, in_channels: int) -> np.ndarray:
    """Deterministic parity-gate probe: unit-variance noise, the input
    ``/predict`` feeds after std normalization."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((b, window, in_channels)).astype(np.float32)


def _first_leaf(out: Any) -> Any:
    """Parity gates compare the primary output (of a tuple, the first)."""
    return out[0] if isinstance(out, (tuple, list)) else out


def _to_device(batch: Any, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(batch):
        return batch.to(device, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).to(device)


def _graph_pool(device: torch.device) -> Optional[Tuple[int, int]]:
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


@dataclass
class ModelEntry:
    """One servable single-task model. :meth:`run` dispatches to the
    captured program of the batch's bucket and variant; ``model`` is the
    fp32 model, from which the variants are made."""

    name: str
    model: torch.nn.Module
    spec: Any  # taskspec.TaskSpec
    window: int
    in_channels: int
    device: torch.device
    #: Monotonic model version, in every response and /healthz; a reload
    #: installs a higher one.
    version: int = 1
    #: The weights file this entry was loaded from ("" = seeded weights).
    checkpoint: str = ""
    variants: Tuple[str, ...] = ("fp32",)
    #: variant -> bucket -> Program (filled by build_programs)
    programs: Dict[str, Dict[int, aot.Program]] = field(default_factory=dict)
    #: variant -> parity-gate verdict (fp32 implicitly True)
    variant_ok: Dict[str, bool] = field(default_factory=dict)
    parity_err: Dict[str, float] = field(default_factory=dict)
    fallback_runs: int = 0
    #: the buckets programs were built for (build_programs)
    buckets: Tuple[int, ...] = (1,)
    _fns: Dict[str, Callable] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    #: variant -> the lock its programs' calls take (a program is called
    #: from one thread at a time: the batcher's, or /annotate's)
    _run_locks: Dict[str, threading.Lock] = field(default_factory=dict)

    def __post_init__(self):
        self._run_locks = {v: threading.Lock() for v in aot.VARIANTS}

    @property
    def is_picker(self) -> bool:
        return _is_picker(self.spec)

    @property
    def channel0(self) -> Optional[str]:
        """'non' or 'det' for a picking model (``ops/stream.annotate``)."""
        return _channel0(self.spec)

    @property
    def is_group(self) -> bool:
        return False

    @property
    def head_scale(self) -> float:
        return _head_scale(self.model)

    def resolve_tasks(self, tasks: Optional[Sequence[str]]) -> None:
        if tasks is not None:
            raise BadRequest(
                f"model '{self.name}' is single-task; 'tasks' is only valid for "
                "multi-task groups (serve --model-group)"
            )
        return None

    def supported_variants(self, tasks: Optional[Sequence[str]] = None) -> List[str]:
        return ["fp32"] + [v for v in self.variants if v != "fp32" and self.variant_ok.get(v)]

    def all_programs(self) -> List[aot.Program]:
        return [p for progs in self.programs.values() for p in progs.values()]

    def _stage(self, x: torch.Tensor) -> Any:
        """The program's input: ``x``, or what a model with
        ``captured_inputs`` computes from it before a replay
        (``train/graph.py::_staged``; BAZNetwork's eigen features)."""
        stage = getattr(self.model, "captured_inputs", None)
        return x if stage is None else stage(x)

    def _fn(self, variant: str) -> Callable:
        """The variant's forward over the flat staged inputs: the function
        its programs capture, and the eager fallback."""
        with self._lock:
            fn = self._fns.get(variant)
            if fn is None:
                apply = aot.make_variant_apply(lambda m, x: m(x), self.model, variant)
                # The staged input's structure: (x, features) or x.
                structure = (0, 0) if hasattr(self.model, "captured_inputs") else 0

                def fn(*flat, _apply=apply, _structure=structure):
                    return _apply(_unflat(_structure, list(flat)))

                self._fns[variant] = fn
            return fn

    def run(self, batch: Any, variant: str = "fp32") -> Any:
        """The request-path forward: (B, window, C) -> outputs on the
        entry's device, through the (variant, B) program, or eagerly when
        there is none (counted in ``fallback_runs``). Inside a batcher
        flush the program and ``aot`` (a program served it: a replayed
        graph on the card, the program's function on the CPU; False for a
        counted fallback) land on the flush's ``forward`` span."""
        with torch.inference_mode(), self._run_locks[variant]:
            inputs = _flat(self._stage(_to_device(batch, self.device)))
            b = int(inputs[0].shape[0])
            prog = self.programs.get(variant, {}).get(b)
            if prog is not None:
                obs_trace.annotate_flush(program=prog.key, aot=True, variant=variant)
                return prog(*inputs)
            obs_trace.annotate_flush(program=f"{self.name}/full/b{b}/{variant}:eager",
                                     aot=False, variant=variant)
            with self._lock:
                self.fallback_runs += 1
            return self._fn(variant)(*inputs)

    # ------------------------------------------------------------ warm-up
    def warmup(self, buckets: Sequence[int]) -> List[Dict[str, Any]]:
        """:meth:`build_programs` for ``buckets``; returns its report."""
        report: List[Dict[str, Any]] = []
        self.build_programs(sorted(set(int(b) for b in buckets)), report)
        return report

    def build_programs(self, buckets: Sequence[int], report: List[Dict[str, Any]]) -> None:
        """One program per (variant, bucket), each variant's graphs in one
        memory pool of their own; then the parity gates. A variant's
        programs are published together once all are captured: a request
        served during an async warm-up runs eagerly and never replays a
        graph of the pool that is being captured."""
        self.buckets = tuple(buckets)
        for variant in self.variants:
            fn = self._fn(variant)
            pool = _graph_pool(self.device)
            progs: Dict[int, aot.Program] = {}
            for b in buckets:
                with torch.inference_mode():
                    x = _to_device(_probe_input(b, self.window, self.in_channels), self.device)
                    inputs = _flat(self._stage(x))
                prog = aot.Program(f"{self.name}/full/b{b}/{variant}", fn, inputs, pool=pool)
                progs[b] = prog
                report.append(_program_row(self.name, b, variant, prog))
                logger.info(f"[serve] program {prog.key}: {prog.capture_s:.2f} s, "
                            f"{prog.flops:.4g} flops, K1 launches per call {prog.launches[0]}")
            self.programs[variant] = progs
        self._gate_variants(buckets[0])

    def _gate_variants(self, probe_bucket: int) -> None:
        if all(v == "fp32" for v in self.variants):
            return
        probe = _probe_input(probe_bucket, self.window, self.in_channels)
        ref = _first_leaf(self.run(probe, "fp32"))
        kind, _ = aot.parity_kind(self.spec)
        for variant in self.variants:
            if variant == "fp32":
                continue
            out = _first_leaf(self.run(probe, variant))
            ok, err = aot.variant_parity(ref, out, variant, kind=kind, scale=self.head_scale)
            self.variant_ok[variant] = ok
            self.parity_err[variant] = err
            logger.info(f"[serve] variant gate {self.name}/{variant}: "
                        f"{'ok' if ok else 'DISABLED'} (err={err:.2g}, {kind})")


def _program_row(model: str, b: int, variant: str, prog: aot.Program) -> Dict[str, Any]:
    return {"model": model, "batch": b, "variant": variant, "program": prog.key,
            "seconds": prog.capture_s, "flops": prog.flops,
            "k1_launches_per_call": prog.launches[0]}


@dataclass
class TaskHead:
    """One task head of a group: duck-types the slice of ModelEntry that
    :func:`decode_outputs` reads (name, spec, is_picker)."""

    task: str
    name: str  # the underlying model name, e.g. seist_l_dpk
    head: torch.nn.Module  # its out_head
    spec: Any
    head_scale: float = 1.0

    @property
    def is_picker(self) -> bool:
        return _is_picker(self.spec)

    @property
    def channel0(self) -> Optional[str]:
        return _channel0(self.spec)


@dataclass
class MultiTaskEntry:
    """One SeisT task group: the shared trunk and each task's head.

    :meth:`fanout` is the request-path forward: the trunk ONCE on the
    batch, then each requested head on its features. The served-traffic
    counters (trunk runs, head runs, the trunk FLOPs a per-task stack
    would have paid again) are in :meth:`fanout_stats`."""

    name: str
    window: int
    in_channels: int
    tasks: Tuple[str, ...]
    heads: Dict[str, TaskHead]
    trunk_model: torch.nn.Module
    device: torch.device
    version: int = 1
    #: per-task weights files, the reload defaults for tasks not re-pointed
    task_checkpoints: Dict[str, str] = field(default_factory=dict)
    variants: Tuple[str, ...] = ("fp32",)
    #: (variant, 'trunk' | task, bucket) -> Program
    programs: Dict[Tuple[str, str, int], aot.Program] = field(default_factory=dict)
    #: variant -> the tasks whose parity gate passed (fp32: all)
    variant_tasks: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    parity_err: Dict[str, Dict[str, float]] = field(default_factory=dict)
    fallback_runs: int = 0
    buckets: Tuple[int, ...] = (1,)
    _fns: Dict[Tuple[str, str], Callable] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _trunk_runs: int = 0
    _head_runs: Dict[str, int] = field(default_factory=dict)
    _flops_saved: float = 0.0
    #: variant -> the lock a fan-out takes (ModelEntry._run_locks)
    _run_locks: Dict[str, threading.Lock] = field(default_factory=dict)

    def __post_init__(self):
        self.variant_tasks.setdefault("fp32", tuple(self.tasks))
        self._run_locks = {v: threading.Lock() for v in aot.VARIANTS}

    @property
    def is_group(self) -> bool:
        return True

    @property
    def is_picker(self) -> bool:
        """A group picks over records (``/annotate``) when it serves dpk."""
        return "dpk" in self.heads and self.heads["dpk"].is_picker

    @property
    def channel0(self) -> Optional[str]:
        return self.heads["dpk"].channel0 if "dpk" in self.heads else None

    def picker_forward(self, x: Any) -> Any:
        """(N, window, C) -> (N, window, 3) dpk probabilities on the entry's
        device: the trunk's and the dpk head's programs replayed, the
        forward ``ops/stream.annotate`` drives for a group's ``/annotate``."""
        return self.fanout(x, ("dpk",), "fp32")["dpk"]

    def resolve_tasks(self, tasks: Optional[Sequence[str]]) -> Tuple[str, ...]:
        if tasks is None:
            return tuple(self.tasks)
        unknown = [t for t in tasks if t not in self.heads]
        if unknown:
            raise BadRequest(f"group '{self.name}' does not serve tasks {unknown}; "
                             f"available: {list(self.tasks)}")
        return tuple(tasks)

    def supported_variants(self, tasks: Optional[Sequence[str]] = None) -> List[str]:
        tasks = tuple(tasks) if tasks is not None else self.tasks
        return [v for v in self.variants
                if all(t in self.variant_tasks.get(v, ()) for t in tasks)]

    def all_programs(self) -> List[aot.Program]:
        return list(self.programs.values())

    def _fn(self, kind: str, variant: str) -> Callable:
        """The trunk's (``kind='trunk'``) or a head's forward for
        ``variant``: the function its programs capture, and the eager
        fallback. The trunk keeps its features in the variant's compute
        dtype; heads return fp32."""
        with self._lock:
            fn = self._fns.get((kind, variant))
            if fn is None:
                if kind == "trunk":
                    fn = aot.make_variant_apply(lambda m, x: m.backbone(x), self.trunk_model,
                                                variant, cast_outputs=False)
                else:
                    compute = aot.head_variant_compute(variant)
                    head = aot.transform_variables(self.heads[kind].head, variant)
                    fn = (lambda feats, _c=compute, _h=head, _n=self.window: _c(_h, feats, _n))
                self._fns[(kind, variant)] = fn
            return fn

    def _program_or_fallback(self, kind: str, variant: str, b: int, x: torch.Tensor) -> Any:
        prog = self.programs.get((variant, kind, b))
        if prog is not None:
            return prog(x), prog
        with self._lock:
            self.fallback_runs += 1
        with torch.inference_mode():
            return self._fn(kind, variant)(x), None

    def fanout(self, batch: Any, tasks: Sequence[str], variant: str = "fp32", *,
               account: bool = True) -> Dict[str, Any]:
        """Trunk once, the requested heads on its features: ``{task: raw
        head outputs}`` with leading dimension B. ``account=False`` for
        load-time callers (warm-up, gate probes): the counters measure
        served traffic."""
        x = _to_device(batch, self.device)
        b = int(x.shape[0])
        with self._run_locks[variant]:  # the heads read the trunk's buffer
            feats, trunk = self._program_or_fallback("trunk", variant, b, x)
            outs, heads = {}, []
            for t in tasks:
                outs[t], prog = self._program_or_fallback(t, variant, b, feats)
                heads.append(prog)
        # Inside a batcher flush the trunk-once fan-out lands on every
        # member's forward span.
        obs_trace.annotate_flush(
            program=trunk.key if trunk is not None else f"{self.name}/trunk/b{b}/{variant}:eager",
            aot=trunk is not None and all(h is not None for h in heads), variant=variant,
            heads=",".join(tasks))
        if account:
            self._account(tuple(tasks), trunk.flops if trunk is not None else 0.0)
        return outs

    def _account(self, tasks: Tuple[str, ...], trunk_flops: float) -> None:
        saved = trunk_flops * max(len(tasks) - 1, 0)
        with self._lock:
            self._trunk_runs += 1
            for t in tasks:
                self._head_runs[t] = self._head_runs.get(t, 0) + 1
            self._flops_saved += saved
        BUS.counter("serve_trunk_runs", model=self.name).inc()
        for t in tasks:
            BUS.counter("serve_head_runs", model=self.name, task=t).inc()
        if saved:
            BUS.counter("serve_trunk_flops_saved", model=self.name).inc(saved)

    def fanout_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "trunk_runs": self._trunk_runs,
                "head_runs": dict(self._head_runs),
                "trunk_flops_saved": self._flops_saved,
                "tasks": list(self.tasks),
                "variants": {v: list(self.variant_tasks.get(v, ())) for v in self.variants},
            }

    # ------------------------------------------------------------ warm-up
    def build_programs(self, buckets: Sequence[int], report: List[Dict[str, Any]]) -> None:
        """Per variant (one memory pool) and bucket: the trunk program, then
        each head's, reading the trunk's output buffer; then the gates. As
        for a single model, a variant's programs are published together."""
        self.buckets = tuple(buckets)
        for variant in self.variants:
            pool = _graph_pool(self.device)
            progs: Dict[Tuple[str, str, int], aot.Program] = {}
            for b in buckets:
                with torch.inference_mode():
                    x = _to_device(_probe_input(b, self.window, self.in_channels), self.device)
                trunk = aot.Program(
                    f"{self.name}/trunk/b{b}/{variant}", self._fn("trunk", variant), [x],
                    pool=pool, copy_outputs=False)
                progs[(variant, "trunk", b)] = trunk
                report.append(_program_row(self.name, b, variant, trunk))
                if trunk.outputs is not None:
                    feats = trunk.outputs
                else:
                    with torch.inference_mode():
                        feats = self._fn("trunk", variant)(x)
                for t in self.tasks:
                    head = aot.Program(f"{self.name}/head:{t}/b{b}/{variant}",
                                       self._fn(t, variant), [feats], pool=pool,
                                       shared_inputs=True)
                    progs[(variant, t, b)] = head
                    report.append(_program_row(self.name, b, variant, head))
                logger.info(f"[serve] programs {self.name} b{b} {variant}: trunk "
                            f"{trunk.capture_s:.2f} s ({trunk.flops:.4g} flops, K1 launches per "
                            f"call {trunk.launches[0]}) + {len(self.tasks)} heads")
            self.programs.update(progs)
        self._gate_variants(buckets[0])

    def _gate_variants(self, probe_bucket: int) -> None:
        probe = _probe_input(probe_bucket, self.window, self.in_channels)
        ref = self.fanout(probe, self.tasks, "fp32", account=False)
        for variant in self.variants:
            if variant == "fp32":
                continue
            out = self.fanout(probe, self.tasks, variant, account=False)
            ok_tasks = []
            self.parity_err[variant] = {}
            for t in self.tasks:
                head = self.heads[t]
                kind, _ = aot.parity_kind(head.spec)
                ok, err = aot.variant_parity(_first_leaf(ref[t]), _first_leaf(out[t]), variant,
                                             kind=kind, scale=head.head_scale)
                self.parity_err[variant][t] = err
                if ok:
                    ok_tasks.append(t)
                logger.info(f"[serve] variant gate {self.name}/{t}/{variant}: "
                            f"{'ok' if ok else 'DISABLED'} (err={err:.2g}, {kind})")
            self.variant_tasks[variant] = tuple(ok_tasks)


def _check_variants(variants: Sequence[str]) -> Tuple[str, ...]:
    out = tuple(dict.fromkeys(variants))  # dedup, keep order
    bad = [v for v in out if v not in aot.VARIANTS]
    if bad:
        raise ValueError(f"unknown variants {bad}; use {list(aot.VARIANTS)}")
    if "fp32" not in out:
        out = ("fp32",) + out  # fp32 is the reference; always served
    return out


def _tf32_off(dev: torch.device) -> None:
    if dev.type == "cuda":
        # The fp32 variant is the parity reference: cuDNN convolutions
        # default to TF32 (about 3 decimal digits), so both are set off.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def load_model_entry(
    model_name: str,
    weights: str = "",
    *,
    window: int = 8192,
    seed: int = 0,
    device: str = "cuda",
    variants: Sequence[str] = ("fp32",),
) -> ModelEntry:
    """Create one model for inference on ``device``.

    Without ``weights`` the model serves weights drawn from ``seed``
    (tests, smoke runs); with a ``.pt`` path (models/convert.py writes
    one) the state dict is checked key by key (:func:`validate_checkpoint`)
    and loads strictly, before anything serves."""
    dev = resolve_device(device)
    _tf32_off(dev)
    model, spec, in_channels = _load_parts(model_name, weights, window=window, seed=seed,
                                           device=dev)
    return ModelEntry(name=model_name, model=model, spec=spec, window=window,
                      in_channels=in_channels, device=dev, checkpoint=weights,
                      variants=_check_variants(variants))


def load_group_entry(
    group_name: str,
    task_entries: Sequence[Tuple[str, str]],
    *,
    window: int = 8192,
    seed: int = 0,
    device: str = "cuda",
    variants: Sequence[str] = ("fp32",),
) -> MultiTaskEntry:
    """One shared-trunk task group: ``group_name`` is the SeisT size prefix
    (e.g. ``seist_l``); each (task, weights) loads ``<group_name>_<task>``.
    The trunk is the FIRST listed task's model; every task keeps only its
    ``out_head``."""
    from seist_tpu_torch.models.seist import SeismogramTransformer

    if not task_entries:
        raise ValueError(f"group '{group_name}' needs at least one task")
    dev = resolve_device(device)
    _tf32_off(dev)
    heads: Dict[str, TaskHead] = {}
    trunk = None
    in_channels = None
    for task, weights in task_entries:
        if task not in TASKS:
            raise ValueError(f"unknown task '{task}' in group '{group_name}'; tasks are "
                             f"{list(TASKS)}")
        if task in heads:
            raise ValueError(f"duplicate task '{task}' in '{group_name}'")
        model_name = f"{group_name}_{task}"
        model, spec, chans = _load_parts(model_name, weights, window=window, seed=seed,
                                         device=dev)
        if not isinstance(model, SeismogramTransformer):
            raise ValueError(f"model '{model_name}' has no trunk/head split; groups support "
                             "the SeisT family only")
        if in_channels is None:
            in_channels = chans
        elif chans != in_channels:
            raise ValueError(f"group '{group_name}': task '{task}' wants {chans} input "
                             f"channels, group has {in_channels}")
        if trunk is None:
            trunk = model
        heads[task] = TaskHead(task=task, name=model_name, head=model.out_head, spec=spec,
                               head_scale=_head_scale(model))
    return MultiTaskEntry(
        name=group_name, window=window, in_channels=int(in_channels),
        tasks=tuple(heads), heads=heads, trunk_model=trunk, device=dev,
        task_checkpoints={task: weights for task, weights in task_entries},
        variants=_check_variants(variants),
    )


def _entry_memory() -> int:
    """Bytes the caching allocator holds on the current card once its
    unused blocks are released (0 on the CPU)."""
    if not torch.cuda.is_available():
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


class ModelPool:
    """Loaded entries by model or group name, the warm-up that captures
    every serving program, and :meth:`reload`, which hot-swaps one entry
    for a new checkpoint after the candidate passes the load-time gates."""

    def __init__(
        self,
        entries: Sequence[Tuple[str, str]] = (),
        *,
        window: int = 8192,
        seed: int = 0,
        groups: Optional[Sequence[Tuple[str, Sequence[Tuple[str, str]]]]] = None,
        variants: Sequence[str] = ("fp32",),
        version: int = 1,
        device: str = "cuda",
    ):
        if not entries and not groups:
            raise ValueError("ModelPool needs at least one (name, weights) entry or one group")
        self._window = window
        self._seed = seed
        self._variants = tuple(variants)
        self._device = device
        self._reload_lock = threading.Lock()  # one candidate at a time
        # Guards the entry dict and the warm-up report only: the request
        # path reads under it, so a candidate's captures happen outside it.
        self._entries_lock = threading.Lock()
        self._entries: Dict[str, Any] = {}
        for name, weights in entries:
            if name in self._entries:
                raise ValueError(f"duplicate model '{name}' in pool")
            self._entries[name] = load_model_entry(name, weights, window=window, seed=seed,
                                                   device=device, variants=variants)
        for group_name, task_entries in groups or ():
            if group_name in self._entries:
                raise ValueError(f"duplicate model '{group_name}' in pool")
            self._entries[group_name] = load_group_entry(
                group_name, task_entries, window=window, seed=seed, device=device,
                variants=variants)
        for entry in self._entries.values():
            entry.version = int(version)
        for name, v in self.versions().items():
            BUS.gauge("serve_model_version", model=name).set(v)
        self.warmup_report: List[Dict[str, Any]] = []
        #: name -> {"graph_programs", "graph_capture_s", "graph_memory_mib"} of the
        #: served entry (the JAX package's aot_programs and aot_compile_ms)
        self.program_stats: Dict[str, Dict[str, float]] = {}

    def names(self) -> List[str]:
        with self._entries_lock:
            return list(self._entries)

    def get(self, name: Optional[str]) -> Any:
        with self._entries_lock:
            if name is None and len(self._entries) == 1:
                return next(iter(self._entries.values()))
            entry = self._entries.get(name) if name is not None else None
            names = list(self._entries)
        if entry is not None:
            return entry
        if name is None:
            raise BadRequest(f"'model' is required when several are loaded: {names}")
        raise UnknownModel(f"model '{name}' is not loaded; serving {names}")

    def entries(self) -> Dict[str, Any]:
        with self._entries_lock:
            return dict(self._entries)

    def versions(self) -> Dict[str, int]:
        return {name: e.version for name, e in self.entries().items()}

    def warm_entry(self, entry: Any, buckets: Sequence[int]) -> Tuple[List[Dict[str, Any]],
                                                                         Dict[str, float]]:
        """Build one entry's (bucket x program x variant) table, gate its
        variants, and decode one output of each head once; returns the
        per-program report and the entry's totals (programs, capture
        seconds, the card memory its programs and variant weights hold).
        Shared by the start-up :meth:`warmup` and :meth:`reload`."""
        report: List[Dict[str, Any]] = []
        buckets = sorted(set(int(b) for b in buckets))
        before = _entry_memory()
        entry.build_programs(buckets, report)
        memory = _entry_memory() - before
        probe = _probe_input(buckets[0], entry.window, entry.in_channels)
        if entry.is_group:
            outs = entry.fanout(probe, entry.tasks, "fp32", account=False)
            for t in entry.tasks:
                decode_outputs(entry.heads[t], slice_outputs(outs[t], 0), PredictOptions())
        else:
            decode_outputs(entry, slice_outputs(entry.run(probe, "fp32"), 0), PredictOptions())
        stats = {"graph_programs": len(report),
                 "graph_capture_s": sum(r["seconds"] for r in report),
                 "graph_memory_mib": memory / 2**20}
        logger.info(f"[serve] {entry.name}: {stats['graph_programs']} programs in "
                    f"{stats['graph_capture_s']:.2f} s of capture, {stats['graph_memory_mib']:.1f} MiB of "
                    "graph pools and variant weights")
        return report, stats

    def warmup(self, buckets: Sequence[int]) -> List[Dict[str, Any]]:
        """Build every entry's programs; returns the per-program report
        (also kept on ``warmup_report`` for /healthz)."""
        report: List[Dict[str, Any]] = []
        stats = {}
        for name, entry in self.entries().items():
            rows, stats[name] = self.warm_entry(entry, buckets)
            report.extend(rows)
        with self._entries_lock:
            self.warmup_report = report
            self.program_stats = stats
        return report

    # ------------------------------------------------------------- reload
    def reload(self, name: Optional[str], *, buckets: Sequence[int],
               checkpoint: Optional[str] = None, checkpoints: Optional[Mapping[str, str]] = None,
               version: Optional[int] = None,
               force_gate_failure: bool = False) -> Tuple[Any, List[Dict[str, Any]]]:
        """Hot-swap one entry for a new checkpoint; the incumbent serves
        throughout. The candidate is loaded BESIDE the incumbent and must
        clear the whole gate ladder before it takes traffic:

        1. the state dict fits the model, key for key
           (:class:`IncompatibleCheckpoint` names the first bad key);
        2. every (bucket x program x variant) captures, in pools of its
           own; any failure there is a :class:`ReloadFailed`;
        3. the parity gates re-run on the new weights: every variant (for
           a group, every task x variant) the incumbent serves must pass;
        4. a finite fp32 probe (a checkpoint of NaNs captures fine).

        Only full success swaps the entry; the next batcher flush takes the
        candidate. ``force_gate_failure`` is the
        ``SEIST_FAULT_SERVE_BAD_CANDIDATE`` hook: the built candidate is
        refused at step 4."""
        with self._reload_lock:
            incumbent = self.get(name)
            name = incumbent.name
            target = int(version) if version is not None else incumbent.version + 1
            if target <= incumbent.version:
                raise BadRequest(f"version must be > the served version {incumbent.version}, "
                                 f"got {target} (versions are monotonic)")
            try:
                candidate = self._build_candidate(incumbent, checkpoint, checkpoints)
                report, stats = self.warm_entry(candidate, buckets)
            except ServeError:
                raise
            except Exception as e:  # noqa: BLE001 - the incumbent must survive
                raise ReloadFailed(f"candidate build failed for '{name}': {e!r}") from e
            self._gate_candidate(incumbent, candidate, force_gate_failure)
            candidate.version = target
            with self._entries_lock:  # the swap
                self._entries[name] = candidate
                self.warmup_report = [r for r in self.warmup_report if r.get("model") != name] + [
                    dict(r, reload_version=target) for r in report]
                self.program_stats[name] = stats
            BUS.gauge("serve_model_version", model=name).set(target)
            logger.info(f"[serve] reload '{name}': version {incumbent.version} -> {target} "
                        f"({len(report)} programs captured)")
            return candidate, report

    def _build_candidate(self, incumbent: Any, checkpoint: Optional[str],
                         checkpoints: Optional[Mapping[str, str]]) -> Any:
        if incumbent.is_group:
            if checkpoint is not None:
                raise BadRequest(f"'{incumbent.name}' is a task group; use 'checkpoints': "
                                 "{task: path} instead of 'checkpoint'")
            paths = dict(incumbent.task_checkpoints)
            for task, path in (checkpoints or {}).items():
                if task not in paths:
                    raise BadRequest(f"group '{incumbent.name}' does not serve task '{task}'; "
                                     f"serves {list(incumbent.tasks)}")
                paths[task] = path
            return load_group_entry(incumbent.name, [(t, paths[t]) for t in incumbent.tasks],
                                    window=self._window, seed=self._seed, device=self._device,
                                    variants=self._variants)
        if checkpoints is not None:
            raise BadRequest(f"'{incumbent.name}' is single-task; use 'checkpoint', not "
                             "'checkpoints'")
        path = checkpoint if checkpoint is not None else incumbent.checkpoint
        return load_model_entry(incumbent.name, path, window=self._window, seed=self._seed,
                                device=self._device, variants=self._variants)

    @staticmethod
    def _gate_candidate(incumbent: Any, candidate: Any, force_gate_failure: bool) -> None:
        """The candidate serves at least the incumbent's variant surface and
        answers finite fp32 outputs."""
        if candidate.is_group:
            for variant in incumbent.variants:
                missing = sorted(set(incumbent.variant_tasks.get(variant, ()))
                                 - set(candidate.variant_tasks.get(variant, ())))
                if missing:
                    raise ParityGateFailed(
                        f"candidate for group '{incumbent.name}' failed the '{variant}' parity "
                        f"gate for task(s) {missing} the incumbent serves")
        else:
            missing = sorted(set(incumbent.supported_variants())
                             - set(candidate.supported_variants()))
            if missing:
                raise ParityGateFailed(
                    f"candidate for '{incumbent.name}' failed the parity gate for variant(s) "
                    f"{missing} the incumbent serves")
        probe = _probe_input(candidate.buckets[0], candidate.window, candidate.in_channels)
        if candidate.is_group:
            outs = candidate.fanout(probe, candidate.tasks, "fp32", account=False)
            finite = all(aot.outputs_finite(outs[t]) for t in candidate.tasks)
        else:
            finite = aot.outputs_finite(candidate.run(probe, "fp32"))
        if not finite:
            raise ParityGateFailed(f"candidate for '{incumbent.name}' produced non-finite fp32 "
                                   "probe outputs; refusing to serve it")
        if force_gate_failure:
            raise ParityGateFailed(f"candidate for '{incumbent.name}' rejected by injected "
                                   "fault (SEIST_FAULT_SERVE_BAD_CANDIDATE)")


def decode_outputs(entry: Any, outputs: Any, opts: PredictOptions) -> Dict[str, Any]:
    """One request's raw model outputs (leading dim 1; on the host when
    the batcher hands them over, or on the entry's device) -> JSON-able
    result. ``entry`` is a ModelEntry or a group's TaskHead (name, spec,
    is_picker). Picking heads run ops/postprocess where the outputs lie and
    come back in one transfer; the other heads go through
    the task spec's results transform (MagNet's mean, BAZNetwork's
    degrees, DiTingMotion's softmax), then value heads report their
    scalar, one-hot heads the argmax class and the scores."""
    spec = entry.spec
    with torch.inference_mode():
        if entry.is_picker:
            res = process_outputs(
                outputs,
                spec.labels,
                opts.sampling_rate,
                ppk_threshold=opts.ppk_threshold,
                spk_threshold=opts.spk_threshold,
                det_threshold=opts.det_threshold,
                min_peak_dist=opts.min_peak_dist,
                max_detect_event_num=opts.max_events,
            )
            keys = [k for k in ("ppk", "spk", "det") if k in res]
            host = torch.cat([res[k].reshape(-1) for k in keys]).cpu().numpy()
            fs = float(opts.sampling_rate)
            out: Dict[str, Any] = {"task": "picking"}
            at = 0
            for k in keys:
                size = res[k].numel()
                vals, at = host[at : at + size], at + size
                if k == "det":
                    pairs = vals.reshape(-1, 2)
                    pairs = pairs[pairs[:, 1] >= pairs[:, 0]]
                    out["det"] = [
                        {"onset": int(a), "offset": int(b),
                         "onset_s": round(a / fs, 6), "offset_s": round(b / fs, 6)}
                        for a, b in pairs
                    ]
                else:
                    out[k] = [
                        {"sample": int(i), "time_s": round(i / fs, 6)}
                        for i in vals[vals >= 0]
                    ]
            return out
        transform = spec.outputs_transform_for_results
        outs = transform(outputs) if transform else outputs
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        if len(outs) != len(spec.labels):
            raise ServeError(
                f"model '{entry.name}' produced {len(outs)} outputs for "
                f"{len(spec.labels)} labels"
            )
        result: Dict[str, Any] = {"task": "regression"}
        for name, arr in zip(spec.labels, outs):
            arr = arr.float().cpu().numpy()
            if taskspec.get_kind(name) == taskspec.ONEHOT:
                result["task"] = "classification"
                scores = arr.reshape(-1)
                result[name] = {
                    "class": int(np.argmax(scores)),
                    "scores": [float(s) for s in scores],
                }
            else:
                result[name] = float(arr.reshape(-1)[0])
        return result


def clip_picks(result: Dict[str, Any], n_real: int, fs: float) -> None:
    """Drop picks inside the zero padding of a short trace (index >=
    ``n_real``) and clip detections to the real extent."""
    if result.get("task") != "picking":
        return
    for kind in ("ppk", "spk"):
        if kind in result:
            result[kind] = [p for p in result[kind] if p["sample"] < n_real]
    if "det" in result:
        kept = []
        for d in result["det"]:
            if d["onset"] >= n_real:
                continue
            if d["offset"] >= n_real:
                d = dict(d, offset=n_real - 1, offset_s=round((n_real - 1) / fs, 6))
            kept.append(d)
        result["det"] = kept
