"""Serving programs captured at load, and the quantized weight variants.

Counterpart of ``seist_tpu/serve/aot.py``. The JAX package compiles every
request-path program ahead of time, one per (entry, program kind, variant,
bucket); the port captures each as a CUDA graph at load
(:class:`Program`, built on ``train/graph.py``'s :class:`Captured`: static
input buffers, two warm-up runs on a side stream so cuDNN's algorithm
choice is fixed before the capture records it, ``capture_error_mode=
"thread_local"``). A request replays the graph: one launch instead of a
forward's ~2,000 kernel launches from Python. The kinds are the full
forward of a single-task model, and for a SeisT task group the shared
trunk and each task's head. A replay's outputs live in the graph's memory:
full and head programs return copies, made before the next replay; a
trunk program hands its output buffer to the head graphs of its bucket,
which read it where it lies. On the CPU a program is its function run
eagerly, with the same keys and the same call accounting.

Several batches per program (:func:`aot_compile_multi`, the counterpart of
the JAX package's ``lax.map`` program, for batch re-picking): one graph
runs the function over each slice of a leading ``steps`` axis of its
static inputs, as ``train/graph.py`` captures ``--steps-per-call``; a
replay copies the call's K batches in and the stacked outputs out once.

Each program adds its load time (ms) to the metrics bus's
``serve_aot_compile_ms{model=...}`` gauge and one to
``serve_aot_programs{model=...}``, the JAX package's compile gauges.

Graph memory: the graphs of one (entry, variant) share one memory pool,
and only that variant's batcher thread replays them, one at a time; a
reload candidate captures into pools of its own.

Variants (``options.variant``), each a transform of the loaded fp32 model
made once at load (:func:`transform_variables`) and the compute convention
the program runs it under (:func:`variant_compute`):

* ``fp32``: the model as loaded;
* ``bf16``: a copy with every floating parameter and buffer (BatchNorm's
  statistics too) cast to bfloat16 (the JAX package's ``cast_variables``), run under ``precision_policy(bf16)``
  with the input cast to bf16 and the outputs cast back to fp32; interior
  programs keep ``cast_outputs=False`` (a bf16 trunk hands bf16 features
  to bf16 heads). SeisT's attention then runs the bf16 K1;
* ``int8``: weight-only quantization. Every >=2-D floating parameter is
  held as int8 with one fp32 scale per output channel (the flax kernel's
  last axis, located in the torch layout by
  ``models/convert.py::flax_last_axis``), and dequantized inside the
  program on every replay; the compute is fp32.

A non-fp32 variant is parity-gated at load against fp32
(:func:`variant_parity`): one that diverges beyond decision-level
tolerance is disabled rather than served wrong.

FLOPs (:func:`program_flops`): ``torch.utils.flop_counter`` over one eager
run of the program's function. On the CPU it counts the plain attention's
two products, which are exactly K1's ``4 N L M H E``; on the card K1 is a
ctypes call it does not see, so those are added from the model's attention
shapes, and the count is the same on both.
"""

from __future__ import annotations

import copy
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.ops import launch_counts
from seist_tpu_torch.serve.protocol import VARIANTS
from seist_tpu_torch.train.graph import COUNTERS, Captured, _flat, _warmup_stream
from seist_tpu_torch.train.precision import cast_floating, precision_policy

#: Decision-level parity tolerances per variant (see variant_parity).
#: bf16 rounds weights and activations to 8 mantissa bits (~4e-3
#: relative); int8 weight-only is coarser. Probability outputs compare
#: absolutely, value outputs relative to the head's output scale.
_PARITY_TOL = {
    "bf16": {"abs": 0.02, "rel": 0.01, "argmax_frac": 0.005},
    "int8": {"abs": 0.05, "rel": 0.02, "argmax_frac": 0.01},
}


# ------------------------------------------------------------------ programs
#: Programs built in this process (:func:`programs_built`).
_BUILT = [0]
_BUILT_LOCK = threading.Lock()


def programs_built() -> int:
    """How many :class:`Program` s this process has built (captured on the
    card, made on the CPU): the repick engine's straight-line check counts
    the ones built after its warm-up."""
    return _BUILT[0]


def _copy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy(v) for v in tree)
    return tree.clone()


def attention_flops(model: torch.nn.Module, batch: int, window: int) -> float:
    """K1's operations in one forward of ``model`` at ``batch`` x ``window``:
    ``4 N L M H E`` per attention launch (two products), 0 for a model
    without attention."""
    shapes = getattr(model, "attention_shapes", None)
    if shapes is None:
        return 0.0
    return float(sum(4 * batch * l * m * h * e for l, m, h, e in shapes(window)))


def program_flops(fn: Callable, inputs: Sequence[torch.Tensor], attention: float = 0.0) -> float:
    """The FLOPs of one call of ``fn(*inputs)`` (module docstring);
    ``attention`` is K1's share, added on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*inputs)
    on_card = any(t.device.type == "cuda" for t in inputs)
    return float(counter.get_total_flops()) + (attention if on_card else 0.0)


class Program:
    """One serving program (the counterpart of ``AotProgram``): ``fn``
    captured as a CUDA graph from ``inputs`` on the card, or ``fn`` itself
    on the CPU. Calls must come from one thread at a time, that of the
    (entry, variant) whose ``pool`` it allocates from.

    ``shared_inputs``: the graph reads ``inputs`` where they lie (a trunk
    program's output buffer). ``copy_outputs``: a call returns copies of
    the outputs, which the next replay would overwrite; a trunk program
    returns its buffer. The capture and the warm-up runs are counted
    nowhere (they run on the capture's side stream, ``ops/launch_counts.py``);
    each call on the card adds the kernels it replays to their launch
    counts."""

    def __init__(self, key: str, fn: Callable, inputs: Sequence[torch.Tensor], *,
                 pool: Optional[Tuple[int, int]] = None, shared_inputs: bool = False,
                 copy_outputs: bool = True, attention: float = 0.0):
        with _BUILT_LOCK:
            _BUILT[0] += 1
        self.key = key
        self.fn = fn
        self.copy_outputs = copy_outputs
        self.calls = 0
        device = inputs[0].device
        t0 = time.perf_counter()
        with torch.inference_mode():
            self.graph: Optional[Captured] = None
            if device.type != "cuda":
                self.flops = program_flops(fn, inputs, attention)
            else:
                # The FLOP count's eager run: on the capture's side stream,
                # whose launches are counted nowhere.
                side = _warmup_stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with launch_counts.diverted(side), torch.cuda.stream(side):
                    self.flops = program_flops(fn, inputs, attention)
                torch.cuda.current_stream(device).wait_stream(side)
                self.graph = Captured(fn, inputs, device, pool=pool,
                                      shared_inputs=shared_inputs)
                self.graph.graph.replay()  # fill the outputs once (a head reads them)
                torch.cuda.synchronize(device)
        #: Wall seconds of the load: FLOP count, warm-up runs and capture.
        self.capture_s = time.perf_counter() - t0
        # The JAX package's compile-time gauges, here the capture's (ms).
        model = key.split("/", 1)[0]
        BUS.gauge("serve_aot_compile_ms", model=model).inc(self.capture_s * 1e3)
        BUS.gauge("serve_aot_programs", model=model).inc(1)
        counts = dict(zip(COUNTERS, self.graph.launches)) if self.graph else {}
        #: Attention forward launches per call: (all, of them bf16).
        self.launches = (counts.get(COUNTERS[0], 0), counts.get(COUNTERS[2], 0))

    @property
    def outputs(self) -> Any:
        """The graph's output buffers (None on the CPU)."""
        return None if self.graph is None else self.graph.outputs

    def __call__(self, *inputs: torch.Tensor) -> Any:
        self.calls += 1
        with torch.inference_mode():
            if self.graph is None:
                return self.fn(*inputs)
            out = self.graph.replay(list(inputs))
            return _copy(out) if self.copy_outputs else out


def _stack_steps(outs: Sequence[Any]) -> Any:
    """The per-step outputs of a multi-batch program stacked on a new
    leading axis, structure by structure."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack_steps([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_steps([o[i] for o in outs]) for i in range(len(first)))
    return torch.stack(list(outs))


def multi_step(fn: Callable, steps: int) -> Callable:
    """``fn`` over each of ``steps`` slices of its arguments' leading axis,
    the outputs stacked: the body of a multi-batch program."""
    def multi(*args):
        return _stack_steps([fn(*(a[i] for a in args)) for i in range(steps)])

    return multi


def aot_compile_multi(key: str, fn: Callable, arg_shapes: Sequence[Tuple[Tuple[int, ...], Any]],
                      *, steps: int, device: torch.device,
                      pool: Optional[Tuple[int, int]] = None,
                      attention: float = 0.0) -> Program:
    """One :class:`Program` running ``fn`` ``steps`` times (``seist_tpu/
    serve/aot.py::aot_compile_multi``): it takes arguments with a leading
    ``steps`` axis, so one replay feeds ``steps`` full batches and host
    Python touches the critical path once per call. ``arg_shapes`` are
    the PER-STEP (shape, torch dtype) pairs; ``attention`` is K1's FLOPs
    per step (:func:`attention_flops`)."""
    inputs = [torch.zeros((steps,) + tuple(shape), dtype=dtype, device=device)
              for shape, dtype in arg_shapes]
    if pool is None and device.type == "cuda":
        pool = torch.cuda.graph_pool_handle()
    return Program(key, multi_step(fn, steps), inputs, pool=pool, attention=attention * steps)


# ------------------------------------------------------------------ variants
def _is_float(t: Any) -> bool:
    return torch.is_tensor(t) and t.is_floating_point()


@dataclass
class Int8Leaf:
    """A weight held as int8 with a symmetric fp32 scale per index of
    ``axis`` (its output channel)."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int

    def scale_view(self) -> torch.Tensor:
        shape = [1] * self.q.dim()
        shape[self.axis] = -1
        return self.scale.reshape(shape)


def quantize_leaf(w: torch.Tensor, axis: int) -> Int8Leaf:
    """``seist_tpu/serve/aot.py::quantize_int8``'s rule for one leaf: scale
    ``max(|w|, 1e-8) / 127`` over every axis but ``axis``, q the rounded
    (half to even) quotient clipped to [-127, 127]."""
    w = w.detach().to(torch.float32)
    dims = tuple(d for d in range(w.dim()) if d != axis)
    scale = torch.clamp_min(w.abs().amax(dim=dims), 1e-8) / 127.0
    shape = [1] * w.dim()
    shape[axis] = -1
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127).to(torch.int8)
    return Int8Leaf(q, scale, axis)


def quantize_int8(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Weight-only int8: every >=2-D floating leaf becomes an
    :class:`Int8Leaf` over its output channel (``convert.flax_last_axis``);
    1-D leaves (biases, norm scales, BatchNorm statistics) stay as they
    are: they are tiny and precision-critical."""
    from seist_tpu_torch.models.convert import flax_last_axis

    return {
        k: quantize_leaf(v, flax_last_axis(k, v.dim())) if _is_float(v) and v.dim() >= 2 else v
        for k, v in state.items()
    }


def dequantize(leaf: Int8Leaf) -> torch.Tensor:
    """Inverse of :func:`quantize_leaf`: the fp32 weight."""
    return leaf.q.to(torch.float32) * leaf.scale_view()


def _quantized_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose >=2-D parameters are int8 leaves: each
    parameter is removed from its module, and :func:`dequantized` puts the
    fp32 weight back for the length of one forward."""
    qmodel = copy.deepcopy(model)
    leaves = quantize_int8(dict(qmodel.named_parameters()))
    held = []
    for name, leaf in leaves.items():
        if not isinstance(leaf, Int8Leaf):
            continue
        owner, _, attr = name.rpartition(".")
        module = qmodel.get_submodule(owner)
        del module._parameters[attr]
        setattr(module, attr, None)  # drops an LSTM's flat-weight reference too
        held.append((module, attr, leaf))
    qmodel.int8_weights = held
    return qmodel


@contextmanager
def dequantized(qmodel: torch.nn.Module) -> Iterator[None]:
    """The fp32 weights of an int8 copy, computed from its int8 leaves for
    one forward (inside a program: on every replay) and dropped after."""
    held = qmodel.int8_weights
    for module, attr, leaf in held:
        setattr(module, attr, dequantize(leaf))
    try:
        yield
    finally:
        for module, attr, _ in held:
            setattr(module, attr, None)


def outputs_to_f32(out: Any) -> Any:
    """Every floating output as float32, so decoding is variant-blind (for
    final outputs only: bf16 trunk features stay bf16)."""
    return cast_floating(out, torch.float32)


def variant_compute(forward: Callable[..., Any], variant: str, *,
                    cast_outputs: bool = True) -> Callable[..., Any]:
    """-> ``fn(module, x, *rest)``: a variant's compute convention over
    ``forward(module, x, *rest)``, ``module`` holding the variant's
    weights at rest (:func:`transform_variables`):

    * ``fp32``: the plain forward;
    * ``bf16``: ``x`` (a tensor or a tuple of them) cast to bf16 and the
      forward run under ``precision_policy(bf16)``, so what the modules
      make inside it (BatchNorm's output dtype, the LSTM's weights) follows
      the variant;
    * ``int8``: the weights dequantized for the forward (fp32 compute).

    ``cast_outputs=False`` for interior programs."""
    out = outputs_to_f32 if cast_outputs else (lambda o: o)
    if variant == "fp32":
        return lambda m, x, *rest: forward(m, x, *rest)
    if variant == "bf16":
        def bf16_fn(m, x, *rest):
            with precision_policy(torch.bfloat16):
                return out(forward(m, cast_floating(x, torch.bfloat16), *rest))

        return bf16_fn
    if variant == "int8":
        def int8_fn(m, x, *rest):
            with dequantized(m):
                return out(forward(m, x, *rest))

        return int8_fn
    raise ValueError(f"unknown variant {variant!r} (use one of {VARIANTS})")


def head_variant_compute(variant: str) -> Callable[..., Any]:
    """-> ``fn(head, feats, in_samples)``: a task head (a SeisT ``out_head``)
    on trunk features. bf16 heads take the bf16 trunk's features as they
    are; int8 heads compute in fp32."""
    head = lambda m, feats, n: m(feats, n)  # noqa: E731
    if variant == "fp32":
        return head
    if variant == "bf16":
        def bf16_fn(m, feats, n):
            with precision_policy(torch.bfloat16):
                return outputs_to_f32(head(m, feats, n))

        return bf16_fn
    if variant == "int8":
        def int8_fn(m, feats, n):
            with dequantized(m):
                return outputs_to_f32(head(m, feats.to(torch.float32), n))

        return int8_fn
    raise ValueError(f"unknown variant {variant!r} (use one of {VARIANTS})")


def transform_variables(model: torch.nn.Module, variant: str) -> torch.nn.Module:
    """The load-time weight transform of :func:`variant_compute`'s
    conventions: the model itself (fp32), a bf16 copy, or an int8 copy."""
    if variant == "fp32":
        return model
    if variant == "bf16":
        return copy.deepcopy(model).to(torch.bfloat16)
    if variant == "int8":
        return _quantized_copy(model)
    raise ValueError(f"unknown variant {variant!r} (use one of {VARIANTS})")


def make_variant_apply(forward: Callable[..., Any], model: torch.nn.Module, variant: str, *,
                       cast_outputs: bool = True) -> Callable[..., Any]:
    """-> ``fn(x, *rest)``: :func:`transform_variables` (once, now) closed
    over :func:`variant_compute`."""
    compute = variant_compute(forward, variant, cast_outputs=cast_outputs)
    transformed = transform_variables(model, variant)
    return lambda x, *rest: compute(transformed, x, *rest)


# -------------------------------------------------------------- parity gate
def outputs_finite(out: Any) -> bool:
    """True iff every floating output is finite: the reload gate's last
    rung (a checkpoint of NaNs captures and gates against itself fine)."""
    return all(bool(torch.isfinite(t).all()) for t in _flat(out) if _is_float(t))


def variant_parity(fp32_out: Any, variant_out: Any, variant: str, *, kind: str,
                   scale: float = 1.0) -> Tuple[bool, float]:
    """Decision-level parity of a variant's probe outputs against fp32.

    ``kind``: ``'soft'`` (per-sample probabilities: absolute error, and
    the per-sample argmax may flip only on a near-tie fraction),
    ``'onehot'`` (the argmax must be identical), ``'value'`` (error
    relative to the head's output ``scale``). Returns (ok, err)."""
    tol = _PARITY_TOL[variant]
    a = _numpy(fp32_out)
    b = _numpy(variant_out)
    if kind == "onehot":
        ok = bool(np.array_equal(np.argmax(a, -1), np.argmax(b, -1)))
        return ok, float(np.max(np.abs(a - b)))
    if kind == "value":
        err = float(np.max(np.abs(a - b))) / max(scale, 1e-8)
        return err <= tol["rel"], err
    err = float(np.max(np.abs(a - b)))
    flips = float(np.mean(np.argmax(a, -1) != np.argmax(b, -1)))
    return err <= tol["abs"] and flips <= tol["argmax_frac"], err


def _numpy(x: Any) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def parity_kind(spec: Any) -> Tuple[str, float]:
    """A task spec's parity-gate comparison: (kind, scale)."""
    from seist_tpu_torch import taskspec

    names = [n for group in spec.labels
             for n in (group if isinstance(group, (tuple, list)) else [group])]
    kinds = {taskspec.get_kind(n) for n in names if n in taskspec.IO_ITEMS}
    if kinds == {taskspec.VALUE}:
        return "value", 1.0
    if kinds == {taskspec.ONEHOT}:
        return "onehot", 1.0
    return "soft", 1.0
