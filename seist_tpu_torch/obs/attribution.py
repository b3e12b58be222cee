"""Per-op step attribution: where a step's time goes (counterpart of
``seist_tpu/obs/attribution.py``).

**The analytic half.** :func:`op_costs` runs ``fn(*args)`` once, eagerly,
under a ``TorchDispatchMode`` of this module's own (:class:`OpRecorder`)
that sees every ATen op below autograd, the backward's too, and charges
each its FLOPs and the bytes of its operands and results. The rules are
the JAX package's walk (``jaxpr_op_costs``), so one step reads the same
work in both packages:

* ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and ``linear``: ``2·batch·m·n·k``
  (``_dot_flops``);
* ``convolution``: ``_conv_flops`` of the same convolution, ``2·(output
  elements / output channels)·kernel elements``, groups included; a
  transposed convolution as JAX charges its form with a dilated input
  (output positions times kernel, the dilated zeros included);
* ``convolution_backward``: only the gradients its ``output_mask`` asks
  for, each as JAX's transpose rules write it: the input's gradient a
  convolution over the input's positions, the weight's one over the
  output gradient's elements divided by the groups (JAX's
  ``batch_group_count``); the bias's gradient is a reduction JAX charges
  apart, so it is left out here;
* the LSTM ops that no dispatch mode sees into (``mkldnn_rnn_layer`` on
  the CPU, ``_cudnn_rnn`` on the card, and their backwards): what the JAX
  walk charges for ``seist_tpu/models/common.py::LSTM`` / ``BiLSTM``, a
  scan body of two products (input and hidden, four gates each) times the
  trip count; the backward two products for each of those (the weights'
  gradient and the operand's), the input's only where it is asked for;
* reductions by their input's element count, data movement 0, anything
  else by the larger of its input and output element counts. An op the
  rules do not model falls back to its element count and never raises.

The hand-written kernels are launched through ``ctypes``, out of the
dispatch mode's sight: each wrapper calls :func:`charge` beside its
launch count (K1 ``4·N·H·L·M·E`` and K2 ``10·N·H·L·M·E`` in the matmul
class, K3 its element count; bytes from ``PERF.md``'s bound formulas), so
a step's matmul FLOPs on the card equal those of the same step on the CPU,
where the plain versions run. ``make_jaxpr`` executes nothing; the
recording executes ``fn``, on a deep copy of ``args`` so a train step's
in-place updates leave the caller's state untouched.

:func:`attribute_step` turns the records into the JAX package's output:
top-k ops by a roofline charge ``max(flops/peak, bytes/bw)`` (the generic
basis, or the card's: :data:`H100`), the class decomposition, and with a
measured step time each class's milliseconds and ``mfu_model``.

**The measured half.** :func:`measured_kernels` runs ``torch.profiler``
over calls of ``fn`` and reports wall and device-busy ms per call, the
idle share, kernels per call and the device kernels that take most;
:func:`kernels_in_trace` reads the same table from a Chrome trace that
``--profile-steps`` or ``profile-step`` wrote.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

# Generic roofline (the JAX package's): ridge intensity 10 FLOP/byte when
# the device's peak and bandwidth are not given; only relative shares
# matter then.
_GENERIC_PEAK = 1e12
_GENERIC_BW = 1e11

#: The H100's roofline (``PERF.md`` §6): HBM3 bytes/s and the peak
#: FLOP/s of fp32 on the CUDA cores and of the bf16 tensor cores.
H100 = {"hbm_bw": 3.35e12, "fp32": 67e12, "bf16": 989e12}

_MATMUL_OPS = frozenset((
    "mm", "addmm", "bmm", "baddbmm", "linear", "convolution", "convolution_backward",
    "mkldnn_rnn_layer", "mkldnn_rnn_layer_backward", "_cudnn_rnn", "_cudnn_rnn_backward",
    "pooled_attention_fwd", "pooled_attention_bwd",
))
_REDUCE_OPS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "cumsum",
    "cumprod", "cummax", "cummin", "logsumexp", "norm", "linalg_vector_norm", "var", "std",
    "var_mean", "std_mean", "all", "any", "_foreach_norm", "nansum",
))
_DATA_OPS = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "transpose", "t", "permute", "expand",
    "squeeze", "unsqueeze", "cat", "stack", "slice", "select", "index_select", "gather",
    "scatter", "scatter_add", "index", "index_put", "constant_pad_nd", "flip", "roll", "clone",
    "copy", "_to_copy", "contiguous", "alias", "detach", "split", "split_with_sizes", "unbind",
    "narrow", "as_strided", "zeros", "zeros_like", "empty", "empty_like", "empty_strided",
    "new_zeros", "new_empty", "new_empty_strided", "new_full", "new_ones", "full", "full_like",
    "ones", "ones_like", "fill", "zero", "arange", "repeat", "where", "masked_fill",
    "lift_fresh", "lift_fresh_copy", "_foreach_copy", "unfold", "diagonal", "slice_scatter",
    "select_scatter", "expand_as", "view_as", "_local_scalar_dense", "_to_dtype",
))


def classify(op: str) -> str:
    """``matmul``, ``reduce``, ``data_movement`` or ``elementwise`` (the JAX
    package's four classes) for an ATen op name; an in-place variant
    (``add_``) is classed as its op."""
    base = op[:-1] if op.endswith("_") and not op.endswith("__") else op
    if base in _MATMUL_OPS:
        return "matmul"
    if base in _REDUCE_OPS:
        return "reduce"
    if base in _DATA_OPS:
        return "data_movement"
    return "elementwise"


def _tensors(tree: Any) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def shape_str(t: torch.Tensor) -> str:
    """``f32[2,512,3]``: the JAX walk's example notation."""
    dt = str(t.dtype).replace("torch.", "")
    short = {"float32": "f32", "bfloat16": "bf16", "float16": "f16", "int32": "i32",
             "int64": "i64", "bool": "pred", "int8": "i8"}.get(dt, dt)
    return f"{short}[{','.join(str(d) for d in t.shape)}]"


# ------------------------------------------------------------- FLOP rules
def dot_flops(a: torch.Tensor, b: torch.Tensor) -> int:
    """``_dot_flops`` of ``a @ b`` for (..., m, k) @ (..., k, n) or a
    2-D ``b``: 2·batch·m·n·k."""
    return 2 * (a.numel() // a.shape[-1]) * a.shape[-1] * b.shape[-1]


def conv_flops(out_or_input: torch.Tensor, weight: torch.Tensor) -> int:
    """``_conv_flops`` of a convolution JAX writes with this output (NC...
    layout) and this kernel: ``2·(elements / channels)·kernel elements``."""
    return 2 * (out_or_input.numel() // out_or_input.shape[1]) * weight.numel()


def _conv_backward_flops(grad_out, inp, weight, groups: int, mask) -> int:
    """The gradients JAX's transpose rules emit for ``mask``: the input's
    as a convolution over the input's positions, the weight's over the
    output gradient's elements divided by ``batch_group_count`` (JAX's
    ``(2·(w / Cout)·g) // groups``)."""
    flops = 0
    if mask[0]:
        flops += conv_flops(inp, weight)
    if mask[1]:
        flops += 2 * (weight.numel() // grad_out.shape[1]) * grad_out.numel() // max(groups, 1)
    return flops


def _cudnn_rnn_flops(a: Dict[str, Any], backward: bool) -> int:
    """``_cudnn_rnn`` and its backward over all layers and directions: the
    flat weight list holds ``weight_stride0`` tensors a (layer, direction),
    its (4H, I) and (4H, H) weights first. The backward's ``output_mask``
    (input, hx, cx, weights) says which gradients it writes; the hidden
    product's transpose runs whenever any does (the recurrence needs it)."""
    x = a["input"]
    tokens = x.numel() // x.shape[-1]
    dirs = 2 if a["bidirectional"] else 1
    mask = list(a["output_mask"]) if backward else None
    any_grad = backward and any(mask)
    weights, stride = a["weight"], max(a["weight_stride0"], 2)
    flops = 0
    for g, i in enumerate(range(0, len(weights), stride)):
        ih, hh = 2 * tokens * weights[i].numel(), 2 * tokens * weights[i + 1].numel()
        if not backward:
            flops += ih + hh
            continue
        layer = g // dirs
        flops += (ih + hh) * bool(mask[3]) + hh * any_grad
        flops += ih * bool(mask[0] or (layer > 0 and any_grad))
    return flops


def _named(func, args, kwargs) -> Dict[str, Any]:
    names = [arg.name for arg in func._schema.arguments]
    out = dict(zip(names, args))
    out.update(kwargs)
    return out


def op_flops(name: str, func, args, kwargs, ins: List[torch.Tensor],
             outs: List[torch.Tensor]) -> int:
    """One op's FLOPs by the rules (module docstring); an op laid out
    otherwise than they expect is charged its output's element count,
    never an error (attribution is a diagnostic)."""
    try:
        return _op_flops(name, func, args, kwargs, ins, outs)
    except (AttributeError, KeyError, TypeError, IndexError, ValueError):
        return max((t.numel() for t in outs), default=0)


def _op_flops(name: str, func, args, kwargs, ins: List[torch.Tensor],
              outs: List[torch.Tensor]) -> int:
    if name in ("mm", "bmm"):
        return dot_flops(args[0], args[1])
    if name in ("addmm", "baddbmm"):
        return dot_flops(args[1], args[2])
    if name == "linear":
        return 2 * args[0].numel() * args[1].shape[0]
    if name == "convolution":
        return conv_flops(outs[0], args[1])
    if name == "convolution_backward":
        a = _named(func, args, kwargs)
        return _conv_backward_flops(a["grad_output"], a["input"], a["weight"], a["groups"],
                                    a["output_mask"])
    if name in ("mkldnn_rnn_layer", "mkldnn_rnn_layer_backward"):
        # One layer and direction: the input, its (4H, I) and (4H, H)
        # weights; the backward always writes the input's and the weights'
        # gradients.
        x, w_ih, w_hh = args[:3]
        fwd = 2 * (x.numel() // x.shape[-1]) * (w_ih.numel() + w_hh.numel())
        return 2 * fwd if name.endswith("backward") else fwd
    if name in ("_cudnn_rnn", "_cudnn_rnn_backward"):
        return _cudnn_rnn_flops(_named(func, args, kwargs), name.endswith("backward"))
    cls = classify(name)
    if cls == "reduce":
        return sum(t.numel() for t in ins)
    if cls == "data_movement":
        return 0
    return max(max((t.numel() for t in outs), default=0), max((t.numel() for t in ins), default=0))


# -------------------------------------------------------------- recording
class OpRecorder(TorchDispatchMode):
    """Records every ATen op dispatched while it is active: per op name its
    class, count, FLOPs, bytes (operands and results) and one example of
    its shapes. The kernel wrappers add their launches through
    :func:`charge`."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, Dict[str, Any]] = {}

    def add(self, name: str, flops: int, nbytes: int, example: Optional[str]) -> None:
        rec = self.ops.setdefault(name, {"op": name, "class": classify(name), "count": 0,
                                         "flops": 0, "bytes": 0, "example": None})
        rec["count"] += 1
        rec["flops"] += int(flops)
        rec["bytes"] += int(nbytes)
        if rec["example"] is None:
            rec["example"] = example

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in ("max", "min") and func._overloadname == "other":
            name = "maximum" if name == "max" else "minimum"
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        flops = op_flops(name, func, args, kwargs, ins, outs)
        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        example = None if name in self.ops else " ".join(shape_str(t) for t in ins[:2]) + (
            f" -> {shape_str(outs[0])}" if outs else "")
        self.add(name, flops, nbytes, example)
        return out


def charge(name: str, flops: int, nbytes: int, example: str) -> None:
    """Charge one launch of a hand-written kernel to every recording active
    in this thread (the dispatch mode stack, which autograd carries to its
    device threads); a no-op outside one."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, OpRecorder):
            mode.add(name, flops, nbytes, example)


def _copy(tree: Any) -> Any:
    """A deep copy; a tensor inside an autograd graph (which ``deepcopy``
    refuses) is copied detached."""
    if torch.is_tensor(tree) and not tree.is_leaf:
        return tree.detach().clone()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(x) for x in tree)
    return copy.deepcopy(tree)


def op_costs(fn: Callable, args: Sequence[Any]) -> List[Dict[str, Any]]:
    """Per-op cost records of one call of ``fn`` on a deep copy of ``args``
    (the counterpart of ``jaxpr_op_costs``), most expensive first."""
    # Under inference mode the composite ops (``linear``, ``conv1d``,
    # ``einsum``) reach the mode whole; outside it, as the products and
    # convolutions the rules charge.
    with torch.inference_mode(False), torch.set_grad_enabled(
            torch.is_grad_enabled() and not torch.is_inference_mode_enabled()):
        args = _copy(tuple(args))
        with OpRecorder() as rec:
            fn(*args)
    return sorted(rec.ops.values(), key=lambda r: -(r["flops"] + r["bytes"]))


def roofline(dtype: str = "fp32") -> Dict[str, float]:
    """The H100's ``peak_flops`` and ``hbm_bw`` for a step in ``dtype``."""
    return {"peak_flops": H100[dtype], "hbm_bw": H100["hbm_bw"]}


def attribute_step(
    fn: Callable,
    args: Sequence[Any],
    *,
    peak_flops: Optional[float] = None,
    hbm_bw: Optional[float] = None,
    measured_step_ms: Optional[float] = None,
    top_k: int = 10,
) -> Dict[str, Any]:
    """Record ``fn(*args)`` and return the top-k ops by roofline-modelled
    time with FLOPs, bytes and the class decomposition, as the JAX
    package's ``attribute_step`` does. With ``measured_step_ms`` the model's
    time shares become milliseconds of the real step; with ``peak_flops``
    as well, ``mfu_model`` and ``mfu_matmul_attributed``."""
    return summarize(op_costs(fn, args), peak_flops=peak_flops, hbm_bw=hbm_bw,
                     measured_step_ms=measured_step_ms, top_k=top_k)


def summarize(
    ops: List[Dict[str, Any]],
    *,
    peak_flops: Optional[float] = None,
    hbm_bw: Optional[float] = None,
    measured_step_ms: Optional[float] = None,
    top_k: int = 10,
) -> Dict[str, Any]:
    """:func:`attribute_step`'s output from :func:`op_costs` records (one
    recording, several bases or measured times)."""
    peak = float(peak_flops or 0.0) or _GENERIC_PEAK
    bw = float(hbm_bw or 0.0) or _GENERIC_BW
    times = [max(r["flops"] / peak, r["bytes"] / bw) for r in ops]
    order = sorted(range(len(ops)), key=lambda i: -times[i])
    t_total = sum(times) or 1e-30
    flops_total = sum(r["flops"] for r in ops)
    bytes_total = sum(r["bytes"] for r in ops)
    classes: Dict[str, Dict[str, float]] = {}
    for r, t in zip(ops, times):
        c = classes.setdefault(r["class"], {"flops": 0, "bytes": 0, "time_model_s": 0.0})
        c["flops"] += r["flops"]
        c["bytes"] += r["bytes"]
        c["time_model_s"] += t

    def _ms(share: float) -> Optional[float]:
        return None if measured_step_ms is None else round(share * measured_step_ms, 3)

    top = []
    for i in order[: max(1, int(top_k))]:
        r, share = ops[i], times[i] / t_total
        top.append({
            "op": r["op"], "class": r["class"], "count": r["count"], "flops": int(r["flops"]),
            "bytes_accessed": int(r["bytes"]), "time_frac": round(share, 4),
            "est_ms": _ms(share),
            "bound": "compute" if r["flops"] / peak >= r["bytes"] / bw else "memory",
            "example": r["example"],
        })
    decomposition = {}
    for cname, c in sorted(classes.items()):
        share = c["time_model_s"] / t_total
        decomposition[cname] = {
            "flops": int(c["flops"]),
            "flops_frac": round(c["flops"] / max(flops_total, 1), 4),
            "time_frac": round(share, 4),
            "est_ms": _ms(share),
        }
    out: Dict[str, Any] = {
        "top_ops": top,
        "n_op_kinds": len(ops),
        "flops_total": int(flops_total),
        "bytes_total": int(bytes_total),
        "arithmetic_intensity": round(flops_total / max(bytes_total, 1), 3),
        "mfu_decomposition": decomposition,
        "roofline_basis": {"peak_flops": peak, "hbm_bw": bw, "generic": not peak_flops},
    }
    if measured_step_ms is not None and peak_flops:
        out["mfu_model"] = round(flops_total / (measured_step_ms / 1e3 * peak_flops), 4)
        mm_ms = decomposition.get("matmul", {}).get("est_ms") or 0.0
        if mm_ms:
            out["mfu_matmul_attributed"] = round(
                classes["matmul"]["flops"] / (mm_ms / 1e3 * peak_flops), 4)
    return out


def matmul_flops(fn: Callable, args: Sequence[Any]) -> int:
    """The matmul class's FLOPs of one call (what a served program
    reports)."""
    return sum(r["flops"] for r in op_costs(fn, args) if r["class"] == "matmul")


# ----------------------------------------------------------- measured half
def device_kernels(prof) -> list:
    """The device events of a ``torch.profiler`` session, without
    user-annotation ranges (such as ``Optimizer.step``), which span other
    kernels and would count their time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def _table(rows: List[tuple], calls: int, top_k: int) -> Dict[str, Any]:
    """rows: (kernel name, total device us, launches)."""
    rows = sorted(rows, key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3 / calls
    launches: Dict[str, float] = {}
    for name, _, n in rows:
        launches[name] = launches.get(name, 0.0) + n / calls
    return {
        "busy_ms": busy_ms,
        "kernels": sum(r[2] for r in rows) / calls,
        "top": [{"kernel": name, "ms": us / 1e3 / calls, "launches": n / calls}
                for name, us, n in rows[: max(0, int(top_k))]],
        "launches": launches,
    }


def launches_of(table: Dict[str, Any], needle: str) -> float:
    """Launches per call of the kernels whose name contains ``needle``."""
    return sum(n for name, n in table["launches"].items() if needle in name)


def measured_kernels(fn: Callable, iters: int = 3, top_k: int = 8,
                     warmup: int = 1) -> Dict[str, Any]:
    """``torch.profiler`` (CPU and CUDA activities) over ``iters`` calls of
    ``fn`` after ``warmup`` calls: wall and device-busy ms per call, the
    idle share, kernels per call and the top-k device kernels by self
    device time (ms and launches per call). Without a card it traces the
    CPU alone, and lists no kernel."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    events = device_kernels(prof)
    out = _table([(e.key, e.self_device_time_total, e.count) for e in events], iters, top_k)
    out.update(iters=iters, wall_ms=wall_ms, idle_share=1.0 - out["busy_ms"] / wall_ms)
    return out


def kernels_in_trace(path: str, calls: int = 1, top_k: int = 8) -> Dict[str, Any]:
    """:func:`measured_kernels`' table from a Chrome trace of
    ``torch.profiler`` (its ``kernel`` events), per call of ``calls``, with
    the file's size."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    totals: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            t = totals.setdefault(e.get("name", ""), [0.0, 0])
            t[0] += float(e.get("dur", 0.0))
            t[1] += 1
    out = _table([(k, v[0], v[1]) for k, v in totals.items()], calls, top_k)
    out.update(path=path, bytes=os.path.getsize(path), calls=calls)
    return out


def kernel_lines(table: Dict[str, Any], unit: str) -> List[str]:
    """The top kernels of a table, one line each: ``ms/<unit> in N
    launches: name``."""
    return [f"{r['ms']:.3f} ms/{unit} in {r['launches']:g} launches: {r['kernel'][:60]}"
            for r in table["top"]]


__all__ = [
    "H100", "OpRecorder", "attribute_step", "charge", "classify", "conv_flops", "device_kernels",
    "dot_flops", "kernel_lines", "kernels_in_trace", "launches_of",
    "matmul_flops", "measured_kernels", "op_costs", "roofline", "summarize",
]
