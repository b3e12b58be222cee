"""The train and eval steps as CUDA graphs (counterpart of
``seist_tpu/train/step.py``'s ``jit_step``, ``jit_multi_step`` and
``jit_eval_step``).

The JAX package compiles its step into one program; the port captures the
step's kernels into a CUDA graph once per (variant, batch geometry, dtype)
and replays it, so a step costs one graph launch instead of ~14,000 kernel
launches from Python. On the CPU the wrappers return the step itself: the
eager step is the graphs' reference and the CPU tests' path.

A capture (:class:`Captured`):

1. copies the first call's inputs into static input buffers on the
   device;
2. runs the step twice on a side stream (cuDNN picks its algorithms, the
   kernels are built, the caching allocator warms up), the first time to
   count the attention calls that draw a dropout seed, then restores every
   tensor the step writes (parameters, gradients, BatchNorm statistics,
   optimizer state, update count) to its value before: the warm-up runs
   update nothing;
3. captures one run into a graph (``capture_error_mode="thread_local"``,
   so the loader threads may pin memory meanwhile). Any failure raises:
   there is no fallback to the eager step.

Several ranks: under NCCL the step's collectives (``parallel/comm.py``)
run inside the graph, on the capturing stream; the warm-up runs have made
them once on every rank before; so does the device-aug cache's row
exchange in the processor's graph. gloo stages CUDA tensors through the
host, which a capture cannot hold, so a capture under gloo raises: the
capture wrappers run the eager step (and processor) there, and only there.

A replay copies the call's inputs into the static buffers (non-blocking
from pinned host memory), writes the step's attention seeds into the
graph's seed buffer (drawn on the host from the step's
:class:`~seist_tpu_torch.models.common.RandomSource`, in call order, as
the eager step draws them), re-seeds the default CUDA generator with the
source's device seed (the graph's dropout and DropPath draws read the
default generator's seed and offset at each replay, so they equal the
eager step's draws from a generator seeded the same way), launches the
graph, and adds the attention kernels it captured to their launch counts
(``ops/pooled_attention.py``: the wrappers do not run in a replay).
Outputs live in the graph's memory and are overwritten by the next
replay: the train step returns copies of its loss and verdict (and of its
outputs when asked), the eval step of its loss and outputs.

A model with a ``captured_inputs(x)`` method (``models/baz_network.py``,
whose ``torch.linalg.eigh`` synchronises with the host) computes, on the
device and before each replay, what its forward would compute from the
input inside the graph; the graph's input is what that method returns.

``--steps-per-call k`` replays the one-step graph k times
(``step.make_multi_train_step`` over :func:`capture_train_step`): a graph
launch costs microseconds, one capture serves every k, and the graph's
memory holds one step's activations. ``--grad-accum-steps k`` captures
three graphs, replayed begin, k x micro-batch, update.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.ops import launch_counts
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.ops import threefry
from seist_tpu_torch.parallel import dist
from seist_tpu_torch.train import step as step_lib
from seist_tpu_torch.train.precision import resolve_dtype
from seist_tpu_torch.train.step import TrainState


def _flat(tree) -> List[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _flat(x)]
    return [tree]


def _unflat(tree, leaves: List[torch.Tensor]):
    """``tree``'s structure over ``leaves`` (consumed in order)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflat(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: _unflat(x, leaves) for k, x in tree.items()}
    return leaves.pop(0)


#: The launch counters of the port's kernels, in :func:`kernel_counts`'
#: order: the attention's four (``ops/pooled_attention.py``) and K3's
#: (``ops/threefry.py``).
COUNTERS = tuple((pa.__name__, n) for n in ("launches", "bwd_launches", "bf16_launches",
                                            "bf16_bwd_launches")) + ((threefry.__name__,
                                                                      "launches"),)


def kernel_counts() -> Tuple[int, ...]:
    """The launch counts of the port's kernels (:data:`COUNTERS`)."""
    return pa.counts() + (threefry.launches,)


def _geometry(tensors: Sequence[torch.Tensor]) -> Tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


#: One warm-up stream per device, for every capture of the process:
#: cuBLAS keeps a workspace for each stream it has run on until the
#: process ends (32 MiB on an H100), so a stream per capture would leak one
#: workspace per capture.
_WARMUP_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _warmup_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index or 0
    if index not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[index] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[index]


class Captured:
    """One function captured as a CUDA graph (module docstring).

    ``fn(*inputs, rng)`` (``fn(*inputs)`` when not ``random``: the
    function draws no randomness) returns the graph's outputs (tensors,
    or None). ``mutable`` lists every tensor ``fn`` writes, restored after
    the warm-up runs. ``pool`` is the memory pool the graph allocates from
    (``torch.cuda.graph_pool_handle()``; graphs that share one must never
    replay at the same time). With ``shared_inputs`` the graph reads
    ``inputs`` where they lie (another graph's outputs) instead of copies."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], device: torch.device,
                 mutable: Sequence[torch.Tensor] = (), random: bool = False,
                 pool: Optional[Tuple[int, int]] = None, shared_inputs: bool = False):
        if dist.backend() == "gloo":
            raise RuntimeError(
                "a step under the gloo backend cannot be captured as a CUDA graph (its "
                "collectives copy through host memory); the train worker runs eager steps "
                "under DIST_BACKEND=gloo")
        self.device = device
        self.random = random
        self.generator = torch.cuda.default_generators[device.index or 0]
        if shared_inputs:
            self.static = list(inputs)
        else:
            self.static = [torch.empty_like(x, device=device) for x in inputs]
            for s, x in zip(self.static, inputs):
                s.copy_(x)
        snapshot = [t.clone() for t in mutable]
        side = _warmup_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        self.seeds: Optional[torch.Tensor] = None
        with launch_counts.diverted(side), torch.cuda.stream(side):  # warm-up: counted nowhere
            counting = self._source(seed_generator=torch.Generator().manual_seed(0))
            fn(*self._args(counting))
            if self.random:
                self.seeds = torch.zeros(counting.attention_calls, dtype=torch.int32,
                                         device=device)
            fn(*self._args(self._source()))
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, saved in zip(mutable, snapshot):
                t.copy_(saved)
        del snapshot
        self.graph = torch.cuda.CUDAGraph()
        with launch_counts.diverted(side) as tally, torch.cuda.graph(
                self.graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            out = fn(*self._args(self._source()))
        self.outputs = out
        #: The kernels one replay launches (:data:`COUNTERS`' order).
        self.launches = tuple(tally.get(c, 0) for c in COUNTERS)

    def _source(self, seed_generator: Optional[torch.Generator] = None) -> Optional[RandomSource]:
        if not self.random:
            return None
        src = RandomSource(self.generator, seed_generator)
        src.attention_seeds = self.seeds
        return src

    def _args(self, src: Optional[RandomSource]) -> List[Any]:
        return self.static + [src] if self.random else list(self.static)

    def replay(self, inputs: Sequence[torch.Tensor], rng: Optional[RandomSource] = None):
        for s, x in zip(self.static, inputs):
            if s is not x:
                s.copy_(x, non_blocking=True)
        if self.random:
            if rng.generator is None or rng.droppath_uniforms is not None:
                raise ValueError("a captured step takes a RandomSource.from_seed source: its "
                                 "dropout and DropPath draw from the re-seeded default generator")
            n = self.seeds.numel()
            if n:
                draws = torch.tensor([rng.draw_attention_seed() for _ in range(n)],
                                     dtype=torch.int32).pin_memory()
                self.seeds.copy_(draws, non_blocking=True)
            self.generator.manual_seed(rng.generator.initial_seed())
        self.graph.replay()
        launch_counts.add(COUNTERS, self.launches)
        return self.outputs


class _Graphs:
    """The captures of one step function, by train state and input
    geometry (a capture holds its state, so the state's id stays its
    own)."""

    def __init__(self):
        self.by_key: Dict[Tuple, Captured] = {}
        self.capture_seconds: List[float] = []

    def get(self, key: Tuple, make: Callable[[], Any]) -> Any:
        """The capture of ``key``, made by ``make`` the first time (its
        wall seconds, warm-up included, go to :attr:`capture_seconds`)."""
        got = self.by_key.get(key)
        if got is None:
            t0 = time.perf_counter()
            got = self.by_key[key] = make()
            torch.cuda.synchronize()
            self.capture_seconds.append(time.perf_counter() - t0)
        return got


def _staged(model: torch.nn.Module, inputs):
    """``inputs`` as a captured step takes them (module docstring)."""
    stage = getattr(model, "captured_inputs", None)
    return inputs if stage is None else stage(inputs)


_EAGER_LOGGED = []


def _on_cuda(state: TrainState) -> Optional[torch.device]:
    """The model's CUDA device, or None when the step runs eagerly: on the
    CPU, and under the gloo backend (module docstring)."""
    return _captured_on(step_lib._device_of(state.model))


def _captured_on(dev: torch.device) -> Optional[torch.device]:
    """``dev`` when what runs there is captured, else None (:func:`_on_cuda`)."""
    if dev.type != "cuda":
        return None
    if dist.backend() == "gloo":
        if not _EAGER_LOGGED:
            from seist_tpu_torch.utils.logger import logger

            logger.info("gloo backend on cuda: the steps run eagerly (no CUDA graphs)")
            _EAGER_LOGGED.append(True)
        return None
    return dev


def _on_model(state: TrainState, tree):
    """``tree``'s tensors on the model's device: the eager step under gloo
    on a card gets the host batch that a replay would copy in."""
    return _on_device(step_lib._device_of(state.model), tree)


def _on_device(dev: torch.device, tree):
    if dev.type == "cpu":
        return tree
    return _unflat(tree, [t.to(dev, non_blocking=True) if torch.is_tensor(t) else t
                          for t in _flat(tree)])


def capture_train_step(step: Callable) -> Callable:
    """``step(state, inputs, targets, rng) -> (loss, outputs, diag)`` (a
    :func:`~seist_tpu_torch.train.step.make_train_step` step) run as a
    graph on CUDA: returns copies of the loss and ``diag``, and of the
    outputs when ``keep_outputs`` (else None; the train worker asks on its
    log-step calls only). The graph keeps its outputs alive in its pool,
    which holds them through the step anyway, so a copy made before the
    next replay is the step's own. On the CPU, and under gloo, the step
    itself."""
    graphs = _Graphs()

    def run(state: TrainState, inputs, targets, rng: RandomSource, keep_outputs: bool = False):
        dev = _on_cuda(state)
        if dev is None:
            return step(state, *_on_model(state, (inputs, targets)), rng)
        inputs = _staged(state.model, inputs)
        flat_in = _flat(inputs) + _flat(targets)
        n_in = len(_flat(inputs))

        def fn(*args):
            *tensors, src = args
            loss, outputs, diag = step(state, _unflat(inputs, list(tensors[:n_in])),
                                       _unflat(targets, list(tensors[n_in:])), src)
            return (loss, diag, outputs)

        def make() -> Captured:
            state.prepare()
            return Captured(fn, flat_in, dev, state.tensors(), random=True)

        cap = graphs.get(("train", id(state)) + _geometry(flat_in), make)
        loss, diag, outputs = cap.replay(flat_in, rng)
        if keep_outputs:
            outputs = _unflat(outputs, [o.clone() for o in _flat(outputs)])
        return loss.clone(), outputs if keep_outputs else None, {
            k: v.clone() for k, v in diag.items()}

    run.graphs = graphs
    return run


def capture_accum_step(loss_fn: Callable, accum_steps: int, guard: bool = True,
                       compute_dtype: Optional[str] = None) -> Callable:
    """:func:`~seist_tpu_torch.train.step.make_accum_train_step` run as
    three graphs on CUDA (begin, one micro-batch, the update), replayed
    begin, k x micro-batch, update; the eager step on the CPU and under
    gloo."""
    eager = step_lib.make_accum_train_step(loss_fn, accum_steps, guard, compute_dtype)
    if accum_steps <= 1:
        return capture_train_step(eager)
    cdtype = resolve_dtype(compute_dtype)
    graphs = _Graphs()

    def run(state: TrainState, inputs_k, targets_k, rngs: Sequence[RandomSource]):
        dev = _on_cuda(state)
        if dev is None:
            return eager(state, *_on_model(state, (inputs_k, targets_k)), rngs)
        micro_inputs = [_staged(state.model, step_lib._index(inputs_k, i))
                        for i in range(accum_steps)]
        xs, ys = micro_inputs[0], step_lib._index(targets_k, 0)
        flat_in = _flat(xs) + _flat(ys)
        n_in = len(_flat(xs))

        def micro(*args):
            *tensors, src = args
            loss, _ = step_lib.accumulate(state, _unflat(xs, list(tensors[:n_in])),
                                          _unflat(ys, list(tensors[n_in:])), src, loss_fn,
                                          cdtype)
            return loss

        def make() -> Tuple[Captured, Captured, Captured]:
            state.prepare()
            mutable = state.tensors()
            return (Captured(lambda: step_lib.begin_step(state, guard), [], dev, mutable),
                    Captured(micro, flat_in, dev, mutable, random=True),
                    Captured(lambda: step_lib.finish_step(
                        state, guard, accum_steps, getattr(loss_fn, "reduction", "mean")),
                        [], dev, mutable))

        begin, one, finish = graphs.get(("accum", id(state)) + _geometry(flat_in), make)
        begin.replay([])
        for i in range(accum_steps):
            one.replay(_flat(micro_inputs[i]) + _flat(step_lib._index(targets_k, i)), rngs[i])
        loss, diag = finish.replay([])
        return loss.clone(), None, {k: v.clone() for k, v in diag.items()}

    run.graphs = graphs
    return run


def capture_processor(process: Callable, device: torch.device, resident: int = 0) -> Callable:
    """A device-augmentation processor (``data/device_aug.py``:
    ``process(rows, idx, aug, epoch)`` or ``process(cache, idx, epoch)``)
    run as its own CUDA graph on a CUDA ``device``, one capture per input
    geometry: a replay copies the arguments (host tensors, pinned for a
    copy that does not wait) into the graph's static buffers and returns
    the graph's ``(inputs, targets)``, which the next replay overwrites;
    the train step copies them into its own buffers at once. The first
    ``resident`` arguments are device tensors the graph reads where they
    lie (the resident cache: the same tensors at every call, keyed by
    address). K3's launch inside it is counted at each replay. Under NCCL
    the sharded cache's row exchange (``pipeline.exchange_rows``) is
    captured with the rest; under gloo the processor runs eagerly on the
    card, as the step does, its host arguments copied there first. On the
    CPU, the processor itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return process
    graphs = _Graphs()

    def run(*args):
        kept, copied = args[:resident], args[resident:]
        if _captured_on(device) is None:
            return process(*kept, *_on_device(device, copied))
        flat_in = _flat(copied)

        def fn(*tensors):
            return process(*kept, *_unflat(copied, list(tensors)))

        key = (tuple(t.data_ptr() for t in _flat(kept)),) + _geometry(flat_in)
        return graphs.get(key, lambda: Captured(fn, flat_in, device)).replay(flat_in)

    run.graphs = graphs
    return run


def capture_eval_step(step: Callable) -> Callable:
    """``step(state, inputs, targets, mask) -> (loss, outputs)`` (a
    :func:`~seist_tpu_torch.train.step.make_eval_step` step) run as a
    graph on CUDA, returning copies; the step itself on the CPU and under
    gloo."""
    graphs = _Graphs()

    def run(state: TrainState, inputs, targets, mask):
        dev = _on_cuda(state)
        if dev is None:
            return step(state, inputs, targets, mask)
        inputs = _staged(state.model, inputs)
        flat_in = _flat(inputs) + _flat(targets) + [mask]
        n_x, n_y = len(_flat(inputs)), len(_flat(targets))

        def fn(*tensors):
            loss, outputs = step(state, _unflat(inputs, list(tensors[:n_x])),
                                 _unflat(targets, list(tensors[n_x:n_x + n_y])),
                                 tensors[-1])
            return (loss, outputs)

        cap = graphs.get(("eval", id(state)) + _geometry(flat_in),
                         lambda: Captured(fn, flat_in, dev))
        loss, outputs = cap.replay(flat_in)
        return loss.clone(), _unflat(outputs, [o.clone() for o in _flat(outputs)])

    run.graphs = graphs
    return run
