"""Train and eval steps (counterpart of ``seist_tpu/train/step.py``).

The JAX package's step is one jitted program over an immutable
``TrainState``; here it is PyTorch over a mutable :class:`TrainState` that
holds the model (parameters and BatchNorm running statistics), the
optimizer (its moments and step counters), the count of applied updates
(``count``, a tensor on the model's device) and the buffers the step works
in. On CUDA the train worker runs these functions as CUDA graphs, captured
once and replayed (``train/graph.py``); on the CPU, and as the reference
the graphs are held against, they run eagerly. Either way they read
nothing back to the host: every function here is free of device syncs.

A step zeroes the persistent gradients, runs the forward and backward
(accumulating into them), then :func:`_guarded_update`: the global
gradient norm (``torch._foreach_norm``), the verdict ``finite =
isfinite(loss) & isfinite(grad_norm)`` on the device, and the optimizer
update at ``schedule.at(count)`` (``train/optim.py::apply_update``), which
a False verdict leaves without effect on the parameters, moments and step
counters. BatchNorm updates its running statistics in the forward (JAX's
are functional), so the step keeps a flat copy of them from before the
forward and selects old or new with one ``where``; the count advances by
the verdict. This is the JAX package's ``jax.tree.map(jnp.where, ...)``.
``diag`` holds the verdict and the norm as device tensors, read by the
worker a few steps late (``train/worker.py::_BadUpdateMonitor``).

Variants: :func:`make_multi_train_step` runs k updates on k batches, one
after another (``--steps-per-call``); :func:`make_accum_train_step` runs
one update from the mean gradient of k micro-batches, BatchNorm chained
through them (``--grad-accum-steps``); :func:`make_device_aug_train_step`
and :func:`make_cached_train_call` augment raw rows on the device first
(``--device-aug step|cached``). The randomness of each update, or of
each micro-batch, is a :class:`RandomSource` that the caller builds from
(seed, epoch, update count[, micro-batch]) with :func:`step_random_source`.

Several ranks (``parallel/``): a rank's batch is its rows of the global
batch, and before the guard :func:`reduce_over_ranks` all-reduces the
gradients and the loss in one flat bucket, so the verdict, the update and
the parameters are the same on every rank.

``compute_dtype="bf16"`` runs the forward and backward in bfloat16
(``train/precision.py``): the parameters are cast inside the step through
``torch.func.functional_call``, so gradients flow back through the cast to
the fp32 master parameters and the optimizer state stays fp32; BatchNorm
running statistics stay fp32 module buffers updated in place; outputs
return to fp32 before the loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seist_tpu_torch.models.common import RandomSource, set_random_source
from seist_tpu_torch.parallel import comm
from seist_tpu_torch.parallel import mesh as mesh_lib
from seist_tpu_torch.train import optim
from seist_tpu_torch.train.precision import (
    cast_floating,
    cast_to_float32,
    precision_policy,
    resolve_dtype,
)
from seist_tpu_torch.train.schedule import Schedule


def _device_of(model: torch.nn.Module) -> torch.device:
    for p in model.parameters():
        return p.device
    return torch.device("cpu")


class TrainState:
    """What one run trains. ``count`` (int64 on the model's device) counts
    applied updates; :attr:`step` reads it (a device sync on CUDA) or
    writes it in place. An eval-only state (the test run) holds no
    optimizer or schedule. ``l1`` lists ``(alpha, mask)`` pairs: each
    update first adds ``alpha * sign(w)`` to the gradient of every
    parameter ``mask(name)`` selects (``optim.l1_sign_decay``, EQTransformer's
    ``--conv-{kernel,bias}-l1-alpha``)."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: Optional[torch.optim.Optimizer] = None,
        schedule: Optional[Schedule] = None,
        step: int = 0,
        l1: Sequence[Tuple[float, Callable[[str], bool]]] = (),
    ):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.l1 = tuple(l1)
        self.count = torch.full((), int(step), dtype=torch.int64, device=_device_of(model))
        self.loss_sum: Optional[torch.Tensor] = None  # the step's summed micro-batch losses
        self.bn_saved: Optional[torch.Tensor] = None  # BatchNorm statistics before the step

    @property
    def step(self) -> int:
        return int(self.count)

    @step.setter
    def step(self, value: int) -> None:
        self.count.fill_(int(value))

    def prepare(self) -> None:
        """Create what a step writes in place, on the model's device: the
        persistent gradients (zeros), the optimizer state, the loss sum and
        the BatchNorm snapshot. A no-op once done (a captured step must not
        allocate them)."""
        dev = _device_of(self.model)
        if self.count.device != dev:
            self.count = self.count.to(dev)
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.optimizer is not None:
            optim.prepare_state(self.optimizer)
        if self.loss_sum is None or self.loss_sum.device != dev:
            self.loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            n = sum(b.numel() for b in _bn_buffers(self.model))
            self.bn_saved = torch.zeros(n, dtype=torch.float32, device=dev)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a train step writes (after :meth:`prepare`)."""
        out = [self.count]
        for p in self.model.parameters():
            out += [p, p.grad]
        out += list(self.model.buffers())
        if self.optimizer is not None:
            out += optim.state_tensors(self.optimizer)
        return out + [self.loss_sum, self.bn_saved]


def _bn_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for name, b in model.named_buffers() if name.endswith(("running_mean", "running_var"))]


def _params(state: TrainState) -> List[torch.Tensor]:
    """The optimizer's parameters, in its order."""
    return list(state.optimizer.param_groups[0]["params"])


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over every leaf."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def _forward(model: torch.nn.Module, inputs, cdtype: Optional[torch.dtype]):
    """The model's forward in the compute dtype: fp32 outputs either way."""
    if cdtype is None:
        return model(inputs)
    params = {n: p.to(cdtype) for n, p in model.named_parameters()}
    with precision_policy(cdtype):
        out = torch.func.functional_call(model, params, (cast_floating(inputs, cdtype),))
    return cast_to_float32(out)


def begin_step(state: TrainState, guard: bool) -> None:
    """Zero the gradients and the loss sum; with the guard, keep the
    BatchNorm statistics of before the forward."""
    state.prepare()
    with torch.no_grad():
        torch._foreach_zero_([p.grad for p in state.model.parameters()])
        state.loss_sum.zero_()
        bufs = _bn_buffers(state.model)
        if guard and bufs:
            state.bn_saved.copy_(torch.cat([b.reshape(-1) for b in bufs]))


def accumulate(state: TrainState, inputs, targets, rng: RandomSource, loss_fn: Callable,
               cdtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, Any]:
    """One train-mode forward and backward with randomness from ``rng``:
    the gradients add into the parameters' ``.grad``, the loss into
    ``state.loss_sum``. Returns (loss, outputs), detached."""
    model = state.model
    model.train()
    set_random_source(model, rng)
    try:
        outputs = _forward(model, inputs, cdtype)
        loss = loss_fn(outputs, targets)
    finally:
        set_random_source(model, None)
    loss.backward()
    loss = loss.detach()
    with torch.no_grad():
        state.loss_sum.add_(loss)
    if isinstance(outputs, (tuple, list)):
        return loss, type(outputs)(o.detach() for o in outputs)
    return loss, outputs.detach()


def reduce_over_ranks(grads: List[torch.Tensor], loss: torch.Tensor,
                      reduction: str = "mean") -> torch.Tensor:
    """Under a mesh with a process group (``parallel/mesh.py``): replace
    each rank's gradients by their global value and return the global loss,
    in one all-reduce of one flat bucket over every rank. A mean-reduced
    loss's global value is the mean over the data ranks, a sum-reduced
    one's the sum. The ranks of a seq group hold the same values, so the
    sum over every rank divides by the seq size too; reducing over every
    rank, not the data group alone, keeps the parameters byte-identical on
    the seq ranks even where a backward kernel is not deterministic.
    Without a process group: ``loss``, nothing moved."""
    mesh = mesh_lib.active_mesh()
    if mesh is None or not mesh.distributed:
        return loss
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0].dtype)])
    flat = comm.all_reduce(flat, "sum") / (mesh.seq if reduction == "sum" else mesh.world)
    parts = flat[:-1].split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [x.view_as(g) for x, g in zip(parts, grads)])
    return flat[-1].to(loss.dtype)


def finish_step(state: TrainState, guard: bool, micro_batches: int = 1,
                reduction: str = "mean") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The update from the gradients summed over ``micro_batches``: their
    mean, and the mean loss, taken over the ranks (:func:`reduce_over_ranks`,
    ``reduction`` the loss's), decide the verdict (:func:`_guarded_update`).
    Returns (mean loss, diag)."""
    with torch.no_grad():
        grads = [p.grad for p in _params(state)]
        if micro_batches > 1:
            torch._foreach_div_(grads, float(micro_batches))
        loss = reduce_over_ranks(grads, state.loss_sum / micro_batches, reduction)
        return loss, _guarded_update(state, grads, loss, guard)


def _guarded_update(state: TrainState, grads: List[torch.Tensor], loss: torch.Tensor,
                    guard: bool) -> Dict[str, torch.Tensor]:
    """Apply the update only where the loss and the global gradient norm
    are finite: otherwise the parameters, the optimizer state, the
    BatchNorm statistics and the count keep their values, so a skipped
    step does not advance the schedule. ``diag``: ``{"applied": bool,
    "grad_norm": fp32}`` device tensors (empty without the guard, where
    every update is applied). The guard judges the raw gradients; the L1
    terms of ``state.l1`` join them after it, as the JAX package chains
    ``l1_sign_decay`` in front of its optimizer."""
    params = _params(state)
    lr = state.schedule.at(state.count)
    grad_norm = global_norm(grads) if guard else None
    for alpha, mask in state.l1:
        optim.l1_sign_decay(state.model.named_parameters(), alpha, mask)
    if not guard:
        optim.apply_update(state.optimizer, params, grads, lr)
        state.count.add_(1)
        return {}
    finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
    optim.apply_update(state.optimizer, params, grads, lr, finite)
    bufs = _bn_buffers(state.model)
    if bufs:
        new = torch.cat([b.reshape(-1) for b in bufs])
        kept = torch.where(finite, new, state.bn_saved)
        torch._foreach_copy_(bufs, [x.view_as(b) for x, b in
                                    zip(kept.split([b.numel() for b in bufs]), bufs)])
    state.count.add_(finite.to(torch.int64))
    return {"applied": finite, "grad_norm": grad_norm}


def make_train_step(
    loss_fn: Callable, guard: bool = True, compute_dtype: Optional[str] = None
) -> Callable:
    """Build ``train_step(state, inputs, targets, rng) -> (loss, outputs,
    diag)``: a train-mode forward with randomness from ``rng`` (a
    :class:`RandomSource`), backward, and the optimizer update at
    ``schedule.at(state.count)``. ``diag`` is ``{"applied": bool tensor,
    "grad_norm": fp32 tensor}`` (module docstring), ``{}`` with
    ``guard=False``; ``loss`` is the raw (possibly non-finite) value.
    ``compute_dtype`` 'bf16' computes the forward and backward in bfloat16
    (module docstring)."""
    cdtype = resolve_dtype(compute_dtype)
    reduction = getattr(loss_fn, "reduction", "mean")

    def train_step(state: TrainState, inputs, targets, rng: RandomSource):
        begin_step(state, guard)
        _, outputs = accumulate(state, inputs, targets, rng, loss_fn, cdtype)
        loss, diag = finish_step(state, guard, reduction=reduction)
        return loss, outputs, diag

    return train_step


def _finite_mean(losses: torch.Tensor, applied: torch.Tensor) -> torch.Tensor:
    """Mean loss over the applied updates of a call; NaN when every one was
    skipped (``seist_tpu/train/step.py::_finite_mean``)."""
    n_ok = applied.sum()
    total = torch.where(applied > 0, losses, 0.0).sum()
    return torch.where(n_ok > 0, total / torch.clamp(n_ok, min=1).to(losses.dtype),
                       torch.full_like(total, float("nan")))


def _index(tree, i: int):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(t, i) for t in tree)
    return tree[i]


def make_multi_train_step(
    loss_fn: Callable,
    steps_per_call: int = 1,
    guard: bool = True,
    compute_dtype: Optional[str] = None,
    step: Optional[Callable] = None,
) -> Callable:
    """Build ``multi_step(state, inputs_k, targets_k, rngs) -> (loss, None,
    diag)``: ``steps_per_call`` updates, one after another, on the k
    batches of ``inputs_k`` / ``targets_k`` (a leading axis of k), update j
    with randomness ``rngs[j]``. k real sequential steps, not gradient
    accumulation. With the guard, ``loss`` is the mean over the applied
    updates (NaN when none was) and ``diag["applied"]`` the ordered (k,)
    int32 mask of applied updates, as the JAX package's scanned step
    returns them. ``step`` is the single step to run k times (the eager
    :func:`make_train_step`, or its captured graph); with k = 1 this is
    that step."""
    base = step or make_train_step(loss_fn, guard=guard, compute_dtype=compute_dtype)
    if steps_per_call <= 1:
        return base

    def multi_step(state: TrainState, inputs_k, targets_k, rngs: Sequence[RandomSource]):
        if len(rngs) != steps_per_call:
            raise ValueError(f"{len(rngs)} random sources for {steps_per_call} updates")
        losses, applied = [], []
        for j in range(steps_per_call):
            loss, _, diag = base(state, _index(inputs_k, j), _index(targets_k, j), rngs[j])
            losses.append(loss)
            if guard:
                applied.append(diag["applied"])
        losses = torch.stack(losses)
        if not guard:
            return losses.mean(), None, {}
        mask = torch.stack(applied).to(torch.int32)
        return _finite_mean(losses, mask), None, {"applied": mask}

    return multi_step


def make_accum_train_step(
    loss_fn: Callable,
    accum_steps: int = 1,
    guard: bool = True,
    compute_dtype: Optional[str] = None,
) -> Callable:
    """Build ``accum_step(state, inputs_k, targets_k, rngs) -> (loss, None,
    diag)``: ONE optimizer update from the mean gradient of ``accum_steps``
    micro-batches (a leading axis of k), micro-batch i with randomness
    ``rngs[i]``; as ``seist_tpu/train/step.py::make_accum_train_step``:

    * the gradient is the mean over the micro-batches, summed in the
      parameters' ``.grad`` as the backward of each adds to it;
    * BatchNorm running statistics chain through the micro-batches;
    * the guard judges the mean loss and the mean gradient, so one NaN
      micro-batch skips the whole update (and restores the statistics);
    * the count advances by one per call, so the schedule sees updates.

    With k = 1 this is :func:`make_train_step`."""
    if accum_steps <= 1:
        return make_train_step(loss_fn, guard=guard, compute_dtype=compute_dtype)
    cdtype = resolve_dtype(compute_dtype)

    def accum_step(state: TrainState, inputs_k, targets_k, rngs: Sequence[RandomSource]):
        if len(rngs) != accum_steps:
            raise ValueError(f"{len(rngs)} random sources for {accum_steps} micro-batches")
        begin_step(state, guard)
        for i in range(accum_steps):
            accumulate(state, _index(inputs_k, i), _index(targets_k, i), rngs[i], loss_fn, cdtype)
        loss, diag = finish_step(state, guard, accum_steps,
                                 getattr(loss_fn, "reduction", "mean"))
        return loss, None, diag

    return accum_step


def make_device_aug_train_step(
    loss_fn: Callable,
    process_rows: Callable,
    guard: bool = True,
    compute_dtype: Optional[str] = None,
    step: Optional[Callable] = None,
) -> Callable:
    """Build the step of ``--device-aug step``: ``step(state, rows, idx,
    aug, epoch, rng) -> (loss, None, diag)``. ``rows`` is a raw-row batch
    (``data/pipeline.RawStore``), ``idx`` the (B,) epoch indices keying the
    augmentation draws, ``aug`` the (B,) augment flags, ``epoch`` a scalar
    int32 tensor; ``process_rows`` (``data/device_aug.make_row_processor``,
    or its captured graph) turns them into (inputs, targets) on the device,
    then the train step ``step`` (:func:`make_train_step`'s, or its captured
    graph) updates with randomness ``rng``. The outputs are not returned:
    the device path has no host metrics targets to score them against."""
    base = step or make_train_step(loss_fn, guard=guard, compute_dtype=compute_dtype)

    def device_aug_step(state: TrainState, rows, idx, aug, epoch, rng: RandomSource):
        inputs, targets = process_rows(rows, idx, aug, epoch)
        loss, _, diag = base(state, inputs, targets, rng)
        return loss, None, diag

    return device_aug_step


def make_cached_train_call(
    loss_fn: Callable,
    process_cache: Callable,
    steps_per_call: int = 1,
    guard: bool = True,
    compute_dtype: Optional[str] = None,
    step: Optional[Callable] = None,
) -> Callable:
    """Build the call of ``--device-aug cached``: ``call(state, cache,
    idx_k, epoch, rngs) -> (loss, None, diag)`` runs ``steps_per_call``
    updates; update j gathers its raw rows from the resident ``cache`` by
    ``idx_k[j]`` and augments them (``process_cache`` =
    ``data/device_aug.make_cache_processor``, or its captured graph), then
    the train step ``step`` updates with randomness ``rngs[j]`` (``rngs``
    one source when k = 1). The loss and ``diag["applied"]`` are those of
    :func:`make_multi_train_step`: the only host-to-device traffic of a
    call is the (k, B) indices and the epoch. Under a process group the
    cache is this data rank's shard and ``idx_k`` is (k, D, B), every data
    rank's indices, from which the processor exchanges the rank's rows
    (``data/device_aug.make_cache_processor``); the step then trains on
    the rank's B rows as any data-parallel step does."""
    base = step or make_train_step(loss_fn, guard=guard, compute_dtype=compute_dtype)

    def call(state: TrainState, cache, idx_k, epoch, rngs):
        def one(st: TrainState, idx, _, rng: RandomSource):
            inputs, targets = process_cache(cache, idx, epoch)
            loss, _, diag = base(st, inputs, targets, rng)
            return loss, None, diag

        if steps_per_call == 1:
            return one(state, idx_k[0], None, rngs)
        multi = make_multi_train_step(loss_fn, steps_per_call, guard=guard, step=one)
        return multi(state, idx_k, idx_k, rngs)

    return call


def make_eval_step(loss_fn: Callable, compute_dtype: Optional[str] = None) -> Callable:
    """Build ``eval_step(state, inputs, targets, mask) -> (loss, outputs)``;
    ``outputs`` are fp32 under any ``compute_dtype``.

    ``mask`` (float, shape (N,)) zeroes padded tail rows: the loss is
    recombined from per-sample losses (the loss of each sample as a batch
    of one) — a mask-weighted mean for mean-reduced losses, a masked sum
    for sum-reduced ones (``loss_fn.reduction == 'sum'``)."""
    sum_reduced = getattr(loss_fn, "reduction", "mean") == "sum"
    cdtype = resolve_dtype(compute_dtype)

    def batch_of_one(tree):
        if isinstance(tree, (tuple, list)):
            return type(tree)(batch_of_one(t) for t in tree)
        return tree[None]

    def one(o1, t1):
        return loss_fn(batch_of_one(o1), batch_of_one(t1))

    per_sample_fn = torch.vmap(one)

    @torch.no_grad()
    def eval_step(state: TrainState, inputs, targets, mask) -> Tuple[torch.Tensor, Any]:
        model = state.model
        model.eval()
        outputs = _forward(model, inputs, cdtype)
        per_sample = per_sample_fn(outputs, targets)
        w = mask.to(per_sample.dtype)
        masked = (per_sample * w).sum()
        loss = masked if sum_reduced else masked / torch.clamp(w.sum(), min=1.0)
        return loss, outputs

    return eval_step


def step_random_source(seed: int, epoch: int, step: int, device,
                       micro: Optional[int] = None) -> RandomSource:
    """The randomness of one train step, a pure function of (seed, epoch,
    step) as the JAX package folds the update count into the epoch key;
    micro-batch ``micro`` of an accumulated update folds its index in too,
    (seed, epoch, step, micro), as the JAX package's ``fold_in(step_rng,
    i)``."""
    entropy = [int(seed), int(epoch), int(step)] + ([] if micro is None else [int(micro)])
    word = np.random.SeedSequence(entropy).generate_state(1)[0]
    return RandomSource.from_seed(int(word), device)


def move_batch(x, device: torch.device):
    """numpy arrays (or tuples of them) -> tensors on ``device``."""
    if isinstance(x, (tuple, list)):
        return tuple(move_batch(t, device) for t in x)
    return torch.as_tensor(x).to(device)
