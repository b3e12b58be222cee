"""Optimizers (counterpart of ``seist_tpu/train/optim.py``).

The JAX package builds optax chains; the port keeps each optimizer's
state in a ``torch.optim`` object (so ``state_<step>.pt`` holds its
``state_dict``, as before) and applies the update itself with
``torch._foreach_*`` operations (:func:`apply_update`), device-agnostic and
free of host reads, so that a step captured as a CUDA graph can run it
and can skip it. The rules are optax's:

* Adam: ``weight_decay`` is L2 added to the gradient (optax
  ``add_decayed_weights`` before ``adam``); moments ``m += (1 - b1)(g - m)``
  and ``v += (1 - b2)(g^2 - v)``; update ``(m / bc1) / (sqrt(v / bc2) +
  eps)`` with ``bc = 1 - b^t`` at the update's count ``t``;
* AdamW: decoupled decay ``p -= lr * wd * p`` beside the Adam update;
* SGD: heavy-ball momentum ``buf = momentum * buf + g`` on the
  L2-decayed gradient (optax ``trace``, which starts from zero).

The learning rate is a tensor on the parameters' device
(``Schedule.at``). With ``applied`` (the guard's verdict, a bool tensor),
a False verdict leaves the parameters, the moments and the step counters
with the values they had: the gradients are first replaced by zeros
(a ``where`` over their flat concatenation, since a NaN times 0 is NaN),
and every change is scaled by ``applied``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch


def l1_sign_decay(
    named_params: Iterable, alpha: float, mask: Optional[Callable[[str], bool]] = None
) -> None:
    """L1 regularization in gradient space: ``g += alpha * sign(w)`` on the
    parameters ``mask(name)`` selects (all when None). Call between
    ``backward()`` and the optimizer step, as the JAX package chains
    ``l1_sign_decay`` before its optimizer."""
    with torch.no_grad():
        for name, p in named_params:
            if p.grad is None or (mask is not None and not mask(name)):
                continue
            p.grad.add_(torch.sign(p), alpha=alpha)


def build_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    weight_decay: float = 0.0,
    momentum: float = 0.9,
) -> torch.optim.Optimizer:
    """Adam / AdamW / SGD by name (case-insensitive): the ``torch.optim``
    object that holds the hyperparameters and the state that
    :func:`apply_update` updates (its own ``step()`` is not called)."""
    name = name.lower()
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               weight_decay=weight_decay)
    raise NotImplementedError(f"Unsupported optimizer: '{name}' (adam/adamw/sgd)")


def _is_adam(opt: torch.optim.Optimizer) -> bool:
    return isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))


def _group(opt: torch.optim.Optimizer) -> dict:
    if len(opt.param_groups) != 1:
        raise ValueError("the port's optimizers hold one parameter group")
    return opt.param_groups[0]


def prepare_state(opt: torch.optim.Optimizer) -> None:
    """Create every state tensor on its parameter's device (torch creates
    them at the first ``step()``; a captured update needs them before):
    Adam's ``step`` (fp32, as torch keeps it), ``exp_avg`` and
    ``exp_avg_sq``; SGD's ``momentum_buffer`` when momentum > 0. A state
    loaded from a checkpoint keeps its values and moves to the device."""
    group = _group(opt)
    for p in group["params"]:
        st = opt.state[p]
        if _is_adam(opt):
            step = st.get("step")
            if step is None:
                st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            elif not torch.is_tensor(step) or step.device != p.device:
                st["step"] = torch.as_tensor(step, dtype=torch.float32).to(p.device)
            for key in ("exp_avg", "exp_avg_sq"):
                if key not in st:
                    st[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
        elif group["momentum"] and st.get("momentum_buffer") is None:
            st["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def state_tensors(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every state tensor, in parameter order (after :func:`prepare_state`)."""
    return [t for p in _group(opt)["params"] for t in opt.state[p].values()
            if torch.is_tensor(t)]


def load_state(opt: torch.optim.Optimizer, state_dict: Dict) -> None:
    """``opt.load_state_dict`` that writes into the state tensors that
    exist, in place: a captured update keeps reading the same memory."""
    group = _group(opt)
    live = {id(p): dict(opt.state[p]) for p in group["params"] if p in opt.state}
    opt.load_state_dict(state_dict)
    for p in _group(opt)["params"]:
        old = live.get(id(p), {})
        st = opt.state[p]
        for key, value in list(st.items()):
            mine = old.get(key)
            if torch.is_tensor(value) and torch.is_tensor(mine) and mine.shape == value.shape:
                mine.copy_(value)
                st[key] = mine
    prepare_state(opt)


def _sanitize(grads: List[torch.Tensor], applied: torch.Tensor) -> List[torch.Tensor]:
    """The gradients where ``applied``, zeros where not: one ``where`` over
    their flat concatenation, returned as views shaped like ``grads``."""
    flat = torch.where(applied, torch.cat([g.reshape(-1) for g in grads]), 0.0)
    return [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)]


def apply_update(
    opt: torch.optim.Optimizer,
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    lr: torch.Tensor,
    applied: Optional[torch.Tensor] = None,
) -> None:
    """One optimizer update of ``params`` (the group's parameters, in its
    order) from ``grads`` at learning rate ``lr`` (an fp32 scalar tensor),
    with optax's rules (module docstring). ``applied`` None applies it;
    a bool scalar tensor applies it where True and leaves every parameter,
    moment and step counter as it was where False."""
    prepare_state(opt)
    group = _group(opt)
    if len(params) != len(group["params"]):
        raise ValueError("apply_update takes every parameter of the optimizer")
    with torch.no_grad():
        if applied is None:
            f = torch.ones((), dtype=torch.float32, device=lr.device)
        else:
            f = applied.to(torch.float32)
            grads = _sanitize(grads, applied)
        neg_lr = -lr * f  # 0 (exactly) when skipped
        wd = float(group["weight_decay"])
        adamw = isinstance(opt, torch.optim.AdamW)
        if wd and not adamw:  # L2 on the gradient
            grads = torch._foreach_add(grads, params, alpha=wd)
        states = [opt.state[p] for p in group["params"]]
        if _is_adam(opt):
            b1, b2 = group["betas"]
            eps = float(group["eps"])
            steps = [st["step"] for st in states]
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            t = steps[0] + 1.0  # this update's count, were it applied
            inv_bc2 = 1.0 / (1.0 - torch.pow(b2, t))
            scale = neg_lr / (1.0 - torch.pow(b1, t))
            d = torch._foreach_sub(grads, m)
            torch._foreach_mul_(d, (1.0 - b1) * f)
            torch._foreach_add_(m, d)
            d = torch._foreach_mul(grads, grads)
            torch._foreach_sub_(d, v)
            torch._foreach_mul_(d, (1.0 - b2) * f)
            torch._foreach_add_(v, d)
            den = torch._foreach_mul(v, inv_bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(m, den)
            torch._foreach_mul_(upd, scale)
            if wd and adamw:  # decoupled decay, from the parameters before the update
                torch._foreach_add_(upd, torch._foreach_mul(params, neg_lr * wd))
            torch._foreach_add_(params, upd)
            # A list of 0-dim tensors: the overload with one tensor reads it
            # back to the host, which a captured step must not.
            torch._foreach_add_(steps, [f] * len(steps))
        else:
            mom = float(group["momentum"])
            if mom:
                bufs = [st["momentum_buffer"] for st in states]
                d = torch._foreach_mul(bufs, mom - 1.0)  # new - old = (mom - 1) buf + g
                torch._foreach_add_(d, grads)
                torch._foreach_mul_(d, f)
                torch._foreach_add_(bufs, d)
                grads = bufs
            torch._foreach_add_(params, torch._foreach_mul(grads, neg_lr))
