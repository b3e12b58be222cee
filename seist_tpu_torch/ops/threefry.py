"""JAX's threefry random draws on torch tensors, and the augmentation draw
kernel K3 that computes them on the card.

The device augmentation (``data/device_aug.py``) keys every sample's
randomness as the JAX package does (``seist_tpu/data/device_aug.py:14-28``)::

    key = fold_in(fold_in(PRNGKey(seed), epoch), idx)

and takes each decision from a named subkey ``fold_in(key, tag)``. This
module reproduces ``jax.random`` under ``jax_threefry_partitionable =
True`` (the default of the JAX releases the package runs):

* ``PRNGKey(seed)`` is the pair ``(0, seed)``; ``fold_in(key, d)`` is
  ``threefry2x32(key, (0, d))``;
* the bits of a draw of n values are ``y0 ^ y1`` of ``threefry2x32(key,
  (hi(i), lo(i)))`` over the flat index i (hi is 0 below 2^32);
* a uniform on [0, 1) is ``bitcast((bits >> 9) | 0x3F800000) - 1``;
* a normal is ``sqrt(2) * erfinv(u)`` with u uniform on (nextafter(-1, 0),
  1), computed as ``f * 2 + lo`` in float32, and erfinv XLA's float32
  polynomial (M. Giles, "Approximating the erfinv function", with
  ``w = -log1p(-x*x)`` switched at 5, its Horner steps fused multiply-adds),
  not ``torch.erfinv``, which differs by up to 2e-5.

Keys and uniforms equal JAX's bit for bit; about 1% of normals differ from
XLA's by the rounding of ``log1p`` (at most a few 1e-7).

The plain version keeps uint32 values in int64 tensors, masked to 32 bits
after every add and shift. :func:`aug_draws` computes every named draw of
a batch in one call: its plain version on CPU tensors, on CUDA tensors the
hand-written kernel ``csrc/aug_draws.cu`` (K3, built by
``ops/_kernels.py``), or an exception. K3 replaces no TPU kernel: the JAX
package leaves these draws to XLA. It takes the epoch and the sample
indices as device tensors, so a captured CUDA graph draws anew for the
indices written into them before each replay. Its one launch does one
threefry block per output: a field block folds its (sample, field) row's
key once and shares it, and each thread draws four consecutive normals at
a time into one float4 (the source's note says why that is the floor).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from seist_tpu_torch.ops import launch_counts

#: Launches of K3 since import (or since a caller reset it), incremented in
#: :func:`aug_draws` right where it launches.
launches = 0

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
#: Slots of the uniform table the kernel takes by value (csrc/aug_draws.cu).
MAX_SLOTS = 128

# XLA's float32 erfinv coefficients (xla/client/lib/math.cc, ErfInv32).
_W_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                   1.50140941], np.float32)
_W_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                   0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                   2.83297682], np.float32)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block of ``jax._src.prng`` on int64
    tensors holding uint32 values (keys broadcast against the counts)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the int64 pair (0, seed)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or an integer tensor
    broadcasting against key[..., 0] (taken as uint32)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def sample_keys(seed: int, epoch, idx: torch.Tensor) -> torch.Tensor:
    """(B, 2) keys ``fold_in(fold_in(PRNGKey(seed), epoch), idx[b])``;
    ``epoch`` an int or a scalar tensor."""
    key = fold_in(prng_key(seed, idx.device), torch.as_tensor(epoch, device=idx.device).reshape(()))
    return fold_in(key.expand(idx.shape[0], 2), idx)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) 32-bit draws of key (..., 2): ``y0 ^ y1`` over the counts
    (0, i), JAX's partitionable layout for n < 2^32."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(counts), counts)
    return y0 ^ y1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Floats on [1, 2) from the top 23 bits, minus one: [0, 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 ``jax.random.uniform(key, (n,))`` on [0, 1)."""
    return _unit_floats(random_bits(key, n))


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv (module docstring)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    # The root in float64, rounded once: the float32 root correctly rounded.
    # torch's first float32 sqrt of a process on the CPU (2.13, 8 threads)
    # returned one thread's share of the elements a few 1e-4 off in some
    # fresh processes.
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    lo, hi = torch.from_numpy(_W_LT5).to(x.device), torch.from_numpy(_W_GE5).to(x.device)
    p = torch.where(lt, lo[0], hi[0])
    w64 = w.double()
    for i in range(1, len(_W_LT5)):
        # A fused multiply-add, as XLA's CPU code and K3 evaluate it: the
        # float32 product is exact in float64, so one rounding remains.
        p = (torch.where(lt, lo[i], hi[i]).double() + p.double() * w64).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 ``jax.random.normal(key, (n,))``."""
    u = _unit_floats(random_bits(key, n)) * 2.0 + _NORMAL_LO
    u = torch.clamp(u, min=_NORMAL_LO)
    return erfinv_xla(u) * _SQRT2


# ------------------------------------------------------------------ K3
def aug_draws_plain(
    seed: int,
    epoch: torch.Tensor,
    idx: torch.Tensor,
    slots: Sequence[Tuple[int, int]],
    field_tags: Sequence[int],
    field_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every named draw of a batch: ``uniforms`` (B, S) float32, slot s the
    ``slots[s] = (tag, pos)`` element of ``uniform(fold_in(key_b, tag))``;
    ``fields`` (B, F, field_len) float32, field f
    ``normal(fold_in(key_b, field_tags[f]), field_len)``. ``key_b`` is
    sample b's key (:func:`sample_keys`) from the scalar ``epoch`` and the
    (B,) ``idx``, both int32 tensors."""
    keys = sample_keys(seed, epoch, idx)
    b = idx.shape[0]
    uniforms = torch.empty(b, len(slots), dtype=torch.float32, device=idx.device)
    for s, (tag, pos) in enumerate(slots):
        uniforms[:, s] = uniform(fold_in(keys, tag), pos + 1)[:, pos]
    fields = torch.empty(b, len(field_tags), field_len, dtype=torch.float32, device=idx.device)
    for f, tag in enumerate(field_tags):
        fields[:, f] = normal(fold_in(keys, tag), field_len)
    return uniforms, fields


def aug_draws(
    seed: int,
    epoch: torch.Tensor,
    idx: torch.Tensor,
    slots: Sequence[Tuple[int, int]],
    field_tags: Sequence[int],
    field_len: int,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`aug_draws_plain`'s function: its plain version on CPU tensors,
    K3 on CUDA tensors: one launch for the whole batch, whose first blocks
    draw the uniforms (a thread per sample and slot) and whose others each
    cover a tile of one (sample, field) row under the row's key, folded
    once a block. ``out`` receives the draws when given."""
    if idx.device.type == "cpu":
        got = aug_draws_plain(seed, epoch, idx, slots, field_tags, field_len)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return out
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous (B,) int32 tensor, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if epoch.dtype != torch.int32 or epoch.numel() != 1 or epoch.device != idx.device:
        raise ValueError(f"epoch must be one int32 on {idx.device}, got {epoch.dtype} "
                         f"{tuple(epoch.shape)} on {epoch.device}")
    if len(slots) > MAX_SLOTS or len(field_tags) > 2:
        raise ValueError(f"K3 takes at most {MAX_SLOTS} uniform slots and 2 fields, got "
                         f"{len(slots)} and {len(field_tags)}")
    b = idx.shape[0]
    if out is None:
        out = (torch.empty(b, len(slots), dtype=torch.float32, device=idx.device),
               torch.empty(b, len(field_tags), field_len, dtype=torch.float32,
                           device=idx.device))
    for o, shape in zip(out, ((b, len(slots)), (b, len(field_tags), field_len))):
        if (tuple(o.shape) != shape or o.dtype != torch.float32 or o.device != idx.device
                or not o.is_contiguous()):
            raise ValueError(f"an output must be contiguous float32 {shape} on {idx.device}")
    from seist_tpu_torch.ops import _kernels

    _kernels.aug_draws(seed, epoch, idx, slots, field_tags, field_len, *out)
    launch_counts.bump(__name__, idx.device, "launches")
    return out
