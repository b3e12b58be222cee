"""K3's own CUDA code, run on the CPU.

``csrc/aug_draws.cu`` is compiled here by g++ against ``tests/_cuda_emu/``,
the CPU stand-in of the CUDA runtime that also runs the bf16 attention
kernels (tests/test_torch_kernel_emulation.py): a block's threads are
std::threads, ``__syncthreads`` a barrier, the kernel's dynamic shared
memory one array the block's threads share (filled with NaN before each
block, so a thread that read the row key before thread 0 wrote it would
draw from a wrong key), and the ``<<<...>>>`` launch a call that runs the
grid block after block. The build passes ``-ffp-contract=off``: each
rounded float operation the kernel spells out (``__fmul_rn``, ``__fadd_rn``,
``__fsub_rn``) stays one rounding, and ``__fmaf_rn`` is ``std::fmaf``.

The outputs are filled with NaN, with NaN guards before and after each, and
held against :func:`threefry.aug_draws_plain` on the CPU: uniforms bit for
bit; normals within 1e-6, because glibc's ``log1pf`` rounds like torch's CPU
``log1p`` only to that limit (as ``tests/test_torch_threefry.py`` allows
against JAX); every output written, nothing written around them. The cases
take the real row (3 x 12000, two tiles' ragged end), rows shorter than one
thread's group, a ragged row whose start is not 16-byte aligned (scalar
stores), an output that starts off alignment, 0, 1, 2 fields, 0, 1, 128
uniform slots, and indices near 2^31 - 1. What this cannot see: timing,
register spills, and whether nvcc accepts the code.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from seist_tpu_torch.ops import _kernels as K
from seist_tpu_torch.ops import threefry as tf

EMU = K.CSRC.parent.parent / "tests" / "_cuda_emu"
_ENTRY = """
namespace { alignas(16) unsigned char smem_k3[232448]; }
unsigned char* emu_smem_base() { return smem_k3; }
#include "aug_draws.cu"
"""
#: Slot tags and positions as draw_all's layout gives them (a tag, then the
#: positions 0..n-1 of its draw).
_SLOTS = [(1, 0), (3, 0), (3, 1), (11, 0), (11, 1), (17, 2), (23, 0)]
_GUARD = 8


@pytest.fixture(scope="module")
def k3(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    out = tmp_path_factory.mktemp("k3_emu")
    src = (K.CSRC / "aug_draws.cu").read_text()
    (out / "aug_draws.cu").write_text(
        re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src, flags=re.S))
    (out / "k3.cpp").write_text(_ENTRY)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread", "-I",
         str(out), "-I", str(EMU), "-o", str(out / "libk3.so"), str(out / "k3.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, proc.stdout[-4000:]
    lib = ctypes.CDLL(str(out / "libk3.so"))
    lib.aug_draws.argtypes = K._ARGTYPES["aug_draws"]
    lib.aug_draws.restype = ctypes.c_int
    return lib


def test_k3_launch_geometry(k3):
    """The grid the source computes: the uniform blocks first, then whole
    float4 groups of one row a block, and at the train step's b64 (30 slots,
    two fields of 3 x 12000) some 2,300 blocks, over 17 for each of the
    card's 132 SMs."""
    g = K.aug_draws_shape(k3, 64, 30, 2, 36000)
    assert g["per_thread"] == 4 and g["tile"] % (g["threads"] * g["per_thread"]) == 0
    assert g["slot_blocks"] == -(-64 * 30 // g["threads"])
    assert g["blocks"] == g["slot_blocks"] + 64 * 2 * -(-36000 // g["tile"])
    assert g["blocks"] >= 17 * 132
    assert K.aug_draws_shape(k3, 3, 0, 2, 0) == dict(g, blocks=0, slot_blocks=0)


def _guarded(n: int, offset: int) -> torch.Tensor:
    """A NaN buffer with ``_GUARD + offset`` floats before n and ``_GUARD``
    after them."""
    return torch.full((n + 2 * _GUARD + offset,), float("nan"))


def _launch(lib, seed, epoch, idx, slots, tags, field_len, offset):
    b = idx.shape[0]
    ubuf, fbuf = _guarded(b * len(slots), 0), _guarded(b * len(tags) * field_len, offset)
    u = ubuf[_GUARD:_GUARD + b * len(slots)].view(b, len(slots))
    start = _GUARD + offset
    f = fbuf[start:start + b * len(tags) * field_len].view(b, len(tags), field_len)
    n = len(slots)
    st = (ctypes.c_int * max(n, 1))(*[t for t, _ in slots])
    sp = (ctypes.c_int * max(n, 1))(*[p for _, p in slots])
    ftags = list(tags) + [0] * (2 - len(tags))
    assert lib.aug_draws(seed, epoch.data_ptr(), idx.data_ptr(), b,
                         ctypes.cast(st, ctypes.c_void_p), ctypes.cast(sp, ctypes.c_void_p), n,
                         ftags[0], ftags[1], len(tags), field_len, u.data_ptr(), f.data_ptr(),
                         None) == 0
    guards = [ubuf[:_GUARD], ubuf[_GUARD + u.numel():], fbuf[:start], fbuf[start + f.numel():]]
    return u, f, guards


@pytest.mark.parametrize("b,field_len,tags,n_slots,offset", [
    (1, 36000, [2, 18], 7, 0),     # the real row: 3 x 12000, 18 tiles, a ragged last one
    (3, 7, [2, 18], 7, 0),         # rows shorter than two float4 groups, misaligned from row 1
    (8, 1, [2, 18], 1, 0),         # one output a row
    (2, 36001, [2, 18], 0, 0),     # ragged and misaligned from row 1: scalar stores; no slots
    (3, 4099, [5], 128, 0),        # one field, ragged tail, every slot of the table
    (3, 4096, [2, 18], 1, 1),      # an output that starts 4 bytes off alignment
    (8, 0, [2, 18], 128, 0),       # empty fields: uniform blocks only
    (3, 300, [], 7, 0),            # no fields
    (2, 300, [], 0, 0),            # nothing to draw: no launch
])
def test_k3_source_matches_plain_on_the_cpu(k3, b, field_len, tags, n_slots, offset):
    seed, epoch = 5, torch.tensor(7, dtype=torch.int32)
    idx = torch.arange(b, dtype=torch.int32) * 977 + 2**31 - 1 - 977 * b
    slots = _SLOTS[:n_slots] if n_slots <= len(_SLOTS) else [
        (t * 7 + 1, p) for t in range(32) for p in range(4)][:n_slots]
    u, f, guards = _launch(k3, seed, epoch, idx, slots, tags, field_len, offset)
    want_u, want_f = tf.aug_draws_plain(seed, epoch, idx, slots, tags, field_len)
    assert not bool(torch.isnan(u).any()) and not bool(torch.isnan(f).any())
    assert all(bool(torch.isnan(g).all()) for g in guards), "K3 wrote outside its outputs"
    assert torch.equal(u, want_u)
    torch.testing.assert_close(f, want_f, rtol=0, atol=1e-6)
