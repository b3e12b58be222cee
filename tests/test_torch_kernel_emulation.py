"""The bf16 attention kernels' own CUDA code, run on the CPU.

``csrc/pooled_attention_fwd_bf16.cuh`` and ``csrc/pooled_attention_bwd_bf16.cuh``
are compiled here by g++ against ``tests/_cuda_emu/``, a CPU stand-in of the
CUDA runtime: a block's threads are std::threads, ``__syncthreads`` a
barrier, and the warp collectives the kernels use (shuffles, ldmatrix with
and without .trans, mma.sync m16n8k16 and m16n8k8 in bf16) are computed
from the fragment layouts of the PTX ISA, exchanged between the lanes of a
warp. Shared memory is filled with NaN before each block, so a read of a
word the kernel did not write shows in the outputs; each ldmatrix and
cp.async address is checked for 16-byte alignment and bounds. The
functions written in inline PTX (``cp_async16``, the ``ldsm_*`` and
``mma_k*`` helpers, ``exp2_approx``) are renamed in a copy of the sources and
replaced by their emulation; ``<<<...>>>`` launches become calls that run
the grid block after block. What this cannot see: timing and races between
copies in flight (a cp.async lands at once here), register spills, and
whether nvcc accepts the code.

The kernels' outputs are held against the plain versions on the same bf16
inputs, at the card's limits (tests/test_torch_cuda.py): the forward 2^-6
absolute and its lse 1e-5, each gradient 2^-7 * max(1, max |plain|). The
cases take the vector and the scalar staging (E = 20, a misaligned pointer),
several key tiles (K1's double buffer, K2's dQ parts), rows split (K2's dK
and dV parts), E from 8 to 64, and dropout 0 and 0.3, whose zeros must fall
where the plain version's do.

Those limits are one bf16 rounding wide, so they cannot tell whether P, Pd
and dS enter their products split into a bf16 hi and lo part or rounded
once. So the outputs are also held, element by element, against the torch
emulation of the split arithmetic (tests/test_torch_attention_bf16.py):
each within one bf16 ulp, and at most 1% of them one ulp apart (a rounding
that fp32 sums in another order flip). The same emulation with P, Pd and dS
rounded once is shown to fail that bound, as a kernel that left out its lo
products would. The launch plan's view of K2 bf16 (its row tile and blocks
an SM) is read from the compiled sources through their C query.
"""

from __future__ import annotations

import ctypes
import math
import re
import shutil
import subprocess

import pytest
import torch

from seist_tpu_torch.ops import _kernels as K
from seist_tpu_torch.ops import pooled_attention as tpa
from tests.test_torch_attention_bf16 import emulate_bwd, emulate_fwd

EMU = K.CSRC.parent.parent / "tests" / "_cuda_emu"
SOURCES = ("attention_common.cuh", "attention_bf16.cuh", "pooled_attention_fwd_bf16.cuh",
           "pooled_attention_bwd_bf16.cuh")
#: The functions written in PTX, replaced by tests/_cuda_emu/emu_ops.h.
PTX_FUNCTIONS = ("cp_async16", "cp_async_commit", "cp_async_wait", "ldsm_x4", "ldsm_x4_t",
                 "ldsm_x2", "ldsm_x2_t", "mma_k16", "mma_k8", "exp2_approx")

_ENTRY = {
    "fwd": """
#include "attention_common.cuh"
namespace seist { namespace { alignas(16) unsigned char smem_fwd_bf16[232448]; } }
unsigned char* emu_smem_base() { return seist::smem_fwd_bf16; }
#include "pooled_attention_fwd_bf16.cuh"
extern "C" int emu_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int n,
                       int l, int m, int heads, int e, int row_warps, int ksplit, float scale,
                       float rate, float out_scale, unsigned lm, const void* seed) {
  return seist::launch_fwd<seist::FwdBf16>(q, k, v, o, (float*)lse, n, l, m, heads, e,
                                           row_warps, ksplit, scale, rate, out_scale, lm,
                                           (const int*)seed, nullptr);
}
""",
    "bwd": """
#include "attention_common.cuh"
namespace seist { namespace { alignas(16) unsigned char smem_bwd_bf16[232448]; } }
unsigned char* emu_smem_base() { return seist::smem_bwd_bf16; }
#include "pooled_attention_bwd_bf16.cuh"
extern "C" int emu_bwd(const void* q, const void* k, const void* v, const void* g,
                       const void* o, const void* lse, void* dq, void* dk, void* dv,
                       void* dq_part, void* dk_part, void* dv_part, int n, int l, int m,
                       int heads, int e, int splits, int rows_per_split, float scale,
                       float rate, float out_scale, unsigned lm, const void* seed) {
  return seist::launch_bwd<seist::BwdBf16>(q, k, v, g, o, (const float*)lse, dq, dk, dv,
                                           (float*)dq_part, (float*)dk_part, (float*)dv_part,
                                           n, l, m, heads, e, splits, rows_per_split, scale,
                                           rate, out_scale, lm, (const int*)seed, nullptr);
}
extern "C" int pooled_attention_bwd_bf16_shape(int e, int* row_tile, int* blocks_per_sm) {
  return seist::bwd_bf16_shape(e, row_tile, blocks_per_sm);
}
""",
}


def _rewrite(text: str) -> str:
    for fn in PTX_FUNCTIONS:
        text = re.sub(r"(__device__ __forceinline__ \w+ )" + fn + r"\(", r"\1ptx_" + fn + "(", text)
    return re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text, flags=re.S)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    for name in SOURCES:
        (out / name).write_text(_rewrite((K.CSRC / name).read_text()))
    common = (out / "attention_common.cuh").read_text()
    include = "#include <cuda_runtime.h>\n"
    (out / "attention_common.cuh").write_text(
        common.replace(include, include + '#include "emu_ops.h"\n', 1))
    procs = {}
    for name, code in _ENTRY.items():
        (out / f"{name}.cpp").write_text(code)
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(out), "-I",
             str(EMU), "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    loaded = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log[-4000:]
        loaded[f"{name}_lib"] = ctypes.CDLL(str(out / f"lib{name}.so"))
        loaded[name] = getattr(loaded[f"{name}_lib"], f"emu_{name}")
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    loaded["fwd"].argtypes = [P] * 5 + [I] * 7 + [F] * 3 + [U, P]
    loaded["bwd"].argtypes = [P] * 12 + [I] * 7 + [F] * 3 + [U, P]
    return loaded


def _inputs(n, l, m, h, e, seed, offset):
    gen = torch.Generator().manual_seed(seed)

    def one(*shape):
        x = torch.randn(*shape, generator=gen).to(torch.bfloat16)
        buf = torch.empty(x.numel() + offset, dtype=torch.bfloat16)
        buf[offset:] = x.reshape(-1)
        return buf[offset:].view(x.shape)  # offset 1: not 16-byte aligned

    return one(n, l, h, e), one(n, m, h, e), one(n, m, h, e), one(n, l, h, e)


def _out_scale(rate):
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,l,m,h,e,offset,sms", [
    (2, 64, 8, 1, 8, 0, 132),       # M under one chunk, rows split
    (1, 300, 200, 2, 16, 0, 132),   # two key tiles: K1's double buffer, K2's dQ parts
    (1, 128, 128, 3, 32, 0, 132),   # seist_l_dpk's E = 32 launch, K1's key halves
    (2, 256, 128, 3, 16, 0, 4),     # four-warp K1 blocks, K2 rows unsplit (few SMs)
    (1, 50, 20, 2, 20, 0, 132),     # E = 20: scalar staging
    (1, 100, 130, 1, 24, 1, 132),   # misaligned pointers: scalar staging
    (1, 40, 30, 1, 64, 0, 132),     # E = 64
])
def test_the_bf16_kernels_match_the_plain_versions(libs, n, l, m, h, e, offset, sms, rate):
    q, k, v, g = _inputs(n, l, m, h, e, l + m + e, offset)
    scale, seed = 1.0 / math.sqrt(e), 1234
    o, lse = _fwd(libs, q, k, v, scale, rate, seed, sms)
    want_o, want_lse = tpa.pooled_attention_plain(q, k, v, scale, rate, seed, return_lse=True)
    assert float((o.float() - want_o.float()).abs().max()) <= 2.0 ** -6
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)

    grads = _bwd(libs, q, k, v, g, o, lse, scale, rate, seed, sms)
    want = tpa.pooled_attention_bwd_plain(q, k, v, g, o, lse, scale, rate, seed)
    for a, b in zip(grads, want):
        limit = 2.0 ** -7 * max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) <= limit


def test_the_bf16_kernels_drop_the_plain_versions_elements(libs):
    """V the identity (M = E): K1 writes the dropped probabilities; g the
    identity (L = E): K2's dV is their transpose. Zeros where the plain
    version's are, at rate 0.3."""
    n, l, m, h, e, rate, seed = 1, 32, 32, 2, 32, 0.3, 77
    gen = torch.Generator().manual_seed(3)
    q, k = (torch.randn(n, s, h, e, generator=gen).to(torch.bfloat16) for s in (l, m))
    eye = torch.eye(32, dtype=torch.bfloat16).reshape(1, 32, 1, 32).expand(n, 32, h, 32)
    eye = eye.contiguous()
    scale = 1.0 / math.sqrt(e)
    o, lse = _fwd(libs, q, k, eye, scale, rate, seed)
    want = tpa.pooled_attention_plain(q, k, eye, scale, rate, seed)
    assert torch.equal(o == 0, want == 0) and 0.2 < float((want == 0).float().mean()) < 0.4
    _, _, dv = _bwd(libs, q, k, eye, eye, o, lse, scale, rate, seed)
    assert torch.equal(dv.permute(0, 2, 3, 1) == 0, want.permute(0, 2, 1, 3) == 0)


def _fwd(libs, q, k, v, scale, rate, seed, sms=132):
    n, l, h, e = q.shape
    m = k.shape[1]
    o, lse = torch.empty_like(q), torch.empty(n, h, l)
    assert libs["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                       n, l, m, h, e, *K.fwd_plan(n, l, m, h, sms), scale, rate,
                       _out_scale(rate), (l * m) & 0xFFFFFFFF,
                       torch.tensor([seed], dtype=torch.int32).data_ptr()) == 0
    return o, lse


def _bwd(libs, q, k, v, g, o, lse, scale, rate, seed, sms=132):
    n, l, h, e = q.shape
    m = k.shape[1]
    splits, rows = K.bwd_plan(n, l, m, h, sms, K.bwd_cost(libs["bwd_lib"], q.dtype, e))
    dq_n, dkv_n = K.bwd_scratch(n, l, m, h, e, splits)
    parts = [torch.empty(max(c, 1)) for c in (dq_n, dkv_n, dkv_n)]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    assert libs["bwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       *(p.data_ptr() for p in parts), n, l, m, h, e, splits, rows, scale,
                       rate, _out_scale(rate), (l * m) & 0xFFFFFFFF,
                       torch.tensor([seed], dtype=torch.int32).data_ptr()) == 0
    return dq, dk, dv


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ulps between a and b, element by element; 0 where they are
    within 2^-20 * max |b| (below what fp32 sums in another order move)."""
    def order(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))

    close = (a.float() - b.float()).abs() <= 2.0 ** -20 * float(b.float().abs().max())
    return torch.where(close, 0, (order(a) - order(b)).abs())


def _within_one_ulp(a, b) -> bool:
    d = _ulps(a, b)
    return int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01


@pytest.mark.parametrize("n,l,m,h,e,rate", [
    (1, 512, 128, 3, 8, 0.3),    # seist_l_dpk's E = 8 shape
    (1, 256, 128, 3, 16, 0.3),   # its E = 16 shape: 64-row tiles
    (1, 128, 128, 3, 32, 0.0),   # its E = 32 shape
    (1, 300, 200, 2, 16, 0.3),   # two key tiles: K1's double buffer, K2's dQ parts
])
def test_the_bf16_kernels_keep_the_split_precision(libs, n, l, m, h, e, rate):
    q, k, v, g = _inputs(n, l, m, h, e, l + m + e, 0)
    scale, seed = 1.0 / math.sqrt(e), 1234
    o, lse = _fwd(libs, q, k, v, scale, rate, seed)
    split, once = (emulate_fwd(q, k, v, scale, rate, seed, s)[0] for s in (True, False))
    assert _within_one_ulp(o, split)
    assert not _within_one_ulp(once, split) and not _within_one_ulp(o, once)
    grads = _bwd(libs, q, k, v, g, o, lse, scale, rate, seed)
    split, once = (emulate_bwd(q, k, v, g, o, lse, scale, rate, seed, s) for s in (True, False))
    for got, want, control in zip(grads, split, once):
        assert _within_one_ulp(got, want)
        assert not _within_one_ulp(control, want) and not _within_one_ulp(got, control)


#: The bf16 K2's plans at the b64 train step's (L, E) = (1024, 8), (512, 8),
#: (256, 16), (128, 32) on 132 SMs: the fastest of every split count in a
#: sweep on an H100 (the planner's cost model is fitted to it).
PLANS_BF16 = [(2, 512), (2, 256), (1, 256), (1, 128)]


def test_bwd_plan_of_the_bf16_kernel(libs):
    """With the kernel's own row tile and blocks an SM (three at E = 8, two
    for E <= 32; 64-row tiles at E = 16), read through its C query, the plan
    takes the sweep's fastest split counts at the b64 train step's shapes,
    and covers the rows in whole tiles at any head width."""
    lib = libs["bwd_lib"]
    assert [K.bwd_plan(64, l, 128, 3, 132, K.bwd_cost(lib, torch.bfloat16, e)) for l, e in
            ((1024, 8), (512, 8), (256, 16), (128, 32))] == PLANS_BF16
    for e in range(1, tpa.E_MAX + 1):
        cost = K.bwd_cost(lib, torch.bfloat16, e)
        assert cost.row_tile % K.BWD_ROW_TILE == 0 and cost.slots_per_sm >= 1, e
        for n, l, m, h in ((2, 1000, 125, 3), (1, 200, 200, 2), (1, 1, 1, 1)):
            splits, rows = K.bwd_plan(n, l, m, h, 132, cost)
            assert rows % cost.row_tile == 0 and splits * rows >= l > (splits - 1) * rows
    with pytest.raises(ValueError):
        K.bwd_cost(lib, torch.bfloat16, tpa.E_MAX + 1)
