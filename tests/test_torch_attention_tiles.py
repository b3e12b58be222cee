"""The redesigned attention kernels' host side, on the CPU.

* The launch planner of ``ops/_kernels.py``: K1's block shape and K2's row
  splits from a given SM count, the scratch sizes, and the tile constants
  it shares with ``csrc/attention_common.cuh`` (read from both files); the
  bf16 kernels' shared-memory row strides, their head-width dispatch and
  their seed mix, read from their sources.
* K1's row statistics: the plain forward's lse against the logsumexp of
  the JAX package's scores, atol 1e-6 (fp32, the same formula).
* K2's function from the forward's (o, lse): the plain version against
  ``jax.vjp`` of the Pallas kernel (interpret mode) within 1e-5 at H 1 and
  3, M = L and L/8, dropout 0 and 0.3 and a ragged L; this pins
  D = rowsum(g o) = rowsum(dP P) under dropout against the reference.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seist_tpu.ops import pallas_attention as jpa

from seist_tpu_torch.ops import _kernels as K
from seist_tpu_torch.ops import pooled_attention as tpa


#: The sources of the four attention kernels: K1 and K2 in fp32 (with the
#: C entry points) and in bf16.
KERNEL_SOURCES = ("pooled_attention_fwd.cu", "pooled_attention_bwd.cu",
                  "pooled_attention_fwd_bf16.cuh", "pooled_attention_bwd_bf16.cuh")


def _cuh_constants() -> dict:
    text = (K.CSRC / "attention_common.cuh").read_text()
    return {name: int(value) for name, value in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_python_tiles_equal_the_kernels():
    c = _cuh_constants()
    assert (c["kKeyTile"], c["kWarpRows"], c["kFwdChunk"], c["kBwdRowTile"]) == (
        K.KEY_TILE, K.WARP_ROWS, K.FWD_CHUNK, K.BWD_ROW_TILE)
    # One dispatch of head widths, up to E_MAX, which all four kernels (fp32
    # and bf16, forward and backward) take through their launchers.
    common = (K.CSRC / "attention_common.cuh").read_text()
    widths = [int(x) for x in re.findall(r"if \(e <= (\d+)\) return f\(", common)]
    assert max(widths) == tpa.E_MAX and widths == sorted(widths)
    assert "with_padded_width(e, " in common.split("cudaError_t launch_fwd(")[1]
    assert "with_padded_width(e, " in common.split("cudaError_t launch_bwd(")[1]
    entries = "".join((K.CSRC / f"pooled_attention_{d}.cu").read_text() for d in ("fwd", "bwd"))
    for traits, name in (("FwdF32", "fwd_kernel<EP>"), ("FwdBf16", "fwd_kernel_bf16<EP>"),
                         ("BwdF32", "bwd_kernel<EP>"), ("BwdBf16", "bwd_kernel_bf16<EP>")):
        kind = traits[:3].lower()
        assert f"launch_{kind}<seist::{traits}>(" in entries, traits
        text = next((K.CSRC / src).read_text() for src in KERNEL_SOURCES
                    if f"struct {traits} {{" in (K.CSRC / src).read_text())
        assert f"{name}<<<" in text.split(f"struct {traits} {{")[1], traits


def test_bf16_rows_are_aligned_and_free_of_bank_conflicts():
    """The bf16 kernels' shared-memory row strides (kBf16Stride for q, g,
    o, k and v rows of EP elements; R + 8 for K2's dS^T rows of R = 32 or 64
    rows):
    ldmatrix and cp.async need 16-byte aligned rows, and the 16-byte
    segments that one ldmatrix reads from eight consecutive rows must lie in
    eight different groups of four banks."""
    common = (K.CSRC / "attention_bf16.cuh").read_text()
    m = re.search(r"constexpr int kBf16Stride = EP == (\d+) \? (\d+) : EP \+ (\d+);", common)
    ep8, s8, pad = (int(x) for x in m.groups())
    bwd = (K.CSRC / "pooled_attention_bwd_bf16.cuh").read_text()
    ds_pad = int(re.search(r"static constexpr int DS = R \+ (\d+);", bwd).group(1))
    strides = {ep: s8 if ep == ep8 else ep + pad for ep in (8, 16, 32, 64)}
    for rows in (K.BWD_ROW_TILE, 2 * K.BWD_ROW_TILE):  # kBf16RowTile's 32 and 64
        strides[f"dS^T of {rows} rows"] = rows + ds_pad
    for name, stride in strides.items():
        assert (2 * stride) % 16 == 0, name
        assert len({(r * 2 * stride // 16) % 8 for r in range(8)}) == 8, name
        if isinstance(name, int):
            assert stride >= name, name


def test_counter_hash_constants_match_the_plain_version():
    hash_src = (K.CSRC / "attention_common.cuh").read_text()
    for const in (0x85EBCA6B, 0xC2B2AE35):
        assert f"0x{const:X}u" in hash_src
    for name in KERNEL_SOURCES:  # the seed mix, of the seed read from device
        # memory (once a block in K1, a row tile in K2)
        text = (K.CSRC / name).read_text()
        assert re.search(r"\(uint32_t\)[^;]*\(seed\)+ \* 0x9E3779B9u", text), name
    src = (K.CSRC.parent / "ops" / "pooled_attention.py").read_text()
    assert all(f"0x{c:X}" in src for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9))


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("n,l,m,h", [(8, 1024, 128, 3), (8, 128, 128, 3), (1, 128, 128, 3),
                                     (8, 256, 128, 3), (2, 50, 7, 1), (1, 8192, 1024, 3)])
def test_fwd_plan(n, l, m, h, sms):
    row_warps, ksplit = K.fwd_plan(n, l, m, h, sms)
    assert row_warps in (1, 2, 4) and ksplit in (1, 2) and row_warps * ksplit <= 4
    groups = -(-l // K.WARP_ROWS) * n * h
    # Two warps share a row group only when groups are scarce and M has two chunks.
    assert (ksplit == 2) == (m > K.FWD_CHUNK and groups < 2 * sms)
    blocks = -(-l // (K.WARP_ROWS * row_warps)) * n * h
    if row_warps > 1:  # the block is as wide as it can be while every SM gets one
        assert blocks >= sms
    if 2 * row_warps * ksplit <= 4:
        assert -(-l // (K.WARP_ROWS * 2 * row_warps)) * n * h < sms


def test_fwd_plan_on_seist_l_serving_shapes():
    # Batch 8 at window 8192 on 132 SMs: (L, E) = (1024, 8), (512, 8), (256, 16), (128, 32).
    assert [K.fwd_plan(8, l, 128, 3, 132) for l in (1024, 512, 256, 128)] == [
        (4, 1), (4, 1), (2, 1), (1, 2)]
    assert K.fwd_plan(1, 1024, 128, 3, 132) == (1, 2)


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("n,l,m,h", [(64, 1024, 128, 3), (64, 128, 128, 3), (2, 1000, 125, 3),
                                     (1, 200, 200, 2), (1, 4096, 512, 3), (256, 1024, 128, 3),
                                     (1, 1, 1, 1), (3, 33, 65, 2)])
def test_bwd_plan_covers_the_rows_in_whole_tiles(n, l, m, h, sms):
    splits, rows = K.bwd_plan(n, l, m, h, sms)
    assert rows % K.BWD_ROW_TILE == 0 and splits >= 1
    # The C entry point's conditions: every range holds rows, together all.
    assert splits * rows >= l and (splits - 1) * rows < l


def test_bwd_plan_balances_the_sms():
    # 192 blocks (batch 64, H 3, one key tile) on 132 SMs: a second range
    # halves the blocks' rows, so the busiest SM runs 3 half-blocks, not 2.
    assert K.bwd_plan(64, 1024, 128, 3, 132) == (2, 512)
    assert K.bwd_plan(64, 256, 128, 3, 132) == (2, 128)
    # Four row tiles: a split saves less than the parts cost.
    assert K.bwd_plan(64, 128, 128, 3, 132) == (1, 128)
    # Few blocks: many ranges; on a smaller card the same shape splits less.
    assert K.bwd_plan(2, 1000, 125, 3, 132) == (16, 64)
    assert K.bwd_plan(2, 1000, 125, 3, 16)[0] < 16
    assert K.bwd_plan(256, 1024, 128, 3, 132) == (1, 1024)


@pytest.mark.parametrize("cost", [K.BwdCost(32, 3, 1), K.BwdCost(64, 2, 1), K.BwdCost(32, 2, 1),
                                  K.BwdCost(32, 1, 1)])
@pytest.mark.parametrize("n,l,m,h", [(64, 1024, 128, 3), (2, 1000, 125, 3), (1, 200, 200, 2),
                                     (3, 33, 65, 2), (1, 1, 1, 1)])
def test_bwd_plan_covers_the_rows_in_whole_tiles_of_any_cost(n, l, m, h, cost):
    """Under another kernel's cost (the bf16 K2's row tiles of 32 or 64 rows,
    two or three blocks an SM, a fixed cost of one tile)."""
    splits, rows = K.bwd_plan(n, l, m, h, 132, cost)
    assert rows % cost.row_tile == 0 and splits * rows >= l > (splits - 1) * rows


def test_the_bf16_kernel_gives_the_plan_its_launch_bounds_and_row_tile():
    """The C query that the plan reads (bwd_bf16_shape) returns the constants
    that the kernel's __launch_bounds__ and its shared-memory tiles use."""
    text = (K.CSRC / "pooled_attention_bwd_bf16.cuh").read_text()
    assert "__launch_bounds__(kBwdThreads, kBf16BwdBlocks<EP>) bwd_kernel_bf16(" in text
    assert "static constexpr int R = kBf16RowTile<EP>;" in text
    query = text.split("inline cudaError_t bwd_bf16_shape(")[1].split("\n}\n")[0]
    assert "*row_tile = kBf16RowTile<" in query and "*blocks_per_sm = kBf16BwdBlocks<" in query
    entry = (K.CSRC / "pooled_attention_bwd.cu").read_text()
    assert 'extern "C" int pooled_attention_bwd_bf16_shape(' in entry
    assert K.FP32_BWD_COST.row_tile == K.BWD_ROW_TILE  # the fp32 kernel's


@pytest.mark.parametrize("n,l,m,h,e,splits,want", [
    (64, 1024, 128, 3, 8, 1, (0, 0)),  # the main path: no scratch
    (64, 1024, 128, 3, 8, 2, (0, 2 * 64 * 128 * 3 * 8)),
    (1, 300, 512, 2, 20, 1, (4 * 300 * 2 * 20, 0)),  # 4 key tiles: dQ parts
    (2, 77, 200, 3, 8, 3, (2 * 2 * 77 * 3 * 8, 3 * 2 * 200 * 3 * 8)),
])
def test_bwd_scratch(n, l, m, h, e, splits, want):
    assert K.bwd_scratch(n, l, m, h, e, splits) == want


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(K, "CSRC", tmp_path)
    before = K.library_path("k")
    (tmp_path / "common.cuh").write_text("// two\n")
    assert K.library_path("k") != before  # a header edit rebuilds


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,l,m,h,e", [(2, 64, 8, 3, 8), (1, 50, 50, 1, 20),
                                       (2, 1000, 125, 3, 8)])
def test_plain_lse_matches_jax_logsumexp(n, l, m, h, e, rate):
    q, k, v = _arrays([(n, l, h, e), (n, m, h, e), (n, m, h, e)], l + m)
    scale = 1.0 / np.sqrt(e)
    s = jnp.einsum("nlhe,nmhe->nhlm", q * scale, k)
    want = np.asarray(jax.scipy.special.logsumexp(s, axis=-1))
    o, lse = tpa.pooled_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), scale,
                                        rate, 3, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (n, h, l)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-6)
    ref = tpa.pooled_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), scale, rate, 3)
    assert torch.equal(o, ref)  # asking for lse changes no output bit


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("m_div", [1, 8])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("l", [64, 50])  # 50: ragged (not a multiple of 16 or 8)
def test_bwd_plain_from_o_and_lse_matches_jax_vjp(l, h, m_div, rate):
    n, e, seed = 2, 8, 4321
    m = max(1, l // m_div)
    q, k, v, g = _arrays([(n, l, h, e), (n, m, h, e), (n, m, h, e), (n, l, h, e)],
                         l * 10 + h + m_div)
    scale = 1.0 / np.sqrt(e)

    def f(q_, k_, v_):
        return jpa.fused_pooled_attention(
            q_, k_, v_, scale, dropout_rate=rate,
            dropout_seed=jnp.asarray([seed], jnp.int32), interpret=True)

    _, vjp = jax.vjp(f, q, k, v)
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    o, lse = tpa.pooled_attention_plain(tq, tk, tv, scale, rate, seed, return_lse=True)
    got = tpa.pooled_attention_bwd_plain(tq, tk, tv, tg, o, lse, scale, rate, seed)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bwd_plain_agrees_with_the_recompute_reference(rate, dtype):
    q, k, v, g = (torch.from_numpy(t).to(dtype) for t in _arrays(
        [(3, 40, 2, 16), (3, 10, 2, 16), (3, 10, 2, 16), (3, 40, 2, 16)], 7))
    o, lse = tpa.pooled_attention_plain(q, k, v, 0.25, rate, 9, return_lse=True)
    got = tpa.pooled_attention_bwd_plain(q, k, v, g, o, lse, 0.25, rate, 9)
    want = tpa.pooled_attention_bwd_reference(q, k, v, g, 0.25, rate, 9)
    # fp32: summation order only. bf16: D comes from the bf16-rounded o,
    # so the two differ by about one bf16 rounding of o (2^-8 relative).
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)


def test_autograd_saves_the_row_statistics_only_for_a_gradient():
    q, k, v = (torch.from_numpy(t) for t in _arrays([(1, 16, 2, 8), (1, 4, 2, 8), (1, 4, 2, 8)], 2))
    before = (tpa.launches, tpa.bwd_launches)
    out = tpa.fused_pooled_attention(q.clone().requires_grad_(), k, v)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and saved[3] is not None and saved[4].shape == (1, 2, 16)
    assert saved[4].dtype == torch.float32
    assert saved[5].dtype == torch.int32 and saved[5].shape == ()  # the seed, as a tensor
    assert tpa._forward(q, k, v, 0.3, 0.0, 0, False)[1] is None
    assert (tpa.launches, tpa.bwd_launches) == before  # CPU tensors: no launch
