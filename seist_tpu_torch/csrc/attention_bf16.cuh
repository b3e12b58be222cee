// Pieces of the bf16 pooled-attention kernels (pooled_attention_fwd_bf16.cuh,
// pooled_attention_bwd_bf16.cuh): bf16 tiles in shared memory, fragments
// read with ldmatrix, products on the bf16 tensor cores with fp32 sums.
//
// Fragments (mma.sync m16n8k16, bf16 operands, fp32 accumulators, PTX ISA).
// In a warp, lane = 4*g + t (g = lane / 4 in 0..7, t = lane % 4); a 32-bit
// register holds two bf16 values, the lower-indexed one in its low half:
//   A (16 x 16, row-major): a0 (g, 2t:2t+1)  a1 (g+8, 2t:2t+1)
//                           a2 (g, 2t+8:2t+9) a3 (g+8, 2t+8:2t+9)
//   B (16 x 8, k x n):      b0 (2t:2t+1, g)  b1 (2t+8:2t+9, g)
//   C (16 x 8, fp32):       c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
// m16n8k8 takes A = {a0, a1} and B = {b0}. So the C fragments of two
// neighbouring 8-column tiles, packed in pairs, are the A fragment of a
// product over those 16 columns: {c0 c1, c2 c3} of the first tile and
// {c0 c1, c2 c3} of the second give a0, a1, a2, a3 (pack_a).
//
// ldmatrix.m8n8 reads 8 x 8 bf16 matrices from shared memory, lane l
// naming the row address of row l % 8 of matrix l / 8; each lane then
// holds (row g, columns 2t:2t+1) of every matrix, or, with .trans,
// (rows 2t:2t+1, column g). A row-major tile therefore gives A fragments
// and the B fragments of a product with its transpose as it is, and the B
// fragments of a product with itself through .trans.
//
// Operands. A bf16 input (q, k, v, g) enters a product as it is: the
// product of two bf16 values is exact in fp32, so such a product (Q K^T,
// G V^T) is exact up to its fp32 sums. An fp32 operand computed in a kernel
// (the probabilities P, Pd and dS) is split into hi = bf16(x) and lo =
// bf16(x - hi) (split_pack): hi + lo keeps 16 of x's 24 mantissa bits
// (|x - hi - lo| <= 2^-17 |x|), against the 2^-9 of one bf16 rounding of
// the outputs, and a product with it is two products, lo first. The tensor
// cores truncate when they add to an fp32 accumulator, so each chunk's or
// row tile's products go to a fresh fragment that is then added with
// rounding.
//
// Shared-memory rows are 16-byte aligned (ldmatrix and cp.async need it)
// and kBf16Stride elements apart: a row of EP = 8 is 16 bytes, so eight
// consecutive rows cover the 32 banks; wider rows get 8 elements of padding,
// which puts eight consecutive rows in eight different 4-bank groups.

#pragma once

#include <string.h>

#include "attention_common.cuh"

namespace seist {

using bf16 = __nv_bfloat16;

template <int EP>
constexpr int kBf16Stride = EP == 8 ? 8 : EP + 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// x2: lanes 0-15 name the rows (the other lanes' addresses are not read).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a b, m16n8k16.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b, m16n8k8 (a depth of E = 8): A = {a0, a1}.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// 2^x on the special-function unit: ex2.approx.ftz, relative error about
// 2^-22, results below 2^-126 flushed to 0 (exp2f adds the steps that keep
// them, which nothing here needs).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// (x, y) -> hi = bf16x2(x, y) and lo = bf16x2(x - hi.x, y - hi.y), x in the
// low half of each.
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragment (hi and lo) of a product over the 16 columns of two C
// fragments c0 (columns 0-7) and c1 (columns 8-15).
__device__ __forceinline__ void pack_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_pack(c0[0], c0[1], hi[0], lo[0]);
  split_pack(c0[2], c0[3], hi[1], lo[1]);
  split_pack(c1[0], c1[1], hi[2], lo[2]);
  split_pack(c1[2], c1[3], hi[3], lo[3]);
}

// Stage rows [r0, r0 + rows) of one bf16 head slice into shared memory at
// row stride S elements, EP columns, zero beyond `valid` rows and E columns.
// src points at (row 0, column 0) of the head slice, `he` = H*E elements
// apart. vec (vec_rows<bf16>: E % 8 == 0, 16-byte aligned): cp.async in
// 16-byte vectors of 8 elements; otherwise scalar loads and stores. All
// threads of the block take part; the caller commits and waits.
template <int EP, int S>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* __restrict__ src, int r0,
                                           int rows, int valid, int E, size_t he, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    constexpr int V = EP / 8;  // vectors of a row, padding included
    for (int i = tid; i < rows * V; i += nt) {
      const int r = i / V, c = (i - r * V) * 8;
      bf16* d = dst + r * S + c;
      if (r < valid && c < E) {
        cp_async16(d, src + (size_t)(r0 + r) * he + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  for (int i = tid; i < rows * EP; i += nt) {
    const int r = i / EP, c = i - r * EP;
    dst[r * S + c] = (r < valid && c < E) ? src[(size_t)(r0 + r) * he + c]
                                          : __float2bfloat16(0.0f);
  }
}

}  // namespace seist
