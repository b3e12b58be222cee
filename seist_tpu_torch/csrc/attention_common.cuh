// Pieces shared by the pooled-attention forward (K1) and backward (K2):
// the tile constants, the dropout counter hash, tensor-core products in
// 3xTF32 and the cp.async copies.
//
// The tile constants are mirrored by seist_tpu_torch/ops/_kernels.py, which
// plans the launches; tests/test_torch_attention_tiles.py reads both files
// and keeps them equal.
//
// Tensor-core fragments (mma.sync.m16n8k8 with TF32 operands, PTX ISA).
// In a warp, lane = 4*g + t (g = lane / 4 in 0..7, t = lane % 4):
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, k x n):       b0 (t, g)  b1 (t+4, g)
//   C (16 x 8, fp32):       c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
// A product's depth index may be permuted as long as A and B agree. So a C
// fragment becomes the A fragment of the next product without a shuffle:
// depth slot t holds column 2t and slot t+4 column 2t+1, that is
// A = {c0, c2, c1, c3}, and the B rows are read at 2t and 2t+1.
//
// 3xTF32: TF32 keeps 10 mantissa bits, too few for the 1e-5 limit against
// the fp32 plain versions. Each fp32 operand x is split into hi = tf32(x)
// and lo = tf32(x - hi), and a*b is summed as lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b (the small terms first), which keeps fp32-level error. A value
// widened from bf16 (8 mantissa bits) is exact in TF32: its lo part is zero,
// so with bf16 inputs a kernel may leave such an operand unsplit and the
// products with its lo part out (split<true>, mma3<ExactA, ExactB>).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace seist {

constexpr int kKeyTile = 128;     // keys per shared-memory tile (K1 and K2)
constexpr int kWarpRows = 16;     // query rows of one K1 warp (the MMA's M)
constexpr int kFwdChunk = 64;     // keys whose scores a K1 warp holds at once
constexpr int kBwdRowTile = 32;   // query rows per K2 row tile
constexpr int kBwdWarps = kKeyTile / 16;  // K2: one warp per 16 keys
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The JAX package's counter hash: murmur3's finalizer over the element
// index pid*(L*M) + row*M + col (uint32, wrapping), seed_mix = seed *
// 0x9E3779B9; returns a uniform in [0, 1) with 24 bits.
__device__ __forceinline__ float uniform01(uint32_t x, uint32_t seed_mix) {
  x ^= seed_mix;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Exact: every x is exact in TF32 (widened from bf16), so hi = x, lo = 0.
template <bool Exact = false, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (Exact) {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    } else {
      split(x[i], hi[i], lo[i]);
    }
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a*b in 3xTF32 from split operands, without the products of an
// operand whose lo part is zero (ExactA, ExactB): adding them adds zeros.
template <bool ExactA = false, bool ExactB = false>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (!ExactA) mma_tf32(d, al, bh);
  if constexpr (!ExactB) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + rows) of one head slice into smem as fp32, `rows`
// x `ep` at row stride `stride` floats, zero beyond `valid` rows and E
// columns. src points at (row 0, column 0) of the head slice, `he` = H*E
// elements apart. vec: E % 4 == 0 and rows aligned for vectors of four
// elements: fp32 is copied with cp.async in 16-byte vectors, bf16 loaded 8
// bytes at a time and widened; otherwise scalar loads. All threads of the
// block take part; the caller commits the cp.async group and waits.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int r0,
                                           int rows, int valid, int E, int ep, int stride,
                                           size_t he, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    const int n4 = E >> 2;
    for (int i = tid; i < rows * n4; i += nt) {
      const int r = i / n4, c = (i - r * n4) << 2;
      float* d = dst + r * stride + c;
      const T* sp = src + (size_t)(r0 + r) * he + c;
      if constexpr (sizeof(T) == 4) {
        if (r < valid) {
          cp_async16(d, sp);
        } else {
          *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < valid) {
          const uint2 u = *reinterpret_cast<const uint2*>(sp);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
          f = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
        *reinterpret_cast<float4*>(d) = f;
      }
    }
    const int pad = ep - E;
    for (int i = tid; i < rows * pad; i += nt) {
      const int r = i / pad;
      dst[r * stride + E + (i - r * pad)] = 0.0f;
    }
    return;
  }
  for (int i = tid; i < rows * ep; i += nt) {
    const int r = i / ep, c = i - r * ep;
    dst[r * stride + c] =
        (r < valid && c < E) ? to_f32(src[(size_t)(r0 + r) * he + c]) : 0.0f;
  }
}

// Whether rows of E elements at these pointers take stage_rows' vectors.
template <typename T>
__host__ inline bool vec_rows(int e, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= (uintptr_t)p;
  return e % 4 == 0 && (bits & (4 * sizeof(T) - 1)) == 0;
}

// Lets the kernel take up to the 227 KB of dynamic shared memory a Hopper
// block may use; set once per instantiation.
template <auto Kernel>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  return err;
}

// out[i] = sum over s of part[s * n + i], in slab order: the fixed-order
// sum of per-tile partials. blockIdx.y picks (part0, out0) or (part1, out1).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) reduce_slabs(
    const float* __restrict__ part0, T* __restrict__ out0, const float* __restrict__ part1,
    T* __restrict__ out1, int slabs, size_t n) {
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  const float* part = blockIdx.y == 0 ? part0 : part1;
  float acc = 0.0f;
  for (int s = 0; s < slabs; ++s) acc += part[(size_t)s * n + i];
  store((blockIdx.y == 0 ? out0 : out1) + i, acc);
}

}  // namespace seist
