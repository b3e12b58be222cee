// Pieces shared by the pooled-attention forward (K1) and backward (K2):
// the tile constants, the dropout counter hash, tensor-core products in
// 3xTF32 (the fp32 kernels) and the cp.async copies. The bf16 kernels'
// own pieces are in attention_bf16.cuh.
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
// hi_a*hi_b (the small terms first), which keeps fp32-level error.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace seist {

constexpr int kKeyTile = 128;     // keys per shared-memory tile (K1 and K2)
constexpr int kWarpRows = 16;     // query rows of one K1 warp (the MMA's M)
constexpr int kFwdChunk = 64;     // keys whose scores a K1 warp holds at once
constexpr int kBwdRowTile = 32;   // query rows per K2 row tile
constexpr int kBwdWarps = kKeyTile / 16;  // K2: one warp per 16 keys
constexpr int kReduceThreads = 256;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kDThreads = kBwdThreads / kBwdRowTile;  // K2: threads per row computing D
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The JAX package's counter hash: murmur3's finalizer over the element
// index pid*(L*M) + row*M + col (uint32, wrapping), pid = pid0 + b*H + h
// (pid0 = n0*H: a data-parallel rank's batch rows start at global row n0),
// seed_mix = seed * 0x9E3779B9. Its top 24 bits make the uniform (uniform01).
__device__ __forceinline__ uint32_t mix32_tail(uint32_t x) {  // after the first xor-shift
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed_mix) {
  x ^= seed_mix;
  return mix32_tail(x ^ (x >> 16));
}
// The same with the seed's part of the first xor-shift computed once:
// (x ^ s) ^ ((x ^ s) >> 16) is x ^ (x >> 16) ^ fold_seed(s).
__device__ __forceinline__ uint32_t fold_seed(uint32_t seed_mix) {
  return seed_mix ^ (seed_mix >> 16);
}
__device__ __forceinline__ uint32_t mix32_folded(uint32_t x, uint32_t seed_fold) {
  return mix32_tail(x ^ (x >> 16) ^ seed_fold);
}

// A uniform in [0, 1) with 24 bits.
__device__ __forceinline__ float uniform01(uint32_t x, uint32_t seed_mix) {
  return (float)(mix32(x, seed_mix) >> 8) * (1.0f / 16777216.0f);
}

// The dropout test without the float: u = (x >> 8) 2^-24 < rate holds
// exactly when x < ceil(rate 2^24) 2^8 (rate 2^24 is exact in fp32, and for
// an integer n, n < y iff n < ceil(y)), so an element is kept when
// mix32(...) >= keep_threshold(rate); 0 keeps every element (rate 0).
__device__ __forceinline__ uint32_t keep_threshold(float rate) {
  return rate > 0.0f ? (uint32_t)ceilf(rate * 16777216.0f) << 8 : 0u;
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

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a*b in 3xTF32 from split operands.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
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

// Stage rows [r0, r0 + rows) of one fp32 head slice into smem, `rows` x
// `ep` at row stride `stride` floats, zero beyond `valid` rows and E
// columns. src points at (row 0, column 0) of the head slice, `he` = H*E
// elements apart. vec (vec_rows): copied with cp.async in 16-byte vectors;
// otherwise scalar loads. All threads of the block take part; the caller
// commits the cp.async group and waits.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int r0,
                                           int rows, int valid, int E, int ep, int stride,
                                           size_t he, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    const int n4 = E >> 2;
    for (int i = tid; i < rows * n4; i += nt) {
      const int r = i / n4, c = (i - r * n4) << 2;
      float* d = dst + r * stride + c;
      if (r < valid) {
        cp_async16(d, src + (size_t)(r0 + r) * he + c);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
    dst[r * stride + c] = (r < valid && c < E) ? src[(size_t)(r0 + r) * he + c] : 0.0f;
  }
}

// Whether rows of E elements of T at these pointers can be copied in
// 16-byte vectors: E a multiple of a vector's elements, every pointer
// 16-byte aligned (then so is every row, H*E*sizeof(T) being a multiple of 16).
template <typename T>
__host__ inline bool vec_rows(int e, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= (uintptr_t)p;
  return e % (16 / (int)sizeof(T)) == 0 && (bits & 15) == 0;
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

// Sums the slabs of one or two fp32 part arrays into their outputs.
template <typename T>
cudaError_t reduce(const float* part0, void* out0, const float* part1, void* out1, int slabs,
                   size_t n, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kReduceThreads - 1) / kReduceThreads), part1 ? 2 : 1);
  reduce_slabs<T><<<grid, kReduceThreads, 0, stream>>>(
      part0, static_cast<T*>(out0), part1, static_cast<T*>(out1), slabs, n);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, EP>()) for the padded head width EP
// of e (8, 16, 32 or 64: each kernel's instantiations), or refuses e > 64.
template <typename F>
cudaError_t with_padded_width(int e, F&& f) {
  if (e <= 8) return f(std::integral_constant<int, 8>());
  if (e <= 16) return f(std::integral_constant<int, 16>());
  if (e <= 32) return f(std::integral_constant<int, 32>());
  if (e <= 64) return f(std::integral_constant<int, 64>());
  return cudaErrorInvalidValue;
}

// Launches K1 through Fwd<EP>, one input type's kernel (FwdF32 in
// pooled_attention_fwd.cu, FwdBf16 in pooled_attention_fwd_bf16.cuh):
// Fwd<EP>::T is the input type, Fwd<EP>::kStagesQ whether the kernel
// copies q's rows too (then q's pointer decides the vector copies with k's
// and v's), Fwd<EP>::smem(stages, row_warps) its shared memory in bytes and
// Fwd<EP>::run(blocks, threads, smem, stream, args...) the launch.
template <template <int> class Fwd>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       int n, int l, int m, int heads, int e, int row_warps, int ksplit,
                       float scale, float rate, float out_scale, uint32_t lm,
                       const int* seed, cudaStream_t stream, uint32_t pid0 = 0) {
  const int row_tiles = (l + kWarpRows * row_warps - 1) / (kWarpRows * row_warps);
  const long long blocks = (long long)row_tiles * n * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int stages = m > kKeyTile ? 2 : 1;  // K and V double-buffered past one tile
  return with_padded_width(e, [&](auto ep) {
    using K = Fwd<decltype(ep)::value>;
    using T = typename K::T;
    const bool vec = vec_rows<T>(e, {K::kStagesQ ? q : nullptr, k, v});
    return K::run((unsigned)blocks, 32 * row_warps * ksplit, K::smem(stages, row_warps),
                  stream, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o), lse, l, m, heads, e,
                  row_tiles, ksplit, scale, rate, out_scale, lm, seed, vec, pid0);
  });
}

// Launches K2 through Bwd<EP>, one input type's kernel (BwdF32 in
// pooled_attention_bwd.cu, BwdBf16 in pooled_attention_bwd_bf16.cuh):
// Bwd<EP>::T, Bwd<EP>::kSmemBytes and Bwd<EP>::run(blocks, stream, args...),
// then the fixed-order sums of the dQ key-tile parts and the dK/dV
// row-range parts.
template <template <int> class Bwd>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* g,
                       const void* o, const float* lse, void* dq, void* dk, void* dv,
                       float* dq_part, float* dk_part, float* dv_part, int n, int l, int m,
                       int heads, int e, int splits, int rows_per_split, float scale,
                       float rate, float out_scale, uint32_t lm, const int* seed,
                       cudaStream_t stream, uint32_t pid0 = 0) {
  const int ktiles = (m + kKeyTile - 1) / kKeyTile;
  const long long blocks = (long long)ktiles * n * heads * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return with_padded_width(e, [&](auto ep) {
    using K = Bwd<decltype(ep)::value>;
    using T = typename K::T;
    const bool vec = vec_rows<T>(e, {q, k, v, g, o});
    cudaError_t err = K::run(
        (unsigned)blocks, stream, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), static_cast<const T*>(o), lse,
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
        ktiles > 1 ? dq_part : nullptr, splits > 1 ? dk_part : nullptr,
        splits > 1 ? dv_part : nullptr, n, l, m, heads, e, ktiles, rows_per_split, scale,
        rate, out_scale, lm, seed, vec, pid0);
    if (err != cudaSuccess) return err;
    if (ktiles > 1) {
      err = reduce<T>(dq_part, dq, nullptr, nullptr, ktiles, (size_t)n * l * heads * e,
                      stream);
      if (err != cudaSuccess) return err;
    }
    if (splits > 1) {
      err = reduce<T>(dk_part, dk, dv_part, dv, splits, (size_t)n * m * heads * e, stream);
    }
    return err;
  });
}

}  // namespace seist
