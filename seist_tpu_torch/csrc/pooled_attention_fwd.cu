// Pooled-KV multi-head attention forward, with post-softmax dropout, for
// Hopper (sm_90a).
//
// Replaces seist_tpu/ops/pallas_attention.py::_fwd_kernel (reached through
// _call_fused -> pl.pallas_call). For every batch element b and head h:
//   P = softmax((q_h * scale) k_h^T)          (L x M, fp32)
//   P = where(u >= rate, P / (1 - rate), 0)   (only when rate > 0)
//   O_h = P v_h                               (written into head h's slice)
// q is (N, L, H*E), k and v are (N, M, H*E), o is (N, L, H*E), all
// contiguous, in float32 or bfloat16; arithmetic is fp32 throughout and
// the output takes the input type.
//
// What bounds it. At the serving shapes (L = 128..1024, M = 128, H = 3,
// E = 8..32, N <= 8) one launch moves under 2 MB and does ~1e8 flops: it
// is bound by the fp32 arithmetic of QK^T and PV and, below that, by
// launch latency. What would cost most is writing the (N, H, L, M)
// probabilities to device memory, as the plain version does; the design
// never does:
//   * one thread owns one query row: its scaled q row, the E accumulators,
//     the running max and the running sum live in registers;
//   * a block of 128 rows of one (b, h) stages k_h and v_h for a tile of
//     64 keys in shared memory, read straight from the strided head slice
//     of (N, M, H*E) (no head transpose); every thread reads the same key,
//     so the reads are broadcasts without bank conflicts;
//   * the softmax is online over the key tiles, so any M works (window
//     8192 gives M = 128, window 65536 gives M = 1024), and ragged L and M
//     are masked.
// Dropout is applied after the normalization in the reference, so the
// running sum counts every key while the accumulators skip dropped ones:
// O = (sum_kept e^(s - max) v) / (sum_all e^(s - max)) / (1 - rate).
// Tensor cores (wgmma) and TMA are later work.
//
// The dropout uniform is the JAX package's counter hash (murmur3's
// finalizer over pid*(L*M) + row*M + col, pid = b*H + h), computed in
// uint32 so its bits equal JAX's int32 arithmetic.
//
// Built by seist_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // query rows (threads) per block
constexpr int kTileM = 64;  // keys staged in shared memory per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float uniform01(uint32_t x, uint32_t seed_mix) {
  x ^= seed_mix;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// EP: head width rounded up to a power of two (register arrays need a
// compile-time size); lanes e >= E hold zeros.
template <typename T, int EP>
__global__ void __launch_bounds__(kRows) pooled_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int L, int M, int H, int E, float scale, float rate,
    float out_scale, uint32_t lm, uint32_t seed_mix) {
  __shared__ float ks[kTileM][EP];
  __shared__ float vs[kTileM][EP];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < L;
  const size_t he = (size_t)H * E;

  float qr[EP], acc[EP];
  const T* qrow = q + ((size_t)b * L + (active ? row : 0)) * he + (size_t)h * E;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    qr[e] = (active && e < E) ? to_f32(qrow[e]) * scale : 0.0f;
    acc[e] = 0.0f;
  }
  float mx = -INFINITY;
  float sum = 0.0f;
  // Counter of element (row, 0) of slice pid = bh, wrapped mod 2^32.
  const uint32_t ctr0 = (uint32_t)bh * lm + (uint32_t)row * (uint32_t)M;

  const T* kb = k + (size_t)b * M * he + (size_t)h * E;
  const T* vb = v + (size_t)b * M * he + (size_t)h * E;
  for (int m0 = 0; m0 < M; m0 += kTileM) {
    const int tm = min(kTileM, M - m0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kTileM * EP; i += kRows) {
      const int r = i / EP;
      const int e = i - r * EP;
      const bool in = r < tm && e < E;
      const size_t off = (size_t)(m0 + r) * he + e;
      ks[r][e] = in ? to_f32(kb[off]) : 0.0f;
      vs[r][e] = in ? to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tm; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < EP; ++e) s = fmaf(qr[e], ks[j][e], s);
      if (s > mx) {  // rescale what was accumulated against the old max
        const float corr = expf(mx - s);
        sum *= corr;
#pragma unroll
        for (int e = 0; e < EP; ++e) acc[e] *= corr;
        mx = s;
      }
      const float p = expf(s - mx);
      sum += p;
      if (rate > 0.0f &&
          uniform01(ctr0 + (uint32_t)(m0 + j), seed_mix) < rate) {
        continue;  // dropped after the softmax: counted in sum, not in acc
      }
#pragma unroll
      for (int e = 0; e < EP; ++e) acc[e] = fmaf(p, vs[j][e], acc[e]);
    }
  }
  if (!active) return;
  const float inv = out_scale / sum;
  T* orow = o + ((size_t)b * L + row) * he + (size_t)h * E;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    if (e < E) store(orow + e, acc[e] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int n,
                   int l, int m, int heads, int e, float scale, float rate,
                   float out_scale, uint32_t lm, uint32_t seed_mix,
                   cudaStream_t stream) {
  const dim3 grid((l + kRows - 1) / kRows, n * heads);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define SEIST_LAUNCH(EP)                                                    \
  pooled_attention_fwd_kernel<T, EP><<<grid, kRows, 0, stream>>>(           \
      qp, kp, vp, op, l, m, heads, e, scale, rate, out_scale, lm, seed_mix)
  if (e <= 8) {
    SEIST_LAUNCH(8);
  } else if (e <= 16) {
    SEIST_LAUNCH(16);
  } else if (e <= 32) {
    SEIST_LAUNCH(32);
  } else if (e <= 64) {
    SEIST_LAUNCH(64);
  } else {
    return cudaErrorInvalidValue;
  }
#undef SEIST_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lm = (L*M) mod 2^32, seed = the int32
// dropout seed's bits, out_scale = 1/(1 - rate) (1 when rate == 0).
extern "C" int pooled_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, int n, int l,
                                    int m, int heads, int e, int dtype,
                                    float scale, float rate, float out_scale,
                                    unsigned int lm, unsigned int seed,
                                    void* stream) {
  if (n < 1 || l < 1 || m < 1 || heads < 1 || e < 1 || n * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t seed_mix = (uint32_t)seed * 0x9E3779B9u;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, o, n, l, m, heads, e, scale, rate, out_scale,
                        lm, seed_mix, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, o, n, l, m, heads, e, scale, rate,
                                out_scale, lm, seed_mix, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
