// Pooled-KV multi-head attention backward, with the forward's post-softmax
// dropout, for Hopper (sm_90a).
//
// Replaces seist_tpu/ops/pallas_attention.py::_bwd_kernel (reached through
// _fused_bwd -> _call_fused -> pl.pallas_call). For every batch element b
// and head h, from the forward's residuals q, k, v, the seed and the
// upstream gradient g:
//   P   = softmax((q_h * scale) k_h^T)                  (L x M, recomputed)
//   Pd  = dropout(P),  dPd = g_h v_h^T,  dP = dropout(dPd)  (the same mask)
//   dV  = Pd^T g_h
//   dS  = P (dP - rowsum(dP P))
//   dQ  = dS k_h * scale,   dK = dS^T q_h * scale
// q, g and dq are (N, L, H*E), k, v, dk and dv are (N, M, H*E), contiguous,
// in float32 or bfloat16; arithmetic is fp32 and the outputs take the input
// type. The dropout mask is the forward's bit for bit: the counter hash of
// element pid*(L*M) + row*M + col, pid = b*H + h, wrapped mod 2^32, kept
// where u >= rate and scaled by 1/(1 - rate).
//
// What bounds it. One call reads q, k, v, g and writes dq, dk, dv:
// itemsize*N*H*E*(3L + 4M) bytes, over 3.35 TB/s. It does 10*N*H*L*M*E
// operations (a multiply-add each for QK^T recomputed, dPd, dV, dQ and dK),
// over 67 TFLOP/s in fp32 on the CUDA cores. At the shapes of seist_l_dpk's
// train step (L = 128..1024, M = 128, E = 8..32) the operations bound it, by
// 2-5x over the bytes. What would cost most is materialising the (N, H, L, M)
// probabilities and their gradients in device memory, as the plain version
// does; this design never writes them, and recomputes instead:
//   * dQ is a sum over keys, dK and dV are sums over query rows. The TPU
//     kernel held a whole (b, h) in VMEM and reduced in place; here blocks
//     run in parallel, and a reduction across blocks would need atomics,
//     whose order changes from run to run. So three launches, no atomics:
//   1. rows: one thread owns one query row (its q, g and dq in registers;
//      k and v tiles of 64 keys staged in shared memory, read straight from
//      the strided head slice, as the forward kernel does). A first walk
//      over the keys builds the softmax max and sum online and, in the same
//      walk, D = rowsum(dP P) (rescaled with the running max like the sum);
//      a second walk forms dS and accumulates dQ. The row's max, 1/sum and
//      D go to a small (N*H, L, 3) scratch buffer.
//   2. keys: one thread owns one key (its k, v, dk, dv in registers); tiles
//      of 64 query rows (q, g and the row statistics) are staged in shared
//      memory and every thread reads the same row, a broadcast. To fill the
//      card when N*H*M/64 blocks are few, the rows are split into S
//      contiguous ranges (S from the wrapper, ops/_kernels.py), each block
//      writing fp32 partial sums to scratch.
//   3. reduce: sums the S partials in a fixed order and writes dk, dv in the
//      input type and layout. The result does not change from run to run.
// Tensor cores (wgmma), TMA and fusing passes 1 and 2 are later work. At
// E = 64 pass 2 holds 4*64 floats per thread and spills; seist's heads are
// at most 32 wide.
//
// Built by seist_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C function returns cudaGetLastError()
// after each launch, and the first error stops it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // pass 1: query rows (threads) per block
constexpr int kTileM = 64;  // pass 1: keys staged per tile
constexpr int kKeys = 64;   // pass 2: keys (threads) per block
constexpr int kTileL = 64;  // pass 2: query rows staged per tile
constexpr int kReduceThreads = 256;

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

// Pass 1. EP: head width rounded up to a power of two (register arrays need
// a compile-time size); lanes e >= E hold zeros.
template <typename T, int EP>
__global__ void __launch_bounds__(kRows) bwd_rows_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ stats,
    int L, int M, int H, int E, float scale, float rate, float out_scale,
    uint32_t lm, uint32_t seed_mix) {
  __shared__ float ks[kTileM][EP];
  __shared__ float vs[kTileM][EP];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < L;
  const size_t he = (size_t)H * E;

  float qr[EP], gr[EP], acc[EP];
  const size_t roff = ((size_t)b * L + (active ? row : 0)) * he + (size_t)h * E;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    qr[e] = (active && e < E) ? to_f32(q[roff + e]) * scale : 0.0f;
    gr[e] = (active && e < E) ? to_f32(g[roff + e]) : 0.0f;
    acc[e] = 0.0f;
  }
  const uint32_t ctr0 = (uint32_t)bh * lm + (uint32_t)row * (uint32_t)M;
  const T* kb = k + (size_t)b * M * he + (size_t)h * E;
  const T* vb = v + (size_t)b * M * he + (size_t)h * E;

  // Walk 1: softmax max and sum, and dsum = sum_j e^(s_j - max) dP_j, online.
  float mx = -INFINITY, sum = 0.0f, dsum = 0.0f;
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
      if (s > mx) {
        const float corr = expf(mx - s);
        sum *= corr;
        dsum *= corr;
        mx = s;
      }
      const float p = expf(s - mx);
      sum += p;
      if (rate > 0.0f && uniform01(ctr0 + (uint32_t)(m0 + j), seed_mix) < rate) {
        continue;  // dropped: dP_j = 0
      }
      float gv = 0.0f;
#pragma unroll
      for (int e = 0; e < EP; ++e) gv = fmaf(gr[e], vs[j][e], gv);
      dsum = fmaf(p, gv, dsum);
    }
  }
  const float inv = 1.0f / sum;
  const float dterm = dsum * inv * out_scale;  // D = rowsum(dP P)

  // Walk 2: dS_j = P_j (dP_j - D), dQ += dS_j k_j.
  for (int m0 = 0; m0 < M; m0 += kTileM) {
    const int tm = min(kTileM, M - m0);
    __syncthreads();
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
      const float p = expf(s - mx) * inv;
      float dp = 0.0f;
      if (!(rate > 0.0f &&
            uniform01(ctr0 + (uint32_t)(m0 + j), seed_mix) < rate)) {
        float gv = 0.0f;
#pragma unroll
        for (int e = 0; e < EP; ++e) gv = fmaf(gr[e], vs[j][e], gv);
        dp = gv * out_scale;
      }
      const float ds = p * (dp - dterm);
#pragma unroll
      for (int e = 0; e < EP; ++e) acc[e] = fmaf(ds, ks[j][e], acc[e]);
    }
  }
  if (!active) return;
  T* dqrow = dq + roff;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    if (e < E) store(dqrow + e, acc[e] * scale);
  }
  float* st = stats + ((size_t)bh * L + row) * 3;
  st[0] = mx;
  st[1] = inv;
  st[2] = dterm;
}

// Pass 2: partial dK, dV of the keys of one block over the rows of one split.
template <typename T, int EP>
__global__ void __launch_bounds__(kKeys) bwd_keys_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ stats,
    float* __restrict__ part, int L, int M, int H, int E, int NH,
    int rows_per_split, float scale, float rate, float out_scale, uint32_t lm,
    uint32_t seed_mix) {
  __shared__ float qs[kTileL][EP];
  __shared__ float gs[kTileL][EP];
  __shared__ float ss[kTileL][3];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int key = blockIdx.x * kKeys + threadIdx.x;
  const bool active = key < M;
  const int split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int r1 = min(L, r0 + rows_per_split);
  const size_t he = (size_t)H * E;

  float kr[EP], vr[EP], dk[EP], dv[EP];
  const size_t koff = ((size_t)b * M + (active ? key : 0)) * he + (size_t)h * E;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    kr[e] = (active && e < E) ? to_f32(k[koff + e]) : 0.0f;
    vr[e] = (active && e < E) ? to_f32(v[koff + e]) : 0.0f;
    dk[e] = 0.0f;
    dv[e] = 0.0f;
  }
  const T* qb = q + (size_t)b * L * he + (size_t)h * E;
  const T* gb = g + (size_t)b * L * he + (size_t)h * E;
  const float* sb = stats + (size_t)bh * L * 3;
  const uint32_t ctr_key = (uint32_t)bh * lm + (uint32_t)key;

  for (int i0 = r0; i0 < r1; i0 += kTileL) {
    const int tl = min(kTileL, r1 - i0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kTileL * EP; i += kKeys) {
      const int r = i / EP;
      const int e = i - r * EP;
      const bool in = r < tl && e < E;
      const size_t off = (size_t)(i0 + r) * he + e;
      qs[r][e] = in ? to_f32(qb[off]) : 0.0f;
      gs[r][e] = in ? to_f32(gb[off]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kTileL * 3; i += kKeys) {
      const int r = i / 3;
      ss[r][i - r * 3] = r < tl ? sb[(size_t)(i0 + r) * 3 + (i - r * 3)] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < tl; ++t) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < EP; ++e) s = fmaf(qs[t][e], kr[e], s);
      const float p = expf(s * scale - ss[t][0]) * ss[t][1];
      float gv = 0.0f;
#pragma unroll
      for (int e = 0; e < EP; ++e) gv = fmaf(gs[t][e], vr[e], gv);
      float pd = p, dp = gv;
      if (rate > 0.0f) {
        const bool keep = uniform01(ctr_key + (uint32_t)(i0 + t) * (uint32_t)M,
                                    seed_mix) >= rate;
        pd = keep ? p * out_scale : 0.0f;
        dp = keep ? gv * out_scale : 0.0f;
      }
      const float ds = p * (dp - ss[t][2]);
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        dv[e] = fmaf(pd, gs[t][e], dv[e]);
        dk[e] = fmaf(ds, qs[t][e], dk[e]);
      }
    }
  }
  if (!active) return;
  float* out = part + (((size_t)split * NH + bh) * M + key) * 2 * E;
#pragma unroll
  for (int e = 0; e < EP; ++e) {
    if (e < E) {
      out[e] = dk[e] * scale;
      out[E + e] = dv[e];
    }
  }
}

// Pass 3: dk, dv = sum over the S splits, in split order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) bwd_reduce_kernel(
    const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
    int S, int NH, int M, int H, int E) {
  const size_t per_split = (size_t)NH * M * 2 * E;
  const size_t idx = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= per_split) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * per_split + idx];
  const int c = (int)(idx % (2 * E));
  const size_t bj = idx / (2 * E);  // bh * M + key
  const int key = (int)(bj % M);
  const int bh = (int)(bj / M);
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t off = ((size_t)b * M + key) * H * E + (size_t)h * E;
  if (c < E) {
    store(dk + off + c, acc);
  } else {
    store(dv + off + (c - E), acc);
  }
}

template <typename T, int EP>
cudaError_t launch_ep(const void* q, const void* k, const void* v,
                      const void* g, void* dq, void* dk, void* dv, float* stats,
                      float* part, int n, int l, int m, int heads, int e,
                      int splits, float scale, float rate, float out_scale,
                      uint32_t lm, uint32_t seed_mix, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const int nh = n * heads;
  bwd_rows_kernel<T, EP><<<dim3((l + kRows - 1) / kRows, nh), kRows, 0, stream>>>(
      qp, kp, vp, gp, static_cast<T*>(dq), stats, l, m, heads, e, scale, rate,
      out_scale, lm, seed_mix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows_per_split = (l + splits - 1) / splits;
  bwd_keys_kernel<T, EP>
      <<<dim3((m + kKeys - 1) / kKeys, nh, splits), kKeys, 0, stream>>>(
          qp, kp, vp, gp, stats, part, l, m, heads, e, nh, rows_per_split,
          scale, rate, out_scale, lm, seed_mix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)nh * m * 2 * e;
  bwd_reduce_kernel<T><<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads),
                         kReduceThreads, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), splits, nh, m, heads, e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   void* dq, void* dk, void* dv, float* stats, float* part,
                   int n, int l, int m, int heads, int e, int splits,
                   float scale, float rate, float out_scale, uint32_t lm,
                   uint32_t seed_mix, cudaStream_t stream) {
#define SEIST_LAUNCH(EP)                                                      \
  return launch_ep<T, EP>(q, k, v, g, dq, dk, dv, stats, part, n, l, m,       \
                          heads, e, splits, scale, rate, out_scale, lm,       \
                          seed_mix, stream)
  if (e <= 8) {
    SEIST_LAUNCH(8);
  } else if (e <= 16) {
    SEIST_LAUNCH(16);
  } else if (e <= 32) {
    SEIST_LAUNCH(32);
  } else if (e <= 64) {
    SEIST_LAUNCH(64);
  }
#undef SEIST_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. stats: fp32 scratch of N*H*L*3 floats;
// part: fp32 scratch of splits*N*H*M*2*E floats. lm = (L*M) mod 2^32, seed =
// the int32 dropout seed's bits, out_scale = 1/(1 - rate) (1 when rate == 0).
extern "C" int pooled_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* g, void* dq, void* dk, void* dv,
                                    void* stats, void* part, int n, int l,
                                    int m, int heads, int e, int splits,
                                    int dtype, float scale, float rate,
                                    float out_scale, unsigned int lm,
                                    unsigned int seed, void* stream) {
  if (n < 1 || l < 1 || m < 1 || heads < 1 || e < 1 || splits < 1 ||
      n * heads > 65535 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t seed_mix = (uint32_t)seed * 0x9E3779B9u;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* pt = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, g, dq, dk, dv, st, pt, n, l, m, heads, e,
                        splits, scale, rate, out_scale, lm, seed_mix, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, pt, n, l, m, heads,
                                e, splits, scale, rate, out_scale, lm, seed_mix,
                                s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
