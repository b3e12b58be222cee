// Pooled-KV multi-head attention forward (K1), with post-softmax dropout,
// for Hopper (sm_90a).
//
// Replaces seist_tpu/ops/pallas_attention.py::_fwd_kernel (reached through
// _fused -> _call_fused -> pl.pallas_call). For every batch element b and
// head h:
//   P = softmax((q_h * scale) k_h^T)          (L x M, fp32)
//   P = where(u >= rate, P / (1 - rate), 0)   (only when rate > 0)
//   O_h = P v_h                               (written into head h's slice)
//   lse = max + log(sum) of each row of the scaled scores (only when asked:
//         the backward, csrc/pooled_attention_bwd.cu, reads it)
// q is (N, L, H*E), k and v are (N, M, H*E), o is (N, L, H*E), all
// contiguous, in float32 (this file's kernel: fp32 arithmetic throughout)
// or bfloat16 (fwd_kernel_bf16, pooled_attention_fwd_bf16.cuh, on the bf16
// tensor cores); the output takes the input type. lse is fp32 (N*H, L).
//
// What bounds it. At seist_l_dpk's shapes (L = 128..1024, M = 128, H = 3,
// E = 8..32, N = 1..8 serving) a launch moves under 2 MB and does 4*N*H*L*M*E
// operations: in fp32 on the CUDA cores the operations bind (1.5 us at
// L = 1024, N = 8), in 3xTF32 on the tensor cores the bytes, and below both
// the few microseconds a launch costs, so what decides is latency: enough
// independent warps, and no serial chain inside one. What would cost most
// is writing the (N, H, L, M) probabilities to device memory, as the plain
// version does; this kernel never does. Its design:
//   * tensor cores: a warp owns 16 query rows of one (b, h) and computes
//     S = (q scale) K^T and O = P V with mma.sync m16n8k8 in 3xTF32
//     (attention_common.cuh), which keeps fp32-level error. E is padded
//     with zeros to a power of two >= 8 (EP), so every width 1..64 runs;
//   * no serial chain per key: the warp keeps the scores of 64 keys in
//     registers (32 floats a thread), takes row max and sum by shuffles in
//     each quad of lanes, and rescales its accumulators once per 64 keys
//     (online softmax); the score fragment is the A operand of P V as it
//     is, with V's rows read in the matching order. P V of a chunk goes to
//     a fresh fragment added to the running one with rounding: the tensor
//     cores truncate when they add to an fp32 accumulator, and over M = 1024
//     keys that bias alone broke the 1e-5 limit;
//   * filling the card: blocks of up to 4 warps, on a 1-D grid; when the
//     16-row groups are fewer than two per SM (batch 8 at L = 128, or any
//     batch-1 forward), two warps share a row group, each over half of the
//     key chunks, and merge (max, sum, O) in shared memory in a fixed order.
//     ops/_kernels.py::fwd_plan chooses from the device's SM count;
//   * staging: K and V tiles of 128 keys go to shared memory with cp.async
//     in 16-byte vectors when E % 4 == 0 and the pointers are 16-byte
//     aligned, scalar loads otherwise, double-buffered when M spans more
//     than one tile. Rows are EP + 4 floats apart, so the fragment reads hit
//     32 different banks.
// Dropout is applied after the normalisation in the reference, so the row
// sum counts every key while P V skips dropped ones:
// O = (sum_kept e^(s - max) v) / (sum_all e^(s - max)) / (1 - rate).
// The dropout uniform is the JAX package's counter hash (murmur3's
// finalizer over pid*(L*M) + row*M + col, pid = b*H + h) in uint32, so its
// bits equal JAX's int32 arithmetic; each accumulator element takes the
// counter of its own (row, col).
//
// Built by seist_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C function returns cudaGetLastError().

#include "attention_common.cuh"
#include "pooled_attention_fwd_bf16.cuh"

namespace seist {
namespace {

// A block is row_warps x ksplit warps. Warp w owns query rows
// (w / ksplit) * 16 .. + 15 of the block's row tile and the chunks of 64
// keys numbered w % ksplit modulo ksplit. With ksplit = 2 the two warps of
// a row group merge their (max, sum, O) in shared memory at the end, in a
// fixed order.
template <int EP>
__global__ void __launch_bounds__(128) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int L, int M, int H, int E,
    int row_tiles, int ksplit, float scale, float rate, float out_scale, uint32_t lm,
    const int* __restrict__ seed, bool vec, uint32_t pid0) {
  constexpr int S = EP + 4;         // shared-memory row stride, floats
  constexpr int KS = EP / 8;        // MMA depth steps over E
  constexpr int NT = kFwdChunk / 8;  // 8-key column blocks of a chunk
  extern __shared__ float smem[];
  // The dropout seed lives in device memory (a captured graph replays with
  // the seed its caller writes there before each replay): read once.
  const uint32_t seed_mix = (uint32_t)__ldg(seed) * 0x9E3779B9u;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_warps = (blockDim.x >> 5) / ksplit;
  const int part = warp % ksplit, rw = warp / ksplit;
  const int rt = blockIdx.x % row_tiles, bh = blockIdx.x / row_tiles;
  const int b = bh / H, h = bh - b * H;
  const int row0 = (rt * row_warps + rw) * kWarpRows;
  const size_t he = (size_t)H * E;
  const float* qb = q + (size_t)b * L * he + (size_t)h * E;
  const float* kb = k + (size_t)b * M * he + (size_t)h * E;
  const float* vb = v + (size_t)b * M * he + (size_t)h * E;
  const int ntiles = (M + kKeyTile - 1) / kKeyTile;

  // The warp's 16 scaled q rows as split A fragments.
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i & 1) * 8, c = kk * 8 + t + (i >> 1) * 4;
      const float x = (r < L && c < E) ? qb[(size_t)r * he + c] * scale : 0.0f;
      split(x, qh[kk][i], ql[kk][i]);
    }
  }
  float acc[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) acc[kk][0] = acc[kk][1] = acc[kk][2] = acc[kk][3] = 0.0f;
  float mrun[2] = {-INFINITY, -INFINITY}, lrun[2] = {0.0f, 0.0f};  // rows g, g + 8
  const uint32_t ctr[2] = {((uint32_t)bh + pid0) * lm + (uint32_t)(row0 + g) * (uint32_t)M,
                           ((uint32_t)bh + pid0) * lm + (uint32_t)(row0 + g + 8) * (uint32_t)M};

  auto stage = [&](int tile) {
    float* ks = smem + (tile & 1) * 2 * kKeyTile * S;
    const int m0 = tile * kKeyTile, valid = min(kKeyTile, M - m0);
    stage_rows(ks, kb, m0, kKeyTile, valid, E, EP, S, he, vec);
    stage_rows(ks + kKeyTile * S, vb, m0, kKeyTile, valid, E, EP, S, he, vec);
    cp_async_commit();
  };
  stage(0);
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      stage(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tk = smem + (tile & 1) * 2 * kKeyTile * S;
    const int tile_keys = min(kKeyTile, M - tile * kKeyTile);
    for (int c0 = part * kFwdChunk; c0 < tile_keys; c0 += ksplit * kFwdChunk) {
      const float* ks = tk + c0 * S;
      const float* vs = tk + (kKeyTile + c0) * S;
      const int m0 = tile * kKeyTile + c0, valid = min(kFwdChunk, tile_keys - c0);

      // S = (q scale) K^T for the chunk, in registers.
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
        if (n * 8 >= valid) continue;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const float* kr = ks + (n * 8 + g) * S + kk * 8 + t;
          const float bf[2] = {kr[0], kr[4]};
          uint32_t bhi[2], blo[2];
          split(bf, bhi, blo);
          mma3(s[n], qh[kk], ql[kk], bhi, blo);
        }
      }
      // Row max over the chunk (quad shuffles), one rescale per chunk.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (n * 8 + 2 * t + (i & 1) >= valid) s[n][i] = -INFINITY;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(mrun[r], mx[r]);
        corr[r] = expf(mrun[r] - m_new);
        mrun[r] = m_new;
        lrun[r] *= corr[r];
      }
      // P = e^(s - max): every key in the row sum, kept keys in P V.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = expf(s[n][i] - mrun[i >> 1]);
          lrun[i >> 1] += p;
          if (rate > 0.0f &&
              uniform01(ctr[i >> 1] + (uint32_t)(m0 + n * 8 + 2 * t + (i & 1)), seed_mix) <
                  rate) {
            p = 0.0f;
          }
          s[n][i] = p;
        }
      }
      // P V into a fresh fragment: the tensor cores truncate when they add
      // to an fp32 accumulator, so long chains of adds are kept off acc,
      // which takes one rounded add per chunk.
      float pv[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) pv[kk][0] = pv[kk][1] = pv[kk][2] = pv[kk][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 >= valid) continue;
        const float af[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ahi[4], alo[4];
        split(af, ahi, alo);
        const float* vr = vs + (j * 8 + 2 * t) * S + g;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const float bf[2] = {vr[kk * 8], vr[S + kk * 8]};
          uint32_t bhi[2], blo[2];
          split(bf, bhi, blo);
          mma3(pv[kk], ahi, alo, bhi, blo);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[kk][i] = fmaf(acc[kk][i], corr[i >> 1], pv[kk][i]);
      }
    }
    __syncthreads();  // this tile's buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrun[r] += __shfl_xor_sync(0xffffffffu, lrun[r], 1);
    lrun[r] += __shfl_xor_sync(0xffffffffu, lrun[r], 2);
  }
  if (ksplit == 2) {  // merge the key halves: part 1 hands its state to part 0
    constexpr int W = KS * 4 + 4;
    float* xs = smem + (rw * 32 + lane) * W;  // the K/V tiles are no longer read
    if (part == 1) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) xs[kk * 4 + i] = acc[kk][i];
      }
      xs[KS * 4] = mrun[0];
      xs[KS * 4 + 1] = mrun[1];
      xs[KS * 4 + 2] = lrun[0];
      xs[KS * 4 + 3] = lrun[1];
    }
    __syncthreads();
    if (part == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xs[KS * 4 + r], m_new = fmaxf(mrun[r], m1);
      a0[r] = expf(mrun[r] - m_new);
      a1[r] = expf(m1 - m_new);
      lrun[r] = lrun[r] * a0[r] + xs[KS * 4 + 2 + r] * a1[r];
      mrun[r] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[kk][i] = acc[kk][i] * a0[i >> 1] + xs[kk * 4 + i] * a1[i >> 1];
      }
    }
  }
  const float inv[2] = {out_scale / lrun[0], out_scale / lrun[1]};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i >> 1) * 8, c = kk * 8 + 2 * t + (i & 1);
      if (r < L && c < E) store(o + ((size_t)b * L + r) * he + (size_t)h * E + c,
                                acc[kk][i] * inv[i >> 1]);
    }
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + r * 8;
      if (row < L) lse[(size_t)bh * L + row] = mrun[r] + logf(lrun[r]);
    }
  }
}

// The fp32 kernel, for launch_fwd (attention_common.cuh): q read from
// device memory, K and V tiles of EP + 4 floats a row.
template <int EP>
struct FwdF32 {
  using T = float;
  static constexpr bool kStagesQ = false;
  static int smem(int stages, int) {
    return stages * 2 * kKeyTile * (EP + 4) * (int)sizeof(float);
  }
  template <typename... A>
  static cudaError_t run(unsigned blocks, int threads, int smem, cudaStream_t stream, A... a) {
    const cudaError_t err = allow_smem<fwd_kernel<EP>>();
    if (err != cudaSuccess) return err;
    fwd_kernel<EP><<<blocks, threads, smem, stream>>>(a...);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace seist

// dtype: 0 = float32, 1 = bfloat16. lse: fp32 (N*H, L) or null (no row
// statistics written). A block has row_warps x ksplit warps (at most 4):
// row_warps groups of 16 rows, each over ksplit (1 or 2) key halves.
// lm = (L*M) mod 2^32, seed = a device pointer to the int32 dropout seed
// (read by every block, so a captured launch takes the seed written there
// before each replay), pid0 = the dropout counter's first batch-head slice
// (n0*H for a rank whose rows start at global row n0), out_scale = 1/(1 -
// rate) (1 when rate == 0).
extern "C" int pooled_attention_fwd(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int n, int l, int m, int heads,
                                    int e, int dtype, int row_warps, int ksplit,
                                    float scale, float rate,
                                    float out_scale, unsigned int lm, const void* seed,
                                    unsigned int pid0, void* stream) {
  if (n < 1 || l < 1 || m < 1 || heads < 1 || e < 1 || !(ksplit == 1 || ksplit == 2) ||
      !(row_warps == 1 || row_warps == 2 || row_warps == 4) || row_warps * ksplit > 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int* sd = static_cast<const int*>(seed);
  if (sd == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) {
    return (int)seist::launch_fwd<seist::FwdF32>(q, k, v, o, ls, n, l, m, heads, e, row_warps,
                                                 ksplit, scale, rate, out_scale, lm, sd, s, pid0);
  }
  if (dtype == 1) {
    return (int)seist::launch_fwd<seist::FwdBf16>(q, k, v, o, ls, n, l, m, heads, e,
                                                  row_warps, ksplit, scale, rate, out_scale,
                                                  lm, sd, s, pid0);
  }
  return (int)cudaErrorInvalidValue;
}
