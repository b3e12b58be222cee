// Pooled-KV multi-head attention forward (K1) on bf16 inputs, for Hopper's
// bf16 tensor cores (sm_90a). Included by pooled_attention_fwd.cu, whose C
// entry point takes dtype 1 here; the function is that file's (and the TPU
// kernel's, seist_tpu/ops/pallas_attention.py::_fwd_kernel), the output is
// bf16 and the row statistics fp32.
//
// What bounds it. At seist_l_dpk's shapes a launch moves under 1 MB and its
// products take well under a microsecond on the bf16 tensor cores: what
// decides is latency, the per-score work (the scale, exp2, the hash when
// rate > 0, the split of P) and the instructions that feed the tensor
// cores. The design (attention_bf16.cuh for the fragments and the operands'
// precision):
//   * the block's q rows and the K and V tiles of 128 keys stay bf16 in
//     shared memory, copied with cp.async in 16-byte vectors when E % 8 == 0
//     and the pointers are 16-byte aligned (scalar loads otherwise), K and V
//     double-buffered when M spans more than one tile; every fragment is
//     read with ldmatrix (V's through .trans), with no conversion;
//   * a warp owns 16 query rows; S = Q K^T is one bf16 product per 16 of E
//     (m16n8k8 at E = 8), exact products summed in fp32, and the scale is
//     applied to the fp32 scores with log2 e folded in: scale (q . k) where
//     the reference computes (q scale) . k, about one fp32 rounding apart;
//   * online softmax over chunks of 64 keys in exp2 units, as the fp32
//     kernel (quad shuffles, one rescale per chunk, two warps per row group
//     when the plan says so, merged in a fixed order);
//   * O = P V with P split into bf16 hi and lo from the score fragments as
//     they are (pack_a): two products, lo first, into a fresh fragment per
//     chunk, added to the running one with rounding.
// The dropout decision is the fp32 kernel's bit for bit: mix32 of the same
// counter (mix32_folded) against keep_threshold(rate).

#pragma once

#include "attention_bf16.cuh"

namespace seist {
namespace {

// Six blocks an SM for E <= 16 (at most 85 registers a thread), five for
// E = 32: with the block size alone ptxas kept 80-96 registers and spilled
// a few values, and with four blocks the b64 launches ran slower on an H100.
template <int EP>
__global__ void __launch_bounds__(128, EP <= 16 ? 6 : EP <= 32 ? 5 : 1) fwd_kernel_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int L, int M, int H, int E,
    int row_tiles, int ksplit, float scale, float rate, float out_scale, uint32_t lm,
    const int* __restrict__ seed, bool vec, uint32_t pid0) {
  constexpr int S = kBf16Stride<EP>;
  constexpr int KS = EP / 8;                  // 8-column tiles of O
  constexpr int KD = EP >= 16 ? EP / 16 : 1;  // depth steps of Q K^T
  constexpr int NT = kFwdChunk / 8;           // 8-key column tiles of a chunk
  constexpr int kTile = kKeyTile * S;         // elements of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_fwd_bf16[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_fwd_bf16);
  // The dropout seed lives in device memory (a captured graph replays with
  // the seed its caller writes there before each replay): read once.
  const uint32_t seed_fold = fold_seed((uint32_t)__ldg(seed) * 0x9E3779B9u);
  const uint32_t thr = keep_threshold(rate);
  const float scale2 = scale * kLog2e;  // scores in log2 units

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_warps = (blockDim.x >> 5) / ksplit;
  const int part = warp % ksplit, rw = warp / ksplit;
  const int rt = blockIdx.x % row_tiles, bh = blockIdx.x / row_tiles;
  const int b = bh / H, h = bh - b * H;
  const int qrow0 = rt * row_warps * kWarpRows;  // the block's first row
  const int row0 = qrow0 + rw * kWarpRows;       // the warp's
  const size_t he = (size_t)H * E;
  const bf16* qb = q + (size_t)b * L * he + (size_t)h * E;
  const bf16* kb = k + (size_t)b * M * he + (size_t)h * E;
  const bf16* vb = v + (size_t)b * M * he + (size_t)h * E;
  const int ntiles = (M + kKeyTile - 1) / kKeyTile;
  bf16* const qs = sm + (ntiles > 1 ? 2 : 1) * 2 * kTile;  // the block's q rows

  auto stage = [&](int tile) {
    bf16* ks = sm + (tile & 1) * 2 * kTile;
    const int m0 = tile * kKeyTile, valid = min(kKeyTile, M - m0);
    stage_bf16<EP, S>(ks, kb, m0, kKeyTile, valid, E, he, vec);
    stage_bf16<EP, S>(ks + kTile, vb, m0, kKeyTile, valid, E, he, vec);
    cp_async_commit();
  };
  stage_bf16<EP, S>(qs, qb, qrow0, row_warps * kWarpRows, L - qrow0, E, he, vec);
  stage(0);  // commits q's copies with the first tile's

  uint32_t qa[KD][4];  // the warp's q rows as A fragments (E = 8: qa[0][0..1])
  float acc[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) acc[kk][0] = acc[kk][1] = acc[kk][2] = acc[kk][3] = 0.0f;
  float mrun[2] = {-INFINITY, -INFINITY}, lrun[2] = {0.0f, 0.0f};  // rows g, g + 8
  const uint32_t ctr[2] = {((uint32_t)bh + pid0) * lm + (uint32_t)(row0 + g) * (uint32_t)M,
                           ((uint32_t)bh + pid0) * lm + (uint32_t)(row0 + g + 8) * (uint32_t)M};

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      stage(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile == 0) {
      const bf16* qw = qs + rw * kWarpRows * S;
      if constexpr (EP == 8) {
        uint32_t a[2];
        ldsm_x2(a, qw + (lane & 15) * S);
        qa[0][0] = a[0];
        qa[0][1] = a[1];
      } else {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(qa[kk], qw + (lane & 15) * S + kk * 16 + (lane >> 4) * 8);
        }
      }
    }
    const bf16* tk = sm + (tile & 1) * 2 * kTile;
    const int tile_keys = min(kKeyTile, M - tile * kKeyTile);
    for (int c0 = part * kFwdChunk; c0 < tile_keys; c0 += ksplit * kFwdChunk) {
      const bf16* ks = tk + c0 * S;
      const bf16* vs = tk + kTile + c0 * S;
      const int m0 = tile * kKeyTile + c0, valid = min(kFwdChunk, tile_keys - c0);

      // S = Q K^T for the chunk (K's rows are B's columns: no .trans).
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      if constexpr (EP == 8) {
#pragma unroll
        for (int n = 0; n < NT; n += 4) {
          if (n * 8 >= valid) continue;
          uint32_t kf[4];
          ldsm_x4(kf, ks + (n * 8 + lane) * S);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_k8(s[n + i], qa[0][0], qa[0][1], kf[i]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n * 8 >= valid) continue;
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            uint32_t kf[4];
            ldsm_x4(kf, ks + (n * 8 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                            ((lane >> 3) & 1) * 8);
            mma_k16(s[n], qa[kk], kf[0], kf[1]);
            mma_k16(s[n + 1], qa[kk], kf[2], kf[3]);
          }
        }
      }
      // Scaled scores in log2 units; row max over the chunk, one rescale.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = n * 8 + 2 * t + (i & 1) < valid ? s[n][i] * scale2 : -INFINITY;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(mrun[r], mx[r]);
        corr[r] = exp2_approx(mrun[r] - m_new);
        mrun[r] = m_new;
        lrun[r] *= corr[r];
      }
      // P = 2^(s - max): every key in the row sum, kept keys in P V.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2_approx(s[n][i] - mrun[i >> 1]);
          lrun[i >> 1] += p;
          if (thr != 0u &&
              mix32_folded(ctr[i >> 1] + (uint32_t)(m0 + n * 8 + 2 * t + (i & 1)), seed_fold) <
                  thr) {
            p = 0.0f;
          }
          s[n][i] = p;
        }
      }
      // O += P V: P's fragments of two 8-key tiles are one A operand over
      // 16 keys, split into hi and lo; V's rows are B's rows (.trans).
      float pv[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) pv[kk][0] = pv[kk][1] = pv[kk][2] = pv[kk][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j * 16 >= valid) continue;
        uint32_t ah[4], al[4];
        pack_a(s[2 * j], s[2 * j + 1], ah, al);
        const bf16* vr = vs + j * 16 * S;
        if constexpr (EP == 8) {
          uint32_t vf[2];
          ldsm_x2_t(vf, vr + (lane & 15) * S);
          mma_k16(pv[0], al, vf[0], vf[1]);
          mma_k16(pv[0], ah, vf[0], vf[1]);
        } else {
#pragma unroll
          for (int nt = 0; nt < KS; nt += 2) {
            uint32_t vf[4];
            ldsm_x4_t(vf, vr + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (nt + (lane >> 4)) * 8);
            mma_k16(pv[nt], al, vf[0], vf[1]);
            mma_k16(pv[nt], ah, vf[0], vf[1]);
            mma_k16(pv[nt + 1], al, vf[2], vf[3]);
            mma_k16(pv[nt + 1], ah, vf[2], vf[3]);
          }
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
    float* xs = reinterpret_cast<float*>(smem_fwd_bf16) + (rw * 32 + lane) * W;  // K/V tiles
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
      a0[r] = exp2_approx(mrun[r] - m_new);
      a1[r] = exp2_approx(m1 - m_new);
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
  // lrun >= 1 (the row's largest term is 2^0): __fdividef's 2 ulp suffice,
  // and IEEE division would call a slow-path subroutine (spilling around it).
  const float inv[2] = {__fdividef(out_scale, lrun[0]), __fdividef(out_scale, lrun[1])};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i >> 1) * 8, c = kk * 8 + 2 * t + (i & 1);
      if (r < L && c < E) {
        o[((size_t)b * L + r) * he + (size_t)h * E + c] = __float2bfloat16(acc[kk][i] * inv[i >> 1]);
      }
    }
  }
  if (lse != nullptr && t == 0) {  // natural-log units, as the fp32 kernel's
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + r * 8;
      if (row < L) lse[(size_t)bh * L + row] = (mrun[r] + log2f(lrun[r])) * (1.0f / kLog2e);
    }
  }
}

// The bf16 kernel, for launch_fwd (attention_common.cuh): the K and V
// tiles (two stages when M spans more than one), then the block's q rows,
// kBf16Stride elements a row; the merge of two key halves reuses the tiles
// (row_warps * 32 * (EP/2 + 4) floats, at most a quarter of one stage).
template <int EP>
struct FwdBf16 {
  using T = bf16;
  static constexpr bool kStagesQ = true;
  static int smem(int stages, int row_warps) {
    return (stages * 2 * kKeyTile + row_warps * kWarpRows) * kBf16Stride<EP> * (int)sizeof(bf16);
  }
  template <typename... A>
  static cudaError_t run(unsigned blocks, int threads, int smem, cudaStream_t stream, A... a) {
    const cudaError_t err = allow_smem<fwd_kernel_bf16<EP>>();
    if (err != cudaSuccess) return err;
    fwd_kernel_bf16<EP><<<blocks, threads, smem, stream>>>(a...);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace seist
