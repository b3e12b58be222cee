// Pooled-KV multi-head attention backward (K2) on bf16 inputs, for Hopper's
// bf16 tensor cores (sm_90a). Included by pooled_attention_bwd.cu, whose C
// entry point takes dtype 1 here; the function, the residuals (o and K1's
// fp32 lse), the scratch and the launch plan are that file's, the outputs
// bf16.
//
// What bounds it. A batch-64 seist_l_dpk step's five calls cover 53.5 M
// (row, key) pairs and 6 GFLOP of products, 6 us on the bf16 tensor cores:
// the per-pair work binds (exp2, the hash, dS, the splits of Pd and dS, the
// instructions that feed the tensor cores). The design (attention_bf16.cuh
// for the fragments and the operands' precision):
//   * a block owns a tile of 128 keys of one (b, h), 8 warps of 16 keys
//     each, K and V bf16 in shared memory (a warp's K and V rows are the A
//     fragments of its products, read again for each piece of rows: held
//     in registers through the row loop they made E = 32 spill); row tiles
//     of 32 rows, 64 at E = 16 (q, g, o bf16, lse fp32) arrive by cp.async
//     in 16-byte vectors, double-buffered (the next tile's copies overlap
//     this tile's work), or by scalar loads for ragged E or misaligned
//     pointers;
//   * S^T = K Q^T and dPd^T = V G^T: one bf16 product per 16 of E (m16n8k8
//     at E = 8), exact products summed in fp32, Q's and G's rows read as B
//     fragments by ldmatrix without conversion. The scale is applied to the
//     fp32 scores (scale (q . k), about one fp32 rounding from the
//     reference's (q scale) . k);
//   * Pd and dS in registers, then packed once into bf16 hi and lo: the A
//     fragments of dV += Pd^T G and dK += dS^T Q (G's and Q's rows through
//     ldmatrix .trans; two products, lo first, into a fresh fragment per
//     piece of 16 or 32 rows), and dS^T (hi and lo) to one of two
//     shared-memory buffers;
//   * dQ = dS K for a row tile: each 16 x 8 output tile is summed over the
//     keys by one warp, dS^T read through ldmatrix .trans. It runs for the
//     tile before, after the pieces of this one, with no barrier of its own:
//     that tile's dS^T buffer was complete at this tile's first barrier;
//   * two barriers a row tile (its copies have landed; D is ready), and
//     three blocks an SM at E = 8 (two for E <= 32);
//   * no atomics: key-tile parts of dQ and row-range parts of dK and dV go
//     to fp32 scratch and a reduce launch sums them in order, as in the fp32
//     kernel (ops/_kernels.py::bwd_plan splits the rows, by this kernel's
//     cost model).
// The dropout decision is the forward's bit for bit: mix32 of the same
// counter (mix32_folded) against keep_threshold(rate).

#pragma once

#include "attention_bf16.cuh"

namespace seist {
namespace {

// Rows of a row tile: 64 at E = 16, where halving the tiles' barriers and
// D prologues paid (faster at seist_l_dpk's E = 16 shapes on an H100, still
// two blocks an SM); 32 elsewhere (at E = 32 the larger tile's shared
// memory left one block an SM, at E = 8 two instead of three). The launch
// plan reads it through bwd_bf16_shape; any rows_per_split works (a range's
// last tile is cut).
template <int EP>
constexpr int kBf16RowTile = EP == 16 ? 2 * kBwdRowTile : kBwdRowTile;

template <int EP>
struct BwdBf16Smem {
  static constexpr int S = kBf16Stride<EP>;  // q, g, o, k, v row stride, elements
  static constexpr int R = kBf16RowTile<EP>;
  static constexpr int DS = R + 8;             // dS^T row stride (a key's row), elements
  static constexpr int kTileBytes = kKeyTile * S * 2;       // K or V
  static constexpr int kStageBytes = 3 * R * S * 2 + 2 * R * 4;  // q, g, o, lse, D
  static constexpr int kDsBytes = kKeyTile * DS * 2;        // dS^T hi or lo
  static constexpr int kBytes = 2 * kTileBytes + 2 * kStageBytes + 4 * kDsBytes;
};

// acc (16 keys x EP) += X^T Y for X^T the warp's (16 keys x 16 J rows)
// operand as split A fragments (ah, al) and Y the rows' (16 J x EP) bf16
// tile y in shared memory, read through ldmatrix .trans: summed in a fresh
// fragment, lo products first, then added with rounding.
template <int KS, int J, int S>
__device__ __forceinline__ void accumulate_bf16(float (&acc)[KS][4], const uint32_t (&ah)[J][4],
                                                const uint32_t (&al)[J][4], const bf16* y,
                                                int lane) {
  float part[KS][4];
#pragma unroll
  for (int e = 0; e < KS; ++e) part[e][0] = part[e][1] = part[e][2] = part[e][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bf16* yr = y + j * 16 * S;
    if constexpr (KS == 1) {
      uint32_t f[2];
      ldsm_x2_t(f, yr + (lane & 15) * S);
      mma_k16(part[0], al[j], f[0], f[1]);
      mma_k16(part[0], ah[j], f[0], f[1]);
    } else {
#pragma unroll
      for (int e = 0; e < KS; e += 2) {
        uint32_t f[4];
        ldsm_x4_t(f, yr + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (e + (lane >> 4)) * 8);
        mma_k16(part[e], al[j], f[0], f[1]);
        mma_k16(part[e], ah[j], f[0], f[1]);
        mma_k16(part[e + 1], al[j], f[2], f[3]);
        mma_k16(part[e + 1], ah[j], f[2], f[3]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < KS; ++e) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] += part[e][i];
  }
}

// Blocks an SM: three at E = 8 (at most 85 registers a thread; 80 without
// a spill, and the b64 shapes ran faster on an H100 than with two), two for
// E <= 32 (128). The launch plan reads it through bwd_bf16_shape.
template <int EP>
constexpr int kBf16BwdBlocks = EP == 8 ? 3 : EP <= 32 ? 2 : 1;

template <int EP>
__global__ void __launch_bounds__(kBwdThreads, kBf16BwdBlocks<EP>) bwd_kernel_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const bf16* __restrict__ o, const float* __restrict__ lse,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dq_part, float* __restrict__ dk_part, float* __restrict__ dv_part,
    int N, int L, int M, int H, int E, int ktiles, int rows_per_split, float scale,
    float rate, float out_scale, uint32_t lm, const int* __restrict__ seed, bool vec,
    uint32_t pid0) {
  using Sm = BwdBf16Smem<EP>;
  constexpr int S = Sm::S, R = Sm::R, DS = Sm::DS;
  constexpr int KS = EP / 8;                  // 8-column tiles of dK, dV and dQ
  constexpr int KD = EP >= 16 ? EP / 16 : 1;  // depth steps of K Q^T and V G^T
  constexpr int RN = R / 8;
  constexpr int HN = EP >= 32 ? 2 : 4;        // 8-row tiles of a piece: 16 or 32 rows
  extern __shared__ __align__(16) unsigned char smem_bwd_bf16[];
  bf16* const ks = reinterpret_cast<bf16*>(smem_bwd_bf16);
  bf16* const vs = ks + kKeyTile * S;
  unsigned char* const stages = smem_bwd_bf16 + 2 * Sm::kTileBytes;
  // dS^T of a row tile, hi then lo, [key][row], in two buffers: the tile's
  // (it & 1) and the previous tile's, which dQ reads meanwhile.
  bf16* const ds_bufs = reinterpret_cast<bf16*>(stages + 2 * Sm::kStageBytes);

  const int NH = N * H;
  const int kt = blockIdx.x % ktiles, rest = blockIdx.x / ktiles;
  const int bh = rest % NH, split_id = rest / NH;
  const int b = bh / H, h = bh - b * H;
  const int k0 = kt * kKeyTile, kvalid = min(kKeyTile, M - k0);
  const int r_begin = split_id * rows_per_split;
  const int r_end = min(L, r_begin + rows_per_split);
  const int nrt = (r_end - r_begin + R - 1) / R;
  const size_t he = (size_t)H * E;
  const bf16* qb = q + (size_t)b * L * he + (size_t)h * E;
  const bf16* gb = g + (size_t)b * L * he + (size_t)h * E;
  const bf16* ob = o + (size_t)b * L * he + (size_t)h * E;
  const bf16* kb = k + (size_t)b * M * he + (size_t)h * E;
  const bf16* vb = v + (size_t)b * M * he + (size_t)h * E;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int kw = warp * 16;  // the warp's first key in the tile
  const bool keys_here = kw < kvalid;
  const float scale2 = scale * kLog2e;  // scores in log2 units
  const uint32_t thr = keep_threshold(rate);
  auto write_dq = [&](int row, int col, float x) {
    const size_t idx = ((size_t)b * L + row) * he + (size_t)h * E + col;
    if (dq_part == nullptr) {
      store(dq + idx, x * scale);
    } else {
      dq_part[(size_t)kt * N * L * he + idx] = x * scale;
    }
  };

  auto stage = [&](int it) {
    bf16* st = reinterpret_cast<bf16*>(stages + (it & 1) * Sm::kStageBytes);
    const int r0 = r_begin + it * R, rv = min(R, r_end - r0);
    stage_bf16<EP, S>(st, qb, r0, R, rv, E, he, vec);
    stage_bf16<EP, S>(st + R * S, gb, r0, R, rv, E, he, vec);
    stage_bf16<EP, S>(st + 2 * R * S, ob, r0, R, rv, E, he, vec);
    float* ls = reinterpret_cast<float*>(st + 3 * R * S);
    for (int i = threadIdx.x; i < R; i += kBwdThreads) {  // log2 units; P = 0 off the range
      ls[i] = i < rv ? lse[(size_t)bh * L + r0 + i] * kLog2e : INFINITY;
    }
    cp_async_commit();
  };
  stage_bf16<EP, S>(ks, kb, k0, kKeyTile, kvalid, E, he, vec);
  stage_bf16<EP, S>(vs, vb, k0, kKeyTile, kvalid, E, he, vec);
  stage(0);  // commits the K and V copies with the first row tile

  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int e = 0; e < KS; ++e) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[e][i] = dva[e][i] = 0.0f;
  }

  // dQ = dS K for the row tile from r0t, dS^T (hi, lo) at dh, dl: (R / 16) x
  // KS output tiles of 16 x 8, a warp's each, summed over the tile's keys
  // (the lo and hi products in two fresh fragments, two chains that
  // overlap, added at the end; a split of the keys among more warps cost
  // more in its reduction than the idle warps at E <= 16). dS (rows x keys)
  // is dS^T read through .trans, K's rows are B's rows (.trans). Keys past
  // kvalid hold dS = 0 and K = 0.
  auto dq_tile = [&](int r0t, const bf16* dh, const bf16* dl) {
    for (int task = warp; task < (R / 16) * KS; task += kBwdWarps) {
      const int mt = task / KS, nt = task - mt * KS;
      const int mi = lane >> 3;
      float clo[4] = {0.0f, 0.0f, 0.0f, 0.0f}, chi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kk = 0; kk < kvalid; kk += 16) {
        const int off = (kk + (lane & 7) + (mi >> 1) * 8) * DS + mt * 16 + (mi & 1) * 8;
        uint32_t ah[4], al[4], f[2];
        ldsm_x4_t(ah, dh + off);
        ldsm_x4_t(al, dl + off);
        ldsm_x2_t(f, ks + (kk + (lane & 15)) * S + nt * 8);
        mma_k16(clo, al, f[0], f[1]);
        mma_k16(chi, ah, f[0], f[1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mt * 16 + gq + (i >> 1) * 8, col = nt * 8 + 2 * t + (i & 1);
        if (r0t + row < r_end && col < E) write_dq(r0t + row, col, chi[i] + clo[i]);
      }
    }
  };

  for (int it = 0; it < nrt; ++it) {
    // This tile's copies land; past the barrier every read of the other
    // stage buffer (the tile before's) and of the other dS^T buffer (dQ of
    // the tile before that) is done, so the next tile's copies start now and
    // overlap this tile's work.
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nrt) stage(it + 1);
    bf16* const dsh = ds_bufs + (it & 1) * 2 * kKeyTile * DS;
    bf16* const dsl = dsh + kKeyTile * DS;
    const bf16* qs = reinterpret_cast<const bf16*>(stages + (it & 1) * Sm::kStageBytes);
    const bf16* gs = qs + R * S;
    const bf16* os = gs + R * S;
    float* ls = reinterpret_cast<float*>(stages + (it & 1) * Sm::kStageBytes + 6 * R * S);
    float* dm = ls + R;  // D, beside lse
    const int r0 = r_begin + it * R;

    {  // D = rowsum(g o): DT threads a row, a fixed order
      constexpr int DT = kBwdThreads / R;
      const int r = threadIdx.x / DT, part = threadIdx.x % DT;
      float d = 0.0f;
      for (int e = part; e < EP; e += DT) {
        d = fmaf(__bfloat162float(gs[r * S + e]), __bfloat162float(os[r * S + e]), d);
      }
#pragma unroll
      for (int w = 1; w < DT; w <<= 1) d += __shfl_xor_sync(0xffffffffu, d, w);
      if (part == 0) dm[r] = d;
    }
    __syncthreads();

    if (keys_here) {
      // The dropout seed lives in device memory (a captured graph replays
      // with the seed written there before each replay): read once a row tile.
      const uint32_t seed_fold =
          fold_seed((uint32_t)(*reinterpret_cast<const volatile int*>(seed)) * 0x9E3779B9u);
#pragma unroll 1
      for (int r8 = 0; r8 < RN; r8 += HN) {
        // S^T = K Q^T and dPd^T = V G^T: the warp's 16 keys x 8*HN rows
        // (K's and V's rows are A's, Q's and G's B's columns: no .trans).
        uint32_t ka[KD][4], va[KD][4];  // E = 8: [0][0..1]
        {
          const bf16* kr = ks + (kw + (lane & 15)) * S;
          const bf16* vr = vs + (kw + (lane & 15)) * S;
          if constexpr (EP == 8) {
            uint32_t f[2];
            ldsm_x2(f, kr);
            ka[0][0] = f[0];
            ka[0][1] = f[1];
            ldsm_x2(f, vr);
            va[0][0] = f[0];
            va[0][1] = f[1];
          } else {
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
              ldsm_x4(ka[kk], kr + kk * 16 + (lane >> 4) * 8);
              ldsm_x4(va[kk], vr + kk * 16 + (lane >> 4) * 8);
            }
          }
        }
        float sT[HN][4], pT[HN][4];
#pragma unroll
        for (int n = 0; n < HN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sT[n][i] = pT[n][i] = 0.0f;
        }
        if constexpr (EP == 8) {
#pragma unroll
          for (int n = 0; n < HN; n += 4) {
            uint32_t qf[4], gf[4];
            ldsm_x4(qf, qs + ((r8 + n) * 8 + lane) * S);
            ldsm_x4(gf, gs + ((r8 + n) * 8 + lane) * S);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mma_k8(sT[n + i], ka[0][0], ka[0][1], qf[i]);
              mma_k8(pT[n + i], va[0][0], va[0][1], gf[i]);
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < HN; n += 2) {
            const int row = (r8 + n) * 8 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
              const int col = kk * 16 + ((lane >> 3) & 1) * 8;
              uint32_t qf[4], gf[4];
              ldsm_x4(qf, qs + row * S + col);
              ldsm_x4(gf, gs + row * S + col);
              mma_k16(sT[n], ka[kk], qf[0], qf[1]);
              mma_k16(sT[n + 1], ka[kk], qf[2], qf[3]);
              mma_k16(pT[n], va[kk], gf[0], gf[1]);
              mma_k16(pT[n + 1], va[kk], gf[2], gf[3]);
            }
          }
        }
        // Pd and dS in place of the score fragments. The dropout counter of
        // (row, key) is cbase + (row - first row) M + (key - first key).
        const uint32_t cbase = ((uint32_t)bh + pid0) * lm +
                               (uint32_t)(r0 + r8 * 8 + 2 * t) * (uint32_t)M +
                               (uint32_t)(k0 + kw + gq);
        // Two copies of the loop, chosen per launch: at rate 0 no hash runs.
        auto probabilities = [&](auto dropout) {
#pragma unroll
          for (int n = 0; n < HN; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int key = kw + gq + (i >> 1) * 8, row = (r8 + n) * 8 + 2 * t + (i & 1);
              const float p =
                  key < kvalid ? exp2_approx(fmaf(sT[n][i], scale2, -ls[row])) : 0.0f;
              if constexpr (decltype(dropout)::value) {
                // Pd = keep p/(1 - rate); dS = p (keep dPd/(1 - rate) - D).
                const bool keep = mix32_folded(cbase + (uint32_t)(n * 8 + (i & 1)) * (uint32_t)M +
                                                   (uint32_t)((i >> 1) * 8),
                                               seed_fold) >= thr;
                const float pk = p * out_scale, pd = p * dm[row];
                pT[n][i] = keep ? fmaf(pk, pT[n][i], -pd) : -pd;
                sT[n][i] = keep ? pk : 0.0f;
              } else {
                pT[n][i] = p * (pT[n][i] - dm[row]);
                sT[n][i] = p;
              }
            }
          }
        };
        if (thr != 0u) {
          probabilities(std::true_type{});
        } else {
          probabilities(std::false_type{});
        }
        // Pd^T and dS^T as split A fragments over 16 rows each; dS^T's
        // also to shared memory (a[0], a[1]: keys gq, gq + 8 at rows 2t,
        // 2t + 1 of the first 8; a[2], a[3] the same of the next 8).
        uint32_t pdh[HN / 2][4], pdl[HN / 2][4], dsh_a[HN / 2][4], dsl_a[HN / 2][4];
#pragma unroll
        for (int j = 0; j < HN / 2; ++j) {
          pack_a(sT[2 * j], sT[2 * j + 1], pdh[j], pdl[j]);
          pack_a(pT[2 * j], pT[2 * j + 1], dsh_a[j], dsl_a[j]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int off = (kw + gq + (a & 1) * 8) * DS + (r8 + 2 * j + (a >> 1)) * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(dsh + off) = dsh_a[j][a];
            *reinterpret_cast<uint32_t*>(dsl + off) = dsl_a[j][a];
          }
        }
        // dV += Pd^T G, dK += dS^T Q (unscaled; dK is scaled when written).
        accumulate_bf16<KS, HN / 2, S>(dva, pdh, pdl, gs + r8 * 8 * S, lane);
        accumulate_bf16<KS, HN / 2, S>(dka, dsh_a, dsl_a, qs + r8 * 8 * S, lane);
      }
    } else {
      for (int i = lane; i < 16 * R; i += 32) {
        const int off = (kw + i / R) * DS + i % R;
        dsh[off] = dsl[off] = __float2bfloat16(0.0f);
      }
    }
    // dQ of the tile before, whose dS^T every warp finished before this
    // tile's first barrier: it overlaps the other warps' pieces.
    if (it > 0) {
      const bf16* prev = ds_bufs + ((it - 1) & 1) * 2 * kKeyTile * DS;
      dq_tile(r0 - R, prev, prev + kKeyTile * DS);
    }
  }
  __syncthreads();
  {
    const bf16* last = ds_bufs + ((nrt - 1) & 1) * 2 * kKeyTile * DS;
    dq_tile(r_begin + (nrt - 1) * R, last, last + kKeyTile * DS);
  }

  if (!keys_here) return;
#pragma unroll
  for (int e = 0; e < KS; ++e) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kw + gq + (i >> 1) * 8, col = e * 8 + 2 * t + (i & 1);
      if (key < kvalid && col < E) {
        const size_t idx = ((size_t)b * M + k0 + key) * he + (size_t)h * E + col;
        if (dk_part == nullptr) {
          store(dk + idx, dka[e][i] * scale);
          store(dv + idx, dva[e][i]);
        } else {
          const size_t off = (size_t)split_id * N * M * he + idx;
          dk_part[off] = dka[e][i] * scale;
          dv_part[off] = dva[e][i];
        }
      }
    }
  }
}

// The bf16 kernel, for launch_bwd (attention_common.cuh).
template <int EP>
struct BwdBf16 {
  using T = bf16;
  template <typename... A>
  static cudaError_t run(unsigned blocks, cudaStream_t stream, A... a) {
    const cudaError_t err = allow_smem<bwd_kernel_bf16<EP>>();
    if (err != cudaSuccess) return err;
    bwd_kernel_bf16<EP><<<blocks, kBwdThreads, BwdBf16Smem<EP>::kBytes, stream>>>(a...);
    return cudaGetLastError();
  }
};

// What the launch plan needs of the kernel at head width e (the C query
// pooled_attention_bwd_bf16_shape): its row tile and blocks an SM.
inline cudaError_t bwd_bf16_shape(int e, int* row_tile, int* blocks_per_sm) {
  return with_padded_width(e, [&](auto ep) {
    *row_tile = kBf16RowTile<decltype(ep)::value>;
    *blocks_per_sm = kBf16BwdBlocks<decltype(ep)::value>;
    return cudaSuccess;
  });
}

}  // namespace
}  // namespace seist
