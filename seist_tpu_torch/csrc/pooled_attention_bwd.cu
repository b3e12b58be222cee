// Pooled-KV multi-head attention backward (K2), with the forward's
// post-softmax dropout, for Hopper (sm_90a).
//
// Replaces seist_tpu/ops/pallas_attention.py::_bwd_kernel (reached through
// _fused_bwd -> _call_fused -> pl.pallas_call). For every batch element b
// and head h, from q, k, v, the forward's output o and row statistics lse
// (csrc/pooled_attention_fwd.cu), the seed and the upstream gradient g:
//   P   = exp((q_h scale) k_h^T - lse)                 (L x M)
//   Pd  = dropout(P),  dPd = g_h v_h^T,  dP = dropout(dPd)  (the same mask)
//   D   = rowsum(dP * P) = rowsum(g_h * o_h)
//   dV  = Pd^T g_h,  dS = P (dP - D)
//   dQ  = dS k_h scale,  dK = dS^T q_h scale
// D = rowsum(g o) holds with dropout too: both sides equal
// sum_j Pd_ij (g_i . v_j). q, g, o and dq are (N, L, H*E), k, v, dk and dv
// are (N, M, H*E), contiguous, float32 (this file's kernel: fp32
// arithmetic) or bfloat16 (bwd_kernel_bf16, pooled_attention_bwd_bf16.cuh,
// on the bf16 tensor cores); lse is fp32 (N*H, L); the outputs take the
// input type. The dropout mask
// is the forward's bit for bit: the counter hash of element
// pid*(L*M) + row*M + col, pid = b*H + h, wrapped mod 2^32.
//
// What bounds it. A call reads q, k, v, g, o and lse and writes dq, dk, dv:
// itemsize*N*H*E*(4L + 4M) + 4*N*H*L bytes. Its products (QK^T, g V^T, dV,
// dK, dQ) are 10*N*H*L*M*E operations: on the CUDA cores in fp32 they bind
// (0.09 ms for a batch-64 seist_l_dpk step); in 3xTF32 on the tensor cores
// they take 0.037 ms, and then one exp and about 11 integer operations of
// the hash per (row, key) pair, and the instructions that feed the tensor
// cores, weigh as much. The design:
//   * one pass over the row-key pairs: with lse from the forward, P needs no
//     statistics walk, and D is one E-wide dot product per row (the row
//     tile's prologue), so each pair's score, g.v, exp and hash are
//     computed once;
//   * a block owns a tile of 128 keys of one (b, h) (on the main path all of
//     M) in shared memory, 8 warps of 16 keys each, and walks row tiles of
//     32 rows (q, g, o, lse) through a cp.async double buffer. Per row tile a
//     warp computes S^T = K Q^T and dPd^T = V G^T on tensor cores (mma.sync
//     m16n8k8, 3xTF32 as in attention_common.cuh), forms Pd and dS in
//     registers, and adds
//     Pd^T G and dS^T Q to dV and dK in registers (the score fragments are
//     the A operands as they are; each row tile's products go to a fresh
//     fragment first, since the tensor cores truncate when they add to an
//     fp32 accumulator). From E = 16 on a row tile is worked in two halves
//     of 16 rows, so that with dK and dV everything fits in 128 registers
//     and two blocks share an SM without spilling. dS^T goes to shared
//     memory; then dQ = dS K for the row tile: each 16 x 8 output tile is
//     summed over the keys by one warp, or by 2-4 warps each over a part
//     of the keys (E <= 16, so that every warp works), the parts then added
//     in a fixed order;
//   * no atomics: when M spans several key tiles, each writes its dQ part
//     to fp32 scratch and a reduce launch sums them in tile order; when the
//     rows are split into ranges to balance the SMs (ops/_kernels.py::
//     bwd_plan, from the device's SM count), dK and dV parts are summed the
//     same way, both in one launch. The result does not change from run to
//     run.
//
// Built by seist_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C function returns cudaGetLastError()
// after each launch, and the first error stops it.

#include "attention_common.cuh"
#include "pooled_attention_bwd_bf16.cuh"

namespace seist {
namespace {

template <int EP>
struct BwdSmem {
  static constexpr int S = EP + 4;                  // row stride, floats
  static constexpr int R = kBwdRowTile;
  static constexpr int DS = R + 8;                  // dS^T row stride (a key's row)
  static constexpr int QT = (R / 16) * (EP / 8);    // 16 x 8 tiles of a row tile's dQ
  static constexpr int KP = QT >= kBwdWarps ? 1 : kBwdWarps / QT;  // key parts per tile
  static constexpr int kStage = 3 * R * S + 2 * R;  // q, g, o, lse, D
  static constexpr int kFloats =
      2 * kKeyTile * S + 2 * kStage + kKeyTile * DS + (KP > 1 ? KP * R * EP : 0);
};

// acc (16 keys x EP) += X^T Y for X the warp's (16 keys x R rows) score
// fragments x and Y the row tile's (R x EP) rows y in shared memory: the
// fragments are the A operands as they are (depth slot t is row 2t, slot
// t + 4 row 2t + 1), summed in a fresh fragment, then added with rounding.
template <int KS, int RN, int S>
__device__ __forceinline__ void accumulate_t(float (&acc)[KS][4], const float (&x)[RN][4],
                                             const float* y, int gq, int t) {
  float part[KS][4];
#pragma unroll
  for (int e = 0; e < KS; ++e) part[e][0] = part[e][1] = part[e][2] = part[e][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const float af[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
    uint32_t ah[4], al[4];
    split(af, ah, al);
    const float* yr = y + (j * 8 + 2 * t) * S + gq;
#pragma unroll
    for (int e = 0; e < KS; ++e) {
      const float bf[2] = {yr[e * 8], yr[S + e * 8]};
      uint32_t bh[2], bl[2];
      split(bf, bh, bl);
      mma3(part[e], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int e = 0; e < KS; ++e) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] += part[e][i];
  }
}

// Two blocks an SM for E <= 32 (at most 128 registers a thread).
template <int EP>
__global__ void __launch_bounds__(kBwdThreads, EP <= 32 ? 2 : 1) bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ o, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dq_part, float* __restrict__ dk_part, float* __restrict__ dv_part,
    int N, int L, int M, int H, int E, int ktiles, int rows_per_split, float scale,
    float rate, float out_scale, uint32_t lm, const int* __restrict__ seed, bool vec,
    uint32_t pid0) {
  using Sm = BwdSmem<EP>;
  constexpr int S = Sm::S, R = Sm::R, DS = Sm::DS, QT = Sm::QT, KP = Sm::KP;
  constexpr int KS = EP / 8, RN = R / 8;
  constexpr int HN = EP >= 16 ? RN / 2 : RN;  // 8-row blocks of a piece
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kKeyTile * S;
  float* stages = vs + kKeyTile * S;
  float* dss = stages + 2 * Sm::kStage;  // dS^T: [key][row]
  float* qpart = dss + kKeyTile * DS;     // dQ key parts: [part][row][col]

  const int NH = N * H;
  const int kt = blockIdx.x % ktiles, rest = blockIdx.x / ktiles;
  const int bh = rest % NH, split_id = rest / NH;
  const int b = bh / H, h = bh - b * H;
  const int k0 = kt * kKeyTile, kvalid = min(kKeyTile, M - k0);
  const int r_begin = split_id * rows_per_split;
  const int r_end = min(L, r_begin + rows_per_split);
  const int nrt = (r_end - r_begin + R - 1) / R;
  const size_t he = (size_t)H * E;
  const float* qb = q + (size_t)b * L * he + (size_t)h * E;
  const float* gb = g + (size_t)b * L * he + (size_t)h * E;
  const float* ob = o + (size_t)b * L * he + (size_t)h * E;
  const float* kb = k + (size_t)b * M * he + (size_t)h * E;
  const float* vb = v + (size_t)b * M * he + (size_t)h * E;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int kw = warp * 16;  // the warp's first key in the tile
  const bool keys_here = kw < kvalid;
  const float scale2 = scale * kLog2e;  // scores in log2 units
  auto write_dq = [&](int row, int col, float x) {
    const size_t idx = ((size_t)b * L + row) * he + (size_t)h * E + col;
    if (dq_part == nullptr) {
      store(dq + idx, x * scale);
    } else {
      dq_part[(size_t)kt * N * L * he + idx] = x * scale;
    }
  };

  auto stage = [&](int it) {
    float* st = stages + (it & 1) * Sm::kStage;
    const int r0 = r_begin + it * R, rv = min(R, r_end - r0);
    stage_rows(st, qb, r0, R, rv, E, EP, S, he, vec);
    stage_rows(st + R * S, gb, r0, R, rv, E, EP, S, he, vec);
    stage_rows(st + 2 * R * S, ob, r0, R, rv, E, EP, S, he, vec);
    float* ls = st + 3 * R * S;
    for (int i = threadIdx.x; i < R; i += kBwdThreads) {  // log2 units; P = 0 off the range
      ls[i] = i < rv ? lse[(size_t)bh * L + r0 + i] * kLog2e : INFINITY;
    }
    cp_async_commit();
  };
  stage_rows(ks, kb, k0, kKeyTile, kvalid, E, EP, S, he, vec);
  stage_rows(vs, vb, k0, kKeyTile, kvalid, E, EP, S, he, vec);
  stage(0);  // commits the K and V copies with the first row tile

  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int e = 0; e < KS; ++e) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[e][i] = dva[e][i] = 0.0f;
  }

  for (int it = 0; it < nrt; ++it) {
    if (it + 1 < nrt) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* qs = stages + (it & 1) * Sm::kStage;
    const float* gs = qs + R * S;
    const float* os = gs + R * S;
    const float* ls = os + R * S;
    float* dm = qs + 3 * R * S + R;  // D, beside lse
    const int r0 = r_begin + it * R;

    {  // D = rowsum(g o): kDThreads threads a row, a fixed order
      const int r = threadIdx.x / kDThreads, part = threadIdx.x % kDThreads;
      float d = 0.0f;
      for (int e = part; e < EP; e += kDThreads) d = fmaf(gs[r * S + e], os[r * S + e], d);
#pragma unroll
      for (int w = 1; w < kDThreads; w <<= 1) d += __shfl_xor_sync(0xffffffffu, d, w);
      if (part == 0) dm[r] = d;
    }
    __syncthreads();

    if (keys_here) {
      // The row tile in pieces of HN 8-row blocks: two pieces of 16 rows
      // from E = 16 on, which keeps the score fragments in 128 registers
      // beside dK and dV.
#pragma unroll 1
      for (int r8 = 0; r8 < RN; r8 += HN) {
        // S^T = K Q^T and dPd^T = V G^T: the warp's 16 keys x 8*HN rows.
        float sT[HN][4], pT[HN][4];
#pragma unroll
        for (int n = 0; n < HN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sT[n][i] = pT[n][i] = 0.0f;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const float* kr = ks + (kw + gq) * S + kk * 8 + t;
          const float* vr = vs + (kw + gq) * S + kk * 8 + t;
          const float ka[4] = {kr[0], kr[8 * S], kr[4], kr[8 * S + 4]};
          const float va[4] = {vr[0], vr[8 * S], vr[4], vr[8 * S + 4]};
          uint32_t kh[4], kl[4], vh[4], vl[4];
          split(ka, kh, kl);
          split(va, vh, vl);
#pragma unroll
          for (int n = 0; n < HN; ++n) {
            const float* qr = qs + ((r8 + n) * 8 + gq) * S + kk * 8 + t;
            const float* gr = gs + ((r8 + n) * 8 + gq) * S + kk * 8 + t;
            const float qf[2] = {qr[0], qr[4]}, gf[2] = {gr[0], gr[4]};
            uint32_t qh[2], ql[2], gh[2], gl[2];
            split(qf, qh, ql);
            split(gf, gh, gl);
            mma3(sT[n], kh, kl, qh, ql);
            mma3(pT[n], vh, vl, gh, gl);
          }
        }
        // Pd and dS in place of the score fragments; dS to shared memory.
        // The dropout seed lives in device memory (a captured graph replays
        // with the seed written there before each replay); it is read here,
        // once per row tile, so that no register holds it through the
        // products (E = 32 in fp32 would spill).
        const uint32_t seed_mix =
            (uint32_t)(*reinterpret_cast<const volatile int*>(seed)) * 0x9E3779B9u;
#pragma unroll
        for (int n = 0; n < HN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = kw + gq + (i >> 1) * 8, row = (r8 + n) * 8 + 2 * t + (i & 1);
            const float p = key < kvalid ? exp2f(fmaf(sT[n][i], scale2, -ls[row])) : 0.0f;
            const bool keep =
                !(rate > 0.0f &&
                  uniform01(((uint32_t)bh + pid0) * lm + (uint32_t)(r0 + row) * (uint32_t)M +
                                (uint32_t)(k0 + key),
                            seed_mix) < rate);
            const float ds = p * ((keep ? pT[n][i] * out_scale : 0.0f) - dm[row]);
            sT[n][i] = keep ? p * out_scale : 0.0f;
            pT[n][i] = ds;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // rows 2t, 2t+1 of keys gq, gq + 8
            *reinterpret_cast<float2*>(dss + (kw + gq + r * 8) * DS + (r8 + n) * 8 + 2 * t) =
                make_float2(pT[n][2 * r], pT[n][2 * r + 1]);
          }
        }
        // dV += Pd^T G, then dK += dS^T Q (G's and Q's rows read at 2t,
        // 2t+1), each into a fresh fragment: the tensor cores truncate when
        // they add to an fp32 accumulator, so dva and dka take one rounded
        // add per piece.
        accumulate_t<KS, HN, S>(dva, sT, gs + r8 * 8 * S, gq, t);
        accumulate_t<KS, HN, S>(dka, pT, qs + r8 * 8 * S, gq, t);
      }
    } else {
      for (int i = lane; i < 16 * R; i += 32) dss[(kw + i / R) * DS + i % R] = 0.0f;
    }
    __syncthreads();

    // dQ = dS K for the row tile: QT output tiles of 16 x 8, each summed
    // over the tile's keys by KP warps (one key part each), the parts then
    // added in part order.
    for (int task = warp; task < QT * KP; task += kBwdWarps) {
      const int ot = task % QT, kp = task / QT;
      const int mt = ot / KS, nt = ot - mt * KS;
      const int kb0 = kp * (kKeyTile / KP), kb1 = min(kvalid, kb0 + kKeyTile / KP);
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kk = kb0; kk < kb1; kk += 8) {
        const float* ar = dss + (kk + t) * DS + mt * 16 + gq;
        const float* br = ks + (kk + t) * S + nt * 8 + gq;
        const float af[4] = {ar[0], ar[8], ar[4 * DS], ar[4 * DS + 8]};
        const float bf[2] = {br[0], br[4 * S]};
        uint32_t ah[4], al[4], bh2[2], bl2[2];
        split(af, ah, al);
        split(bf, bh2, bl2);
        mma3(c, ah, al, bh2, bl2);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mt * 16 + gq + (i >> 1) * 8, col = nt * 8 + 2 * t + (i & 1);
        if constexpr (KP > 1) {
          qpart[(kp * R + row) * EP + col] = c[i];
        } else if (r0 + row < r_end && col < E) {
          write_dq(r0 + row, col, c[i]);
        }
      }
    }
    if constexpr (KP > 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < R * EP; i += kBwdThreads) {
        const int row = i / EP, col = i - row * EP;
        if (r0 + row >= r_end || col >= E) continue;
        float sum = qpart[i];
#pragma unroll
        for (int p = 1; p < KP; ++p) sum += qpart[p * R * EP + i];
        write_dq(r0 + row, col, sum);
      }
    }
    __syncthreads();  // the stage and dS buffers are reused
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

// The fp32 kernel, for launch_bwd (attention_common.cuh).
template <int EP>
struct BwdF32 {
  using T = float;
  template <typename... A>
  static cudaError_t run(unsigned blocks, cudaStream_t stream, A... a) {
    const cudaError_t err = allow_smem<bwd_kernel<EP>>();
    if (err != cudaSuccess) return err;
    bwd_kernel<EP><<<blocks, kBwdThreads, BwdSmem<EP>::kFloats * (int)sizeof(float), stream>>>(
        a...);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace seist

// dtype: 0 = float32, 1 = bfloat16. lse: the forward's fp32 (N*H, L) row
// statistics. The rows are split into `splits` ranges of rows_per_split (a
// multiple of the 32-row tile). Scratch, fp32, used only when needed:
// dq_part holds ceil(M/128) slabs of N*L*H*E (when M > 128), dk_part and
// dv_part `splits` slabs of N*M*H*E each (when splits > 1). lm = (L*M) mod
// 2^32, seed = a device pointer to the int32 dropout seed and pid0 the
// counter's first batch-head slice (as the forward's), out_scale = 1/(1 -
// rate) (1 when rate == 0).
extern "C" int pooled_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* g, const void* o, const void* lse,
                                    void* dq, void* dk, void* dv, void* dq_part,
                                    void* dk_part, void* dv_part, int n, int l, int m,
                                    int heads, int e, int dtype, int splits,
                                    int rows_per_split, float scale, float rate,
                                    float out_scale, unsigned int lm, const void* seed,
                                    unsigned int pid0, void* stream) {
  if (n < 1 || l < 1 || m < 1 || heads < 1 || e < 1 || splits < 1 ||
      rows_per_split < 1 || rows_per_split % seist::kBwdRowTile != 0 ||
      (long long)splits * rows_per_split < l ||
      (long long)(splits - 1) * rows_per_split >= l) {
    return (int)cudaErrorInvalidValue;
  }
  const int* sd = static_cast<const int*>(seed);
  if (sd == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* qp = static_cast<float*>(dq_part);
  float* kp = static_cast<float*>(dk_part);
  float* vp = static_cast<float*>(dv_part);
  if (dtype == 0) {
    return (int)seist::launch_bwd<seist::BwdF32>(q, k, v, g, o, ls, dq, dk, dv, qp, kp, vp, n,
                                                 l, m, heads, e, splits, rows_per_split, scale,
                                                 rate, out_scale, lm, sd, s, pid0);
  }
  if (dtype == 1) {
    return (int)seist::launch_bwd<seist::BwdBf16>(q, k, v, g, o, ls, dq, dk, dv, qp, kp, vp,
                                                  n, l, m, heads, e, splits, rows_per_split,
                                                  scale, rate, out_scale, lm, sd, s, pid0);
  }
  return (int)cudaErrorInvalidValue;
}

// K2 bf16's row tile (rows) and the blocks that share an SM (its
// __launch_bounds__ minimum) at head width e: what ops/_kernels.py's launch
// plan needs of the kernel. Returns cudaErrorInvalidValue for e > 64.
extern "C" int pooled_attention_bwd_bf16_shape(int e, int* row_tile, int* blocks_per_sm) {
  return (int)seist::bwd_bf16_shape(e, row_tile, blocks_per_sm);
}
