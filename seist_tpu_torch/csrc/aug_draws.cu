// K3: every named augmentation draw of a batch, in one launch.
//
// The port's own kernel: it replaces no TPU kernel. The JAX package draws
// these numbers with jax.random inside its jitted step
// (seist_tpu/data/device_aug.py:169-236, draw_all), which XLA compiles; a
// plain PyTorch version emulates uint32 arithmetic in masked int64 tensors,
// one pass over device memory per operation, and would spend milliseconds
// of every train step on it.
//
// What it computes (ops/threefry.py, module docstring): sample b's key is
// fold_in(fold_in((0, seed), epoch), idx[b]); uniform slot s is element
// pos[s] of uniform(fold_in(key, tag[s])); field f is the normal draw
// normal(fold_in(key, field_tag[f]), field_len). threefry2x32 and the
// float conversions are jax.random's (partitionable layout), erfinv XLA's
// float32 polynomial with its Horner steps as fused multiply-adds.
//
// Bound: the (C, L) normal fields are nearly all of the work. Each output
// is y0 ^ y1 of its own threefry2x32 block at counts (0, p): 20 rounds of
// add, rotate and xor plus the key injections, 68 integer instructions in
// the built code (45 of them on the int32 pipe: 20 funnel-shift rotates,
// 21 xors, 4 three-input adds that fold an x0 injection into a round's
// add; the other adds compile to IMAD on the FMA pipe), then XLA's erfinv
// on the fp32 pipe. Its 4 bytes written are far below that, so the kernel
// is bound by integer operations, and one block per output is the floor.
// A thread per output that rebuilt the key chain (three more blocks:
// epoch, index, field tag) would do four blocks where one is needed.
//
// Design: a block of the field grid covers a tile of kTile outputs of one
// (sample, field) row. Thread 0 folds the row's key once and hands it to
// the block through shared memory (dynamic, so the CPU emulation of the
// tests shares it across its threads too); then each thread draws groups
// of kPerThread consecutive outputs, kIters groups a tile: a group's four
// blocks side by side, with no branch between them, for the integer pipe,
// then their normals, written as one float4 where the row is 16-byte
// aligned (scalar stores elsewhere and at a row's ragged end). The chain is
// then 3 blocks a tile, under 5% of the blocks the warps issue even though
// one warp computes it alone. At the train step's b64 (two fields of 3 x
// 12000) that is 2,304 field blocks of 256 threads at 32 registers, eight
// blocks resident an SM. The uniform slots (at most kMaxSlots a sample,
// under 0.1% of the outputs) take the first blocks of the grid, one thread
// per (sample, slot) with its own chain.
//
// The arithmetic is the plain version's (ops/threefry.py), operation for
// operation, so the outputs are the same bits: threefry, the unit float,
// u = max(lo, f * 2 + lo), erfinv's steps. Its code differs in two places,
// not in its results: the w >= 5 polynomial replaces the common one under
// a branch a warp seldom takes (a select between two coefficient tables
// costs 9 int32-pipe instructions an output), and XLA's |x| == 1 case is
// left out: |u| < 1 always.
//
// Interface: a plain C function, bound with ctypes (ops/_kernels.py). The
// slot table arrives as host arrays and is passed to the kernel by value,
// so a captured launch keeps it; the epoch and the indices are read from
// device memory, so a replay draws for whatever was written there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 128;  // ops/threefry.py MAX_SLOTS
constexpr int kThreads = 256;
constexpr int kPerThread = 4;   // consecutive outputs a thread draws at once: one float4
constexpr int kIters = 2;       // groups of kPerThread a thread draws in a tile
constexpr int kTile = kThreads * kPerThread * kIters;  // outputs of one row a block

struct SlotTable {
  int tag[kMaxSlots];
  int pos[kMaxSlots];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;

// jax._src.prng threefry2x32 on one counter pair, in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef TF_ROUND

// fold_in(key, data): threefry2x32(key, (0, data)) becomes the key.
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// The 32 bits of element pos of a draw from key: y0 ^ y1 at counts (0, pos).
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint32_t pos) {
  uint32_t x0 = 0u, x1 = pos;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// XLA's float32 erfinv (xla/client/lib/math.cc ErfInv32) for |x| < 1, the
// only inputs normal_of gives it. w >= 5 only for |x| > 0.9966, one output
// in 300, so the w >= 5 polynomial replaces the common one under a branch
// a warp rarely takes, each Horner step an FMA with an immediate.
__device__ __forceinline__ float erfinv_xla(float x) {
  const float w = -log1pf(__fmul_rn(-x, x));
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  float v = __fsub_rn(w, 2.5f);
  float p = lt5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, v, lt5[i]);
  if (!(w < 5.0f)) {
    const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                          -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                          0.00943887047f,   1.00167406f,     2.83297682f};
    v = __fsub_rn(sqrtf(w), 3.0f);
    p = ge5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, v, ge5[i]);
  }
  return __fmul_rn(p, x);
}

// The normal a draw's 32 bits give.
__device__ __forceinline__ float normal_of(uint32_t bits) {
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  // u on (lo, 1): f * (1 - lo) + lo with 1 - lo rounding to 2 in float32.
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(unit_float(bits), 2.0f), lo));
  return __fmul_rn(erfinv_xla(u), 1.41421354f);
}

// Sample b's key: fold_in(fold_in((0, seed), epoch), idx[b]).
__device__ __forceinline__ void sample_key(uint32_t seed, const int* __restrict__ epoch,
                                           const int* __restrict__ idx, int b, uint32_t& k0,
                                           uint32_t& k1) {
  k0 = 0u;
  k1 = seed;
  fold_in(k0, k1, static_cast<uint32_t>(__ldg(epoch)));
  fold_in(k0, k1, static_cast<uint32_t>(__ldg(idx + b)));
}

// Blocks [0, slot_blocks) draw the uniforms, one thread per (b, s); the
// rest are field tiles, tiles_per_row to each (b, f) row.
__global__ void __launch_bounds__(kThreads)
    aug_draws_kernel(uint32_t seed, const int* __restrict__ epoch, const int* __restrict__ idx,
                     int batch, SlotTable table, int n_slots, int slot_blocks, int tag0,
                     int tag1, int n_fields, int field_len, int tiles_per_row,
                     float* __restrict__ uniforms, float* __restrict__ fields) {
  if (static_cast<int>(blockIdx.x) < slot_blocks) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= batch * n_slots) return;
    const int b = i / n_slots, s = i - b * n_slots;
    uint32_t k0, k1;
    sample_key(seed, epoch, idx, b, k0, k1);
    fold_in(k0, k1, static_cast<uint32_t>(table.tag[s]));
    uniforms[i] = unit_float(bits_at(k0, k1, static_cast<uint32_t>(table.pos[s])));
    return;
  }
  const int t = blockIdx.x - slot_blocks;
  const int row = t / tiles_per_row;  // b * n_fields + f
  const int start = (t - row * tiles_per_row) * kTile;
  extern __shared__ __align__(16) unsigned char smem_k3[];
  uint32_t* const row_key = reinterpret_cast<uint32_t*>(smem_k3);
  if (threadIdx.x == 0) {
    const int b = row / n_fields;
    uint32_t k0, k1;
    sample_key(seed, epoch, idx, b, k0, k1);
    fold_in(k0, k1, static_cast<uint32_t>(row - b * n_fields == 0 ? tag0 : tag1));
    row_key[0] = k0;
    row_key[1] = k1;
  }
  __syncthreads();
  const uint32_t k0 = row_key[0], k1 = row_key[1];
  float* const out = fields + static_cast<int64_t>(row) * field_len;
  const int end = min(start + kTile, field_len);
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int p = start + (it * kThreads + static_cast<int>(threadIdx.x)) * kPerThread;
    if (p >= end) break;
    // The group's blocks first, side by side (no branch between them), then
    // their normals.
    uint32_t bits[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) bits[j] = bits_at(k0, k1, static_cast<uint32_t>(p + j));
    float v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) v[j] = normal_of(bits[j]);
    if (vec && p + kPerThread <= end) {
      *reinterpret_cast<float4*>(out + p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (p + j < end) out[p + j] = v[j];
    }
  }
}

struct Grid {
  int slot_blocks, tiles_per_row;
  int64_t blocks;
};

Grid grid_of(int batch, int n_slots, int n_fields, int field_len) {
  Grid g;
  g.slot_blocks = (batch * n_slots + kThreads - 1) / kThreads;
  g.tiles_per_row = (field_len + kTile - 1) / kTile;
  g.blocks = g.slot_blocks + static_cast<int64_t>(batch) * n_fields * g.tiles_per_row;
  return g;
}

}  // namespace

// seed: the run's seed (low 32 bits); epoch: one int32 on the device; idx:
// (batch,) int32 on the device; slot_tags/slot_pos: n_slots host ints;
// field tags of the n_fields (<= 2) fields; uniforms (batch, n_slots) and
// fields (batch, n_fields, field_len) float32 on the device. Returns
// cudaGetLastError() after the launch.
extern "C" int aug_draws(unsigned int seed, const int* epoch, const int* idx, int batch,
                         const int* slot_tags, const int* slot_pos, int n_slots, int tag0,
                         int tag1, int n_fields, int field_len, float* uniforms, float* fields,
                         cudaStream_t stream) {
  if (n_slots < 0 || n_slots > kMaxSlots || n_fields < 0 || n_fields > 2 || batch < 0 ||
      field_len < 0 || static_cast<int64_t>(batch) * kMaxSlots > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  SlotTable table;
  for (int s = 0; s < kMaxSlots; ++s) {
    table.tag[s] = s < n_slots ? slot_tags[s] : 0;
    table.pos[s] = s < n_slots ? slot_pos[s] : 0;
  }
  const Grid g = grid_of(batch, n_slots, n_fields, field_len);
  if (g.blocks == 0) return static_cast<int>(cudaSuccess);
  if (g.blocks > 0x7FFFFFFF || field_len > 0x7FFFFFFF - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  aug_draws_kernel<<<static_cast<unsigned int>(g.blocks), kThreads, 2 * sizeof(uint32_t),
                     stream>>>(static_cast<uint32_t>(seed), epoch, idx, batch, table, n_slots,
                               g.slot_blocks, tag0, tag1, n_fields, field_len, g.tiles_per_row,
                               uniforms, fields);
  return static_cast<int>(cudaGetLastError());
}

// K3's launch geometry for a call's shapes (chip_smoke.py prints it):
// blocks of the grid, of them the uniform slots', threads a block, outputs
// a thread draws at once, and outputs of one row a field block covers.
extern "C" int aug_draws_shape(int batch, int n_slots, int n_fields, int field_len,
                               long long* blocks, int* slot_blocks, int* threads,
                               int* per_thread, int* tile) {
  const Grid g = grid_of(batch, n_slots, n_fields, field_len);
  *blocks = g.blocks;
  *slot_blocks = g.slot_blocks;
  *threads = kThreads;
  *per_thread = kPerThread;
  *tile = kTile;
  return 0;
}
