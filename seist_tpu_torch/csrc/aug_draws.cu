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
// needs one threefry2x32 block (20 rounds of add, rotate, xor: about 75
// integer operations) and the erfinv polynomial; its 4 bytes written are
// far below that, so the kernel is bound by integer operations. This
// simple version has one thread per output element and recomputes the key
// chain (three more blocks) in every thread: four blocks where one is
// needed. Making it fast (sharing the key chain, several elements a
// thread) is later work.
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

// XLA's float32 erfinv (xla/client/lib/math.cc ErfInv32).
__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt5[i] : ge5[i]);
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));  // +-inf
  return __fmul_rn(p, x);
}

__global__ void __launch_bounds__(kThreads)
    aug_draws_kernel(uint32_t seed, const int* __restrict__ epoch, const int* __restrict__ idx,
                     int batch, SlotTable table, int n_slots, int tag0, int tag1, int n_fields,
                     int field_len, float* __restrict__ uniforms, float* __restrict__ fields) {
  const int64_t per_sample = n_slots + static_cast<int64_t>(n_fields) * field_len;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= per_sample * batch) return;
  const int b = static_cast<int>(i / per_sample);
  int64_t r = i - b * per_sample;
  uint32_t k0 = 0u, k1 = seed;
  fold_in(k0, k1, static_cast<uint32_t>(__ldg(epoch)));
  fold_in(k0, k1, static_cast<uint32_t>(__ldg(idx + b)));
  if (r < n_slots) {
    const int s = static_cast<int>(r);
    fold_in(k0, k1, static_cast<uint32_t>(table.tag[s]));
    uniforms[static_cast<int64_t>(b) * n_slots + s] =
        unit_float(bits_at(k0, k1, static_cast<uint32_t>(table.pos[s])));
    return;
  }
  r -= n_slots;
  const int f = static_cast<int>(r / field_len);
  const int p = static_cast<int>(r - static_cast<int64_t>(f) * field_len);
  fold_in(k0, k1, static_cast<uint32_t>(f == 0 ? tag0 : tag1));
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  // u on (lo, 1): f * (1 - lo) + lo with 1 - lo rounding to 2 in float32.
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(unit_float(bits_at(k0, k1, p)), 2.0f), lo));
  fields[(static_cast<int64_t>(b) * n_fields + f) * field_len + p] =
      __fmul_rn(erfinv_xla(u), 1.41421354f);
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
      field_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SlotTable table;
  for (int s = 0; s < kMaxSlots; ++s) {
    table.tag[s] = s < n_slots ? slot_tags[s] : 0;
    table.pos[s] = s < n_slots ? slot_pos[s] : 0;
  }
  const int64_t total = (n_slots + static_cast<int64_t>(n_fields) * field_len) * batch;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  aug_draws_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<uint32_t>(seed), epoch, idx, batch, table, n_slots, tag0, tag1, n_fields,
      field_len, uniforms, fields);
  return static_cast<int>(cudaGetLastError());
}
