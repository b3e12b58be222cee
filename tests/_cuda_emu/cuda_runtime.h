// A CPU stand-in of the CUDA runtime, enough to run the port's bf16
// attention kernels on the host (tests/test_torch_kernel_emulation.py): a
// block's threads are std::threads and __syncthreads a std::barrier; the
// warp collectives (shuffles, ldmatrix, mma.sync) exchange their operands
// through per-warp buffers between two warp barriers and compute each
// lane's result from the PTX ISA's fragment layouts. The grid runs one
// block after another; shared memory is filled with NaN before each.
#pragma once
#include <algorithm>
#include <barrier>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include "cuda_bf16.h"
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
using std::min;
using std::max;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return 0; }
template <class K> inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct Idx3 { unsigned x, y, z; };
inline thread_local Idx3 threadIdx, blockIdx, blockDim;
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __fdividef(float a, float b) { return a / b; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned long long __cvta_generic_to_shared(const void* p) { return (unsigned long long)p; }

struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t buf[32][16];
  const void* ptr[32];
};
inline std::barrier<>* g_block_bar = nullptr;
inline EmuWarp* g_warps = nullptr;
inline unsigned char* g_smem_lo = nullptr;
inline size_t g_smem_bytes = 0;
inline int emu_lane() { return threadIdx.x & 31; }
inline EmuWarp& emu_warp() { return g_warps[threadIdx.x >> 5]; }
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  EmuWarp& w = emu_warp(); const int l = emu_lane();
  std::memcpy(&w.buf[l][0], &v, sizeof(T));
  w.bar.arrive_and_wait();
  T r; std::memcpy(&r, &w.buf[l ^ m][0], sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}
inline void emu_check_smem(const void* p, size_t n) {
  const unsigned char* c = (const unsigned char*)p;
  if (((uintptr_t)p & 15) != 0 || c < g_smem_lo || c + n > g_smem_lo + g_smem_bytes) {
    std::fprintf(stderr, "bad shared address %p (smem %p + %zu)\n", p, (void*)g_smem_lo, g_smem_bytes);
    std::abort();
  }
}
// ldmatrix .m8n8 .b16, nmat matrices, optionally transposed.
inline void emu_ldsm(uint32_t* r, int nmat, bool trans, const __nv_bfloat16* p) {
  EmuWarp& w = emu_warp(); const int l = emu_lane();
  w.ptr[l] = p;
  if (l < nmat * 8) emu_check_smem(p, 16);
  w.bar.arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int i = 0; i < nmat; ++i) {
    uint16_t lo, hi;
    if (!trans) {
      const __nv_bfloat16* row = (const __nv_bfloat16*)w.ptr[i * 8 + g];
      lo = row[2 * t].x; hi = row[2 * t + 1].x;
    } else {
      lo = ((const __nv_bfloat16*)w.ptr[i * 8 + 2 * t])[g].x;
      hi = ((const __nv_bfloat16*)w.ptr[i * 8 + 2 * t + 1])[g].x;
    }
    r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  w.bar.arrive_and_wait();
}
inline float emu_half(uint32_t r, int h) { return __bfloat162float({uint16_t(h ? r >> 16 : r & 0xFFFF)}); }
// mma.sync m16n8k{16,8} bf16 -> fp32: d = c + a b.
inline void emu_mma(float* d, const uint32_t* a, int na, const uint32_t* b, int nb) {
  EmuWarp& w = emu_warp(); const int l = emu_lane();
  for (int i = 0; i < na; ++i) w.buf[l][i] = a[i];
  for (int i = 0; i < nb; ++i) w.buf[l][4 + i] = b[i];
  w.bar.arrive_and_wait();
  const int g = l >> 2, t = l & 3, K = na == 4 ? 16 : 8;
  auto A = [&](int r, int c) {
    const int lane = 4 * (r & 7) + (c & 7) / 2, reg = (r >= 8) + 2 * (c >= 8);
    return emu_half((uint32_t)w.buf[lane][reg], c & 1);
  };
  auto B = [&](int k, int n) {
    const int lane = 4 * n + (k & 7) / 2, reg = k >= 8;
    return emu_half((uint32_t)w.buf[lane][4 + reg], k & 1);
  };
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + (i >> 1) * 8, c = 2 * t + (i & 1);
    double s = 0.0;
    for (int k = 0; k < K; ++k) s += (double)A(r, k) * (double)B(k, c);
    out[i] = (float)((double)d[i] + s);
  }
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

template <class Kern, class... Args>
void emu_launch(Kern kernel, dim3 grid, dim3 block, int smem, cudaStream_t, Args... args) {
  if ((size_t)smem > 232448) { std::fprintf(stderr, "smem %d too large\n", smem); std::abort(); }
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar((std::ptrdiff_t)block.x);
      const int nw = (block.x + 31) / 32;
      std::unique_ptr<EmuWarp[]> warps(new EmuWarp[nw]);
      g_block_bar = &bar;
      g_warps = warps.get();
      extern unsigned char* emu_smem_base();
      g_smem_lo = emu_smem_base();
      g_smem_bytes = (size_t)smem;
      std::memset(g_smem_lo, 0xFF, 232448);  // NaN in bf16 and fp32: unwritten reads show
      std::vector<std::thread> ts;
      for (unsigned tid = 0; tid < block.x; ++tid) {
        ts.emplace_back([&, tid] {
          threadIdx = {tid, 0, 0};
          blockIdx = {bx, by, 0};
          blockDim = {block.x, block.y, block.z};
          kernel(args...);
          warps[tid >> 5].bar.arrive_and_drop();
          bar.arrive_and_drop();
        });
      }
      for (auto& t : ts) t.join();
    }
  }
}
