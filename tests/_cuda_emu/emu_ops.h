// The port's PTX helpers (csrc/attention_common.cuh, csrc/attention_bf16.cuh)
// on the CPU stand-in of tests/_cuda_emu/cuda_runtime.h. The test renames
// the PTX versions in its copy of the sources; these take their names. A
// cp.async lands at once.
#pragma once
#include <cuda_runtime.h>

namespace seist {

inline void cp_async16(void* d, const void* s) {
  emu_check_smem(d, 16);
  if (((uintptr_t)s & 15) != 0) {
    std::fprintf(stderr, "misaligned cp.async source %p\n", s);
    std::abort();
  }
  std::memcpy(d, s, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline float exp2_approx(float x) { return exp2f(x); }
inline void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) { emu_ldsm(r, 4, false, p); }
inline void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) { emu_ldsm(r, 4, true, p); }
inline void ldsm_x2(uint32_t (&r)[2], const __nv_bfloat16* p) { emu_ldsm(r, 2, false, p); }
inline void ldsm_x2_t(uint32_t (&r)[2], const __nv_bfloat16* p) { emu_ldsm(r, 2, true, p); }
inline void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  emu_mma(d, a, 4, b, 2);
}
inline void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  const uint32_t a[2] = {a0, a1};
  emu_mma(d, a, 2, &b, 1);
}

}  // namespace seist
