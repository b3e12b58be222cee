// A CPU stand-in of cuda_bf16.h: bf16 storage and round-to-nearest-even
// conversions (tests/_cuda_emu/cuda_runtime.h).
#pragma once
#include <cstdint>
#include <cstring>
#include <cmath>
struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {uint16_t(0x7FC0)};
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = uint32_t(h.x) << 16; float f; std::memcpy(&f, &u, 4); return f;
}
struct float2 { float x, y; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}
