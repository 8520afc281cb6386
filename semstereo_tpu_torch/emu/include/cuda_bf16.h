// Stand-in for cuda_bf16.h on the CPU: bf16 as its 16 bits, converted to
// float exactly and from float by round-to-nearest-even, as the card does.
#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = uint32_t(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
