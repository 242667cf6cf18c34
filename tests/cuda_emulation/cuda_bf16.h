// A host stand-in for <cuda_bf16.h>: the storage type and the two
// conversions the kernels use (round to nearest, ties to even).
#pragma once
#include <cstring>

struct __nv_bfloat16 { unsigned short bits; };

inline float __bfloat162float(__nv_bfloat16 v) {
  const unsigned u = static_cast<unsigned>(v.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return {static_cast<unsigned short>((u + 0x7FFF + ((u >> 16) & 1)) >> 16)};
}
