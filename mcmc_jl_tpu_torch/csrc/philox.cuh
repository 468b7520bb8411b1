// Counter-based random numbers shared by every kernel that draws inside the
// kernel (glm_common.cuh's GLM kernels, target_common.cuh's custom-target
// kernels): Philox4x32-10, 24-bit uniforms and Box-Muller normals.
// ops/philox.py is their plain version, for replaying a kernel's draws.
//
// In an anonymous namespace: each source that includes it is built into a
// library of its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Philox4x32-10 (Salmon et al., SC'11): a 128-bit counter the caller
// builds from (chain, transition, draw, stream), key = the launch seed.
__device__ __forceinline__ uint4 philox(uint4 x, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    uint32_t hi0 = __umulhi(0xD2511F53u, x.x), lo0 = 0xD2511F53u * x.x;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, x.z), lo1 = 0xCD9E8D57u * x.z;
    x = make_uint4(hi1 ^ x.y ^ k.x, lo1, hi0 ^ x.w ^ k.y, lo0);
  }
  return x;
}

// U[0, 1) with 24 random mantissa bits.
__device__ __forceinline__ float u01(uint32_t b) {
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}

// Box-Muller on (1 - u1, u2), cosine branch (pallas_rwm.py _normal_hw).
__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
  float u1 = 1.f - u01(b1);
  float u2 = u01(b2);
  return sqrtf(-2.f * logf(u1)) * cospif(2.f * u2);
}

}  // namespace
