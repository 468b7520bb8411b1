// Device routines shared by the GLM kernels (glm_hmc.cu, glm_nuts.cu,
// glm_bign.cu): the model's parameters and the link functions.  Every GLM
// kernel runs on the chain-tile gradient of glm_tile.cuh, which takes the
// link from here for probit.  The Philox generator lives in philox.cuh,
// shared with the custom-target kernels.
//
// Model: logp(theta) = sum_n w_n ll(z_n, y_n) - 1/2 sum_j lam_j theta_j^2
// with z_n = x_n . theta + o_n, and
// grad = sum_n w_n resid(z_n, y_n) x_n - lam theta.  lam is a scalar, or a
// (d,) row (the diagonal-metric fold of the warm-start pipeline), or a
// symmetric (d, d) matrix A (the dense-metric fold lam L'L): then the prior
// gradient is theta A and the prior term 1/2 theta' A theta.
//
// Everything here sits in an anonymous namespace: each source that includes
// it is built into a library of its own.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

enum Link { kLogistic = 0, kLinear = 1, kPoisson = 2, kProbit = 3 };

struct Glm {
  const float* xt;    // (d, N) transposed design
  const float* y;     // (N,)
  const float* w;     // (N,) or null
  const float* o;     // (N,) or null
  const float* lamv;  // (d,) prior precision row, or null: scalar lam
  const float* lamm;  // (d, d) prior precision matrix, or null
  int N, d, kind;
  float lam;
  int tile;           // rows per shared-memory tile
  bool resident;      // all N rows fit: staged once per launch
};

// log Phi(z), exact to float rounding for all z.
__device__ __forceinline__ float log_ndtr(float z) {
  const float r2 = 0.70710678118654752f;
  if (z > 0.f) return log1pf(-0.5f * erfcf(z * r2));
  return logf(0.5f * erfcxf(-z * r2)) - 0.5f * z * z;
}

__device__ __forceinline__ void link(int kind, float z, float y, bool want_ll,
                                     float& r, float& ll) {
  switch (kind) {
    case kLogistic: {
      float e = expf(-fabsf(z));
      float s = z >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);  // sigmoid(z)
      r = y - s;
      if (want_ll) ll = z * y - (fmaxf(z, 0.f) + log1pf(e));
      break;
    }
    case kLinear: {
      r = y - z;
      if (want_ll) ll = -0.5f * r * r;
      break;
    }
    case kPoisson: {
      float e = expf(z);
      r = y - e;
      if (want_ll) ll = y * z - e;
      break;
    }
    default: {  // probit: phi/Phi ratios as sqrt(2/pi) / erfcx(-+z/sqrt 2)
      const float r2 = 0.70710678118654752f;
      const float c = 0.79788456080286536f;
      float wp = c / erfcxf(-z * r2);
      float wn = c / erfcxf(z * r2);
      r = y * wp - (1.f - y) * wn;
      if (want_ll) ll = y * log_ndtr(z) + (1.f - y) * log_ndtr(-z);
      break;
    }
  }
}

// ---- host side -------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
