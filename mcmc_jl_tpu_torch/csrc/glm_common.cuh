// Device routines shared by the GLM kernels (glm_hmc.cu, glm_nuts.cu,
// glm_bign.cu): the link functions, the staging of observation rows in
// shared memory and the fused log-target + gradient pass of the kernel
// that runs one thread per chain (glm_multistep_rows in glm_hmc.cu; the
// other GLM kernels run on the chain-tile gradient of glm_tile.cuh, which
// takes the link from here for probit).  The Philox
// generator lives in philox.cuh, shared with the custom-target kernels.
//
// Model: logp(theta) = sum_n w_n ll(z_n, y_n) - 1/2 sum_j lam_j theta_j^2
// with z_n = x_n . theta + o_n, and
// grad = sum_n w_n resid(z_n, y_n) x_n - lam theta.  lam is a scalar, or a
// (d,) row (the diagonal-metric fold of the warm-start pipeline).
//
// Everything here sits in an anonymous namespace: each source that includes
// it is built into a library of its own.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kSmemCap = 100 * 1024;   // dynamic shared memory budget, bytes

enum Link { kLogistic = 0, kLinear = 1, kPoisson = 2, kProbit = 3 };

struct Glm {
  const float* xt;    // (d, N) transposed design
  const float* y;     // (N,)
  const float* w;     // (N,) or null
  const float* o;     // (N,) or null
  const float* lamv;  // (d,) prior precision row, or null: scalar lam
  int N, d, kind;
  float lam;
  int tile;           // rows per shared-memory tile
  bool resident;      // all N rows fit: load once per launch
};

__host__ __device__ constexpr int stride_for(int D) { return (D + 3 + 3) & ~3; }

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

// Copy observation rows [t0, t0 + nt) into shared memory: x (D lanes, zero
// beyond d), then y, w, o.  Called by every thread of the block.
template <int D>
__device__ void load_rows(const Glm& p, float* sm, int t0, int nt) {
  const int S = stride_for(D);
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    int n = t0 + i;
    float* row = sm + i * S;
#pragma unroll
    for (int j = 0; j < D; ++j)
      row[j] = j < p.d ? p.xt[(size_t)j * p.N + n] : 0.f;
    row[D] = p.y[n];
    row[D + 1] = p.w ? p.w[n] : 1.f;
    row[D + 2] = p.o ? p.o[n] : 0.f;
  }
}

// Gradient at th into g; with lp != null also the log-target, from the same
// pass over the observations (pallas_glm.py _glm_funcs logp_grad).  The
// log-likelihood sum is carried in double.
//
// Barrier rule: when the rows stream (!p.resident), this routine loads each
// tile with __syncthreads() before and after, so it may be called only where
// every thread of the block makes the same number of calls (the leap
// counts of glm_hmc.cu are the same for every chain of a launch); with
// resident rows it has no barrier.
template <int D>
__device__ void glm_eval(const Glm& p, float* sm, const float (&th)[D],
                         float (&g)[D], float* lp) {
  const int S = stride_for(D);
  float acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = 0.f;
  double ll_sum = 0.0;
  const bool want_ll = lp != nullptr;
  for (int t0 = 0; t0 < p.N; t0 += p.tile) {
    int nt = min(p.tile, p.N - t0);
    if (!p.resident) {
      __syncthreads();
      load_rows<D>(p, sm, t0, nt);
      __syncthreads();
    }
    for (int i = 0; i < nt; ++i) {
      const float* row = sm + i * S;
      float z = row[D + 2];
#pragma unroll
      for (int j = 0; j < D; ++j) z = fmaf(th[j], row[j], z);
      float r, ll = 0.f;
      link(p.kind, z, row[D], want_ll, r, ll);
      float wn = row[D + 1];
      r *= wn;
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] = fmaf(r, row[j], acc[j]);
      if (want_ll) ll_sum += (double)(wn * ll);
    }
  }
  float quad = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float lam = (p.lamv && j < p.d) ? p.lamv[j] : p.lam;
    float pg = lam * th[j];
    g[j] = acc[j] - pg;
    quad = fmaf(pg, th[j], quad);
  }
  if (want_ll) *lp = (float)(ll_sum - 0.5 * (double)quad);
}

template <int D>
__device__ __forceinline__ float half_sq(const float (&m)[D]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) s = fmaf(m[j], m[j], s);
  return 0.5f * s;
}

template <int D>
__device__ void load_vec(float (&v)[D], const float* src, int c, int d) {
#pragma unroll
  for (int j = 0; j < D; ++j) v[j] = j < d ? src[(size_t)c * d + j] : 0.f;
}

template <int D>
__device__ void store_vec(float* dst, const float (&v)[D], int c, int d) {
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (j < d) dst[(size_t)c * d + j] = v[j];
}

// With all rows resident, stage them once before the kernel's work.
template <int D>
__device__ __forceinline__ void stage(const Glm& p, float* sm) {
  if (p.resident) {
    load_rows<D>(p, sm, 0, p.N);
    __syncthreads();
  }
}

// ---- host side -------------------------------------------------------------

int bound_for(int d) {
  // d = 10 is the main path; the powers of two cover the rest up to 32
  const int bounds[] = {8, 10, 16, 32};
  for (int b : bounds)
    if (d <= b) return b;
  return 0;
}

bool make_params(const float* xt, const float* y, const float* w,
                 const float* o, const float* lamv, int N, int d, int kind,
                 float lam, int D, Glm* p, size_t* smem) {
  if (N < 1 || d < 1 || kind < 0 || kind > 3) return false;
  const size_t row = (size_t)stride_for(D) * sizeof(float);
  int tile = (int)(kSmemCap / row);
  if (tile > N) tile = N;
  *p = Glm{xt, y, w, o, lamv, N, d, kind, lam, tile, tile >= N};
  *smem = (size_t)tile * row;
  return true;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

#define GLM_DISPATCH(D_, CALL)                         \
  switch (D_) {                                        \
    case 8: CALL(8); break;                            \
    case 10: CALL(10); break;                          \
    case 16: CALL(16); break;                          \
    case 32: CALL(32); break;                          \
    default: return (int)cudaErrorInvalidValue;        \
  }
