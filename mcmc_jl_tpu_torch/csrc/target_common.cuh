// Device routines shared by the custom-target kernels (target_hmc.cu,
// target_rwm.cu, target_nuts.cu): the log-density and its derivative for
// each of the ten continuous catalog families, the staging of the
// per-coordinate rows in shared memory, and warp reductions.
//
// A catalog target is log p(theta) = sum_j logpdf_j(theta_j): coordinate j
// follows family code[j] with scalar parameters (p0, p1, p2) and the
// log-normalizer c folded on the host in double
// (models/distributions.py kernel_row).  The derivatives are the analytic
// rules of the reference's MCMCDerivRules.jl, taken where the JAX package's
// double-where logpdfs put them under jax.grad:
//   - outside the support the term is -inf and its derivative 0 (boundaries
//     as in mcmc_jl_tpu/models/distributions.py: x >= 0 for Exponential,
//     a <= x <= b for Uniform, x > 0 for Gamma, Weibull and LogNormal,
//     0 < x < 1 for Beta);
//   - Laplace at x = loc has the derivative -1/scale, since
//     jax.grad(jnp.abs)(0.0) is 1.
//
// A dense target (ops/target_kernels.py, models/distributions.py
// DenseTarget; the JAX package's _dense_wrap) is a catalog target seen
// through a frozen dense metric: the chain's state is z, the families are
// evaluated at theta = z L' (L the (d, d) lower-triangular Cholesky factor
// of the metric), lp is the target's at theta and the gradient is the one
// in z, g_z = g_theta L.  Target.L is then the factor as (2, d, d) floats,
// L and L' each row-major (null for a catalog target); kernels 5 and 8b
// take a bool DENSE template parameter whose false instantiations read no
// L, and every other kernel keeps L null.
//
// Layout: one warp per chain.  Lane l holds coordinates l, l + 32, ...
// (CPL of them, a template bound), so any d <= 32 * CPL runs one code path;
// lp and |m|^2 are reduced with xor shuffles, which leave the same bits in
// every lane, so every lane takes the same accept decision.  (At d <= 32
// every custom-target kernel runs one chain per lane instead and takes only
// the families and the rows from here: target_lane.cuh.)
//
// Everything here sits in an anonymous namespace: each source that includes
// it is built into a library of its own.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kChainsPerBlock = 4;                // warps (chains) per block
constexpr int kThreads = kChainsPerBlock * kWarp;
constexpr int kMaxDim = 1024;                     // 32 lanes x CPL 32
constexpr int kFamilies = 10;
constexpr int kMaxOps = 8;                        // longest kick/drift schedule

enum Family {
  kNormal = 0, kUniform = 1, kExponential = 2, kGamma = 3, kWeibull = 4,
  kCauchy = 5, kLogNormal = 6, kBeta = 7, kLaplace = 8, kTDist = 9
};

// One coordinate's family: code, parameters, folded log-normalizer.
struct Row {
  int code;
  float p0, p1, p2, c;
};

struct Target {
  const int* codes;     // (d,)
  const float* params;  // (d, 4): p0, p1, p2, c
  int d;
  const float* L;       // dense target: (2, d, d), L then L'; else null
};

// Kick ("B", op 0) / drift ("A", op 1) schedule, coefficients in units of eps
// (samplers/integrators.py SCHEDULES).
struct Sched {
  int n;
  int last_a;  // index of the final drift: its gradient pass also yields lp
  int op[kMaxOps];
  float c[kMaxOps];
};

// Stage the d rows in shared memory; every thread of the block calls it.
__device__ __forceinline__ void stage_rows(const Target& t, Row* rows) {
  for (int j = threadIdx.x; j < t.d; j += blockDim.x)
    rows[j] = Row{t.codes[j], t.params[4 * j], t.params[4 * j + 1],
                  t.params[4 * j + 2], t.params[4 * j + 3]};
  __syncthreads();
}

// log-density term of one coordinate (WANT_LP) and its derivative (WANT_G).
template <bool WANT_LP, bool WANT_G>
__device__ __forceinline__ float family_eval(const Row& r, float x,
                                             float& dlp) {
  const float ninf = -CUDART_INF_F;
  float lp = 0.f;
  dlp = 0.f;
  switch (r.code) {
    case kNormal: {  // p0 mu, p1 sigma
      const float z = (x - r.p0) / r.p1;
      if (WANT_G) dlp = -z / r.p1;
      if (WANT_LP) lp = -0.5f * z * z + r.c;
      break;
    }
    case kUniform: {  // p0 a, p1 b
      const bool in = x >= r.p0 && x <= r.p1;
      if (WANT_LP) lp = in ? r.c : ninf;
      break;
    }
    case kExponential: {  // p0 scale
      const bool in = x >= 0.f;
      if (WANT_G) dlp = in ? -1.f / r.p0 : 0.f;
      if (WANT_LP) lp = in ? -x / r.p0 + r.c : ninf;
      break;
    }
    case kGamma: {  // p0 shape a, p1 scale s
      const bool in = x > 0.f;
      if (WANT_G) dlp = in ? (r.p0 - 1.f) / x - 1.f / r.p1 : 0.f;
      if (WANT_LP) lp = in ? (r.p0 - 1.f) * logf(x) - x / r.p1 + r.c : ninf;
      break;
    }
    case kWeibull: {  // p0 shape k, p1 scale s; z = x / s
      const bool in = x > 0.f;
      const float xs = in ? x : 1.f;
      const float z = xs / r.p1;
      const float zk = powf(z, r.p0);
      // d/dx [(k - 1) log z - z^k] = ((k - 1) - k z^k) / x
      if (WANT_G) dlp = in ? ((r.p0 - 1.f) - r.p0 * zk) / xs : 0.f;
      if (WANT_LP) lp = in ? r.c + (r.p0 - 1.f) * logf(z) - zk : ninf;
      break;
    }
    case kCauchy: {  // p0 loc, p1 scale
      const float z = (x - r.p0) / r.p1;
      if (WANT_G) dlp = -2.f * z / (r.p1 * (1.f + z * z));
      if (WANT_LP) lp = r.c - log1pf(z * z);
      break;
    }
    case kLogNormal: {  // p0 mu, p1 sigma
      const bool in = x > 0.f;
      const float xs = in ? x : 1.f;
      const float lx = logf(xs);
      const float z = (lx - r.p0) / r.p1;
      if (WANT_G) dlp = in ? -(z / r.p1 + 1.f) / xs : 0.f;
      if (WANT_LP) lp = in ? -0.5f * z * z - lx + r.c : ninf;
      break;
    }
    case kBeta: {  // p0 a, p1 b
      const bool in = x > 0.f && x < 1.f;
      const float xs = in ? x : 0.5f;
      if (WANT_G) dlp = in ? (r.p0 - 1.f) / xs - (r.p1 - 1.f) / (1.f - xs)
                           : 0.f;
      if (WANT_LP)
        lp = in ? (r.p0 - 1.f) * logf(xs) + (r.p1 - 1.f) * log1pf(-xs) + r.c
                : ninf;
      break;
    }
    case kLaplace: {  // p0 loc, p1 scale; d|u|/du = +1 at u = 0 (as JAX)
      const float u = x - r.p0;
      if (WANT_G) dlp = (u >= 0.f ? -1.f : 1.f) / r.p1;
      if (WANT_LP) lp = -fabsf(u) / r.p1 + r.c;
      break;
    }
    default: {  // kTDist: p0 df v
      const float v = r.p0;
      if (WANT_G) dlp = -(v + 1.f) * x / (v + x * x);
      if (WANT_LP) lp = r.c - 0.5f * (v + 1.f) * log1pf(x * x / v);
      break;
    }
  }
  return lp;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This lane's coordinates of a (C, d) row-major tensor; zero past d.
template <int CPL>
__device__ __forceinline__ void load_lane(float (&v)[CPL], const float* src,
                                          int c, int d, int lane) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    v[i] = j < d ? src[(size_t)c * d + j] : 0.f;
  }
}

template <int CPL>
__device__ __forceinline__ void store_lane(float* dst, const float (&v)[CPL],
                                           int c, int d, int lane) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    if (j < d) dst[(size_t)c * d + j] = v[i];
  }
}

// The gradient at th into g (zero past d); with WANT_LP also the
// log-target, summed over the warp.
template <int CPL, bool WANT_LP>
__device__ __forceinline__ float eval_grad(const Row* rows, int d, int lane,
                                           const float (&th)[CPL],
                                           float (&g)[CPL]) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    g[i] = 0.f;  // zero past d: those momenta then stay zero
    if (j < d) {
      float dl;
      const float l = family_eval<WANT_LP, true>(rows[j], th[i], dl);
      g[i] = dl;
      if (WANT_LP) part += l;
    }
  }
  return WANT_LP ? warp_sum(part) : 0.f;
}

// The z-space pass of a dense target, one warp a chain: the gradient in z
// at z into g (zero past d) and, with WANT_LP, the log-target at theta =
// z L', summed over the warp.  z passes through the warp's slice zs of
// shared memory (d floats), each lane forms its coordinates of theta
// (theta_j = sum over k <= j of L_jk z_k, k ascending, reading row k of L'
// from L2: a warp's read is one row segment), the families give g_theta,
// which passes through zs again for g_z,k = sum over j >= k of L_jk
// g_theta,j (j ascending, row j of L).  The sums run in the lane layout's
// order (target_lane.cuh lane_dense_theta), so both layouts give the same
// bits.
template <int CPL, bool WANT_LP>
__device__ __forceinline__ float dense_eval_grad(const Row* rows,
                                                 const float* __restrict__ L,
                                                 float* zs, int d, int lane,
                                                 const float (&z)[CPL],
                                                 float (&g)[CPL]) {
  const float* __restrict__ Lt = L + (size_t)d * d;
  float th[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    if (j < d) zs[j] = z[i];
    th[i] = 0.f;
  }
  __syncwarp();
  for (int k = 0; k < d; ++k) {
    const float zk = zs[k];
    const float* __restrict__ row = Lt + (size_t)k * d;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      if (kWarp * i >= d) break;  // warp-uniform: no slot past d
      const int j = lane + kWarp * i;
      if (j >= k && j < d) th[i] = fmaf(__ldg(row + j), zk, th[i]);
    }
  }
  __syncwarp();  // every lane has read z
  const float lp = eval_grad<CPL, WANT_LP>(rows, d, lane, th, g);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    if (j < d) zs[j] = g[i];
    g[i] = 0.f;
  }
  __syncwarp();
  for (int j = 0; j < d; ++j) {
    const float gj = zs[j];
    const float* __restrict__ row = L + (size_t)j * d;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      if (kWarp * i > j) break;  // warp-uniform: no slot k <= j left
      const int k = lane + kWarp * i;
      if (k <= j) g[i] = fmaf(__ldg(row + k), gj, g[i]);
    }
  }
  __syncwarp();  // zs is free for the next pass
  return lp;
}

// The gradient (and with WANT_LP the log-target) of a chain in the warp
// layout: eval_grad at th, or with DENSE the z-space pass at z = th
// (dense_eval_grad; zs the warp's slice of shared memory).
template <int CPL, bool WANT_LP, bool DENSE>
__device__ __forceinline__ float grad_at(const Row* rows, const float* L,
                                         float* zs, int d, int lane,
                                         const float (&th)[CPL],
                                         float (&g)[CPL]) {
  if constexpr (DENSE)
    return dense_eval_grad<CPL, WANT_LP>(rows, L, zs, d, lane, th, g);
  else
    return eval_grad<CPL, WANT_LP>(rows, d, lane, th, g);
}

// Dynamic shared memory of a warp-layout kernel: the d rows, and with DENSE
// each warp's slice for the z-space pass (d floats a warp).
size_t warp_smem(int d, bool dense) {
  return (size_t)d * sizeof(Row) +
         (dense ? sizeof(float) * (size_t)kChainsPerBlock * d : 0);
}

// This warp's slice of a warp-layout kernel's shared memory after the rows.
__device__ __forceinline__ float* warp_slice(Row* rows, int d) {
  return reinterpret_cast<float*>(rows + d) + (threadIdx.x / kWarp) * d;
}

// The log-target at th alone, summed over the warp.
template <int CPL>
__device__ __forceinline__ float eval_lp(const Row* rows, int d, int lane,
                                         const float (&th)[CPL]) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    if (j < d) {
      float dl;
      part += family_eval<true, false>(rows[j], th[i], dl);
    }
  }
  return warp_sum(part);
}

template <int CPL>
__device__ __forceinline__ float half_sq(const float (&m)[CPL]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) s = fmaf(m[i], m[i], s);
  return 0.5f * warp_sum(s);
}

// NaN-rejecting Metropolis test (samplers/base.py metropolis_accept).
__device__ __forceinline__ bool mh_accept(float ratio, float logu) {
  if (isnan(ratio)) ratio = -CUDART_INF_F;
  return (ratio > 0.f) || (ratio > logu);
}

// ---- host side -------------------------------------------------------------

// Coordinates per lane: the template bound for d (d <= 32 is the main
// path; three bounds keep the build short).
int cpl_for(int d) {
  const int bounds[] = {1, 4, 32};
  for (int b : bounds)
    if (d <= kWarp * b) return b;
  return 0;
}

bool make_sched(const int* ops, const float* cs, int n, Sched* s) {
  if (n < 1 || n > kMaxOps) return false;
  s->n = n;
  s->last_a = -1;
  for (int k = 0; k < n; ++k) {
    s->op[k] = ops[k];
    s->c[k] = cs[k];
    if (ops[k] == 1) s->last_a = k;
  }
  return s->last_a >= 0;
}

int blocks_for(int C) { return (C + kChainsPerBlock - 1) / kChainsPerBlock; }

}  // namespace

// The helpers every custom-target library exports (each .cu that includes
// this header is a library of its own).
extern "C" {

int target_max_dim() { return kMaxDim; }

int target_n_families() { return kFamilies; }

const char* target_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
