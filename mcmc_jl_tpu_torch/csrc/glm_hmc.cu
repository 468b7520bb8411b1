// Fused GLM-HMC kernels for Hopper (sm_90a): the trajectory, the whole
// transition, and k transitions per launch with the RNG inside the kernel
// (fixed leap count, or the shared Halton-jittered one with per-transition
// rows).
//
// Replaces the Pallas kernels of mcmc_jl_tpu/ops/pallas_glm.py:
//   glm_leapfrogs      <- _kernel           (via _leapfrogs_inner / glm_hmc_leapfrogs)
//   glm_step           <- _step_kernel      (via _step_inner / glm_hmc_step)
//   glm_multistep      <- _multistep_kernel (halton=False, via _multistep_inner)
//   glm_multistep_rows <- _multistep_kernel (halton=True, collect_rows=True,
//                                            via _multistep_rows_inner)
// all sharing _glm_funcs + _trajectory, which here are the device routines
// glm_eval (glm_common.cuh, shared with glm_nuts.cu and glm_bign.cu) and
// trajectory.
//
// Model: logp(theta) = sum_n w_n ll(z_n, y_n) - 1/2 sum_j lam_j theta_j^2
// with z_n = x_n . theta + o_n, and grad = sum_n w_n resid(z_n, y_n) x_n -
// lam theta; lam is a scalar, or a (d,) row for glm_multistep_rows (the
// diagonal-metric fold of the warm-start pipeline).
//
// What bounds it on the H100: at the main-path shape (d = 10, N = 1000) one
// gradient is d*N = 10k FMAs for z plus 10k FMAs for r x per chain, and one
// expf (plus a reciprocal) per observation for the link.  That is arithmetic
// on values held in registers: the design matrix (40 KB) is read from shared
// memory and never from device memory inside the trajectory, so the bound is
// the FP32 FMA rate of the SMs and the SFU rate of expf, not bytes.
//
// Design: one thread per chain.  theta, m and g live in registers, the
// parameter count is a template bound D (d <= D, unused lanes are zero and
// stay zero), and the whole trajectory and accept run without touching device
// memory.  The observations (x_n, y_n, w_n, o_n) are staged in shared memory
// as rows of a fixed stride; all threads of a warp read the same row, which
// the shared memory broadcasts.  When N rows do not fit in the shared memory
// budget, the rows are streamed through shared memory tile by tile at every
// gradient.  The log-likelihood sum is carried in double, so lp keeps full
// float precision after a 1000-term sum.  A ragged last block of chains is
// masked: its idle threads still load tiles and reach every barrier.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "glm_common.cuh"

namespace {

constexpr int kThreads = 128;          // chains per block
constexpr int kMaxOps = 8;             // longest kick/drift schedule

// Kick ("B", op 0) / drift ("A", op 1) schedule, coefficients in units of eps
// (samplers/integrators.py SCHEDULES).
struct Sched {
  int n;
  int last_a;  // index of the final drift: its gradient also yields lp
  int op[kMaxOps];
  float c[kMaxOps];
};

// n_leaps macro steps of the schedule; returns lp at the end point, computed
// by the last drift's gradient pass (pallas_glm.py _trajectory).
template <int D>
__device__ float trajectory(const Glm& p, float* sm, const Sched& s,
                            float eps, int n_leaps, float (&th)[D],
                            float (&m)[D], float (&g)[D]) {
  float lp = 0.f;
  for (int l = 0; l < n_leaps; ++l) {
    const bool final = l == n_leaps - 1;
    for (int k = 0; k < s.n; ++k) {
      const float ce = s.c[k] * eps;
      if (s.op[k] == 0) {
#pragma unroll
        for (int j = 0; j < D; ++j) m[j] = m[j] + ce * g[j];
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) th[j] = th[j] + ce * m[j];
        glm_eval<D>(p, sm, th, g, (final && k == s.last_a) ? &lp : nullptr);
      }
    }
  }
  return lp;
}

// NaN-rejecting Metropolis test (samplers/base.py metropolis_accept).
__device__ __forceinline__ bool mh_accept(float h0, float h, float logu) {
  float ratio = h0 - h;
  if (isnan(ratio)) ratio = -CUDART_INF_F;
  return (ratio > 0.f) || (ratio > logu);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
leapfrogs_kernel(Glm p, Sched s, int C, float eps, int n_leaps,
                 const float* __restrict__ th_in, const float* __restrict__ m_in,
                 const float* __restrict__ g_in, float* th_out, float* m_out,
                 float* g_out, float* lp_out) {
  extern __shared__ float sm[];
  stage<D>(p, sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int cc = c < C ? c : C - 1;  // idle threads shadow the last chain
  float th[D], m[D], g[D];
  load_vec<D>(th, th_in, cc, p.d);
  load_vec<D>(m, m_in, cc, p.d);
  load_vec<D>(g, g_in, cc, p.d);
  float lp = trajectory<D>(p, sm, s, eps, n_leaps, th, m, g);
  if (c < C) {
    store_vec<D>(th_out, th, c, p.d);
    store_vec<D>(m_out, m, c, p.d);
    store_vec<D>(g_out, g, c, p.d);
    lp_out[c] = lp;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
step_kernel(Glm p, Sched s, int C, float eps, int n_leaps,
            const float* __restrict__ th_in, const float* __restrict__ g_in,
            const float* __restrict__ lp_in, const float* __restrict__ m0_in,
            const float* __restrict__ logu_in, float* th_out, float* g_out,
            float* lp_out, float* acc_out) {
  extern __shared__ float sm[];
  stage<D>(p, sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int cc = c < C ? c : C - 1;
  float th[D], m[D], g[D];
  load_vec<D>(th, th_in, cc, p.d);
  load_vec<D>(m, m0_in, cc, p.d);
  load_vec<D>(g, g_in, cc, p.d);
  const float lp0 = lp_in[cc];
  const float h0 = -lp0 + half_sq<D>(m);
  float lp = trajectory<D>(p, sm, s, eps, n_leaps, th, m, g);
  const bool a = mh_accept(h0, -lp + half_sq<D>(m), logu_in[cc]);
  if (c < C) {
    if (a) {
      store_vec<D>(th_out, th, c, p.d);
      store_vec<D>(g_out, g, c, p.d);
    } else {
      for (int j = 0; j < p.d; ++j) {
        th_out[(size_t)c * p.d + j] = th_in[(size_t)c * p.d + j];
        g_out[(size_t)c * p.d + j] = g_in[(size_t)c * p.d + j];
      }
    }
    lp_out[c] = a ? lp : lp0;
    acc_out[c] = a ? 1.f : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
multistep_kernel(Glm p, Sched s, int C, float eps, int n_leaps, int k_trans,
                 uint2 key, const float* __restrict__ th_in, float* th_out,
                 float* g_out, float* lp_out, float* acc_out) {
  extern __shared__ float sm[];
  stage<D>(p, sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int cc = c < C ? c : C - 1;
  float th[D], g[D];
  load_vec<D>(th, th_in, cc, p.d);
  float lp;
  glm_eval<D>(p, sm, th, g, &lp);
  float n_acc = 0.f;
  for (int t = 0; t < k_trans; ++t) {
    float m[D], thp[D], gp[D];
    // two normals per Philox draw; the last draw also gives the MH uniform
#pragma unroll
    for (int j = 0; j < D; j += 2) {
      uint4 b = philox(make_uint4((uint32_t)cc, (uint32_t)t, (uint32_t)(j / 2), 0u), key);
      m[j] = j < p.d ? box_muller(b.x, b.y) : 0.f;
      if (j + 1 < D) m[j + 1] = j + 1 < p.d ? box_muller(b.z, b.w) : 0.f;
    }
    uint4 bu = philox(make_uint4((uint32_t)cc, (uint32_t)t, 0xFFFFFFFFu, 0u), key);
    const float logu = logf(1.f - u01(bu.x));
#pragma unroll
    for (int j = 0; j < D; ++j) {
      thp[j] = th[j];
      gp[j] = g[j];
    }
    const float h0 = -lp + half_sq<D>(m);
    float lpp = trajectory<D>(p, sm, s, eps, n_leaps, thp, m, gp);
    if (mh_accept(h0, -lpp + half_sq<D>(m), logu)) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        th[j] = thp[j];
        g[j] = gp[j];
      }
      lp = lpp;
      n_acc += 1.f;
    }
  }
  if (c < C) {
    store_vec<D>(th_out, th, c, p.d);
    store_vec<D>(g_out, g, c, p.d);
    lp_out[c] = lp;
    acc_out[c] = n_acc / (float)k_trans;
  }
}

// Radical inverse base 2 of i (samplers/chees.py halton2): the reversed bits
// scaled by 2^-32, exact for i < 2^24 and rounded to nearest beyond, as the
// float32 cast of the JAX package's float64 sum is.
__device__ __forceinline__ float vdc2(uint32_t i) {
  return __uint2float_rn(__brev(i)) * 2.3283064365386963e-10f;
}

// Shared leap count of absolute transition i, in float32 in the order of
// pallas_glm.py _multistep_kernel and warmstart.py _chees_scan:
// clip(ceil(vdc2(i) * T / eps), 1, max_leaps).
__device__ __forceinline__ int halton_leaps(uint32_t i, float T, float eps,
                                            int max_leaps) {
  float nl = ceilf(__fdiv_rn(__fmul_rn(vdc2(i), T), eps));
  return (int)fminf(fmaxf(nl, 1.f), (float)max_leaps);
}

// k whole transitions per launch with the shared Halton-jittered leap count
// of each absolute transition i0 + t, and the post-accept rows of every
// transition: theta, g (k, C, d); lp, accept, alpha (k, C); nleaps (k, C).
// Replaces pallas_glm.py _multistep_kernel with halton=True,
// collect_rows=True.  The leap count is the same for every chain of the
// launch, so with streamed rows every thread still makes the same glm_eval
// calls (the barrier rule of glm_common.cuh).
//
// Bound: the arithmetic of multistep_kernel (2 d N FMAs and N links per
// gradient) times the mean leap count; the rows add 2 (k C d) + 4 (k C)
// floats of writes per launch, small beside it.
template <int D>
__global__ void __launch_bounds__(kThreads)
multistep_rows_kernel(Glm p, Sched s, int C, float eps, float T, int i0,
                      int max_leaps, int k_trans, uint2 key,
                      const float* __restrict__ th_in, float* th_out,
                      float* g_out, float* lp_out, float* r_th, float* r_g,
                      float* r_lp, float* r_acc, float* r_alpha, int* r_nl) {
  extern __shared__ float sm[];
  stage<D>(p, sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int cc = c < C ? c : C - 1;
  float th[D], g[D];
  load_vec<D>(th, th_in, cc, p.d);
  float lp;
  glm_eval<D>(p, sm, th, g, &lp);
  for (int t = 0; t < k_trans; ++t) {
    const uint32_t ti = (uint32_t)(i0 + t);
    const int nl = halton_leaps(ti, T, eps, max_leaps);
    float m[D], thp[D], gp[D];
    // draws counted by (chain, absolute transition, draw): two normals per
    // Philox draw, the last draw gives the MH uniform
#pragma unroll
    for (int j = 0; j < D; j += 2) {
      uint4 b = philox(make_uint4((uint32_t)cc, ti, (uint32_t)(j / 2), 0u), key);
      m[j] = j < p.d ? box_muller(b.x, b.y) : 0.f;
      if (j + 1 < D) m[j + 1] = j + 1 < p.d ? box_muller(b.z, b.w) : 0.f;
    }
    uint4 bu = philox(make_uint4((uint32_t)cc, ti, 0xFFFFFFFFu, 0u), key);
    const float logu = logf(1.f - u01(bu.x));
#pragma unroll
    for (int j = 0; j < D; ++j) {
      thp[j] = th[j];
      gp[j] = g[j];
    }
    const float h0 = -lp + half_sq<D>(m);
    float lpp = trajectory<D>(p, sm, s, eps, nl, thp, m, gp);
    float ratio = h0 - (-lpp + half_sq<D>(m));
    if (isnan(ratio)) ratio = -CUDART_INF_F;
    const bool a = (ratio > 0.f) || (ratio > logu);
    if (a) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        th[j] = thp[j];
        g[j] = gp[j];
      }
      lp = lpp;
    }
    if (c < C) {
      const size_t at = (size_t)t * C;
      store_vec<D>(r_th + at * p.d, th, c, p.d);
      store_vec<D>(r_g + at * p.d, g, c, p.d);
      r_lp[at + c] = lp;
      r_acc[at + c] = a ? 1.f : 0.f;
      r_alpha[at + c] = expf(fminf(ratio, 0.f));
      r_nl[at + c] = nl;
    }
  }
  if (c < C) {
    store_vec<D>(th_out, th, c, p.d);
    store_vec<D>(g_out, g, c, p.d);
    lp_out[c] = lp;
  }
}

// ---- host side -------------------------------------------------------------

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

}  // namespace

extern "C" {

int glm_max_dim() { return 32; }

const char* glm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int glm_leapfrogs(const float* xt, const float* y, const float* w,
                  const float* o, int N, int d, int C, const float* th_in,
                  const float* m_in, const float* g_in, float* th_out,
                  float* m_out, float* g_out, float* lp_out, float eps,
                  float lam, int n_leaps, int kind, const int* sched_ops,
                  const float* sched_c, int n_ops, void* stream) {
  const int D = bound_for(d);
  Glm p;
  Sched s;
  size_t smem;
  if (!D || C < 1 || n_leaps < 1 ||
      !make_params(xt, y, w, o, nullptr, N, d, kind, lam, D, &p, &smem) ||
      !make_sched(sched_ops, sched_c, n_ops, &s))
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(DD)                                                          \
  {                                                                         \
    cudaError_t e = prepare(leapfrogs_kernel<DD>, smem);                    \
    if (e != cudaSuccess) return (int)e;                                    \
    leapfrogs_kernel<DD><<<blocks, kThreads, smem, st>>>(                   \
        p, s, C, eps, n_leaps, th_in, m_in, g_in, th_out, m_out, g_out,     \
        lp_out);                                                            \
  }
  GLM_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

int glm_step(const float* xt, const float* y, const float* w, const float* o,
             int N, int d, int C, const float* th_in, const float* g_in,
             const float* lp_in, const float* m0, const float* logu,
             float* th_out, float* g_out, float* lp_out, float* acc_out,
             float eps, float lam, int n_leaps, int kind,
             const int* sched_ops, const float* sched_c, int n_ops,
             void* stream) {
  const int D = bound_for(d);
  Glm p;
  Sched s;
  size_t smem;
  if (!D || C < 1 || n_leaps < 1 ||
      !make_params(xt, y, w, o, nullptr, N, d, kind, lam, D, &p, &smem) ||
      !make_sched(sched_ops, sched_c, n_ops, &s))
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(DD)                                                          \
  {                                                                         \
    cudaError_t e = prepare(step_kernel<DD>, smem);                         \
    if (e != cudaSuccess) return (int)e;                                    \
    step_kernel<DD><<<blocks, kThreads, smem, st>>>(                        \
        p, s, C, eps, n_leaps, th_in, g_in, lp_in, m0, logu, th_out, g_out, \
        lp_out, acc_out);                                                   \
  }
  GLM_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

int glm_multistep(const float* xt, const float* y, const float* w,
                  const float* o, int N, int d, int C, const float* th_in,
                  float* th_out, float* g_out, float* lp_out, float* acc_out,
                  float eps, float lam, int n_leaps, int k_trans, int kind,
                  unsigned long long seed, const int* sched_ops,
                  const float* sched_c, int n_ops, void* stream) {
  const int D = bound_for(d);
  Glm p;
  Sched s;
  size_t smem;
  if (!D || C < 1 || n_leaps < 1 || k_trans < 1 ||
      !make_params(xt, y, w, o, nullptr, N, d, kind, lam, D, &p, &smem) ||
      !make_sched(sched_ops, sched_c, n_ops, &s))
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + kThreads - 1) / kThreads;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(DD)                                                          \
  {                                                                         \
    cudaError_t e = prepare(multistep_kernel<DD>, smem);                    \
    if (e != cudaSuccess) return (int)e;                                    \
    multistep_kernel<DD><<<blocks, kThreads, smem, st>>>(                   \
        p, s, C, eps, n_leaps, k_trans, key, th_in, th_out, g_out, lp_out,  \
        acc_out);                                                           \
  }
  GLM_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

int glm_multistep_rows(const float* xt, const float* y, const float* w,
                       const float* o, const float* lamv, int N, int d, int C,
                       const float* th_in, float* th_out, float* g_out,
                       float* lp_out, float* r_th, float* r_g, float* r_lp,
                       float* r_acc, float* r_alpha, int* r_nl, float eps,
                       float T, float lam, int i0, int max_leaps, int k_trans,
                       int kind, unsigned long long seed, const int* sched_ops,
                       const float* sched_c, int n_ops, void* stream) {
  const int D = bound_for(d);
  Glm p;
  Sched s;
  size_t smem;
  if (!D || C < 1 || max_leaps < 1 || k_trans < 1 || i0 < 0 ||
      !(eps > 0.f) || !(T >= 0.f) ||
      !make_params(xt, y, w, o, lamv, N, d, kind, lam, D, &p, &smem) ||
      !make_sched(sched_ops, sched_c, n_ops, &s))
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + kThreads - 1) / kThreads;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(DD)                                                          \
  {                                                                         \
    cudaError_t e = prepare(multistep_rows_kernel<DD>, smem);               \
    if (e != cudaSuccess) return (int)e;                                    \
    multistep_rows_kernel<DD><<<blocks, kThreads, smem, st>>>(              \
        p, s, C, eps, T, i0, max_leaps, k_trans, key, th_in, th_out, g_out, \
        lp_out, r_th, r_g, r_lp, r_acc, r_alpha, r_nl);                     \
  }
  GLM_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
