// Fused GLM-HMC kernels for Hopper (sm_90a): the trajectory, the whole
// transition, and k transitions per launch with the RNG inside the kernel.
//
// Replaces the Pallas kernels of mcmc_jl_tpu/ops/pallas_glm.py:
//   glm_leapfrogs  <- _kernel           (via _leapfrogs_inner / glm_hmc_leapfrogs)
//   glm_step       <- _step_kernel      (via _step_inner / glm_hmc_step)
//   glm_multistep  <- _multistep_kernel (halton=False, via _multistep_inner)
// all three sharing _glm_funcs + _trajectory, which here are the device
// routines glm_eval and trajectory.
//
// Model: logp(theta) = sum_n w_n ll(z_n, y_n) - lam/2 |theta|^2 with
// z_n = x_n . theta + o_n, and grad = sum_n w_n resid(z_n, y_n) x_n - lam theta.
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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // chains per block
constexpr int kSmemCap = 100 * 1024;   // dynamic shared memory budget, bytes
constexpr int kMaxOps = 8;             // longest kick/drift schedule

enum Link { kLogistic = 0, kLinear = 1, kPoisson = 2, kProbit = 3 };

// Kick ("B", op 0) / drift ("A", op 1) schedule, coefficients in units of eps
// (samplers/integrators.py SCHEDULES).
struct Sched {
  int n;
  int last_a;  // index of the final drift: its gradient also yields lp
  int op[kMaxOps];
  float c[kMaxOps];
};

struct Glm {
  const float* xt;  // (d, N) transposed design
  const float* y;   // (N,)
  const float* w;   // (N,) or null
  const float* o;   // (N,) or null
  int N, d, kind;
  float lam;
  int tile;         // rows per shared-memory tile
  bool resident;    // all N rows fit: load once per launch
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
// pass over the observations (pallas_glm.py _glm_funcs logp_grad).
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
    float pg = p.lam * th[j];
    g[j] = acc[j] - pg;
    quad = fmaf(pg, th[j], quad);
  }
  if (want_ll) *lp = (float)(ll_sum - 0.5 * (double)quad);
}

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

template <int D>
__device__ __forceinline__ float half_sq(const float (&m)[D]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) s = fmaf(m[j], m[j], s);
  return 0.5f * s;
}

// NaN-rejecting Metropolis test (samplers/base.py metropolis_accept).
__device__ __forceinline__ bool mh_accept(float h0, float h, float logu) {
  float ratio = h0 - h;
  if (isnan(ratio)) ratio = -CUDART_INF_F;
  return (ratio > 0.f) || (ratio > logu);
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

// With all rows resident, stage them once before the trajectory.
template <int D>
__device__ __forceinline__ void stage(const Glm& p, float* sm) {
  if (p.resident) {
    load_rows<D>(p, sm, 0, p.N);
    __syncthreads();
  }
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

// Philox4x32-10 (Salmon et al., SC'11): counter (chain, transition, draw, 0),
// key = the launch seed.
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

// ---- host side -------------------------------------------------------------

int bound_for(int d) {
  // d = 10 is the main path; the powers of two cover the rest up to 32
  const int bounds[] = {8, 10, 16, 32};
  for (int b : bounds)
    if (d <= b) return b;
  return 0;
}

bool make_params(const float* xt, const float* y, const float* w,
                 const float* o, int N, int d, int kind, float lam, int D,
                 Glm* p, size_t* smem) {
  if (N < 1 || d < 1 || kind < 0 || kind > 3) return false;
  const size_t row = (size_t)stride_for(D) * sizeof(float);
  int tile = (int)(kSmemCap / row);
  if (tile > N) tile = N;
  *p = Glm{xt, y, w, o, N, d, kind, lam, tile, tile >= N};
  *smem = (size_t)tile * row;
  return true;
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
      !make_params(xt, y, w, o, N, d, kind, lam, D, &p, &smem) ||
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
      !make_params(xt, y, w, o, N, d, kind, lam, D, &p, &smem) ||
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
      !make_params(xt, y, w, o, N, d, kind, lam, D, &p, &smem) ||
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

}  // extern "C"
