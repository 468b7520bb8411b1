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
// The Pallas kernels share _glm_funcs + _trajectory.  Here glm_leapfrogs
// runs on the chain-tile gradient of glm_tile.cuh (traj_grad, shared with
// the NUTS kernels of glm_nuts.cu; the tile routines also with
// glm_bign.cu); glm_step, glm_multistep and glm_multistep_rows run on the
// device routines glm_eval (glm_common.cuh) and trajectory.
//
// Model: logp(theta) = sum_n w_n ll(z_n, y_n) - 1/2 sum_j lam_j theta_j^2
// with z_n = x_n . theta + o_n, and grad = sum_n w_n resid(z_n, y_n) x_n -
// lam theta; lam is a scalar, or a (d,) row for glm_multistep_rows (the
// diagonal-metric fold of the warm-start pipeline).
//
// What bounds them on the H100: at the main-path shape (d = 10, N = 1000)
// one gradient is d*N = 10k multiply-adds for z plus 10k for r x per chain,
// and one link per observation (logistic: expf, a division, a select; with
// ll also log1pf).  The design matrix (40 KB) is read from shared memory
// and never from device memory inside the trajectory, so bytes do not bound
// any of them: the products and the link's special functions do.
//
// glm_leapfrogs (kernel 1): a block takes a tile of 16 chains and runs their
// trajectory in lockstep (the leap count and schedule are the same for every
// chain of a launch).  Each gradient is two block products on the tensor
// cores (mma.sync m16n8k8, 3xTF32 for float32 accuracy) with the link in
// registers between them; the 16 warps split the row groups, and their
// partial gradients are summed in a fixed order through shared memory: two
// barriers per gradient.  The kicks and drifts are per-element register
// updates: thread e < 16 D owns one coordinate of one chain.  The rows, split
// into TF32 hi and lo parts once, stay resident in shared memory while they
// fit (N up to 1192 at d <= 16, 624 at d <= 32); above that they stream in
// double-buffered cp.async tiles at every gradient.  The blocks are
// persistent, one per SM (the resident rows take about 190 KB): each stages
// the rows once and walks the chain tiles blockIdx.x + k gridDim.x, so 4096
// chains (256 tiles) keep every SM busy.  What bounds it now is instruction
// issue on the CUDA cores, about 30 instructions per chain and observation
// (the link's expf and reciprocal, the fragment loads, the TF32 splits),
// with 16 warps per SM to hide the latency of the mma and link chains.
//
// glm_step, glm_multistep, glm_multistep_rows (kernels 2, 3, 3b): one thread
// per chain.  theta, m and g live in registers, the parameter count is a
// template bound D (d <= D, unused lanes are zero and stay zero), and the
// whole trajectory and accept run without touching device memory.  The
// observations (x_n, y_n, w_n, o_n) are staged in shared memory as rows of a
// fixed stride; all threads of a warp read the same row, which the shared
// memory broadcasts.  When N rows do not fit in the shared memory budget,
// the rows are streamed through shared memory tile by tile at every
// gradient.  A ragged last block of chains is masked: its idle threads still
// load tiles and reach every barrier.  These are bound by instruction issue:
// every row is a dependent chain of d FMAs, then the link, on 128-chain
// blocks that fill 32 of the 132 SMs at 4096 chains.
//
// In every kernel the log-likelihood sum is carried in double, so lp keeps
// full float precision after a 1000-term sum.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "glm_tile.cuh"

namespace {

constexpr int kThreads = 128;          // chains per block (kernels 2, 3, 3b)
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

// ---- kernel 1: the trajectory on the chain-tile gradient ------------------

// n_leaps macro steps of the schedule for a tile of 16 chains, in lockstep:
// the leap count and schedule are the same for every chain of the launch.
// Thread e < 16 D owns coordinate e % D of chain e / D and keeps its theta,
// m and g in registers: the kicks and drifts touch nothing else, and each
// gradient is the chain-tile routine with the rows split over the warps,
// then a fixed-order sum of the warps' partials.  The last drift's pass
// also gives lp (pallas_glm.py _trajectory), to threads e < 16.
template <int D>
__global__ void __launch_bounds__(kTrajThreads, 1)
leapfrogs_tile_kernel(Glm p, Sched s, int C, float eps, int n_leaps,
                      const float* __restrict__ th_in,
                      const float* __restrict__ m_in,
                      const float* __restrict__ g_in, float* th_out,
                      float* m_out, float* g_out, float* lp_out) {
  extern __shared__ double tile_sm[];
  double* pll = tile_sm;
  float* part = reinterpret_cast<float*>(pll + kTrajWarps * kTileChains);
  float* sth = part + kTrajWarps * kTileChains * D;
  float* rest = sth + kTileChains * D;
  float* raw = p.resident ? nullptr : rest;
  const Rows t = rows_at<D>(
      p.resident ? rest : rest + 2 * raw_row_floats(D) * p.tile, p.tile);
  const int tid = threadIdx.x;
  const bool own = tid < kTileChains * D;
  const int oc = tid / D, oj = tid % D;
  const bool live = own && oj < p.d;
  const float lam = live ? p.lam : 0.f;
  if (p.resident) stage_rows<D>(p, t, 0, p.N);  // once for all its tiles
  // persistent blocks: each walks the chain tiles blockIdx.x + k gridDim.x
  for (int c0 = blockIdx.x * kTileChains; c0 < C;
       c0 += gridDim.x * kTileChains) {
    const size_t at = (size_t)min(c0 + oc, C - 1) * p.d + oj;  // shadow
    float th = live ? th_in[at] : 0.f;
    float m = live ? m_in[at] : 0.f;
    float gr = live ? g_in[at] : 0.f;
    __syncthreads();  // the last tile's lp threads are done with sth
    if (own) sth[tid] = th;
    float lp = 0.f;
    for (int l = 0; l < n_leaps; ++l) {
      const bool final = l == n_leaps - 1;
      for (int k = 0; k < s.n; ++k) {
        const float ce = s.c[k] * eps;
        if (s.op[k] == 0) {
          m = m + ce * gr;
          continue;
        }
        th = th + ce * m;
        if (own) sth[tid] = th;
        const bool want = final && k == s.last_a;
        traj_grad<D>(p, t, raw, sth, part, pll, want);
        if (own) {
          float acc = 0.f;
          for (int w = 0; w < kTrajWarps; ++w)
            acc += part[w * kTileChains * D + tid];
          gr = acc - lam * th;
        }
        // lp as glm_eval forms it; no drift follows the last one, so theta
        // in sth stays put while these threads read it
        if (want && tid < kTileChains) {
          double ll = 0.0;
          for (int w = 0; w < kTrajWarps; ++w)
            ll += pll[w * kTileChains + tid];
          float quad = 0.f;
#pragma unroll
          for (int j = 0; j < D; ++j) {
            const float tj = sth[tid * D + j];
            const float pg = (j < p.d ? p.lam : 0.f) * tj;
            quad = fmaf(pg, tj, quad);
          }
          lp = (float)(ll - 0.5 * (double)quad);
        }
      }
    }
    if (live && c0 + oc < C) {
      const size_t o = (size_t)(c0 + oc) * p.d + oj;
      th_out[o] = th;
      m_out[o] = m;
      g_out[o] = gr;
    }
    if (tid < kTileChains && c0 + tid < C) lp_out[c0 + tid] = lp;
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
  const int D = tile_bound_for(d);
  Sched s;
  if (!D || C < 1 || N < 1 || n_leaps < 1 || kind < 0 || kind > 3 ||
      !make_sched(sched_ops, sched_c, n_ops, &s))
    return (int)cudaErrorInvalidValue;
  const TrajPlan tp = traj_plan(D, N);
  const Glm p{xt, y, w, o, nullptr, N, d, kind, lam, tp.rows, tp.resident};
  const int tiles = (C + kTileChains - 1) / kTileChains;
  int dev, sms, per_sm;
  cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 == cudaSuccess)
    e0 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e0 != cudaSuccess) return (int)e0;
  cudaStream_t st = (cudaStream_t)stream;
  // persistent blocks, as many as fit at once: the resident rows are
  // staged once per block, not once per tile
#define LAUNCH(DD)                                                          \
  {                                                                         \
    cudaError_t e = prepare(leapfrogs_tile_kernel<DD>, tp.smem);            \
    if (e == cudaSuccess)                                                   \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
          &per_sm, leapfrogs_tile_kernel<DD>, kTrajThreads, tp.smem);       \
    if (e != cudaSuccess) return (int)e;                                    \
    const int blocks = min(tiles, sms * max(per_sm, 1));                    \
    leapfrogs_tile_kernel<DD><<<blocks, kTrajThreads, tp.smem, st>>>(       \
        p, s, C, eps, n_leaps, th_in, m_in, g_in, th_out, m_out, g_out,     \
        lp_out);                                                            \
  }
  TILE_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

// How leapfrogs_tile_kernel runs at (d, N): blocks resident per SM (from
// the occupancy calculator), dynamic shared memory per block, and whether
// all rows stay resident.  Returns a CUDA error code.
int glm_leapfrogs_plan(int d, int N, int* blocks_per_sm, int* smem,
                       int* resident) {
  const int D = tile_bound_for(d);
  if (!D || N < 1) return (int)cudaErrorInvalidValue;
  const TrajPlan tp = traj_plan(D, N);
  *smem = (int)tp.smem;
  *resident = tp.resident ? 1 : 0;
#define PLAN(DD)                                                            \
  {                                                                         \
    cudaError_t e = prepare(leapfrogs_tile_kernel<DD>, tp.smem);            \
    if (e == cudaSuccess)                                                   \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
          blocks_per_sm, leapfrogs_tile_kernel<DD>, kTrajThreads, tp.smem); \
    if (e != cudaSuccess) return (int)e;                                    \
  }
  TILE_DISPATCH(D, PLAN)
#undef PLAN
  return 0;
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
