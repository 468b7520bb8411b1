// Fused HMC on catalog targets for Hopper (sm_90a): the trajectory, and k
// whole transitions per launch with the RNG inside the kernel; and one
// (logp, gradient) pass.
//
// Replaces the Pallas kernels of mcmc_jl_tpu/ops/pallas_target.py:
//   target_leapfrogs <- _kernel           (fused_target_leapfrogs; vec_eps
//                                           and dyn_len: the step is a scalar
//                                           or a (d,) row, the leap count a
//                                           launch argument)
//   target_multistep <- _multistep_kernel (_multistep_inner /
//                                           run_target_hmc_multistep)
// and, with no Pallas counterpart, the XLA-compiled jax.value_and_grad of
// the JAX model (mcmc_jl_tpu/models/model.py:361) that the generic engine
// evaluates at every leaf:
//   target_logp_grad <- one gradient pass for all chains, sanitized as the
//                       generic engine's model gradient is
// The Pallas kernels differentiate the user's logp_block with jax.vjp inside
// the kernel.  CUDA has no autodiff, so these kernels take a catalog target
// (a product of the ten continuous families over the coordinates, with scalar
// parameters) and evaluate each coordinate's (logp, dlogp/dx) pair
// analytically (target_common.cuh); every other model runs on the generic
// torch engine.
//
// What bounds it on the H100: one leapfrog of one chain is d independent
// coordinate updates of a few tens of FP32 operations each (a division or
// two, a logf or powf for some families), and one sum over the coordinates
// when lp is needed.  State lives in registers for the whole trajectory, so
// device memory sees theta, m, g once in and once out per launch (12 d bytes
// per chain in, 12 d + 4 out): at d = 10 and 10 leapfrogs, counting 20 FP32
// operations per coordinate and leapfrog, that is about 8 FLOP per byte,
// under the card's 20 FP32 FLOP per byte, so the bytes bound it on paper;
// at 4096 chains that is a few microseconds, under a launch's fixed cost.
// The multistep kernel reads theta once and writes theta, g, lp and the
// accept rate once for k transitions, so its operations bound it.
//
// Two layouts for each kernel, chosen up front from d (*_launch_for):
//
// d <= 32 (leapfrogs_lane_kernel, multistep_lane_kernel,
// logp_grad_lane_kernel; target_lane.cuh): one chain per lane, 32 chains a
// block, W warps sharing their coordinates (coordinate j in warp j % W; W
// from lane_warps: D up to one group an SM, 4 above).  A leapfrog is
// coordinate-local, so each warp runs its coordinates' kicks and drifts in
// registers and their family derivatives in a loop over its coordinates
// that is the same for every lane (the family branch and the step
// warp-uniform, one copy of the families' code for the gradient and one for
// the final lp; lane_trajectory, which the trajectory and multistep kernels
// share); the warps exchange nothing until lp at the last drift, the one
// sum across warps.  The multistep kernel adds one barrier a transition,
// after which every warp sums the W warps' partials of |m0|^2, lp and |m|^2
// in warp order and takes the same accept decision.  Lanes past C shadow
// chain C - 1 and store nothing.
//
// d > 32: one warp per chain, four chains per 128-thread block; lane l
// holds coordinates l, l + 32, ... in registers (CPL per lane, a template
// bound, so d <= 1024 runs one code path); the d family rows are staged in
// shared memory once per block.
//
// Kernel 5 also takes a dense target (target_common.cuh): its DENSE
// instantiations run the same trajectory on z at a scalar step, each
// gradient pass the z-space pass (two triangular products around the
// families); in the lane layout that pass is the one exchange between warps
// besides lp, two block barriers a pass (target_lane.cuh lane_dense_theta,
// lane_dense_grad).  L costs 2 d (d + 1) FP32 operations a pass and chain
// (at d 1024 it is 4 MB, read from L2 by every chain's warp: those reads
// bound the warp layout there).
//
// Kick and drift round each product and sum separately (__fmul_rn /
// __fadd_rn), as the plain PyTorch version does, in both layouts: theta, m
// and g come out the same bits in both, lp summed in another order.
// The multistep kernel's Philox counters are (chain, absolute transition
// i0 + t, coordinate, stream), the same in both layouts, with the momenta on
// stream 0 and the MH uniform on stream 1, keyed by a seed drawn per launch,
// so no launch and no coordinate reuses a counter.  ops/target_kernels.py
// target_multistep_draws replays these draws on the host for the plain
// version: change both together.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "target_lane.cuh"

namespace {

// n_leaps macro steps of the schedule; returns lp at the end point, from
// the last drift's gradient pass (pallas_glm.py _trajectory).  With DENSE
// th is z and each gradient pass the z-space pass (L the factor, zs this
// warp's slice of shared memory).
template <int CPL, bool DENSE = false>
__device__ float trajectory(const Row* rows, int d, int lane, const Sched& s,
                            const float (&e)[CPL], int n_leaps,
                            float (&th)[CPL], float (&m)[CPL],
                            float (&g)[CPL], const float* L = nullptr,
                            float* zs = nullptr) {
  float lp = 0.f;
  for (int l = 0; l < n_leaps; ++l) {
    const bool final = l == n_leaps - 1;
    for (int k = 0; k < s.n; ++k) {
      if (s.op[k] == 0) {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          m[i] = __fadd_rn(m[i], __fmul_rn(__fmul_rn(s.c[k], e[i]), g[i]));
      } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          th[i] = __fadd_rn(th[i], __fmul_rn(__fmul_rn(s.c[k], e[i]), m[i]));
        if (final && k == s.last_a)
          lp = grad_at<CPL, true, DENSE>(rows, L, zs, d, lane, th, g);
        else
          grad_at<CPL, false, DENSE>(rows, L, zs, d, lane, th, g);
      }
    }
  }
  return lp;
}

// The step of each of this lane's coordinates: the scalar, or the row.
template <int CPL>
__device__ __forceinline__ void load_eps(float (&e)[CPL], float eps,
                                         const float* eps_row, int d,
                                         int lane) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    e[i] = eps_row ? (j < d ? eps_row[j] : 0.f) : eps;
  }
}

template <int CPL, bool DENSE>
__global__ void __launch_bounds__(kThreads)
leapfrogs_kernel(Target t, Sched s, int C, float eps,
                 const float* __restrict__ eps_row, int n_leaps,
                 const float* __restrict__ th_in,
                 const float* __restrict__ m_in,
                 const float* __restrict__ g_in, float* th_out, float* m_out,
                 float* g_out, float* lp_out) {
  extern __shared__ Row rows[];
  stage_rows(t, rows);
  float* zs = DENSE ? warp_slice(rows, t.d) : nullptr;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (c >= C) return;  // the whole warp: no barrier follows
  float th[CPL], m[CPL], g[CPL], e[CPL];
  load_lane<CPL>(th, th_in, c, t.d, lane);
  load_lane<CPL>(m, m_in, c, t.d, lane);
  load_lane<CPL>(g, g_in, c, t.d, lane);
  load_eps<CPL>(e, eps, eps_row, t.d, lane);
  const float lp = trajectory<CPL, DENSE>(rows, t.d, lane, s, e, n_leaps, th,
                                         m, g, t.L, zs);
  store_lane<CPL>(th_out, th, c, t.d, lane);
  store_lane<CPL>(m_out, m, c, t.d, lane);
  store_lane<CPL>(g_out, g, c, t.d, lane);
  if (lane == 0) lp_out[c] = lp;
}

// Kernel 5's trajectory in the lane layout, which kernel 6 runs too: n_leaps
// macro steps of the schedule (pallas_glm.py _trajectory) on this warp's
// coordinates of its lane's chain, th, m and g in registers and the family
// operands through x (D, 32) in shared memory.  Returns this warp's share of
// lp at the end point, from the last drift's gradient pass.  No exchange
// between warps: a leapfrog is coordinate-local.  With DENSE th is z, which
// each drift writes to z (D, 32), and each gradient pass is the z-space pass
// (Ls the factor L in shared memory): two block barriers, every warp.
template <int D, int W, bool DENSE = false>
__device__ __forceinline__ float lane_trajectory(
    const Row* rows, float* x, int d, int nown, const Sched& s,
    const float (&e)[lane_slots<W>(D)], int n_leaps,
    float (&th)[lane_slots<W>(D)], float (&m)[lane_slots<W>(D)],
    float (&g)[lane_slots<W>(D)], const float* Ls = nullptr,
    float* z = nullptr) {
  constexpr int DW = lane_slots<W>(D);
  float part = 0.f;
  for (int l = 0; l < n_leaps; ++l) {
    const bool final = l == n_leaps - 1;
    for (int k = 0; k < s.n; ++k) {
      const float ck = s.c[k];
      if (s.op[k] == 0) {
#pragma unroll
        for (int jj = 0; jj < DW; ++jj)
          m[jj] = __fadd_rn(m[jj], __fmul_rn(__fmul_rn(ck, e[jj]), g[jj]));
        continue;
      }
#pragma unroll
      for (int jj = 0; jj < DW; ++jj) {
        th[jj] = __fadd_rn(th[jj], __fmul_rn(__fmul_rn(ck, e[jj]), m[jj]));
        if (lane_coord<W>(jj) < d)
          *lane_at<D>(DENSE ? z : x, 0, lane_coord<W>(jj)) = th[jj];
      }
      if constexpr (DENSE) lane_dense_theta<D, W>(Ls, z, x, d, nown);
      if (final && k == s.last_a)
        part = lane_family<D, W, true, true>(rows, x, nown);
      else
        lane_family<D, W, false, true>(rows, x, nown);
      if constexpr (DENSE) {
        lane_dense_grad<D, W>(Ls, x, d, g);
      } else {
#pragma unroll
        for (int jj = 0; jj < DW; ++jj)
          if (lane_coord<W>(jj) < d)
            g[jj] = *lane_at<D>(x, 0, lane_coord<W>(jj));
      }
    }
  }
  return part;
}

// Shared memory of the trajectory and gradient lane kernels after the rows:
// the family loop's operands (D, 32), then each warp's lp partial (W, 32).
size_t leapfrogs_lane_smem(int d, int D, int W) {
  return lane_rows_bytes(d) + sizeof(float) * (size_t)(D + W) * kWarp;
}

// The dense kernel's: then z (D, 32) and L (d, d).
size_t leapfrogs_lane_dense_smem(int d, int D, int W) {
  return leapfrogs_lane_smem(d, D, W) +
         sizeof(float) * ((size_t)D * kWarp + (size_t)d * d);
}

// One chain per lane; the W warps of a block each run the trajectory of
// their coordinates of the block's 32 chains, and sum lp from the last
// drift's gradient pass across the warps at the end.
template <int D, int W, bool DENSE>
__global__ void __launch_bounds__(W * kWarp)
leapfrogs_lane_kernel(Target t, Sched s, int C, float eps,
                      const float* __restrict__ eps_row, int n_leaps,
                      const float* __restrict__ th_in,
                      const float* __restrict__ m_in,
                      const float* __restrict__ g_in, float* th_out,
                      float* m_out, float* g_out, float* lp_out) {
  constexpr int DW = lane_slots<W>(D);
  extern __shared__ float4 lane_sm[];
  const int d = t.d;
  const Row* rows = lane_rows(t, lane_sm);
  float* x = reinterpret_cast<float*>(reinterpret_cast<char*>(lane_sm) +
                                      lane_rows_bytes(d));
  float* xch = x + D * kWarp;  // [warp][lane]
  float* z = xch + W * kWarp;  // dense: z (D, 32), then L (d, d)
  float* Ls = z + D * kWarp;
  if (DENSE) lane_stage_factor(t.L, Ls, d);
  const int w = threadIdx.x / kWarp;
  const int nown = lane_owned<W>(d);
  const int c0 = blockIdx.x * kWarp + (threadIdx.x & (kWarp - 1));
  const int c = min(c0, C - 1);

  float th[DW], m[DW], g[DW], e[DW];
#pragma unroll
  for (int jj = 0; jj < DW; ++jj) {
    const int j = lane_coord<W>(jj);
    const size_t at = (size_t)c * d + j;
    th[jj] = j < d ? th_in[at] : 0.f;
    m[jj] = j < d ? m_in[at] : 0.f;
    g[jj] = j < d ? g_in[at] : 0.f;
    e[jj] = j < d ? (eps_row ? eps_row[j] : eps) : 0.f;
  }
  __syncthreads();  // the rows (and L)

  *partial_at<W>(xch, 1, 0, w, 0) = lane_trajectory<D, W, DENSE>(
      rows, x, d, nown, s, e, n_leaps, th, m, g, Ls, z);
  __syncthreads();
  if (c0 < C) {
#pragma unroll
    for (int jj = 0; jj < DW; ++jj) {
      const int j = lane_coord<W>(jj);
      const size_t at = (size_t)c * d + j;
      if (j < d) {
        th_out[at] = th[jj];
        m_out[at] = m[jj];
        g_out[at] = g[jj];
      }
    }
    if (w == 0) lp_out[c] = partial_sum<W>(xch, 1, 0, 0);
  }
}

// The generic engine's sanitizing of a (logp, gradient) pair
// (models/model.py _sanitize_allg): a NaN lp is -inf, and the gradient is
// 0 where lp is not finite and where it is not finite itself.
__device__ __forceinline__ float sanitized_lp(float lp) {
  return isnan(lp) ? -CUDART_INF_F : lp;
}

__device__ __forceinline__ float sanitized_g(bool lp_finite, float g) {
  return lp_finite && isfinite(g) ? g : 0.f;
}

// lp and the gradient at th for every chain, sanitized: the generic
// engine's model.evalallg on the card for a catalog DSL model in float32.
// Device memory sees theta once in and the gradient and lp once out.
template <int CPL>
__global__ void __launch_bounds__(kThreads)
logp_grad_kernel(Target t, int C, const float* __restrict__ th_in,
                 float* g_out, float* lp_out) {
  extern __shared__ Row rows[];
  stage_rows(t, rows);
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (c >= C) return;
  float th[CPL], g[CPL];
  load_lane<CPL>(th, th_in, c, t.d, lane);
  const float lp = sanitized_lp(eval_grad<CPL, true>(rows, t.d, lane, th, g));
#pragma unroll
  for (int i = 0; i < CPL; ++i) g[i] = sanitized_g(isfinite(lp), g[i]);
  store_lane<CPL>(g_out, g, c, t.d, lane);
  if (lane == 0) lp_out[c] = lp;
}

// The same pass with one chain per lane: each warp evaluates its
// coordinates' families (one lane_family pass), then the W partials of lp
// are summed in warp order after one barrier.  Lanes past C shadow chain
// C - 1 and store nothing.  A lane reads and writes its own chain, a
// stride of d floats across the warp: staging the group's contiguous
// block through shared memory coalesced it, 1.9-2.5x faster at d 32 but
// 1.2-2.5x slower at d 10 (PERF.md section 6), so it stays direct.
template <int D, int W>
__global__ void __launch_bounds__(W * kWarp)
logp_grad_lane_kernel(Target t, int C, const float* __restrict__ th_in,
                      float* g_out, float* lp_out) {
  extern __shared__ float4 lane_sm[];
  const int d = t.d;
  const Row* rows = lane_rows(t, lane_sm);
  float* x = reinterpret_cast<float*>(reinterpret_cast<char*>(lane_sm) +
                                      lane_rows_bytes(d));
  float* xch = x + D * kWarp;  // [warp][lane]
  const int w = threadIdx.x / kWarp;
  const int nown = lane_owned<W>(d);
  const int c0 = blockIdx.x * kWarp + (threadIdx.x & (kWarp - 1));
  const int c = min(c0, C - 1);
  for (int jj = 0; jj < nown; ++jj) {
    const int j = lane_coord<W>(jj);
    *lane_at<D>(x, 0, j) = th_in[(size_t)c * d + j];
  }
  __syncthreads();  // the rows
  *partial_at<W>(xch, 1, 0, w, 0) =
      lane_family<D, W, true, true>(rows, x, nown);
  __syncthreads();
  if (c0 < C) {
    const float lp = sanitized_lp(partial_sum<W>(xch, 1, 0, 0));
    for (int jj = 0; jj < nown; ++jj) {
      const int j = lane_coord<W>(jj);
      g_out[(size_t)c * d + j] =
          sanitized_g(isfinite(lp), *lane_at<D>(x, 0, j));
    }
    if (w == 0) lp_out[c] = lp;
  }
}

// k whole transitions per launch: Box-Muller momenta and the MH uniform from
// Philox inside the kernel, the trajectory, the accept; lp and the gradient
// at the start computed here (pallas_target.py:227-230).
template <int CPL>
__global__ void __launch_bounds__(kThreads)
multistep_kernel(Target t, Sched s, int C, float eps,
                 const float* __restrict__ eps_row, int n_leaps, int k_trans,
                 int i0, uint2 key, const float* __restrict__ th_in,
                 float* th_out, float* g_out, float* lp_out, float* acc_out) {
  extern __shared__ Row rows[];
  stage_rows(t, rows);
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (c >= C) return;
  const int d = t.d;
  float th[CPL], g[CPL], e[CPL];
  load_lane<CPL>(th, th_in, c, d, lane);
  load_eps<CPL>(e, eps, eps_row, d, lane);
  float lp = eval_grad<CPL, true>(rows, d, lane, th, g);
  float n_acc = 0.f;
  for (int t_ = 0; t_ < k_trans; ++t_) {
    const uint32_t ti = (uint32_t)(i0 + t_);
    float m[CPL], thp[CPL], gp[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int j = lane + kWarp * i;
      uint4 b = philox(make_uint4((uint32_t)c, ti, (uint32_t)j, 0u), key);
      m[i] = j < d ? box_muller(b.x, b.y) : 0.f;
      thp[i] = th[i];
      gp[i] = g[i];
    }
    const uint4 bu = philox(make_uint4((uint32_t)c, ti, 0u, 1u), key);
    const float logu = logf(1.f - u01(bu.x));
    const float h0 = -lp + half_sq<CPL>(m);
    const float lpp = trajectory<CPL>(rows, d, lane, s, e, n_leaps, thp, m,
                                      gp);
    if (mh_accept(h0 - (-lpp + half_sq<CPL>(m)), logu)) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        th[i] = thp[i];
        g[i] = gp[i];
      }
      lp = lpp;
      n_acc += 1.f;
    }
  }
  store_lane<CPL>(th_out, th, c, d, lane);
  store_lane<CPL>(g_out, g, c, d, lane);
  if (lane == 0) {
    lp_out[c] = lp;
    acc_out[c] = n_acc / (float)k_trans;
  }
}

// Shared memory of the multistep lane kernel after the rows: the family
// loop's operands (D, 32), the chain's current theta and gradient (2, D,
// 32), then the warps' partials, two buffers of (W, 3, 32) floats: |m0|^2
// (q 0), lp at the end point (q 1) and |m|^2 (q 2) of this warp's
// coordinates.
size_t multistep_lane_smem(int d, int D, int W) {
  return lane_rows_bytes(d) +
         sizeof(float) * ((size_t)3 * D * kWarp + (size_t)2 * W * 3 * kWarp);
}

// k whole transitions with one chain per lane.  Each warp draws its
// coordinates' momenta on the warp kernel's Philox counters (chain,
// transition, coordinate, 0) and the MH uniform on (chain, transition, 0,
// 1), runs kernel 5's trajectory on its coordinates, and leaves its
// partials of |m0|^2, lp' and |m|^2; after one barrier a transition every
// warp sums the W partials in warp order, so all take the same accept
// decision on the same bits (NaN rejects, pallas_target.py:242).  The
// current theta and gradient wait in shared memory while the proposal runs
// in registers (at D 32 and W 4 both in registers spilled).  Lanes past C
// shadow chain C - 1 and store nothing; no thread returns early.
template <int D, int W>
__global__ void __launch_bounds__(W * kWarp)
multistep_lane_kernel(Target t, Sched s, int C, float eps,
                      const float* __restrict__ eps_row, int n_leaps,
                      int k_trans, int i0, uint2 key,
                      const float* __restrict__ th_in, float* th_out,
                      float* g_out, float* lp_out, float* acc_out) {
  constexpr int DW = lane_slots<W>(D);
  constexpr int NQ = 3;
  extern __shared__ float4 lane_sm[];
  const int d = t.d;
  const Row* rows = lane_rows(t, lane_sm);
  float* x = reinterpret_cast<float*>(reinterpret_cast<char*>(lane_sm) +
                                      lane_rows_bytes(d));
  float* cur = x + D * kWarp;        // [theta, g][coordinate][lane]
  float* xch = cur + 2 * D * kWarp;  // [buf][warp][|m0|^2, lp', |m|^2][lane]
  const int w = threadIdx.x / kWarp;
  const int nown = lane_owned<W>(d);
  const int c0 = blockIdx.x * kWarp + (threadIdx.x & (kWarp - 1));
  const int c = min(c0, C - 1);

  float e[DW];
  for (int jj = 0; jj < nown; ++jj) {
    const int j = lane_coord<W>(jj);
    *lane_at<D>(x, 0, j) = *lane_at<D>(cur, 0, j) = th_in[(size_t)c * d + j];
  }
#pragma unroll
  for (int jj = 0; jj < DW; ++jj) {
    const int j = lane_coord<W>(jj);
    e[jj] = j < d ? (eps_row ? eps_row[j] : eps) : 0.f;
  }
  __syncthreads();  // the rows
  int buf = 0;
  *partial_at<W>(xch, NQ, buf, w, 1) =
      lane_family<D, W, true, true>(rows, x, nown);
  for (int jj = 0; jj < nown; ++jj) {
    const int j = lane_coord<W>(jj);
    *lane_at<D>(cur, 1, j) = *lane_at<D>(x, 0, j);
  }
  __syncthreads();
  float lp = partial_sum<W>(xch, NQ, buf, 1);
  buf ^= 1;

  float n_acc = 0.f;
  for (int t_ = 0; t_ < k_trans; ++t_) {
    const uint32_t ti = (uint32_t)(i0 + t_);
    float m[DW], thp[DW], gp[DW];
    float sq0 = 0.f;
#pragma unroll
    for (int jj = 0; jj < DW; ++jj) {
      const int j = lane_coord<W>(jj);
      float z = 0.f, th0 = 0.f, g0 = 0.f;  // past d: m, theta and g stay 0
      if (j < d) {
        const uint4 b =
            philox(make_uint4((uint32_t)c, ti, (uint32_t)j, 0u), key);
        z = box_muller(b.x, b.y);
        th0 = *lane_at<D>(cur, 0, j);
        g0 = *lane_at<D>(cur, 1, j);
      }
      m[jj] = z;
      sq0 = fmaf(z, z, sq0);
      thp[jj] = th0;
      gp[jj] = g0;
    }
    const uint4 bu = philox(make_uint4((uint32_t)c, ti, 0u, 1u), key);
    const float logu = logf(1.f - u01(bu.x));
    const float part =
        lane_trajectory<D, W>(rows, x, d, nown, s, e, n_leaps, thp, m, gp);
    float sq1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < DW; ++jj) sq1 = fmaf(m[jj], m[jj], sq1);
    *partial_at<W>(xch, NQ, buf, w, 0) = sq0;
    *partial_at<W>(xch, NQ, buf, w, 1) = part;
    *partial_at<W>(xch, NQ, buf, w, 2) = sq1;
    __syncthreads();
    const float h0 = -lp + 0.5f * partial_sum<W>(xch, NQ, buf, 0);
    const float lpp = partial_sum<W>(xch, NQ, buf, 1);
    const float h1 = -lpp + 0.5f * partial_sum<W>(xch, NQ, buf, 2);
    buf ^= 1;
    if (mh_accept(h0 - h1, logu)) {
#pragma unroll
      for (int jj = 0; jj < DW; ++jj) {
        const int j = lane_coord<W>(jj);
        if (j < d) {
          *lane_at<D>(cur, 0, j) = thp[jj];
          *lane_at<D>(cur, 1, j) = gp[jj];
        }
      }
      lp = lpp;
      n_acc += 1.f;
    }
  }
  if (c0 < C) {
    for (int jj = 0; jj < nown; ++jj) {
      const int j = lane_coord<W>(jj);
      th_out[(size_t)c * d + j] = *lane_at<D>(cur, 0, j);
      g_out[(size_t)c * d + j] = *lane_at<D>(cur, 1, j);
    }
    if (w == 0) {
      lp_out[c] = lp;
      acc_out[c] = n_acc / (float)k_trans;
    }
  }
}

// Warps a lane block at bound D and C chains, for the trajectory, multistep
// and gradient kernels: one coordinate per warp (W = D) while the groups
// are no more than the SMs, else kLaneWarps.  With one block an SM or fewer
// D warps hide each other's latency where four leave one warp a scheduler;
// with more blocks an SM four warps a block keep the schedulers busy, and D
// warps only add the idle warps past d and each warp's loop overhead.  At
// d 10 on one H100 (PERF.md section 6): kernel 5, D warps 16-25% faster at
// 1024-4096 chains, four 1.1-1.8x faster at 6144-65,536; kernel 6, D 1.2x
// faster at 1024-4096, four 1.2-2.4x faster at 8192-65,536; the gradient
// pass, D 1.2x faster at 1024-4096, four 1.3-1.6x at 16,384-65,536.
int lane_warps(int D, int C) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return kLaneWarps;
  return (C + kWarp - 1) / kWarp <= sms ? D : kLaneWarps;
}

// The kernel, grid and shared memory of a launch at (d, C), the layout
// decided from d alone: one chain per lane at d <= 32 (LANE<D, W>, W from
// lane_warps, SMEM(d, D, W) bytes), one warp per chain above (WARP<CPL>).
// False when the kernels do not take it.
#define LAUNCH_FOR(L, d, C, LANE, WARP, SMEM)                               \
  {                                                                         \
    if ((d) < 1 || (d) > kMaxDim || (C) < 1) return false;                  \
    const int D = lane_bound_for(d);                                        \
    if (!D) {                                                               \
      (L)->kernel = cpl_for(d) == 4 ? WARP<4> : WARP<32>;                   \
      (L)->blocks = blocks_for(C);                                          \
      (L)->threads = kThreads;                                              \
      (L)->smem = (size_t)(d) * sizeof(Row);                                \
      return true;                                                          \
    }                                                                       \
    const int W = lane_warps(D, C);                                         \
    (L)->kernel = D == 8    ? (W == 8 ? LANE<8, 8> : LANE<8, kLaneWarps>)   \
                  : D == 16 ? (W == 16 ? LANE<16, 16> : LANE<16, kLaneWarps>) \
                            : (W == 32 ? LANE<32, 32> : LANE<32, kLaneWarps>); \
    (L)->blocks = ((C) + kWarp - 1) / kWarp;                                \
    (L)->threads = W * kWarp;                                               \
    (L)->smem = SMEM(d, D, W);                                              \
    return true;                                                            \
  }

using LeapfrogsKernel = void (*)(Target, Sched, int, float, const float*,
                                 int, const float*, const float*,
                                 const float*, float*, float*, float*,
                                 float*);
using LogpGradKernel = void (*)(Target, int, const float*, float*, float*);
using MultistepKernel = void (*)(Target, Sched, int, float, const float*,
                                 int, int, int, uint2, const float*, float*,
                                 float*, float*, float*);

// Kernel 5's launch (LAUNCH_FOR with the DENSE instantiations and their
// shared memory).
template <bool DENSE>
bool leapfrogs_launch_for(int d, int C, LaneLaunch<LeapfrogsKernel>* L) {
  if (d < 1 || d > kMaxDim || C < 1) return false;
  const int D = lane_bound_for(d);
  if (!D) {
    L->kernel = cpl_for(d) == 4 ? leapfrogs_kernel<4, DENSE>
                                : leapfrogs_kernel<32, DENSE>;
    L->blocks = blocks_for(C);
    L->threads = kThreads;
    L->smem = warp_smem(d, DENSE);
    return true;
  }
  const int W = lane_warps(D, C);
  L->kernel =
      D == 8 ? (W == 8 ? leapfrogs_lane_kernel<8, 8, DENSE>
                       : leapfrogs_lane_kernel<8, kLaneWarps, DENSE>)
      : D == 16 ? (W == 16 ? leapfrogs_lane_kernel<16, 16, DENSE>
                           : leapfrogs_lane_kernel<16, kLaneWarps, DENSE>)
                : (W == 32 ? leapfrogs_lane_kernel<32, 32, DENSE>
                           : leapfrogs_lane_kernel<32, kLaneWarps, DENSE>);
  L->blocks = (C + kWarp - 1) / kWarp;
  L->threads = W * kWarp;
  L->smem = DENSE ? leapfrogs_lane_dense_smem(d, D, W)
                  : leapfrogs_lane_smem(d, D, W);
  return true;
}

bool logp_grad_launch_for(int d, int C, LaneLaunch<LogpGradKernel>* L) {
  LAUNCH_FOR(L, d, C, logp_grad_lane_kernel, logp_grad_kernel,
             leapfrogs_lane_smem);
}

bool multistep_launch_for(int d, int C, LaneLaunch<MultistepKernel>* L) {
  LAUNCH_FOR(L, d, C, multistep_lane_kernel, multistep_kernel,
             multistep_lane_smem);
}

#undef LAUNCH_FOR

// Kernel 5 on a catalog target (factor null) or, with DENSE, on a dense
// target at a scalar step (factor: L and L', (2, d, d)).
template <bool DENSE>
int leapfrogs_entry(const float* factor, const int* codes,
                    const float* params, int d, int C, const float* th_in,
                    const float* m_in, const float* g_in, float* th_out,
                    float* m_out, float* g_out, float* lp_out, float eps,
                    const float* eps_row, int n_leaps, const int* sched_ops,
                    const float* sched_c, int n_ops, void* stream) {
  LaneLaunch<LeapfrogsKernel> L;
  Sched s;
  if (!leapfrogs_launch_for<DENSE>(d, C, &L) || n_leaps < 1 ||
      !make_sched(sched_ops, sched_c, n_ops, &s) ||
      (DENSE && (factor == nullptr || eps_row != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = lane_prepare(L);
  if (e != cudaSuccess) return (int)e;
  L.kernel<<<L.blocks, L.threads, L.smem, (cudaStream_t)stream>>>(
      Target{codes, params, d, factor}, s, C, eps, eps_row, n_leaps, th_in,
      m_in, g_in, th_out, m_out, g_out, lp_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int target_leapfrogs(const int* codes, const float* params, int d, int C,
                     const float* th_in, const float* m_in,
                     const float* g_in, float* th_out, float* m_out,
                     float* g_out, float* lp_out, float eps,
                     const float* eps_row, int n_leaps, const int* sched_ops,
                     const float* sched_c, int n_ops, void* stream) {
  return leapfrogs_entry<false>(nullptr, codes, params, d, C, th_in, m_in,
                                g_in, th_out, m_out, g_out, lp_out, eps,
                                eps_row, n_leaps, sched_ops, sched_c, n_ops,
                                stream);
}

// The same trajectory on a dense target: factor holds L and L' ((2, d, d)
// floats), the step is the scalar eps (eps_row must be null).
int target_leapfrogs_dense(const float* factor, const int* codes,
                           const float* params, int d, int C,
                           const float* th_in, const float* m_in,
                           const float* g_in, float* th_out, float* m_out,
                           float* g_out, float* lp_out, float eps,
                           const float* eps_row, int n_leaps,
                           const int* sched_ops, const float* sched_c,
                           int n_ops, void* stream) {
  return leapfrogs_entry<true>(factor, codes, params, d, C, th_in, m_in,
                               g_in, th_out, m_out, g_out, lp_out, eps,
                               eps_row, n_leaps, sched_ops, sched_c, n_ops,
                               stream);
}

// How a trajectory launch at (d, C) runs: blocks, blocks resident per SM,
// threads and dynamic shared memory per block; the same for the dense
// instantiation (target_leapfrogs_dense_plan).
int target_leapfrogs_plan(int d, int C, int* blocks, int* blocks_per_sm,
                          int* threads, int* smem) {
  LaneLaunch<LeapfrogsKernel> L;
  if (!leapfrogs_launch_for<false>(d, C, &L))
    return (int)cudaErrorInvalidValue;
  return lane_plan(L, blocks, blocks_per_sm, threads, smem);
}

int target_leapfrogs_dense_plan(int d, int C, int* blocks, int* blocks_per_sm,
                                int* threads, int* smem) {
  LaneLaunch<LeapfrogsKernel> L;
  if (!leapfrogs_launch_for<true>(d, C, &L))
    return (int)cudaErrorInvalidValue;
  return lane_plan(L, blocks, blocks_per_sm, threads, smem);
}

int target_logp_grad(const int* codes, const float* params, int d, int C,
                     const float* th_in, float* g_out, float* lp_out,
                     void* stream) {
  LaneLaunch<LogpGradKernel> L;
  if (!logp_grad_launch_for(d, C, &L)) return (int)cudaErrorInvalidValue;
  cudaError_t e = lane_prepare(L);
  if (e != cudaSuccess) return (int)e;
  L.kernel<<<L.blocks, L.threads, L.smem, (cudaStream_t)stream>>>(
      Target{codes, params, d}, C, th_in, g_out, lp_out);
  return (int)cudaGetLastError();
}

int target_multistep(const int* codes, const float* params, int d, int C,
                     const float* th_in, float* th_out, float* g_out,
                     float* lp_out, float* acc_out, float eps,
                     const float* eps_row, int n_leaps, int k_trans, int i0,
                     unsigned long long seed, const int* sched_ops,
                     const float* sched_c, int n_ops, void* stream) {
  LaneLaunch<MultistepKernel> L;
  Sched s;
  if (!multistep_launch_for(d, C, &L) || n_leaps < 1 || k_trans < 1 ||
      i0 < 0 || !make_sched(sched_ops, sched_c, n_ops, &s))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = lane_prepare(L);
  if (e != cudaSuccess) return (int)e;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  L.kernel<<<L.blocks, L.threads, L.smem, (cudaStream_t)stream>>>(
      Target{codes, params, d}, s, C, eps, eps_row, n_leaps, k_trans, i0, key,
      th_in, th_out, g_out, lp_out, acc_out);
  return (int)cudaGetLastError();
}

// How a multistep launch at (d, C) runs (as target_leapfrogs_plan).
int target_multistep_plan(int d, int C, int* blocks, int* blocks_per_sm,
                          int* threads, int* smem) {
  LaneLaunch<MultistepKernel> L;
  if (!multistep_launch_for(d, C, &L)) return (int)cudaErrorInvalidValue;
  return lane_plan(L, blocks, blocks_per_sm, threads, smem);
}

}  // extern "C"
