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
// The Pallas kernels share _glm_funcs + _trajectory.  Here the four share one
// body (hmc_tiles) and one lockstep trajectory (tile_trajectory) on the
// chain-tile gradient of glm_tile.cuh (traj_grad, shared with the NUTS
// kernels of glm_nuts.cu; the tile routines also with glm_bign.cu).
//
// Model: logp(theta) = sum_n w_n ll(z_n, y_n) - 1/2 sum_j lam_j theta_j^2
// with z_n = x_n . theta + o_n, and grad = sum_n w_n resid(z_n, y_n) x_n -
// lam theta; lam is a scalar, a (d,) row (the diagonal-metric fold of the
// warm-start pipeline) or a (d, d) matrix A (the dense-metric fold: prior
// gradient theta A, glm_tile.cuh prior_grad), in every kernel, as the
// Pallas kernels take them (pallas_glm.py _lam_input).
//
// What bounds them on the H100: at the main-path shape (d = 10, N = 1000)
// one gradient is d*N = 10k multiply-adds for z plus 10k for r x per chain,
// and one link per observation (logistic: expf, a division, a select; with
// ll also log1pf).  The design matrix (40 KB) is read from shared memory
// and never from device memory inside the trajectory, so bytes do not bound
// any of them: the products and the link's special functions do.
//
// Design (hmc_tiles): a block takes a tile of 16 chains and runs their
// trajectories in lockstep (the leap count and schedule are the same for
// every chain of a launch).  Each gradient is two block products on the
// tensor cores (mma.sync m16n8k8, 3xTF32 for float32 accuracy) with the
// link in registers between them; the 16 warps split the row groups, and
// their partial gradients are summed in a fixed order through shared
// memory: two barriers per gradient.  The kicks and drifts are per-element
// register updates: thread e < 16 D owns one coordinate of one chain.  The
// rows, split into TF32 hi and lo parts once, stay resident in shared
// memory while they fit (N up to 1192 at d <= 16, 624 at d <= 32); above
// that they stream in double-buffered cp.async tiles at every gradient.
// The blocks are persistent, one per SM (the resident rows take about 190
// KB): each stages the rows once and walks the chain tiles blockIdx.x + k
// gridDim.x, so 4096 chains (256 tiles) keep every SM busy.  What bounds
// them is instruction issue on the CUDA cores, about 30 instructions per
// chain and observation (the link's expf and reciprocal, the fragment
// loads, the TF32 splits), with 16 warps per SM to hide the latency of the
// mma and link chains.
//
// Kernels 2, 3 and 3b add the Metropolis test of each chain inside the
// tile.  Every lane of a chain selects its own coordinate of theta and g,
// so the decision is made only from values that are the same bits in all
// the chain's lanes: lp (the 16 warps' ll partials summed in one order, the
// prior term and 1/2 |m|^2 as chain_sum butterflies over the chain's D
// lanes) and log u.  Kernels 3 and 3b draw inside the tile: each lane its
// own momentum coordinate and the chain's uniform, from Philox counted by
// (chain, transition, draw) (glm_tile.cuh momentum, log_uniform, which the
// multistep NUTS kernel draws through too): one Philox per lane and
// transition beside ten tile gradients.  Every kernel takes each lane's
// prior precision from the (d,) row when one is given (or, with the (d, d)
// matrix, the lane's coordinate of theta A from its chain's lanes by
// shuffle).  Kernel 3b counts by the absolute
// transition i0 + t, whose Halton leap count is the same for every chain
// of the launch, and writes every transition's rows
// after its test: theta
// and g one coordinate per lane, lp, accept, alpha and the leap count from
// the chain's head lane (alpha from the MH log-ratio, the same bits in all
// the chain's lanes).
//
// Above d = 32 the four kernels run the same transitions on the wide tile
// (glm_tile.cuh: one warp a chain, D / 32 coordinates a lane, the columns
// of G split over the warps), up to d = kWideMax (hmc_wide).  At d = 150,
// N = 1000 one gradient of a chain is 4 d N = 6e5 operations, the rows
// (600 KB) stream through shared memory from L2 at every gradient, and
// theta's fragments are read from shared memory for every row group.
// Above kWideMax, up to kXWideMax = 1024, they run on the very-wide tile
// (hmc_xwide): the chain state in a slot of the caller's scratch in device
// memory, stage 1 split over k, stage 2 over all 16 warps' n-blocks.  At d
// = 1024, N = 1000 one gradient of a chain is 4.1e6 operations and the
// rows (4 MB) stream from L2 in tiles of 16 at every gradient: 16 chains
// a pass over X, 16 operations a byte of L2, so the L2's bandwidth and the
// tensor cores bound it about alike.  Above kXWideMax, up to kXChunkDMax =
// 131072, the same body runs on glm_tile.cuh's chunked tier (hmc_xwide<MODE,
// true>): the proposal's theta in the slot too, each gradient two passes
// over X in column chunks of at most 512 (xchunk_grad).  At d = 4096, N =
// 1000 a gradient of the tile reads X twice (33 MB from L2) for 16 chains'
// 2.6e8 operations: 8 operations a byte of L2, so L2's bandwidth bounds it
// before the tensor cores do.
//
// In every kernel the log-likelihood sum is carried in double, so lp keeps
// full float precision after a 1000-term sum.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "glm_tile.cuh"

namespace {

constexpr int kMaxOps = 8;             // longest kick/drift schedule

// Kick ("B", op 0) / drift ("A", op 1) schedule, coefficients in units of eps
// (samplers/integrators.py SCHEDULES).
struct Sched {
  int n;
  int last_a;  // index of the final drift: its gradient also yields lp
  int op[kMaxOps];
  float c[kMaxOps];
};

// The MH log-ratio h0 - h with NaN as -inf (samplers/base.py
// metropolis_accept rejects it), and the test on it.
__device__ __forceinline__ float mh_ratio(float h0, float h) {
  const float ratio = h0 - h;
  return isnan(ratio) ? -CUDART_INF_F : ratio;
}

__device__ __forceinline__ bool mh_accept(float ratio, float logu) {
  return (ratio > 0.f) || (ratio > logu);
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

// ---- the four kernels on the chain-tile gradient --------------------------

// A launch of the tile kernels beyond the model and the schedule.  Kernel 1
// reads th, m, g and writes th, m, g, lp; kernel 2 reads th, g, lp and the
// noise m0 (C, d), logu (C,), and writes th, g, lp, accept; kernel 3 reads
// th, draws its noise from key and writes th, g, lp and the accept rate;
// kernel 3b reads th, draws its noise from key for the absolute transitions
// i0 .. i0 + k_trans - 1, each of the Halton leap count of (T, eps,
// max_leaps), and writes th, g, lp and the rows of every transition.
struct HmcArgs {
  int C, n_leaps, k_trans;
  float eps;
  uint2 key;
  const float *th_in, *m_in, *g_in, *lp_in, *logu_in;
  float *th_out, *m_out, *g_out, *lp_out, *acc_out;
  // kernel 3b
  float T;
  int i0, max_leaps;
  float *r_th, *r_g, *r_lp, *r_acc, *r_alpha;
  int* r_nl;
  // the very-wide tile and the chunked tier: the blocks' slots (slot_bytes
  // each)
  float* scratch;
};

// The tile's shared memory (traj_plan's layout) and this thread's place in
// the tile: thread e < 16 D owns coordinate e % D of chain e / D.
template <int D>
struct TileCtx {
  Rows t;
  float* raw;    // streamed rows' cp.async buffers, or null (resident)
  float* sth;    // (16, D) theta of the gradient in flight
  float* part;   // the warps' gradient partials
  double* pll;   // the warps' log-likelihood partials
  bool own;      // whole warps: 16 D is a multiple of 32
  int oc;        // chain in the tile
  float lam;     // prior precision of this coordinate (lamv[j] or lam), 0
                 // past d
};

template <int D>
__device__ __forceinline__ TileCtx<D> tile_ctx(const Glm& p) {
  extern __shared__ double tile_sm[];
  double* pll = tile_sm;
  float* part = reinterpret_cast<float*>(pll + kTrajWarps * kTileChains);
  float* sth = part + kTrajWarps * kTileChains * D;
  float* rest = sth + kTileChains * D;
  const int tid = threadIdx.x, oj = tid % D;
  const bool own = tid < kTileChains * D;
  return TileCtx<D>{
      rows_at<D>(p.resident ? rest : rest + 2 * raw_row_floats(D) * p.tile,
                    p.tile),
      p.resident ? nullptr : rest, sth, part, pll, own, tid / D,
      own && oj < p.d ? (p.lamv ? p.lamv[oj] : p.lam) : 0.f};
}

// One tile gradient at this thread's theta coordinate th: returns its
// gradient coordinate; with want_ll also the chain's lp, the same bits in
// all its lanes (the 16 warps' ll partials summed in one order, the prior
// term a chain_sum).  Every thread of the block calls it.
template <int D>
__device__ __forceinline__ float tile_grad(const Glm& p, const TileCtx<D>& x,
                                           float th, bool want_ll,
                                           float& lp) {
  const int tid = threadIdx.x;
  if (x.own) x.sth[tid] = th;
  traj_grad<D>(p, x.t, x.raw, x.sth, x.part, x.pll, want_ll);
  if (!x.own) return 0.f;
  float acc = 0.f;
  for (int w = 0; w < kTrajWarps; ++w)
    acc += x.part[w * kTileChains * D + tid];
  // own is warp-uniform: the whole warp shuffles and sums
  const float pg = prior_grad<D>(p, x.lam, th, tid % D);
  if (want_ll) {
    const float quad = chain_sum<D>(th * pg);
    lp = (float)(sum_ll(x.pll, x.oc, kTrajWarps) - 0.5 * (double)quad);
  }
  return acc - pg;
}

// n_leaps macro steps of the schedule for the tile's 16 chains in lockstep
// (the leap count and schedule are the same for every chain of a launch):
// the kicks and drifts are register updates of this thread's coordinate,
// each drift takes one tile gradient.  Returns the chain's lp at the end,
// from the last drift's pass (pallas_glm.py _trajectory).
template <int D>
__device__ __forceinline__ float tile_trajectory(const Glm& p,
                                                 const TileCtx<D>& x,
                                                 const Sched& s, float eps,
                                                 int n_leaps, float& th,
                                                 float& m, float& g) {
  float lp = 0.f;
  for (int l = 0; l < n_leaps; ++l) {
    const bool final = l == n_leaps - 1;
    for (int k = 0; k < s.n; ++k) {
      const float ce = s.c[k] * eps;
      if (s.op[k] == 0) {
        m = m + ce * g;
      } else {
        th = th + ce * m;
        g = tile_grad<D>(p, x, th, final && k == s.last_a, lp);
      }
    }
  }
  return lp;
}

// One HMC transition of the tile's chains from (th, g, lp) with momentum m
// and log-uniform logu: the trajectory, then the NaN-rejecting test on
// values that are the same bits in all the chain's lanes (lp, the
// chain_sum of |m|^2, logu), so every lane selects alike.  Updates (th, g,
// lp) to the accepted or the old state; returns the accept bit and sets
// ratio to the MH log-ratio (the same bits in all the chain's lanes too).
template <int D>
__device__ __forceinline__ bool tile_transition(const Glm& p,
                                                const TileCtx<D>& x,
                                                const Sched& s, float eps,
                                                int n_leaps, float& th,
                                                float& g, float& lp, float m,
                                                float logu, float& ratio) {
  const float h0 = -lp + 0.5f * chain_sum<D>(m * m);
  float thp = th, gp = g;
  const float lpp = tile_trajectory<D>(p, x, s, eps, n_leaps, thp, m, gp);
  ratio = mh_ratio(h0, -lpp + 0.5f * chain_sum<D>(m * m));
  const bool a = mh_accept(ratio, logu);
  if (a) {
    th = thp;
    g = gp;
    lp = lpp;
  }
  return a;
}

// The four kernels: a block of kTrajThreads threads takes a tile of 16
// chains at a time; the blocks are persistent and walk the tiles
// blockIdx.x + k gridDim.x (every tile does the same work: the leap counts
// are the same for every chain of a launch).  A ragged last tile's lanes
// past C shadow chain C - 1 (its inputs and its draws, so they follow its
// path) and write nothing.  Threads that own no coordinate take part in
// every tile gradient.
enum HmcMode { kTraj = 0, kStep = 1, kMulti = 2, kRows = 3 };

template <int D, int MODE>
__device__ __forceinline__ void hmc_tiles(const Glm& p, const Sched& s,
                                          const HmcArgs& a) {
  const TileCtx<D> x = tile_ctx<D>(p);
  const int oj = threadIdx.x % D;
  const bool live = x.own && oj < p.d;
  if (p.resident) stage_rows<D>(p, x.t, 0, p.N);  // once for all its tiles
  for (int c0 = blockIdx.x * kTileChains; c0 < a.C;
       c0 += gridDim.x * kTileChains) {
    const int c = c0 + x.oc, cs = min(c, a.C - 1);
    const size_t at = (size_t)cs * p.d + oj;
    const bool out = live && c < a.C;               // writes a coordinate
    const bool head = x.own && oj == 0 && c < a.C;  // writes a chain's scalars
    float th = live ? a.th_in[at] : 0.f, g, lp = 0.f;
    if constexpr (MODE == kTraj) {
      float m = live ? a.m_in[at] : 0.f;
      g = live ? a.g_in[at] : 0.f;
      lp = tile_trajectory<D>(p, x, s, a.eps, a.n_leaps, th, m, g);
      if (out) {
        a.th_out[at] = th;
        a.m_out[at] = m;
        a.g_out[at] = g;
      }
      if (head) a.lp_out[c] = lp;
    } else if constexpr (MODE == kStep) {
      g = live ? a.g_in[at] : 0.f;
      if (x.own) lp = a.lp_in[cs];
      const float m = live ? a.m_in[at] : 0.f;
      const float logu = x.own ? a.logu_in[cs] : 0.f;
      float ratio;
      const bool acc = tile_transition<D>(p, x, s, a.eps, a.n_leaps, th, g,
                                          lp, m, logu, ratio);
      if (out) {
        a.th_out[at] = th;
        a.g_out[at] = g;
      }
      if (head) {
        a.lp_out[c] = lp;
        a.acc_out[c] = acc ? 1.f : 0.f;
      }
    } else {
      g = tile_grad<D>(p, x, th, true, lp);  // lp and g at the start
      float n_acc = 0.f;
      for (int t = 0; t < a.k_trans; ++t) {
        // kernel 3 counts its draws by the launch's transition t, kernel
        // 3b by the absolute transition i0 + t, which also sets the leap
        // count (the same for every chain: the barrier rule holds)
        const int ti = MODE == kRows ? a.i0 + t : t;
        const int nl = MODE == kRows
                           ? halton_leaps((uint32_t)ti, a.T, a.eps,
                                          a.max_leaps)
                           : a.n_leaps;
        const float m = live ? momentum(a.key, cs, ti, oj) : 0.f;
        const float logu = x.own ? log_uniform(a.key, cs, ti) : 0.f;
        float ratio;
        const bool acc = tile_transition<D>(p, x, s, a.eps, nl, th, g, lp, m,
                                            logu, ratio);
        if (acc) n_acc += 1.f;
        if constexpr (MODE == kRows) {  // the rows after the test
          const size_t rt = (size_t)t * a.C;
          if (out) {
            a.r_th[(rt + c) * p.d + oj] = th;
            a.r_g[(rt + c) * p.d + oj] = g;
          }
          if (head) {
            a.r_lp[rt + c] = lp;
            a.r_acc[rt + c] = acc ? 1.f : 0.f;
            a.r_alpha[rt + c] = expf(fminf(ratio, 0.f));
            a.r_nl[rt + c] = nl;
          }
        }
      }
      if (out) {
        a.th_out[at] = th;
        a.g_out[at] = g;
      }
      if (head) {
        a.lp_out[c] = lp;
        if constexpr (MODE == kMulti) a.acc_out[c] = n_acc / (float)a.k_trans;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTrajThreads, 1)
leapfrogs_tile_kernel(Glm p, Sched s, HmcArgs a) {
  hmc_tiles<D, kTraj>(p, s, a);
}

template <int D>
__global__ void __launch_bounds__(kTrajThreads, 1)
step_tile_kernel(Glm p, Sched s, HmcArgs a) {
  hmc_tiles<D, kStep>(p, s, a);
}

template <int D>
__global__ void __launch_bounds__(kTrajThreads, 1)
multistep_tile_kernel(Glm p, Sched s, HmcArgs a) {
  hmc_tiles<D, kMulti>(p, s, a);
}

template <int D>
__global__ void __launch_bounds__(kTrajThreads, 1)
rows_tile_kernel(Glm p, Sched s, HmcArgs a) {
  hmc_tiles<D, kRows>(p, s, a);
}

// ---- the four kernels on the wide tile (32 < d <= kWideMax) ---------------
// The same transitions as hmc_tiles on glm_tile.cuh's wide layout: warp c
// holds chain c of the tile and lane l its coordinates l + 32 i (i <
// D / 32) in registers; every lane of the block takes part in every
// gradient.  The Metropolis decision is made from values that are the same
// bits in all the chain's lanes (lp from the warps' ll partials in one
// order and a wide_chain_sum, log u from the chain's own draw).

// One gradient at theta th for the tile's chains: g = G - prior term
// (0 past d); with want_ll also lp, the same bits in all the chain's lanes.
__device__ __forceinline__ void wide_grad(const Glm& p, const Wide& w,
                                          const float (&th)[kWideRegs],
                                          float (&g)[kWideRegs], bool want_ll,
                                          float& lp) {
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  wide_put_theta(w, c, th);
  wide_rows(p, w, want_ll);
  float pg[kWideRegs];
  wide_prior_grad(p, w, th, pg);
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) {
    const int j = lane + 32 * i;
    g[i] = j < p.d ? wide_gsum(w, c, j) - pg[i] : 0.f;
  }
  if (want_ll) {
    float v[kWideRegs];
#pragma unroll
    for (int i = 0; i < kWideRegs; ++i) v[i] = th[i] * pg[i];
    lp = (float)(sum_ll(w.pll, c, kTrajWarps) -
                 0.5 * (double)wide_chain_sum(w, v));
  }
}

// tile_trajectory on the wide tile.
__device__ __forceinline__ float wide_trajectory(const Glm& p, const Wide& w,
                                                 const Sched& s, float eps,
                                                 int n_leaps,
                                                 float (&th)[kWideRegs],
                                                 float (&m)[kWideRegs],
                                                 float (&g)[kWideRegs]) {
  float lp = 0.f;
  for (int l = 0; l < n_leaps; ++l) {
    const bool final = l == n_leaps - 1;
    for (int k = 0; k < s.n; ++k) {
      const float ce = s.c[k] * eps;
      if (s.op[k] == 0) {
#pragma unroll
        for (int i = 0; i < kWideRegs; ++i) m[i] = m[i] + ce * g[i];
      } else {
#pragma unroll
        for (int i = 0; i < kWideRegs; ++i) th[i] = th[i] + ce * m[i];
        wide_grad(p, w, th, g, final && k == s.last_a, lp);
      }
    }
  }
  return lp;
}

__device__ __forceinline__ float wide_sq(const Wide& w,
                                         const float (&m)[kWideRegs]) {
  float v[kWideRegs];
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) v[i] = m[i] * m[i];
  return wide_chain_sum(w, v);
}

// tile_transition on the wide tile.
__device__ __forceinline__ bool wide_transition(
    const Glm& p, const Wide& w, const Sched& s, float eps, int n_leaps,
    float (&th)[kWideRegs], float (&g)[kWideRegs], float& lp,
    float (&m)[kWideRegs], float logu, float& ratio) {
  const float h0 = -lp + 0.5f * wide_sq(w, m);
  float thp[kWideRegs], gp[kWideRegs];
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) {
    thp[i] = th[i];
    gp[i] = g[i];
  }
  const float lpp = wide_trajectory(p, w, s, eps, n_leaps, thp, m, gp);
  ratio = mh_ratio(h0, -lpp + 0.5f * wide_sq(w, m));
  const bool a = mh_accept(ratio, logu);
  if (a) {
#pragma unroll
    for (int i = 0; i < kWideRegs; ++i) {
      th[i] = thp[i];
      g[i] = gp[i];
    }
    lp = lpp;
  }
  return a;
}

// hmc_tiles on the wide tile: the blocks are persistent and walk the tiles
// blockIdx.x + k gridDim.x; a ragged last tile's warps past C shadow chain
// C - 1 and write nothing.
template <int MODE>
__device__ __forceinline__ void hmc_wide(const Glm& p, const Sched& s,
                                         const HmcArgs& a) {
  const Wide w = wide_at(p);
  wide_init(p, w);  // resident rows staged once for all its tiles
  for (int c0 = blockIdx.x * kTileChains; c0 < a.C;
       c0 += gridDim.x * kTileChains) {
    const int c = c0 + (threadIdx.x >> 5), cs = min(c, a.C - 1);
    const bool out = c < a.C, head = out && (threadIdx.x & 31) == 0;
    float th[kWideRegs], g[kWideRegs], m[kWideRegs], lp = 0.f;
    wide_load(th, a.th_in, cs, p.d);
    if constexpr (MODE == kTraj) {
      wide_load(m, a.m_in, cs, p.d);
      wide_load(g, a.g_in, cs, p.d);
      lp = wide_trajectory(p, w, s, a.eps, a.n_leaps, th, m, g);
      if (out) {
        wide_store(a.th_out, th, c, p.d);
        wide_store(a.m_out, m, c, p.d);
        wide_store(a.g_out, g, c, p.d);
      }
      if (head) a.lp_out[c] = lp;
    } else if constexpr (MODE == kStep) {
      wide_load(g, a.g_in, cs, p.d);
      wide_load(m, a.m_in, cs, p.d);
      lp = a.lp_in[cs];
      float ratio;
      const bool acc = wide_transition(p, w, s, a.eps, a.n_leaps, th, g, lp,
                                       m, a.logu_in[cs], ratio);
      if (out) {
        wide_store(a.th_out, th, c, p.d);
        wide_store(a.g_out, g, c, p.d);
      }
      if (head) {
        a.lp_out[c] = lp;
        a.acc_out[c] = acc ? 1.f : 0.f;
      }
    } else {
      wide_grad(p, w, th, g, true, lp);  // lp and g at the start
      float n_acc = 0.f;
      for (int t = 0; t < a.k_trans; ++t) {
        // draws by the launch's transition (3) or the absolute one (3b),
        // which also sets the shared Halton leap count
        const int ti = MODE == kRows ? a.i0 + t : t;
        const int nl = MODE == kRows
                           ? halton_leaps((uint32_t)ti, a.T, a.eps,
                                          a.max_leaps)
                           : a.n_leaps;
#pragma unroll
        for (int i = 0; i < kWideRegs; ++i) {
          const int j = (threadIdx.x & 31) + 32 * i;
          m[i] = j < p.d ? momentum(a.key, cs, ti, j) : 0.f;
        }
        float ratio;
        const bool acc = wide_transition(p, w, s, a.eps, nl, th, g, lp, m,
                                         log_uniform(a.key, cs, ti), ratio);
        if (acc) n_acc += 1.f;
        if constexpr (MODE == kRows) {  // the rows after the test
          const size_t rt = (size_t)t * a.C;
          if (out) {
            wide_store(a.r_th, th, rt + c, p.d);
            wide_store(a.r_g, g, rt + c, p.d);
          }
          if (head) {
            a.r_lp[rt + c] = lp;
            a.r_acc[rt + c] = acc ? 1.f : 0.f;
            a.r_alpha[rt + c] = expf(fminf(ratio, 0.f));
            a.r_nl[rt + c] = nl;
          }
        }
      }
      if (out) {
        wide_store(a.th_out, th, c, p.d);
        wide_store(a.g_out, g, c, p.d);
      }
      if (head) {
        a.lp_out[c] = lp;
        if constexpr (MODE == kMulti) a.acc_out[c] = n_acc / (float)a.k_trans;
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kTrajThreads, 1)
hmc_wide_kernel(Glm p, Sched s, HmcArgs a) {
  hmc_wide<MODE>(p, s, a);
}

// ---- the four kernels on the very-wide tile (kWideMax < d <= kXWideMax) ---
// The same transitions on glm_tile.cuh's very-wide layout: warp c holds
// chain c of the tile, its theta, g and m and the proposal's g as rows of
// the block's slot in device memory (a.scratch), the proposal's theta as
// its row of sth in shared memory; lanes stride over the coordinates.  The
// Metropolis decision is made from values that are the same bits in all
// the chain's lanes (lp from xwide_grad, |m|^2 from xw_sq, log u from the
// chain's own draw).  Above kXWideMax the same code runs on the chunked
// tier (CH): the proposal's theta moves to a fifth slot array and each
// gradient is xchunk_grad's, which walks d in chunks.

// The slot arrays: (kXArrays, 16, D) floats of block b, (kXChunkArrays,
// 16, D) on the chunked tier.
enum XArray { kXTh = 0, kXG = 1, kXM = 2, kXGp = 3, kXThp = 4 };

template <bool CH>
__device__ __forceinline__ float* xslot(const HmcArgs& a, int D, int k) {
  return a.scratch +
         ((size_t)blockIdx.x * (CH ? kXChunkArrays : kXArrays) + k) *
             kTileChains * D;
}

// tile_trajectory on the very-wide tile: theta in the warp's row of thp
// (sth, stride D + 4; on the chunked tier the slot array, stride D), m in
// its slot row, g in its row of the slot array gp (where each drift's
// gradient writes the gradient of all 16 chains).
template <bool CH>
__device__ __forceinline__ float xw_trajectory(const Glm& p, int D,
                                               float* thp, int TS,
                                               const Sched& s, float eps,
                                               int n_leaps, float* m,
                                               float* gp) {
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* th = thp + c * TS;
  const float* g = gp + c * D;
  float lp = 0.f;
  for (int l = 0; l < n_leaps; ++l) {
    const bool final = l == n_leaps - 1;
    for (int k = 0; k < s.n; ++k) {
      const float ce = s.c[k] * eps;
      if (s.op[k] == 0) {
        for (int j = lane; j < D; j += 32) m[j] = m[j] + ce * g[j];
      } else {
        for (int j = lane; j < D; j += 32) th[j] = th[j] + ce * m[j];
        lp = xw_grad<CH>(p, thp, gp, final && k == s.last_a);
      }
    }
  }
  return lp;
}

// tile_transition on the very-wide tile: the proposal starts from the
// chain's slot rows th and g (copied to its thp row and its gp row) and,
// when accepted, is copied back.
template <bool CH>
__device__ __forceinline__ bool xw_transition(const Glm& p, int D, float* thp,
                                              int TS, const Sched& s,
                                              float eps, int n_leaps,
                                              float* th, float* g, float& lp,
                                              float* m, float* gp, float logu,
                                              float& ratio) {
  const int c = threadIdx.x >> 5;
  float* sth = thp + c * TS;
  const float h0 = -lp + 0.5f * xw_sq(m, D);
  xw_copy(sth, th, D);
  xw_copy(gp + c * D, g, D);
  const float lpp = xw_trajectory<CH>(p, D, thp, TS, s, eps, n_leaps, m, gp);
  ratio = mh_ratio(h0, -lpp + 0.5f * xw_sq(m, D));
  const bool acc = mh_accept(ratio, logu);
  if (acc) {
    xw_copy(th, sth, D);
    xw_copy(g, gp + c * D, D);
    lp = lpp;
  }
  return acc;
}

// hmc_tiles on the very-wide tile (or the chunked tier): the blocks are
// persistent (as many as the scratch holds slots for) and walk the tiles
// blockIdx.x + k gridDim.x; a ragged last tile's warps past C shadow chain
// C - 1 in their own slot rows and write nothing.
template <int MODE, bool CH>
__device__ __forceinline__ void hmc_xwide(const Glm& p, const Sched& s,
                                          const HmcArgs& a) {
  int D, TS;
  float* thp;
  if constexpr (CH) {
    const XChunk xc = xchunk_at(p);
    xwide_init(p, xc.x);
    D = xc.D;
    TS = D;
    thp = xslot<CH>(a, D, kXThp);
  } else {
    const XWide x = xwide_at(p);
    xwide_init(p, x);
    D = x.D;
    TS = D + 4;
    thp = x.sth;
  }
  const int ct = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* th = xslot<CH>(a, D, kXTh) + ct * D;
  float* gb = xslot<CH>(a, D, kXG);
  float* g = gb + ct * D;
  float* m = xslot<CH>(a, D, kXM) + ct * D;
  float* gp = xslot<CH>(a, D, kXGp);
  float* sth = thp + ct * TS;
  for (int c0 = blockIdx.x * kTileChains; c0 < a.C;
       c0 += gridDim.x * kTileChains) {
    const int c = c0 + ct, cs = min(c, a.C - 1);
    const bool out = c < a.C, head = out && lane == 0;
    float lp = 0.f;
    if constexpr (MODE == kTraj) {
      xw_load(sth, D, a.th_in, cs, p.d);
      xw_load(m, D, a.m_in, cs, p.d);
      xw_load(gp + ct * D, D, a.g_in, cs, p.d);
      lp = xw_trajectory<CH>(p, D, thp, TS, s, a.eps, a.n_leaps, m, gp);
      if (out) {
        xw_store(a.th_out, c, p.d, sth);
        xw_store(a.m_out, c, p.d, m);
        xw_store(a.g_out, c, p.d, gp + ct * D);
      }
      if (head) a.lp_out[c] = lp;
    } else if constexpr (MODE == kStep) {
      xw_load(th, D, a.th_in, cs, p.d);
      xw_load(g, D, a.g_in, cs, p.d);
      xw_load(m, D, a.m_in, cs, p.d);
      lp = a.lp_in[cs];
      float ratio;
      const bool acc = xw_transition<CH>(p, D, thp, TS, s, a.eps, a.n_leaps,
                                         th, g, lp, m, gp, a.logu_in[cs],
                                         ratio);
      if (out) {
        xw_store(a.th_out, c, p.d, th);
        xw_store(a.g_out, c, p.d, g);
      }
      if (head) {
        a.lp_out[c] = lp;
        a.acc_out[c] = acc ? 1.f : 0.f;
      }
    } else {
      xw_load(th, D, a.th_in, cs, p.d);
      xw_copy(sth, th, D);
      lp = xw_grad<CH>(p, thp, gb, true);  // lp and g at the start
      float n_acc = 0.f;
      for (int t = 0; t < a.k_trans; ++t) {
        // draws by the launch's transition (3) or the absolute one (3b),
        // which also sets the shared Halton leap count
        const int ti = MODE == kRows ? a.i0 + t : t;
        const int nl = MODE == kRows
                           ? halton_leaps((uint32_t)ti, a.T, a.eps,
                                          a.max_leaps)
                           : a.n_leaps;
        for (int j = lane; j < D; j += 32)
          m[j] = j < p.d ? momentum(a.key, cs, ti, j) : 0.f;
        float ratio;
        const bool acc = xw_transition<CH>(p, D, thp, TS, s, a.eps, nl, th,
                                           g, lp, m, gp,
                                           log_uniform(a.key, cs, ti), ratio);
        if (acc) n_acc += 1.f;
        if constexpr (MODE == kRows) {  // the rows after the test
          const size_t rt = (size_t)t * a.C;
          if (out) {
            xw_store(a.r_th, rt + c, p.d, th);
            xw_store(a.r_g, rt + c, p.d, g);
          }
          if (head) {
            a.r_lp[rt + c] = lp;
            a.r_acc[rt + c] = acc ? 1.f : 0.f;
            a.r_alpha[rt + c] = expf(fminf(ratio, 0.f));
            a.r_nl[rt + c] = nl;
          }
        }
      }
      if (out) {
        xw_store(a.th_out, c, p.d, th);
        xw_store(a.g_out, c, p.d, g);
      }
      if (head) {
        a.lp_out[c] = lp;
        if constexpr (MODE == kMulti) a.acc_out[c] = n_acc / (float)a.k_trans;
      }
    }
  }
}

template <int MODE, bool CH>
__global__ void __launch_bounds__(kTrajThreads, 1)
hmc_xwide_kernel(Glm p, Sched s, HmcArgs a) {
  hmc_xwide<MODE, CH>(p, s, a);
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

using HmcKernel = void (*)(Glm, Sched, HmcArgs);

template <int D>
HmcKernel hmc_kernel(int mode) {
  return mode == kTraj    ? leapfrogs_tile_kernel<D>
         : mode == kStep  ? step_tile_kernel<D>
         : mode == kMulti ? multistep_tile_kernel<D>
                          : rows_tile_kernel<D>;
}

// The kernel of `mode` at bound D: the narrow tile's instantiation for D
// <= 32, the wide tile's up to kWideMax, the very-wide tile's up to
// kXWideMax and the chunked tier's above (D a run-time value on all three).
HmcKernel hmc_kernel_for(int mode, int D) {
  switch (D) {
    case 8: return hmc_kernel<8>(mode);
    case 16: return hmc_kernel<16>(mode);
    case 32: return hmc_kernel<32>(mode);
    default:
      if (D > kXWideMax)
        return mode == kTraj    ? hmc_xwide_kernel<kTraj, true>
               : mode == kStep  ? hmc_xwide_kernel<kStep, true>
               : mode == kMulti ? hmc_xwide_kernel<kMulti, true>
                                : hmc_xwide_kernel<kRows, true>;
      if (D > kWideMax)
        return mode == kTraj    ? hmc_xwide_kernel<kTraj, false>
               : mode == kStep  ? hmc_xwide_kernel<kStep, false>
               : mode == kMulti ? hmc_xwide_kernel<kMulti, false>
                                : hmc_xwide_kernel<kRows, false>;
      return mode == kTraj    ? hmc_wide_kernel<kTraj>
             : mode == kStep  ? hmc_wide_kernel<kStep>
             : mode == kMulti ? hmc_wide_kernel<kMulti>
                              : hmc_wide_kernel<kRows>;
  }
}

// The shared-memory plan at (d, N), D = glm_bound_for(d): traj_plan's for
// the narrow tile, wide_plan's for the wide one, xwide_plan's (rows always
// streamed) for the very-wide one, xchunk_plan's for the chunked tier.
TrajPlan hmc_plan(int d, int D, int N) {
  return D <= kNarrowMax  ? traj_plan(D, N)
         : D <= kWideMax  ? wide_plan(D, N)
         : D <= kXWideMax ? xwide_plan(D)
                          : xchunk_plan(d);
}

// Bytes of one block's slot at bound D (0 at D <= kWideMax, where no
// scratch is read).
size_t slot_bytes(int D) {
  return D > kXWideMax  ? xchunk_slot_bytes(D)
         : D > kWideMax ? xwide_slot_bytes(D)
                        : 0;
}

// How the tile kernel of `mode` runs at (d, N): blocks resident per SM
// (from the occupancy calculator), dynamic shared memory per block, and
// whether all rows stay resident.  Returns a CUDA error code.
int plan_hmc(int mode, int d, int N, int* blocks_per_sm, int* smem,
             int* resident) {
  const int D = glm_bound_for(d);
  if (!D || N < 1) return (int)cudaErrorInvalidValue;
  const TrajPlan tp = hmc_plan(d, D, N);
  if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
  *smem = (int)tp.smem;
  *resident = tp.resident ? 1 : 0;
  const HmcKernel kernel = hmc_kernel_for(mode, D);
  cudaError_t e = prepare(kernel, tp.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kTrajThreads, tp.smem);
  return (int)e;
}

// Launch the tile kernel of `mode` on persistent blocks, as many as fit at
// once: the resident rows are staged once per block, not once per tile.
// On the very-wide tile and the chunked tier also no more blocks than the
// scratch of scratch_bytes holds slots for (slot_bytes each; at least one).
// lamv, lamm: the (d,) prior row or the (d, d) prior matrix, or null (the
// scalar lam); every mode takes them.
int launch_hmc(int mode, const float* xt, const float* y, const float* w,
               const float* o, const float* lamv, const float* lamm, int N,
               int d, int kind,
               float lam, const int* sched_ops, const float* sched_c,
               int n_ops, const HmcArgs& a, long long scratch_bytes,
               void* stream) {
  const int D = glm_bound_for(d);
  Sched s;
  if (!D || a.C < 1 || N < 1 || a.k_trans < 1 || kind < 0 || kind > 3 ||
      !make_sched(sched_ops, sched_c, n_ops, &s))
    return (int)cudaErrorInvalidValue;
  if (mode == kRows ? a.max_leaps < 1 || a.i0 < 0 || !(a.eps > 0.f) ||
                          !(a.T >= 0.f)
                    : a.n_leaps < 1)
    return (int)cudaErrorInvalidValue;
  const TrajPlan tp = hmc_plan(d, D, N);
  if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
  const Glm p{xt, y, w, o, lamv, lamm, N, d, kind, lam, tp.rows,
              tp.resident};
  const HmcKernel kernel = hmc_kernel_for(mode, D);
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = prepare(kernel, tp.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTrajThreads, tp.smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.C + kTileChains - 1) / kTileChains;
  int blocks = min(tiles, sms * max(per_sm, 1));
  if (D > kWideMax) {
    const long long slots =
        a.scratch ? scratch_bytes / (long long)slot_bytes(D) : 0;
    if (slots < 1) return (int)cudaErrorInvalidValue;
    if (slots < blocks) blocks = (int)slots;
  }
  kernel<<<blocks, kTrajThreads, tp.smem, (cudaStream_t)stream>>>(p, s, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int glm_max_dim() { return kXChunkDMax; }

// Bytes of one block's slot of the very-wide tile or the chunked tier at d
// (0 at d <= kWideMax, where no scratch is read): the scratch of a launch
// holds one a block.
long long glm_slot_bytes(int d) {
  return (long long)slot_bytes(glm_bound_for(d));
}

const char* glm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int glm_leapfrogs(const float* xt, const float* y, const float* w,
                  const float* o, const float* lamv, const float* lamm,
                  int N, int d, int C, const float* th_in,
                  const float* m_in, const float* g_in, float* th_out,
                  float* m_out, float* g_out, float* lp_out, float eps,
                  float lam, int n_leaps, int kind, const int* sched_ops,
                  const float* sched_c, int n_ops, float* scratch,
                  long long scratch_bytes, void* stream) {
  HmcArgs a{};
  a.scratch = scratch;
  a.C = C;
  a.n_leaps = n_leaps;
  a.k_trans = 1;
  a.eps = eps;
  a.th_in = th_in;
  a.m_in = m_in;
  a.g_in = g_in;
  a.th_out = th_out;
  a.m_out = m_out;
  a.g_out = g_out;
  a.lp_out = lp_out;
  return launch_hmc(kTraj, xt, y, w, o, lamv, lamm, N, d, kind, lam,
                    sched_ops, sched_c, n_ops, a, scratch_bytes, stream);
}

// The occupancy plans of kernels 1, 2, 3 and 3b at (d, N) (plan_hmc).
int glm_leapfrogs_plan(int d, int N, int* blocks_per_sm, int* smem,
                       int* resident) {
  return plan_hmc(kTraj, d, N, blocks_per_sm, smem, resident);
}

int glm_step_plan(int d, int N, int* blocks_per_sm, int* smem,
                  int* resident) {
  return plan_hmc(kStep, d, N, blocks_per_sm, smem, resident);
}

int glm_multistep_plan(int d, int N, int* blocks_per_sm, int* smem,
                       int* resident) {
  return plan_hmc(kMulti, d, N, blocks_per_sm, smem, resident);
}

int glm_multistep_rows_plan(int d, int N, int* blocks_per_sm, int* smem,
                            int* resident) {
  return plan_hmc(kRows, d, N, blocks_per_sm, smem, resident);
}

int glm_step(const float* xt, const float* y, const float* w, const float* o,
             const float* lamv, const float* lamm, int N, int d, int C,
             const float* th_in, const float* g_in,
             const float* lp_in, const float* m0, const float* logu,
             float* th_out, float* g_out, float* lp_out, float* acc_out,
             float eps, float lam, int n_leaps, int kind,
             const int* sched_ops, const float* sched_c, int n_ops,
             float* scratch, long long scratch_bytes, void* stream) {
  HmcArgs a{};
  a.scratch = scratch;
  a.C = C;
  a.n_leaps = n_leaps;
  a.k_trans = 1;
  a.eps = eps;
  a.th_in = th_in;
  a.g_in = g_in;
  a.lp_in = lp_in;
  a.m_in = m0;
  a.logu_in = logu;
  a.th_out = th_out;
  a.g_out = g_out;
  a.lp_out = lp_out;
  a.acc_out = acc_out;
  return launch_hmc(kStep, xt, y, w, o, lamv, lamm, N, d, kind, lam,
                    sched_ops, sched_c, n_ops, a, scratch_bytes, stream);
}

int glm_multistep(const float* xt, const float* y, const float* w,
                  const float* o, const float* lamv, const float* lamm,
                  int N, int d, int C, const float* th_in,
                  float* th_out, float* g_out, float* lp_out, float* acc_out,
                  float eps, float lam, int n_leaps, int k_trans, int kind,
                  unsigned long long seed, const int* sched_ops,
                  const float* sched_c, int n_ops, float* scratch,
                  long long scratch_bytes, void* stream) {
  HmcArgs a{};
  a.scratch = scratch;
  a.C = C;
  a.n_leaps = n_leaps;
  a.k_trans = k_trans;
  a.eps = eps;
  a.key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  a.th_in = th_in;
  a.th_out = th_out;
  a.g_out = g_out;
  a.lp_out = lp_out;
  a.acc_out = acc_out;
  return launch_hmc(kMulti, xt, y, w, o, lamv, lamm, N, d, kind, lam,
                    sched_ops, sched_c, n_ops, a, scratch_bytes, stream);
}

int glm_multistep_rows(const float* xt, const float* y, const float* w,
                       const float* o, const float* lamv, const float* lamm,
                       int N, int d, int C,
                       const float* th_in, float* th_out, float* g_out,
                       float* lp_out, float* r_th, float* r_g, float* r_lp,
                       float* r_acc, float* r_alpha, int* r_nl, float eps,
                       float T, float lam, int i0, int max_leaps, int k_trans,
                       int kind, unsigned long long seed, const int* sched_ops,
                       const float* sched_c, int n_ops, float* scratch,
                       long long scratch_bytes, void* stream) {
  HmcArgs a{};
  a.scratch = scratch;
  a.C = C;
  a.k_trans = k_trans;
  a.eps = eps;
  a.key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  a.th_in = th_in;
  a.th_out = th_out;
  a.g_out = g_out;
  a.lp_out = lp_out;
  a.T = T;
  a.i0 = i0;
  a.max_leaps = max_leaps;
  a.r_th = r_th;
  a.r_g = r_g;
  a.r_lp = r_lp;
  a.r_acc = r_acc;
  a.r_alpha = r_alpha;
  a.r_nl = r_nl;
  return launch_hmc(kRows, xt, y, w, o, lamv, lamm, N, d, kind, lam,
                    sched_ops, sched_c, n_ops, a, scratch_bytes, stream);
}

}  // extern "C"
