// Fused exact No-U-Turn kernels for GLM posteriors on Hopper (sm_90a): one
// whole NUTS transition per launch with the noise drawn outside, and k whole
// transitions per launch with the noise drawn inside from Philox.
//
// Replaces the Pallas kernels of mcmc_jl_tpu/ops/pallas_nuts.py (GLM mode):
//   glm_nuts_transition <- _nuts_kernel    (via _transition_inner)
//   glm_nuts_multistep  <- _nuts_ms_kernel (via _ms_transition_inner)
// both sharing the tree build, here the device routine nuts_transition, and
// _glm_funcs, here glm_eval (glm_common.cuh).
//
// What bounds it on the H100: every leaf of a tree is one leapfrog, i.e. one
// gradient pass over the N observations (2 d N FMAs, one expf per
// observation), read from shared memory as in the HMC kernels, so the bound
// is again the FP32 FMA and SFU rate.  What NUTS adds is divergence: trees
// of 1 to 2^md - 1 leaves, and the leaf count differs from chain to chain.
// A warp runs as long as its deepest tree.
//
// Design: one thread per chain builds its own tree, with the TPU kernel's
// iterative form (doubling loop, reservoir proposal, popcount-addressed
// checkpoint stacks, span checks at odd leaves, outer merge and u-turn).
// The walker, the proposal and the trajectory state live in registers; the
// two edges and the 2 x md checkpoint vectors are indexed at run time and sit
// in local memory (L1), touched once per leaf beside a 2 d N FMA gradient.
// While the rows are resident in shared memory, glm_eval has no barrier and
// each thread stops when its own tree does; when they stream
// (N x stride x 4 B > 100 KB), the block runs its leaves in lockstep: every
// loop continues while __syncthreads_or of the block's flags holds, and a
// stopped chain still calls glm_eval on its frozen state so that every
// thread reaches every barrier.  The per-chain result is the same either
// way.  A block holds 128 chains: at 4096 chains, blocks of 32 or 64 that
// spread the warps over 128 SMs time within 2% of it, and at 65536 chains
// they are 1.4 and 2.2 times slower (H100 80GB HBM3, 700 W).  lp is summed
// in double.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "glm_common.cuh"

namespace {

constexpr int kThreads = 128;        // chains per block
constexpr int kMaxDoublings = 10;    // leaf uniforms: 2^md columns per chain
constexpr float kDeltaMax = 100.f;   // divergence gate (NUTS.jl:90-95)

// Philox draw numbers inside one (chain, transition): the momenta take
// 0 .. D/2 - 1 and the slice uniform 0xFFFFFFFF, as in glm_multistep.
constexpr uint32_t kDirDraw = 0x100u;      // + doubling j
constexpr uint32_t kMergeDraw = 0x200u;    // + doubling j
constexpr uint32_t kLeafDraw = 0x10000u;   // + leaf (1 << j) - 1 + k

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -CUDART_INF_F) return -CUDART_INF_F;
  return m + log1pf(expf(-fabsf(a - b)));
}

// Pre-drawn noise of one chain: dirn and merge are (C, md), leaf is
// (C, 2^md).
struct BufNoise {
  const float* dirn;
  const float* merge;
  const float* leaf;
  int md;
  int c;
  __device__ float direction(int j) const { return dirn[(size_t)c * md + j]; }
  __device__ float merge_u(int j) const { return merge[(size_t)c * md + j]; }
  __device__ float leaf_u(int l) const {
    return leaf[((size_t)c << md) + l];
  }
};

// Noise of one (chain, transition) from Philox; uniforms in (0, 1].
struct PhiloxNoise {
  uint2 key;
  uint32_t c, t;
  __device__ float u(uint32_t draw) const {
    return 1.f - u01(philox(make_uint4(c, t, draw, 0u), key).x);
  }
  __device__ float direction(int j) const {
    return u(kDirDraw + j) < 0.5f ? -1.f : 1.f;
  }
  __device__ float merge_u(int j) const { return u(kMergeDraw + j); }
  __device__ float leaf_u(int l) const { return u(kLeafDraw + l); }
};

template <int D>
__device__ __forceinline__ void copy(float (&dst)[D], const float (&src)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) dst[j] = src[j];
}

// One exact NUTS transition of one chain (pallas_nuts.py _nuts_kernel body,
// samplers/nuts.py step).  (th, g, lp) enter as the current state and leave
// as the chosen proposal; nd counts the doublings made, dv any divergence.
// A chain with live == false builds nothing (ragged last block).
template <int D, class Noise>
__device__ void nuts_transition(const Glm& p, float* sm, float eps, int md,
                                bool multinomial, bool live, float (&th)[D],
                                float (&g)[D], float& lp, const float (&m0)[D],
                                float logu, const Noise& nz, int& nd,
                                bool& dv) {
  const bool lockstep = !p.resident;
  const float H0 = -lp + half_sq<D>(m0);
  const float u_slice = multinomial ? -H0 : logu - H0;  // NUTS.jl:141

  // trajectory edges, [0] = minus, [1] = plus
  float e_p[2][D], e_m[2][D], e_g[2][D], e_lp[2];
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      e_p[s][j] = th[j];
      e_m[s][j] = m0[j];
      e_g[s][j] = g[j];
    }
    e_lp[s] = lp;
  }
  float ck_p[kMaxDoublings][D], ck_m[kMaxDoublings][D];  // checkpoint stacks
  bool s = live;
  float ntot = 1.f, lwtot = 0.f;  // the initial point, weight exp(H0 - H0)
  nd = 0;
  dv = false;

  for (int j = 0; j < md; ++j) {
    if (!(lockstep ? __syncthreads_or(s) : s)) break;
    const float dirn = nz.direction(j);
    const int e = dirn > 0.f ? 1 : 0;
    const float es = dirn * eps;
    float wp[D], wm[D], wg[D], sp[D], sg[D];
#pragma unroll
    for (int jj = 0; jj < D; ++jj) {
      wp[jj] = e_p[e][jj];
      wm[jj] = e_m[e][jj];
      wg[jj] = e_g[e][jj];
    }
    float wlp = e_lp[e];
    copy<D>(sp, wp);  // proposal seed: the first valid leaf always takes
    copy<D>(sg, wg);
    float slp = wlp;
    float n1 = 0.f, lw1 = -CUDART_INF_F;
    bool ok = s, sdv = false;
    const int n_leaves = 1 << j;

    for (int k = 0; k < n_leaves; ++k) {
      if (!(lockstep ? __syncthreads_or(ok) : ok)) break;
      float tp[D], tm[D], tg[D], tlp;
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        tm[jj] = wm[jj] + 0.5f * es * wg[jj];
        tp[jj] = wp[jj] + es * tm[jj];
      }
      glm_eval<D>(p, sm, tp, tg, &tlp);
      if (!ok) continue;  // lockstep: a stopped chain only kept the barriers
#pragma unroll
      for (int jj = 0; jj < D; ++jj) {
        wm[jj] = tm[jj] + 0.5f * es * tg[jj];
        wp[jj] = tp[jj];
        wg[jj] = tg[jj];
      }
      wlp = tlp;

      float H = -wlp + half_sq<D>(wm);
      if (isnan(H)) H = CUDART_INF_F;
      const bool diverged = u_slice >= kDeltaMax - H;  // NUTS.jl:92
      // reservoir draw, indexed by the transition-global leaf number
      const float u_leaf = nz.leaf_u(n_leaves - 1 + k);
      bool take;
      if (multinomial) {
        const float lw_leaf = diverged ? -CUDART_INF_F : H0 - H;
        const float lw_new = logaddexp(lw1, lw_leaf);
        take = !diverged && logf(u_leaf) < lw_leaf - lw_new;
        lw1 = lw_new;
        if (!diverged) n1 += 1.f;
      } else {
        const bool valid = u_slice <= -H;  // NUTS.jl:91
        const float nf = n1 + (valid ? 1.f : 0.f);
        take = valid && u_leaf * nf < 1.f;
        n1 = nf;
      }
      if (take) {
        copy<D>(sp, wp);
        copy<D>(sg, wg);
        slp = wlp;
      }
      if (diverged) {
        sdv = true;
        ok = false;
      }
      if ((k & 1) == 0) {  // checkpoint store at slot popcount(k)
        const int slot = __popc(k);
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          ck_p[slot][jj] = wp[jj];
          ck_m[slot][jj] = wm[jj];
        }
      } else {  // spans ending at k: slots popc(k>>1) - trailing_ones(k) + 1 ..
        const int hi = __popc(k >> 1);
        const int lo = hi - (__ffs(~k) - 1) + 1;
        for (int i = lo; i <= hi; ++i) {
          float a = 0.f, b = 0.f;
#pragma unroll
          for (int jj = 0; jj < D; ++jj) {
            const float dl = dirn * (wp[jj] - ck_p[i][jj]);
            a = fmaf(dl, ck_m[i][jj], a);
            b = fmaf(dl, wm[jj], b);
          }
          if (a < 0.f || b < 0.f) ok = false;  // NUTS.jl:50
        }
      }
    }
    if (!s) continue;  // lockstep: a finished chain keeps its tree

    // the walker's end is the new edge
#pragma unroll
    for (int jj = 0; jj < D; ++jj) {
      e_p[e][jj] = wp[jj];
      e_m[e][jj] = wm[jj];
      e_g[e][jj] = wg[jj];
    }
    e_lp[e] = wlp;

    // outer merge (NUTS.jl:160; biased progressive for multinomial)
    const float u = nz.merge_u(j);
    bool take;
    if (multinomial) {
      take = ok && logf(u) < lw1 - lwtot;
      if (ok) lwtot = logaddexp(lwtot, lw1);
    } else {
      take = ok && u * ntot < n1;
    }
    if (take) {
      copy<D>(th, sp);
      copy<D>(g, sg);
      lp = slp;
    }
    ntot += n1;

    // overall u-turn between the extreme states (NUTS.jl:165)
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int jj = 0; jj < D; ++jj) {
      const float dp = e_p[1][jj] - e_p[0][jj];
      a = fmaf(dp, e_m[0][jj], a);
      b = fmaf(dp, e_m[1][jj], b);
    }
    nd += 1;
    dv = dv || sdv;
    s = ok && !(a < 0.f || b < 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
nuts_kernel(Glm p, int C, float eps, int md, int multinomial,
            const float* __restrict__ th_in, const float* __restrict__ lp_in,
            const float* __restrict__ g_in, const float* __restrict__ m0_in,
            const float* __restrict__ logu_in, const float* __restrict__ dirn,
            const float* __restrict__ merge, const float* __restrict__ leaf,
            float* th_out, float* g_out, float* lp_out, int* nd_out,
            unsigned char* div_out) {
  extern __shared__ float sm[];
  stage<D>(p, sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int cc = c < C ? c : C - 1;  // idle threads shadow the last chain
  float th[D], g[D], m0[D];
  load_vec<D>(th, th_in, cc, p.d);
  load_vec<D>(g, g_in, cc, p.d);
  load_vec<D>(m0, m0_in, cc, p.d);
  float lp = lp_in[cc];
  const BufNoise nz{dirn, merge, leaf, md, cc};
  int nd;
  bool dv;
  nuts_transition<D>(p, sm, eps, md, multinomial != 0, c < C, th, g, lp, m0,
                     logu_in[cc], nz, nd, dv);
  if (c < C) {
    store_vec<D>(th_out, th, c, p.d);
    store_vec<D>(g_out, g, c, p.d);
    lp_out[c] = lp;
    nd_out[c] = nd;
    div_out[c] = dv ? 1 : 0;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
nuts_multistep_kernel(Glm p, int C, float eps, int md, int multinomial,
                      int k_trans, uint2 key, const float* __restrict__ th_in,
                      const float* __restrict__ lp_in,
                      const float* __restrict__ g_in, float* th_out,
                      float* g_out, float* lp_out, float* r_th, float* r_g,
                      float* r_lp, unsigned char* r_acc, int* r_nd,
                      unsigned char* r_div) {
  extern __shared__ float sm[];
  stage<D>(p, sm);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int cc = c < C ? c : C - 1;
  float th[D], g[D];
  load_vec<D>(th, th_in, cc, p.d);
  load_vec<D>(g, g_in, cc, p.d);
  float lp = lp_in[cc];
  for (int t = 0; t < k_trans; ++t) {
    float m0[D], th0[D];
    // two normals per Philox draw, as in glm_multistep
#pragma unroll
    for (int j = 0; j < D; j += 2) {
      uint4 b = philox(make_uint4((uint32_t)cc, (uint32_t)t, (uint32_t)(j / 2), 0u), key);
      m0[j] = j < p.d ? box_muller(b.x, b.y) : 0.f;
      if (j + 1 < D) m0[j + 1] = j + 1 < p.d ? box_muller(b.z, b.w) : 0.f;
    }
    uint4 bu = philox(make_uint4((uint32_t)cc, (uint32_t)t, 0xFFFFFFFFu, 0u), key);
    const float logu = logf(1.f - u01(bu.x));
    copy<D>(th0, th);
    const PhiloxNoise nz{key, (uint32_t)cc, (uint32_t)t};
    int nd;
    bool dv;
    nuts_transition<D>(p, sm, eps, md, multinomial != 0, c < C, th, g, lp,
                       m0, logu, nz, nd, dv);
    bool acc = false;
#pragma unroll
    for (int j = 0; j < D; ++j) acc = acc || th[j] != th0[j];
    if (c < C) {
      const size_t row = (size_t)t * C;
      store_vec<D>(r_th + row * p.d, th, c, p.d);
      store_vec<D>(r_g + row * p.d, g, c, p.d);
      r_lp[row + c] = lp;
      r_acc[row + c] = acc ? 1 : 0;
      r_nd[row + c] = nd;
      r_div[row + c] = dv ? 1 : 0;
    }
  }
  if (c < C) {
    store_vec<D>(th_out, th, c, p.d);
    store_vec<D>(g_out, g, c, p.d);
    lp_out[c] = lp;
  }
}

// ---- host side -------------------------------------------------------------

}  // namespace

extern "C" {

int nuts_max_doublings() { return kMaxDoublings; }

const char* nuts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int glm_nuts_transition(const float* xt, const float* y, const float* w,
                        const float* o, const float* lamv, int N, int d, int C,
                        const float* th_in, const float* lp_in,
                        const float* g_in, const float* m0, const float* logu,
                        const float* dirn, const float* merge,
                        const float* leaf, float* th_out, float* g_out,
                        float* lp_out, int* nd_out, unsigned char* div_out,
                        float eps, float lam, int md, int kind,
                        int multinomial, void* stream) {
  const int D = bound_for(d);
  Glm p;
  size_t smem;
  if (!D || C < 1 || md < 1 || md > kMaxDoublings ||
      !make_params(xt, y, w, o, lamv, N, d, kind, lam, D, &p, &smem))
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(DD)                                                          \
  {                                                                         \
    cudaError_t e = prepare(nuts_kernel<DD>, smem);                         \
    if (e != cudaSuccess) return (int)e;                                    \
    nuts_kernel<DD><<<blocks, kThreads, smem, st>>>(                        \
        p, C, eps, md, multinomial, th_in, lp_in, g_in, m0, logu, dirn,     \
        merge, leaf, th_out, g_out, lp_out, nd_out, div_out);               \
  }
  GLM_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

int glm_nuts_multistep(const float* xt, const float* y, const float* w,
                       const float* o, const float* lamv, int N, int d, int C,
                       const float* th_in, const float* lp_in,
                       const float* g_in, float* th_out, float* g_out,
                       float* lp_out, float* r_th, float* r_g, float* r_lp,
                       unsigned char* r_acc, int* r_nd, unsigned char* r_div,
                       float eps, float lam, int md, int kind, int multinomial,
                       int k_trans, unsigned long long seed, void* stream) {
  const int D = bound_for(d);
  Glm p;
  size_t smem;
  if (!D || C < 1 || md < 1 || md > kMaxDoublings || k_trans < 1 ||
      !make_params(xt, y, w, o, lamv, N, d, kind, lam, D, &p, &smem))
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + kThreads - 1) / kThreads;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(DD)                                                          \
  {                                                                         \
    cudaError_t e = prepare(nuts_multistep_kernel<DD>, smem);               \
    if (e != cudaSuccess) return (int)e;                                    \
    nuts_multistep_kernel<DD><<<blocks, kThreads, smem, st>>>(              \
        p, C, eps, md, multinomial, k_trans, key, th_in, lp_in, g_in,       \
        th_out, g_out, lp_out, r_th, r_g, r_lp, r_acc, r_nd, r_div);        \
  }
  GLM_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
