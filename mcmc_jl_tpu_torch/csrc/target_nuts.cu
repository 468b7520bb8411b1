// Fused exact No-U-Turn transition on catalog targets for Hopper (sm_90a):
// one whole NUTS transition per launch, the noise drawn outside.
//
// Replaces the Pallas kernel of mcmc_jl_tpu/ops/pallas_nuts.py in target
// mode:
//   target_nuts_transition <- _nuts_kernel (via _target_transition_inner;
//                             vec_eps: the step is a scalar or a (d,) row)
// The Pallas kernel differentiates the user's logp_block with jax.vjp; here,
// as in target_hmc.cu, the target is a product of the ten continuous catalog
// families and each coordinate's (logp, dlogp/dx) pair is analytic
// (target_common.cuh).
//
// What bounds it on the H100: a tree of depth n has 2^(n-1) to 2^n - 1
// leaves, each one leapfrog of d independent coordinate updates (a few tens
// of FP32 operations each, a logf or powf for some families) and two or
// three warp reductions (lp, |m|^2, the u-turn dots).  Device memory sees the
// chain's state and its noise once in and once out, so on paper the
// operations bound it; in practice the chain of dependent reductions per
// leaf (latency, not throughput) and the spread of tree depths across the
// warps of an SM do.
//
// Design: one warp per chain, four chains per 128-thread block, lanes over
// coordinates (CPL = 1, 4 or 32 per lane, so d <= 1024 runs one code path).
// Each warp builds its own tree, with the TPU kernel's iterative form
// (doubling loop, reservoir or multinomial proposal, popcount-addressed
// checkpoint stacks, span checks at odd leaves, outer merge and u-turn); the
// warps of a block never wait for each other after the rows are staged, so a
// shallow tree does not wait for a deep one in its block, which the TPU's
// lockstep over a block of chains could not avoid.  The edges, the walker,
// the proposal and the two checkpoint stacks live in registers (at CPL 1 the
// stacks are selected by unrolled compares, never indexed at run time; at
// CPL 32 they sit in local memory).  Every dot product is a warp_sum: its
// xor shuffles leave the same bits in every lane, so every lane takes the
// same branch, and every lane reads the chain's uniforms.  Kick and drift
// round each product and sum separately (__fmul_rn / __fadd_rn), as the
// plain PyTorch version does; lp and the dots sum in another order, so a
// decision within rounding of a tie may differ from it.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "target_common.cuh"

namespace {

constexpr int kMaxDoublings = 10;   // leaf uniforms: 2^md columns per chain
constexpr float kDeltaMax = 100.f;  // divergence gate (NUTS.jl:90-95)

// log(exp(a) + exp(b)) with torch.logaddexp's infinities: (-inf, -inf) is
// -inf and (inf, inf) is inf.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float dl = a - b;
  if (isnan(dl)) return a + b;
  return fmaxf(a, b) + log1pf(expf(-fabsf(dl)));
}

template <int CPL>
__device__ __forceinline__ void copy(float (&dst)[CPL],
                                     const float (&src)[CPL]) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) dst[i] = src[i];
}

// v into checkpoint slot ``slot`` (warp-uniform).
template <int CPL>
__device__ __forceinline__ void ck_store(float (&ck)[kMaxDoublings][CPL],
                                         int slot, const float (&v)[CPL]) {
  if constexpr (CPL == 1) {
#pragma unroll
    for (int q = 0; q < kMaxDoublings; ++q)
      if (q == slot) ck[q][0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) ck[slot][i] = v[i];
  }
}

// True when a span starting at checkpoint slot q and ending at the walker
// (p, m) has turned (NUTS.jl:50).
template <int CPL>
__device__ __forceinline__ bool span_turned(const float (&ckp)[CPL],
                                            const float (&ckm)[CPL],
                                            const float (&p)[CPL],
                                            const float (&m)[CPL],
                                            float dirn) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const float dl = dirn * (p[i] - ckp[i]);
    a = fmaf(dl, ckm[i], a);
    b = fmaf(dl, m[i], b);
  }
  return warp_sum(a) < 0.f || warp_sum(b) < 0.f;
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
nuts_kernel(Target t, int C, float eps, const float* __restrict__ eps_row,
            int md, int multinomial, const float* __restrict__ th_in,
            const float* __restrict__ lp_in, const float* __restrict__ g_in,
            const float* __restrict__ m0_in,
            const float* __restrict__ logu_in,
            const float* __restrict__ dirn_in,
            const float* __restrict__ merge_in,
            const float* __restrict__ leaf_in, float* th_out, float* g_out,
            float* lp_out, int* nd_out, unsigned char* div_out) {
  extern __shared__ Row rows[];
  stage_rows(t, rows);
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (c >= C) return;  // the whole warp: no barrier follows
  const int d = t.d;

  // the proposal (th, g, lp) starts at the current state
  float th[CPL], g[CPL], e[CPL];
  load_lane<CPL>(th, th_in, c, d, lane);
  load_lane<CPL>(g, g_in, c, d, lane);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    e[i] = eps_row ? (j < d ? eps_row[j] : 0.f) : eps;
  }
  float lp = lp_in[c];

  // trajectory edges: plus (p*) and minus (n*)
  float pp[CPL], pm[CPL], pg[CPL], np_[CPL], nm[CPL], ng[CPL];
  load_lane<CPL>(pm, m0_in, c, d, lane);
  copy<CPL>(pp, th);
  copy<CPL>(pg, g);
  copy<CPL>(np_, th);
  copy<CPL>(nm, pm);
  copy<CPL>(ng, g);
  float plp = lp, nlp = lp;

  const float H0 = -lp + half_sq<CPL>(pm);
  const float u_slice = multinomial ? -H0 : logu_in[c] - H0;  // NUTS.jl:141
  float ck_p[kMaxDoublings][CPL], ck_m[kMaxDoublings][CPL];
  float ntot = 1.f, lwtot = 0.f;  // the initial point, weight exp(H0 - H0)
  int nd = 0;
  bool dv = false, s = true;

  for (int j = 0; j < md && s; ++j) {
    const float dirn = dirn_in[(size_t)c * md + j];
    const bool fwd = dirn > 0.f;
    float wp[CPL], wm[CPL], wg[CPL], es[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      wp[i] = fwd ? pp[i] : np_[i];
      wm[i] = fwd ? pm[i] : nm[i];
      wg[i] = fwd ? pg[i] : ng[i];
      es[i] = dirn * e[i];
    }
    float wlp = fwd ? plp : nlp;
    float sp[CPL], sg[CPL];  // proposal seed: the first valid leaf takes
    copy<CPL>(sp, wp);
    copy<CPL>(sg, wg);
    float slp = wlp;
    float n1 = 0.f, lw1 = -CUDART_INF_F;
    bool ok = true, sdv = false;
    const int n_leaves = 1 << j;

    for (int k = 0; k < n_leaves && ok; ++k) {
      // one leapfrog (HMC.jl:93-102) at the signed step
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        wm[i] = __fadd_rn(wm[i], __fmul_rn(__fmul_rn(0.5f, es[i]), wg[i]));
        wp[i] = __fadd_rn(wp[i], __fmul_rn(es[i], wm[i]));
      }
      wlp = eval_grad<CPL, true>(rows, d, lane, wp, wg);
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        wm[i] = __fadd_rn(wm[i], __fmul_rn(__fmul_rn(0.5f, es[i]), wg[i]));

      float H = -wlp + half_sq<CPL>(wm);
      if (isnan(H)) H = CUDART_INF_F;
      const bool diverged = u_slice >= kDeltaMax - H;  // NUTS.jl:92
      // reservoir draw, indexed by the transition-global leaf number
      const float u_leaf = leaf_in[((size_t)c << md) + n_leaves - 1 + k];
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
        copy<CPL>(sp, wp);
        copy<CPL>(sg, wg);
        slp = wlp;
      }
      if (diverged) {
        sdv = true;
        ok = false;
      }
      if ((k & 1) == 0) {  // checkpoint store at slot popcount(k)
        const int slot = __popc(k);
        ck_store<CPL>(ck_p, slot, wp);
        ck_store<CPL>(ck_m, slot, wm);
      } else {  // spans ending at k: slots popc(k>>1) - trailing_ones(k) + 1
        const int hi = __popc(k >> 1);
        const int lo = hi - (__ffs(~k) - 1) + 1;
#pragma unroll
        for (int q = 0; q < kMaxDoublings; ++q)
          if (q >= lo && q <= hi &&
              span_turned<CPL>(ck_p[q], ck_m[q], wp, wm, dirn))
            ok = false;
      }
    }

    // the walker's end is the new edge
    if (fwd) {
      copy<CPL>(pp, wp);
      copy<CPL>(pm, wm);
      copy<CPL>(pg, wg);
      plp = wlp;
    } else {
      copy<CPL>(np_, wp);
      copy<CPL>(nm, wm);
      copy<CPL>(ng, wg);
      nlp = wlp;
    }

    // outer merge (NUTS.jl:160; biased progressive for multinomial)
    const float u = merge_in[(size_t)c * md + j];
    bool take;
    if (multinomial) {
      take = ok && logf(u) < lw1 - lwtot;
      if (ok) lwtot = logaddexp(lwtot, lw1);
    } else {
      take = ok && u * ntot < n1;
    }
    if (take) {
      copy<CPL>(th, sp);
      copy<CPL>(g, sg);
      lp = slp;
    }
    ntot += n1;

    // overall u-turn between the extreme states (NUTS.jl:165)
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float dp = pp[i] - np_[i];
      a = fmaf(dp, nm[i], a);
      b = fmaf(dp, pm[i], b);
    }
    const bool turned = warp_sum(a) < 0.f || warp_sum(b) < 0.f;
    nd += 1;
    dv = dv || sdv;
    s = ok && !turned;
  }

  store_lane<CPL>(th_out, th, c, d, lane);
  store_lane<CPL>(g_out, g, c, d, lane);
  if (lane == 0) {
    lp_out[c] = lp;
    nd_out[c] = nd;
    div_out[c] = dv ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int target_nuts_max_doublings() { return kMaxDoublings; }

int target_nuts_transition(const int* codes, const float* params, int d,
                           int C, const float* th_in, const float* lp_in,
                           const float* g_in, const float* m0,
                           const float* logu, const float* dirn,
                           const float* merge, const float* leaf,
                           float* th_out, float* g_out, float* lp_out,
                           int* nd_out, unsigned char* div_out, float eps,
                           const float* eps_row, int md, int multinomial,
                           void* stream) {
  const int cpl = cpl_for(d);
  if (!cpl || C < 1 || md < 1 || md > kMaxDoublings)
    return (int)cudaErrorInvalidValue;
  const Target t{codes, params, d};
  const size_t smem = (size_t)d * sizeof(Row);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(CC)                                                          \
  {                                                                         \
    cudaError_t e = cudaFuncSetAttribute(                                   \
        nuts_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,       \
        (int)smem);                                                         \
    if (e != cudaSuccess) return (int)e;                                    \
    nuts_kernel<CC><<<blocks_for(C), kThreads, smem, st>>>(                 \
        t, C, eps, eps_row, md, multinomial, th_in, lp_in, g_in, m0, logu,  \
        dirn, merge, leaf, th_out, g_out, lp_out, nd_out, div_out);         \
  }
  TARGET_DISPATCH(cpl, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
