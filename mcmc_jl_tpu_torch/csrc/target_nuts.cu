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
// of FP32 operations each, a logf or powf for some families), the sums of
// lp and |m|^2, and the u-turn dots.  Device memory sees the chain's state
// and its noise once in and once out, so on paper the operations bound it;
// in practice the latency of each leaf's dependent steps and the spread of
// tree depths among the chains that share a warp or group do.
//
// Two layouts, chosen up front from d (target_nuts_transition below):
//
// d <= 32 (nuts_lane_kernel): one chain per lane, 32 chains a group.  The
// loop over coordinates is outer and the same for every lane, so each
// coordinate's family (code[j], read from the rows in shared memory) is a
// warp-uniform branch taken with all lanes active: each family's code runs
// once per coordinate and warp, where the warp-per-chain layout ran every
// distinct family of a row serially on its lanes.  That loop is not
// unrolled, so the kernel holds one copy of the ten families' code (a loop
// unrolled over the template bound D repeats it D times, and a warp that
// waits on instruction fetches has no other warp to hide them).  lp, |m|^2,
// H and the u-turn dots are sums inside a thread: no shuffle.  Each lane's
// tree is flattened into one leaf loop (as the GLM NUTS kernels of
// glm_nuts.cu do): a lane carries its own (doubling j, leaf k, ok, s) state,
// starts its next doubling as soon as its subtree ends, and is masked once
// its tree has ended; the group loops until its deepest tree is done.
// Divergence is left only in the per-lane scalars (take, merge, the span
// range) and the copies they guard, never in the family evaluation.  A leaf
// is a chain of dependent steps (a family's logf or powf, its divisions, the
// sums, the decisions), and one warp alone on a scheduler waits on each
// (4096 chains are 128 groups on 132 SMs of four schedulers).  So four warps
// share a group's coordinates (coordinate j in warp j % 4): each adds its
// coordinates' terms of lp, |m|^2 and the dots into partials, and every warp
// sums the four partials in one order after one barrier a leaf, so the four
// keep the same per-chain state and take the same branches.  The walker
// (theta, m, g at the edge being extended) lives in registers, the warp's
// coordinates unrolled to the template bound; everything else a chain
// carries per coordinate lives in shared memory laid out
// [array][coordinate][lane], so that a warp's access hits 32 banks: the
// transition's proposal, the subtree's proposal, the edge the walker does
// not extend (the two edges are the walker and this one, swapped when a
// doubling turns the other way) and the two checkpoint stacks of md slots
// (13 D floats a lane in registers would not fit at D 32).
//
// d > 32 (nuts_kernel): one warp per chain, four chains per 128-thread
// block, lanes over coordinates (CPL = 4 or 32 per lane, so 32 < d <= 1024
// runs one code path).  Each warp builds its own tree with the TPU kernel's
// iterative form; the edges, the walker, the proposal and the two
// checkpoint stacks sit in registers or local memory, and every dot product
// is a warp_sum whose xor shuffles leave the same bits in every lane, so
// every lane takes the same branch.
//
// A dense target (target_common.cuh; the JAX kernel runs on _dense_wrap's
// block) takes the DENSE instantiations: the chain's state is z, each
// leaf's gradient pass the z-space pass, and the tree (U-turns, spans,
// energies) stays in z with a unit metric, as the JAX kernel computes it.
// In the lane layout the pass adds two block barriers a leaf (the leaf's
// family loop becomes lane_dense_theta, the loop, lane_dense_grad); in the
// warp layout it is the warp's own (dense_eval_grad).
//
// Both follow the TPU kernel's iterative form: the doubling loop, the
// reservoir or multinomial proposal drawn by the transition-global leaf
// number, popcount-addressed checkpoint stores and the span checks at odd
// leaves, the outer merge and u-turn.  Kick and drift round each product
// and sum separately (__fmul_rn / __fadd_rn), as the plain PyTorch version
// does; lp and the dots sum in another order, so a decision within
// rounding of a tie may differ from it.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "target_lane.cuh"

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
#pragma unroll
  for (int i = 0; i < CPL; ++i) ck[slot][i] = v[i];
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

template <int CPL, bool DENSE>
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
  float* zs = DENSE ? warp_slice(rows, t.d) : nullptr;
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
      wlp = grad_at<CPL, true, DENSE>(rows, t.L, zs, d, lane, wp, wg);
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

// ---- one chain per lane (d <= 32) ------------------------------------------

// The per-lane arrays of a block in shared memory, after the rows and the
// step row, each (D, 32) floats indexed [coordinate][lane]: the
// transition's proposal (th, g), the subtree's proposal (sp, sg), the edge
// the walker does not extend (op, om, og), the family loop's operands (x
// in, dlogp/dx out), then the checkpoint stacks ckp, ckm of md slots each,
// [slot][coordinate][lane].  After them, the warps' partial sums: two
// buffers of (kLaneWarps, kXq + 2 md, 32) floats, quantity q of warp v at
// [buf][v][q][lane]: lp, |m|^2, the two u-turn dots, then the two dots of
// each span check slot.
enum LaneArray { kTh = 0, kG, kSp, kSg, kOp, kOm, kOg, kX, kCk };
enum LanePartial { kPLp = 0, kPMsq, kPUa, kPUb, kXq };

// A dense target's kernel adds z (D, 32) and L (d, d) at the end.
size_t lane_smem(int d, int D, int md, bool dense) {
  const size_t rows = ((size_t)d * sizeof(Row) + 15) & ~(size_t)15;
  return rows + sizeof(float) *
                    ((size_t)D + (size_t)(kCk + 2 * md) * D * kWarp +
                     (size_t)2 * kLaneWarps * (kXq + 2 * md) * kWarp +
                     (dense ? (size_t)D * kWarp + (size_t)d * d : 0));
}

template <int D>
__device__ __forceinline__ void lane_store(float* arr, int which, int d,
                                           const float (&v)[D / kLaneWarps]) {
#pragma unroll
  for (int jj = 0; jj < lane_slots<kLaneWarps>(D); ++jj)
    if (lane_coord<kLaneWarps>(jj) < d)
      *lane_at<D>(arr, which, lane_coord<kLaneWarps>(jj)) = v[jj];
}

// Copy array ``from`` onto ``to`` in shared memory (this warp's
// coordinates, this lane's column).
template <int D>
__device__ __forceinline__ void lane_copy(float* arr, int to, int from,
                                          int d) {
#pragma unroll
  for (int jj = 0; jj < lane_slots<kLaneWarps>(D); ++jj)
    if (lane_coord<kLaneWarps>(jj) < d)
      *lane_at<D>(arr, to, lane_coord<kLaneWarps>(jj)) =
          *lane_at<D>(arr, from, lane_coord<kLaneWarps>(jj));
}

// Swap the register row v with array ``which`` in shared memory.
template <int D>
__device__ __forceinline__ void lane_swap(float* arr, int which, int d,
                                          float (&v)[D / kLaneWarps]) {
#pragma unroll
  for (int jj = 0; jj < lane_slots<kLaneWarps>(D); ++jj)
    if (lane_coord<kLaneWarps>(jj) < d) {
      float* s = lane_at<D>(arr, which, lane_coord<kLaneWarps>(jj));
      const float t = *s;
      *s = v[jj];
      v[jj] = t;
    }
}

// One chain per lane; the kLaneWarps warps of a block share the
// coordinates of the block's 32 chains.  Every per-chain decision is made
// from sums of the warps' partials that are the same bits in every warp,
// so the warps keep the same per-chain state and take the same branches;
// one barrier a leaf (three on a dense target).
template <int D, bool DENSE>
__global__ void __launch_bounds__(kLaneWarps * kWarp)
nuts_lane_kernel(Target t, int C, float eps, const float* __restrict__ eps_row,
                 int md, int multinomial, const float* __restrict__ th_in,
                 const float* __restrict__ lp_in,
                 const float* __restrict__ g_in,
                 const float* __restrict__ m0_in,
                 const float* __restrict__ logu_in,
                 const float* __restrict__ dirn_in,
                 const float* __restrict__ merge_in,
                 const float* __restrict__ leaf_in, float* th_out,
                 float* g_out, float* lp_out, int* nd_out,
                 unsigned char* div_out) {
  constexpr int DW = lane_slots<kLaneWarps>(D);
  extern __shared__ float4 lane_sm[];
  const int d = t.d, nq = kXq + 2 * md;
  Row* rows = reinterpret_cast<Row*>(lane_sm);
  float* es = reinterpret_cast<float*>(lane_sm) +
              (((size_t)d * sizeof(Row) + 15) & ~(size_t)15) / sizeof(float);
  float* arr = es + D;
  float* xch = arr + (size_t)(kCk + 2 * md) * D * kWarp;
  float* z = xch + (size_t)2 * kLaneWarps * nq * kWarp;  // dense: z, L
  float* Ls = z + D * kWarp;
  float* x = arr + (size_t)kX * D * kWarp;  // the family loop's operands
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    rows[j] = Row{t.codes[j], t.params[4 * j], t.params[4 * j + 1],
                  t.params[4 * j + 2], t.params[4 * j + 3]};
    es[j] = eps_row ? eps_row[j] : eps;
  }
  if (DENSE) lane_stage_factor(t.L, Ls, d);
  const int w = threadIdx.x / kWarp;
  const int nown = (d - w + kLaneWarps - 1) / kLaneWarps;  // its coordinates
  // lanes past C shadow chain C - 1 with their tree already ended
  const int c0 = blockIdx.x * kWarp + (threadIdx.x & (kWarp - 1));
  const int c = min(c0, C - 1);

  // the walker (wp, wm, wg, wlp) in registers, both edges at the start
  float wp[DW], wm[DW], wg[DW];
  float msq = 0.f;
#pragma unroll
  for (int jj = 0; jj < DW; ++jj) {
    const int j = lane_coord<kLaneWarps>(jj);
    const size_t at = (size_t)c * d + j;
    wp[jj] = j < d ? th_in[at] : 0.f;
    wm[jj] = j < d ? m0_in[at] : 0.f;
    wg[jj] = j < d ? g_in[at] : 0.f;
    msq = fmaf(wm[jj], wm[jj], msq);
  }
  float wlp = lp_in[c];
  lane_store<D>(arr, kTh, d, wp);
  lane_store<D>(arr, kG, d, wg);
  lane_store<D>(arr, kOp, d, wp);
  lane_store<D>(arr, kOm, d, wm);
  lane_store<D>(arr, kOg, d, wg);
  int buf = 0;
  *partial_at<kLaneWarps>(xch, nq, buf, w, kPMsq) = msq;
  __syncthreads();  // the rows, the step row, the partials (and L)
  msq = partial_sum<kLaneWarps>(xch, nq, buf, kPMsq);
  buf ^= 1;
  float lp = wlp, olp = wlp;  // the proposal's and the other edge's lp
  const float H0 = -lp + 0.5f * msq;
  const float u_slice = multinomial ? -H0 : logu_in[c] - H0;  // NUTS.jl:141

  float ntot = 1.f, lwtot = 0.f;  // the initial point, weight exp(H0 - H0)
  int nd = 0;
  bool dv = false;
  // the doubling in flight: jd, its direction (and the next one's, read
  // ahead), the walker's edge (plus or minus), its leaf k, its subtree
  // state and its merge uniform
  int jd = 0, k = 0;
  bool wplus = true, ok = true, sdv = false;
  float dirn = 0.f, dirn_next = dirn_in[(size_t)c * md], n1 = 0.f,
        lw1 = -CUDART_INF_F, slp = wlp, u_merge = 0.f;
  bool live = c0 < C, start = live;

  while (__syncthreads_or(live)) {
    if (start) {
      // doubling jd begins: the walker takes the edge of its direction
      // (swapped with the other when it turns) and seeds the subtree's
      // proposal: the first valid leaf always takes
      dirn = dirn_next;
      if (jd + 1 < md) dirn_next = dirn_in[(size_t)c * md + jd + 1];
      u_merge = merge_in[(size_t)c * md + jd];
      const bool fwd = dirn > 0.f;
      if (fwd != wplus) {
        lane_swap<D>(arr, kOp, d, wp);
        lane_swap<D>(arr, kOm, d, wm);
        lane_swap<D>(arr, kOg, d, wg);
        const float tl = olp;
        olp = wlp;
        wlp = tl;
        wplus = fwd;
      }
      lane_store<D>(arr, kSp, d, wp);
      lane_store<D>(arr, kSg, d, wg);
      slp = wlp;
      n1 = 0.f;
      lw1 = -CUDART_INF_F;
      ok = true;
      sdv = false;
      k = 0;
      start = false;
    }
    // this leaf's reservoir uniform, indexed by the transition-global leaf
    // number; loaded first so that its latency hides behind the leapfrog
    const float u_leaf =
        live ? leaf_in[((size_t)c << md) + (1 << jd) - 1 + k] : 1.f;

    // one leapfrog (HMC.jl:93-102) at the signed step, every lane (a lane
    // whose tree has ended computes on a walker nothing reads again): the
    // kick and drift of each coordinate, then the family of each in a loop
    // over the coordinates, the same for every lane, so that each family
    // branch is warp-uniform; the loop is not unrolled, so that the kernel
    // holds one copy of the ten families' code, and its operands pass
    // through shared memory; a dense target's walker is z, and its pass
    // forms theta from every warp's z first
#pragma unroll
    for (int jj = 0; jj < DW; ++jj)
      if (lane_coord<kLaneWarps>(jj) < d) {
        const float e = dirn * es[lane_coord<kLaneWarps>(jj)];
        wm[jj] = __fadd_rn(wm[jj], __fmul_rn(__fmul_rn(0.5f, e), wg[jj]));
        wp[jj] = __fadd_rn(wp[jj], __fmul_rn(e, wm[jj]));
        *lane_at<D>(DENSE ? z : x, 0, lane_coord<kLaneWarps>(jj)) = wp[jj];
      }
    if constexpr (DENSE) lane_dense_theta<D, kLaneWarps>(Ls, z, x, d, nown);
    float part = 0.f;
#pragma unroll 1
    for (int jj = 0; jj < nown; ++jj) {
      const int j = lane_coord<kLaneWarps>(jj);
      float* xp = lane_at<D>(arr, kX, j);
      float dl;
      part += family_eval<true, true>(rows[j], *xp, dl);
      *xp = dl;
    }
    // a dense target's gradient in z, from every warp's g_theta
    if constexpr (DENSE) lane_dense_grad<D, kLaneWarps>(Ls, x, d, wg);
    // this warp's partials: lp, |m|^2, the u-turn dots of the walker as the
    // new edge (read only when the doubling ends here), the span checks'
    // dots at odd leaves (slots popc(k>>1) - trailing_ones(k) + 1 ..
    // popc(k>>1), NUTS.jl:50)
    const int hi = __popc(k >> 1), lo = hi - (__ffs(~k) - 1) + 1;
    const bool span = live && (k & 1);
    float ua = 0.f, ub = 0.f;
    msq = 0.f;
#pragma unroll
    for (int jj = 0; jj < DW; ++jj)
      if (lane_coord<kLaneWarps>(jj) < d) {
        const int j = lane_coord<kLaneWarps>(jj);
        const float e = dirn * es[j];
        if constexpr (!DENSE) wg[jj] = *lane_at<D>(arr, kX, j);
        wm[jj] = __fadd_rn(wm[jj], __fmul_rn(__fmul_rn(0.5f, e), wg[jj]));
        msq = fmaf(wm[jj], wm[jj], msq);
        // the overall u-turn between the extreme states (NUTS.jl:165): the
        // walker holds the plus edge when wplus
        const float op = *lane_at<D>(arr, kOp, j);
        const float om = *lane_at<D>(arr, kOm, j);
        const float dp = wplus ? wp[jj] - op : op - wp[jj];
        ua = fmaf(dp, wplus ? om : wm[jj], ua);
        ub = fmaf(dp, wplus ? wm[jj] : om, ub);
      }
    if (live) {
      *partial_at<kLaneWarps>(xch, nq, buf, w, kPLp) = part;
      *partial_at<kLaneWarps>(xch, nq, buf, w, kPMsq) = msq;
      *partial_at<kLaneWarps>(xch, nq, buf, w, kPUa) = ua;
      *partial_at<kLaneWarps>(xch, nq, buf, w, kPUb) = ub;
    }
    if (span)
      for (int q = lo; q <= hi; ++q) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int jj = 0; jj < DW; ++jj)
          if (lane_coord<kLaneWarps>(jj) < d) {
            const int j = lane_coord<kLaneWarps>(jj);
            const float dl = dirn * (wp[jj] - *lane_at<D>(arr, kCk + q, j));
            a = fmaf(dl, *lane_at<D>(arr, kCk + md + q, j), a);
            b = fmaf(dl, wm[jj], b);
          }
        *partial_at<kLaneWarps>(xch, nq, buf, w, kXq + 2 * q) = a;
        *partial_at<kLaneWarps>(xch, nq, buf, w, kXq + 2 * q + 1) = b;
      }
    __syncthreads();
    const int pb = buf;
    buf ^= 1;
    if (!live) continue;

    wlp = partial_sum<kLaneWarps>(xch, nq, pb, kPLp);
    float H = -wlp + 0.5f * partial_sum<kLaneWarps>(xch, nq, pb, kPMsq);
    if (isnan(H)) H = CUDART_INF_F;
    const bool diverged = u_slice >= kDeltaMax - H;  // NUTS.jl:92
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
      lane_store<D>(arr, kSp, d, wp);
      lane_store<D>(arr, kSg, d, wg);
      slp = wlp;
    }
    if (diverged) {
      sdv = true;
      ok = false;
    }
    if (span) {
      for (int q = lo; q <= hi && ok; ++q)
        if (partial_sum<kLaneWarps>(xch, nq, pb, kXq + 2 * q) < 0.f ||
            partial_sum<kLaneWarps>(xch, nq, pb, kXq + 2 * q + 1) < 0.f)
          ok = false;
    } else {  // checkpoint store at slot popcount(k)
      lane_store<D>(arr, kCk + __popc(k), d, wp);
      lane_store<D>(arr, kCk + md + __popc(k), d, wm);
    }
    if (++k < (1 << jd) && ok) continue;

    // the doubling ends; the walker's end is the new edge.  Outer merge
    // (NUTS.jl:160; biased progressive for multinomial)
    bool mtake;
    if (multinomial) {
      mtake = ok && logf(u_merge) < lw1 - lwtot;
      if (ok) lwtot = logaddexp(lwtot, lw1);
    } else {
      mtake = ok && u_merge * ntot < n1;
    }
    if (mtake) {
      lane_copy<D>(arr, kTh, kSp, d);
      lane_copy<D>(arr, kG, kSg, d);
      lp = slp;
    }
    ntot += n1;
    const bool turned = partial_sum<kLaneWarps>(xch, nq, pb, kPUa) < 0.f ||
                        partial_sum<kLaneWarps>(xch, nq, pb, kPUb) < 0.f;
    nd += 1;
    dv = dv || sdv;
    live = start = ok && !turned && ++jd < md;
  }

  if (c0 < C) {
#pragma unroll
    for (int jj = 0; jj < DW; ++jj)
      if (lane_coord<kLaneWarps>(jj) < d) {
        const int j = lane_coord<kLaneWarps>(jj);
        const size_t at = (size_t)c * d + j;
        th_out[at] = *lane_at<D>(arr, kTh, j);
        g_out[at] = *lane_at<D>(arr, kG, j);
      }
    if (w == 0) {
      lp_out[c] = lp;
      nd_out[c] = nd;
      div_out[c] = dv ? 1 : 0;
    }
  }
}

// The kernel, grid and shared memory of a launch at (d, C, md), the layout
// decided from d alone.  False when the kernels do not take (d, md).
using NutsKernel = void (*)(Target, int, float, const float*, int, int,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, float*, float*,
                            float*, int*, unsigned char*);

struct NutsLaunch {
  NutsKernel kernel;
  int blocks, threads;
  size_t smem;
};

template <bool DENSE>
bool nuts_launch_for(int d, int C, int md, NutsLaunch* L) {
  if (d < 1 || d > kMaxDim || C < 1 || md < 1 || md > kMaxDoublings)
    return false;
  const int D = lane_bound_for(d);
  if (D) {  // one chain per lane, a block of kLaneWarps warps per 32
    L->kernel = D == 8    ? nuts_lane_kernel<8, DENSE>
                : D == 16 ? nuts_lane_kernel<16, DENSE>
                          : nuts_lane_kernel<32, DENSE>;
    L->blocks = (C + kWarp - 1) / kWarp;
    L->threads = kLaneWarps * kWarp;
    L->smem = lane_smem(d, D, md, DENSE);
  } else {  // one warp per chain: CPL 4 or 32
    L->kernel = cpl_for(d) == 4 ? nuts_kernel<4, DENSE>
                                : nuts_kernel<32, DENSE>;
    L->blocks = blocks_for(C);
    L->threads = kThreads;
    L->smem = warp_smem(d, DENSE);
  }
  return true;
}

// One transition on a catalog target (factor null) or, with DENSE, on a
// dense target at a scalar step (factor: L and L', (2, d, d)).
template <bool DENSE>
int nuts_entry(const float* factor, const int* codes, const float* params,
               int d, int C, const float* th_in, const float* lp_in,
               const float* g_in, const float* m0, const float* logu,
               const float* dirn, const float* merge, const float* leaf,
               float* th_out, float* g_out, float* lp_out, int* nd_out,
               unsigned char* div_out, float eps, const float* eps_row,
               int md, int multinomial, void* stream) {
  NutsLaunch L;
  if (!nuts_launch_for<DENSE>(d, C, md, &L) ||
      (DENSE && (factor == nullptr || eps_row != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      L.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  if (e != cudaSuccess) return (int)e;
  L.kernel<<<L.blocks, L.threads, L.smem, (cudaStream_t)stream>>>(
      Target{codes, params, d, factor}, C, eps, eps_row, md, multinomial,
      th_in, lp_in, g_in, m0, logu, dirn, merge, leaf, th_out, g_out, lp_out,
      nd_out, div_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int target_nuts_max_doublings() { return kMaxDoublings; }

// The largest d launched with one chain per lane; above it, one warp per
// chain (ops/nuts_kernels.py LANE_D_MAX, target_nuts_layout).
int target_nuts_lane_max_dim() { return kLaneDMax; }

int target_nuts_transition(const int* codes, const float* params, int d,
                           int C, const float* th_in, const float* lp_in,
                           const float* g_in, const float* m0,
                           const float* logu, const float* dirn,
                           const float* merge, const float* leaf,
                           float* th_out, float* g_out, float* lp_out,
                           int* nd_out, unsigned char* div_out, float eps,
                           const float* eps_row, int md, int multinomial,
                           void* stream) {
  return nuts_entry<false>(nullptr, codes, params, d, C, th_in, lp_in, g_in,
                           m0, logu, dirn, merge, leaf, th_out, g_out, lp_out,
                           nd_out, div_out, eps, eps_row, md, multinomial,
                           stream);
}

// The same transition on a dense target: factor holds L and L' ((2, d, d)
// floats), the step is the scalar eps (eps_row must be null).
int target_nuts_transition_dense(
    const float* factor, const int* codes, const float* params, int d, int C,
    const float* th_in, const float* lp_in, const float* g_in,
    const float* m0, const float* logu, const float* dirn,
    const float* merge, const float* leaf, float* th_out, float* g_out,
    float* lp_out, int* nd_out, unsigned char* div_out, float eps,
    const float* eps_row, int md, int multinomial, void* stream) {
  return nuts_entry<true>(factor, codes, params, d, C, th_in, lp_in, g_in,
                          m0, logu, dirn, merge, leaf, th_out, g_out, lp_out,
                          nd_out, div_out, eps, eps_row, md, multinomial,
                          stream);
}

// How a launch at (d, C, md) runs: blocks resident per SM (from the
// occupancy calculator), threads and dynamic shared memory per block.
int target_nuts_plan(int d, int C, int md, int* blocks_per_sm, int* threads,
                     int* smem) {
  NutsLaunch L;
  if (!nuts_launch_for<false>(d, C, md, &L))
    return (int)cudaErrorInvalidValue;
  *threads = L.threads;
  *smem = (int)L.smem;
  cudaError_t e = cudaFuncSetAttribute(
      L.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, L.kernel,
                                                      L.threads, L.smem);
  return (int)e;
}

}  // extern "C"
