// Fused exact No-U-Turn kernels for GLM posteriors on Hopper (sm_90a): one
// whole NUTS transition per launch with the noise drawn outside (kernel 8),
// and k whole transitions per launch with the noise drawn inside from
// Philox (kernel 9).
//
// Replaces the Pallas kernels of mcmc_jl_tpu/ops/pallas_nuts.py (GLM mode):
//   glm_nuts_transition <- _nuts_kernel    (via _transition_inner)
//   glm_nuts_multistep  <- _nuts_ms_kernel (via _ms_transition_inner)
// both sharing the tree build, here the body of nuts_tile_kernel, and
// _glm_funcs, here traj_grad (glm_tile.cuh): the chain-tile gradient of the
// trajectory kernel (glm_hmc.cu, kernel 1).  That is the narrow tile, d <=
// 32; above it, up to kWideMax = 256, nuts_wide_kernel builds the same tree
// on the wide tile (glm_tile.cuh wide_rows), with the tree's state out of
// shared memory, above that, up to kXWideMax = 1024, nuts_xwide_kernel on
// the very-wide tile (glm_tile.cuh xwide_grad), with the walker out of
// registers too, and above that, up to kXChunkDMax = 16384, the same
// kernel on the chunked tier (glm_tile.cuh xchunk_grad), with the walker's
// position out of shared memory as well (see their own notes).  The
// launcher picks one from d alone.
//
// What bounds them on the H100: every leaf of a tree is one leapfrog, i.e.
// one gradient and log-target pass over the N observations: 4 d N
// multiply-adds in two products, and one link with its log-likelihood per
// observation.  The products run on the tensor cores (mma.sync m16n8k8,
// 3xTF32), so a leaf is bound, as in kernel 1, by the instructions of the
// link.  What NUTS adds is divergence: trees of 1 to 2^md - 1 leaves whose
// count differs from chain to chain, while the chains of a tile share each
// gradient, so a tile runs as long as its deepest tree.  On an H100 80GB
// HBM3 (700 W) at N 1000, d 10, a pass over the tile takes 6.7-7.5 us at
// 65536 chains, about 1.9 us of it the row loop's instruction issue and
// the rest serial per pass (barriers, the sums of the warps' partials, the
// shuffle reductions); 39-63% of the tile's gradient lanes serve a tree.
//
// Design: a block takes a tile of 16 chains and builds their trees in one
// flattened loop, "while some chain of the tile has a leaf to take".  In
// each pass every running chain takes one leaf: a half kick and a drift,
// then one gradient of the tile (the 16 warps split the row groups, and
// their partials are summed in a fixed order), then its own bookkeeping.
// Each chain keeps its own cursor (doubling j, leaf k), so chains at
// different doublings share a gradient; a chain whose tree has ended puts
// its chosen state into the tile, and that gradient is thrown away.
// Thread e < 16 D owns coordinate e % D of chain e / D and keeps that
// coordinate of the walker, the subtree proposal, the chosen state and the
// two edges in registers.  D is 8, 16 or 32, so the D lanes of a chain lie
// in one warp: 1/2 |m|^2, the two dot products of each span check and the
// two of the u-turn are __shfl_xor_sync sums over those lanes, and every
// per-chain scalar (H, the weights, the ok and running flags, the cursor)
// is the same in all of them.  The checkpoint stacks (2 x md x 16 x D
// floats) sit in shared memory, indexed by slot.  The tree is the TPU
// kernel's iterative form: the doubling loop, the reservoir proposal
// indexed by the transition-global leaf number, the popcount-addressed
// checkpoint slots, span checks at odd leaves, the outer merge, the overall
// u-turn and the divergence gate.
//
// Kernel 9 does not wait at the end of a transition: a chain whose tree
// ends writes that transition's rows, draws its next momenta and slice at
// (chain, t + 1, .) and starts its next tree in the next pass.  A tile then
// waits for its deepest chain once per launch, over the leaves of a
// chain's k trees summed.  Every draw is counted by (chain, transition,
// draw), so the schedule changes no result.
//
// Blocks are persistent, one per SM while the rows are resident in shared
// memory (about 200 KB at N 1000, d <= 16), and take the tiles from a queue
// (an atomic counter, one per stream, that the launch leaves at 0 for the
// next).  Tiles take unequal times: with the queue kernel 8 took 11% less
// device time than in the strided order blockIdx.x + k gridDim.x at 4096
// chains (about two tiles per SM) and 3-11% less at 65536 (same card).
// Rows that do not fit stream through double-buffered cp.async tiles at
// every leaf, as in kernel 1.  lp is summed in double.
//
// Every entry launches on the caller's stream, allocates nothing (the wide
// tile's tree state lives in a scratch buffer the caller passes in, sized by
// glm_nuts_plan) and returns cudaGetLastError().

#include "glm_tile.cuh"

namespace {

constexpr int kMaxDoublings = 10;    // leaf uniforms: 2^md columns per chain
constexpr float kDeltaMax = 100.f;   // divergence gate (NUTS.jl:90-95)

// Philox draw numbers inside one (chain, transition) beside the momenta
// (0 .. d/2 - 1: below 0x2000 up to d kXChunkDMax = 16384) and the slice
// uniform (kSliceDraw; glm_tile.cuh momentum, log_uniform): five disjoint
// ranges at every width the kernels take.
constexpr uint32_t kDirDraw = 0x2000u;     // + doubling j
constexpr uint32_t kMergeDraw = 0x2100u;   // + doubling j
constexpr uint32_t kLeafDraw = 0x10000u;   // + leaf (1 << j) - 1 + k

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -CUDART_INF_F) return -CUDART_INF_F;
  return m + log1pf(expf(-fabsf(a - b)));
}

// A launch beyond the model.  Kernel 8 reads its noise from the buffers:
// m0 (C, d), logu (C,), dirn and merge (C, md), leaf (C, 2^md); kernel 9
// draws it and writes the rows of every transition.
struct NutsArgs {
  int C, md, multinomial, k_trans;
  float eps;
  uint2 key;
  const float *th_in, *lp_in, *g_in;
  const float *m0, *logu, *dirn, *merge, *leaf;
  float *th_out, *g_out, *lp_out;
  int* nd_out;
  unsigned char* div_out;
  float *r_th, *r_g, *r_lp;  // (k, C, d), (k, C, d), (k, C)
  unsigned char *r_acc, *r_div;
  int* r_nd;
  int* queue;  // tile queue: one int, 0 between launches
  float* scratch;  // the tree state above the narrow tile
};

// Uniform in (0, 1] of draw `draw` of (chain c, transition t).
__device__ __forceinline__ float philox_u(uint2 key, int c, int t,
                                          uint32_t draw) {
  return 1.f - u01(philox(make_uint4((uint32_t)c, (uint32_t)t, draw, 0u),
                          key).x);
}

template <bool MS>
__device__ __forceinline__ float direction(const NutsArgs& a, int c, int t,
                                           int j) {
  if (MS) return philox_u(a.key, c, t, kDirDraw + j) < 0.5f ? -1.f : 1.f;
  return a.dirn[(size_t)c * a.md + j];
}

template <bool MS>
__device__ __forceinline__ float merge_u(const NutsArgs& a, int c, int t,
                                         int j) {
  if (MS) return philox_u(a.key, c, t, kMergeDraw + j);
  return a.merge[(size_t)c * a.md + j];
}

template <bool MS>
__device__ __forceinline__ float leaf_u(const NutsArgs& a, int c, int t,
                                        int l) {
  if (MS) return philox_u(a.key, c, t, kLeafDraw + l);
  return a.leaf[((size_t)c << a.md) + l];
}

// Whether b holds in some lane of the chain; every lane of the warp must
// call it.
template <int D>
__device__ __forceinline__ bool chain_any(bool b) {
  const unsigned m = __ballot_sync(0xffffffffu, b);
  if (D == 32) return m != 0u;
  const int base = (threadIdx.x & 31) & ~(D - 1);
  return ((m >> base) & ((1u << (D & 31)) - 1u)) != 0u;
}

// One chain's transition as the lane that owns coordinate oj of it sees it:
// the per-coordinate fields hold that coordinate, the others are per chain
// and the same in all the chain's lanes.
struct Tree {
  float th, g, lp;                   // the chosen state
  float ep0, ep1, em0, em1, eg0, eg1;  // the edges: minus (0), plus (1)
  float elp0, elp1;
  float wp, wm, wg, wlp;             // the walker
  float sp, sg, slp;                 // the subtree's proposal
  float H0, u_slice, dirn, n1, lw1, ntot, lwtot;
  int t, j, k, nd;                   // transition, doubling, leaf
  bool run, ok, sdv, dv;             // leaves to take; subtree running
};

// Doubling T.j starts from the edge its direction points to (NUTS.jl:150).
template <bool MS>
__device__ __forceinline__ void begin_doubling(Tree& T, const NutsArgs& a,
                                               int c) {
  T.dirn = direction<MS>(a, c, T.t, T.j);
  const bool plus = T.dirn > 0.f;
  T.wp = plus ? T.ep1 : T.ep0;
  T.wm = plus ? T.em1 : T.em0;
  T.wg = plus ? T.eg1 : T.eg0;
  T.wlp = plus ? T.elp1 : T.elp0;
  T.sp = T.wp;  // proposal seed: the first valid leaf always takes
  T.sg = T.wg;
  T.slp = T.wlp;
  T.n1 = 0.f;
  T.lw1 = -CUDART_INF_F;
  T.ok = true;
  T.sdv = false;
  T.k = 0;
}

// A new tree at the chosen state with momentum m (this lane's coordinate),
// hs = |m|^2 over the chain, and the slice's log-uniform.
template <bool MS>
__device__ __forceinline__ void start_tree(Tree& T, const NutsArgs& a, int c,
                                           float m, float hs, float logu) {
  T.H0 = -T.lp + 0.5f * hs;
  T.u_slice = a.multinomial ? -T.H0 : logu - T.H0;  // NUTS.jl:141
  T.ep0 = T.ep1 = T.th;
  T.em0 = T.em1 = m;
  T.eg0 = T.eg1 = T.g;
  T.elp0 = T.elp1 = T.lp;
  T.ntot = 1.f;  // the initial point, weight exp(H0 - H0)
  T.lwtot = 0.f;
  T.nd = 0;
  T.dv = false;
  T.j = 0;
  begin_doubling<MS>(T, a, c);
}

// Kernel 8 (MS false): one transition of every chain.  Kernel 9 (MS true):
// k_trans transitions of every chain, the rows of each written as it ends.
template <int D, bool MS>
__global__ void __launch_bounds__(kTrajThreads, 1)
nuts_tile_kernel(Glm p, NutsArgs a) {
  extern __shared__ double tile_sm[];
  __shared__ int next_tile;
  constexpr int kSlot = kTileChains * D;  // floats of one checkpoint slot
  double* pll = tile_sm;
  float* part = reinterpret_cast<float*>(pll + kTrajWarps * kTileChains);
  float* sth = part + kTrajWarps * kSlot;
  float* ckp = sth + kSlot;  // checkpoint stacks, (md, 16, D) each
  float* ckm = ckp + a.md * kSlot;
  float* rest = ckm + a.md * kSlot;
  float* raw = p.resident ? nullptr : rest;
  const Rows rows = rows_at<D>(
      p.resident ? rest : rest + 2 * raw_row_floats(D) * p.tile, p.tile);
  const int tid = threadIdx.x;
  const bool own = tid < kSlot;  // whole warps: 16 D is a multiple of 32
  const int oc = tid / D, oj = tid % D;
  const bool live = own && oj < p.d;
  const float lam = live ? (p.lamv ? p.lamv[oj] : p.lam) : 0.f;
  if (p.resident) stage_rows<D>(p, rows, 0, p.N);  // once for all its tiles
  const int tiles = (a.C + kTileChains - 1) / kTileChains;
  for (int tile = blockIdx.x; tile < tiles;) {
    const int c = tile * kTileChains + oc;
    const bool real = own && c < a.C;
    const int cs = min(c, a.C - 1);  // idle lanes shadow the last chain
    const size_t at = (size_t)cs * p.d + oj;
    Tree T;
    T.th = live ? a.th_in[at] : 0.f;
    T.g = live ? a.g_in[at] : 0.f;
    T.lp = a.lp_in[cs];
    T.t = 0;
    float th0 = T.th;  // kernel 9: where the transition started
    if (own) {
      float m, logu;
      if (MS) {
        m = live ? momentum(a.key, cs, 0, oj) : 0.f;
        logu = log_uniform(a.key, cs, 0);
      } else {
        m = live ? a.m0[at] : 0.f;
        logu = a.logu[cs];
      }
      start_tree<MS>(T, a, cs, m, chain_sum<D>(m * m), logu);
    }
    T.run = real;

    for (;;) {
      if (!__syncthreads_or(T.run)) break;
      // a half kick and a drift; a chain without a leaf to take puts its
      // chosen state in the tile
      float es = 0.f, tm = 0.f, tp = 0.f;
      if (own) {
        es = T.dirn * a.eps;
        tm = T.wm + 0.5f * es * T.wg;
        tp = T.wp + es * tm;
        sth[tid] = T.run ? tp : T.th;
      }
      traj_grad<D>(p, rows, raw, sth, part, pll, true);
      if (!own) continue;

      // the leaf's gradient and lp as the HMC kernels form them (tile_grad)
      const bool act = T.run;
      float acc = 0.f;
      for (int w = 0; w < kTrajWarps; ++w) acc += part[w * kSlot + tid];
      const float pg = prior_grad<D>(p, lam, tp, oj);  // own: whole warps
      const float tg = acc - pg;
      const float quad = chain_sum<D>(tp * pg);
      const float tlp =
          (float)(sum_ll(pll, oc, kTrajWarps) - 0.5 * (double)quad);
      const float wm = tm + 0.5f * es * tg;
      float H = -tlp + 0.5f * chain_sum<D>(wm * wm);
      if (isnan(H)) H = CUDART_INF_F;
      if (act) {
        T.wp = tp;
        T.wm = wm;
        T.wg = tg;
        T.wlp = tlp;
        const bool diverged = T.u_slice >= kDeltaMax - H;  // NUTS.jl:92
        // reservoir draw, indexed by the transition-global leaf number
        const float u_leaf = leaf_u<MS>(a, c, T.t, (1 << T.j) - 1 + T.k);
        bool take;
        if (a.multinomial) {
          const float lw_leaf = diverged ? -CUDART_INF_F : T.H0 - H;
          const float lw_new = logaddexp(T.lw1, lw_leaf);
          take = !diverged && logf(u_leaf) < lw_leaf - lw_new;
          T.lw1 = lw_new;
          if (!diverged) T.n1 += 1.f;
        } else {
          const bool valid = T.u_slice <= -H;  // NUTS.jl:91
          const float nf = T.n1 + (valid ? 1.f : 0.f);
          take = valid && u_leaf * nf < 1.f;
          T.n1 = nf;
        }
        if (take) {
          T.sp = T.wp;
          T.sg = T.wg;
          T.slp = T.wlp;
        }
        if (diverged) {
          T.sdv = true;
          T.ok = false;
        }
        if ((T.k & 1) == 0) {  // checkpoint store at slot popcount(k)
          const int s = __popc(T.k);
          ckp[s * kSlot + tid] = T.wp;
          ckm[s * kSlot + tid] = T.wm;
        }
      }
      // spans ending at an odd leaf k: slots popc(k >> 1) - trailing_ones(k)
      // + 1 .. popc(k >> 1) (NUTS.jl:50).  Their dot products are sums over
      // the chain's lanes, so the warp runs its largest count of them.
      int lo = 1, hi = 0;
      if (act && (T.k & 1)) {
        hi = __popc(T.k >> 1);
        lo = hi - (__ffs(~T.k) - 1) + 1;
      }
      const int spans = (int)__reduce_max_sync(0xffffffffu,
                                               (unsigned)(hi - lo + 1));
      for (int i = 0; i < spans; ++i) {
        const int s = min(lo + i, hi);
        const float dl = T.dirn * (T.wp - ckp[s * kSlot + tid]);
        const float da = chain_sum<D>(dl * ckm[s * kSlot + tid]);
        const float db = chain_sum<D>(dl * T.wm);
        if (lo + i <= hi && (da < 0.f || db < 0.f)) T.ok = false;
      }
      if (act) ++T.k;

      // the doubling ends: the walker's end is the new edge, then the
      // outer merge (NUTS.jl:160; biased progressive for multinomial)
      const bool ends = act && (!T.ok || T.k == (1 << T.j));
      if (ends) {
        if (T.dirn > 0.f) {
          T.ep1 = T.wp;
          T.em1 = T.wm;
          T.eg1 = T.wg;
          T.elp1 = T.wlp;
        } else {
          T.ep0 = T.wp;
          T.em0 = T.wm;
          T.eg0 = T.wg;
          T.elp0 = T.wlp;
        }
        const float u = merge_u<MS>(a, c, T.t, T.j);
        bool take;
        if (a.multinomial) {
          take = T.ok && logf(u) < T.lw1 - T.lwtot;
          if (T.ok) T.lwtot = logaddexp(T.lwtot, T.lw1);
        } else {
          take = T.ok && u * T.ntot < T.n1;
        }
        if (take) {
          T.th = T.sp;
          T.g = T.sg;
          T.lp = T.slp;
        }
        T.ntot += T.n1;
      }
      // overall u-turn between the extreme states (NUTS.jl:165)
      const float dp = T.ep1 - T.ep0;
      const float ua = chain_sum<D>(dp * T.em0);
      const float ub = chain_sum<D>(dp * T.em1);
      if (ends) {
        T.nd += 1;
        T.dv = T.dv || T.sdv;
        ++T.j;
        if (T.ok && !(ua < 0.f || ub < 0.f) && T.j < a.md)
          begin_doubling<MS>(T, a, c);
        else
          T.run = false;
      }
      if (!MS) continue;

      // kernel 9: a tree that ended writes its transition's rows and, while
      // transitions remain, starts the next one at once
      const bool done = ends && !T.run;
      const bool moved = chain_any<D>(T.th != th0);
      if (done) {
        const size_t row = (size_t)T.t * a.C + c;
        if (live) {
          a.r_th[row * p.d + oj] = T.th;
          a.r_g[row * p.d + oj] = T.g;
        }
        if (oj == 0) {
          a.r_lp[row] = T.lp;
          a.r_acc[row] = moved ? 1 : 0;
          a.r_nd[row] = T.nd;
          a.r_div[row] = T.dv ? 1 : 0;
        }
        ++T.t;
      }
      const bool again = done && T.t < a.k_trans;
      float m = 0.f, logu = 0.f;
      if (again) {
        if (live) m = momentum(a.key, c, T.t, oj);
        logu = log_uniform(a.key, c, T.t);
      }
      const float hs = chain_sum<D>(m * m);
      if (again) {
        th0 = T.th;
        start_tree<MS>(T, a, c, m, hs, logu);
        T.run = true;
      }
    }

    if (real) {
      if (live) {
        a.th_out[(size_t)c * p.d + oj] = T.th;
        a.g_out[(size_t)c * p.d + oj] = T.g;
      }
      if (oj == 0) {
        a.lp_out[c] = T.lp;
        if (!MS) {
          a.nd_out[c] = T.nd;
          a.div_out[c] = T.dv ? 1 : 0;
        }
      }
    }
    // The first tile of every block is its blockIdx.x, the next ones come
    // from the queue.  Each block takes one ticket past the last tile, so
    // the launch hands out `tiles` tickets: the block holding the last has
    // seen every other taken and puts the queue back to 0 for the next
    // launch on this stream.
    if (tid == 0) {
      const int ticket = atomicAdd(a.queue, 1);
      if (ticket == tiles - 1) *a.queue = 0;
      next_tile = gridDim.x + ticket;
    }
    __syncthreads();
    tile = next_tile;
  }
}

// ---- the wide tile: 32 < d <= kWideMax -------------------------------------
// The same tree on glm_tile.cuh's wide layout, as hmc_wide (glm_hmc.cu)
// runs the HMC transitions: warp c holds chain c of the tile and lane l its
// coordinates l + 32 i (i < D / 32); each leaf's gradient is one wide_rows
// pass of the whole block.  Every per-chain value (H, the weights, the
// flags, the cursor) comes from values that are the same bits in all 32
// lanes: lp from the warps' ll partials summed in one order, the dot
// products from wide_chain_sum, the draws from the chain's own counters.
// So a warp takes every branch of its chain together, and the span checks
// loop over the chain's own spans with no shadow slots.
//
// Where the tree's state lives.  The walker (position, momentum, gradient:
// 3 D / 32 floats a lane) stays in registers: every leaf reads and writes
// it.  Everything else a chain keeps per coordinate goes to a scratch
// buffer in device memory that the caller allocates once and passes in:
// the chosen state (theta, g), the two edges (p, m, g each), the subtree's
// proposal (p, g) and the two checkpoint stacks (md slots each).  Those
// 10 + 2 md arrays of D floats are 491 KB a block at md 10 and D 256,
// beyond the 227 KB of shared memory (which the row buffers of wide_plan
// already fill) and beyond registers: with three more arrays live across
// the gradient the wide HMC kernels already spill at the 128-register cap
// of a 512-thread block.  A leaf touches little of it: a checkpoint store
// (2 D floats) on even leaves, at most md span reads (2 D each) on odd
// ones, a proposal store (2 D) when the leaf is taken, and the edges and
// the merge once a doubling; against the leaf's gradient, 4 d N
// multiply-adds a chain (600 K at d 150, N 1000).  The buffer is sized by
// resident block, not by chain: block b's slice serves every tile it takes
// from the queue.  It is laid out [chain of the tile][array][coordinate
// block][lane], so that a warp's load or store of one register is one
// 128-byte line, and only the thread that wrote a value reads it back (no
// fence).
//
// What bounds it, as the narrow kernel: the tile's passes, each one
// wide_rows (latency-bound, glm_tile.cuh).  On an H100 80GB HBM3 (700 W)
// at d 150, N 1000, 4096 chains, md 6 a pass takes about 78 us (kernel 8:
// 4.69 ms for 60 passes a block), 24-26% of the 4 d N bound of the leaves
// the trees need; the (d, d) prior's serial loop makes a pass 1.6x dearer.
// ptxas gives it 128 registers and 602 (kernel 8) or 820 (kernel 9) bytes
// of spill stores.  The scratch costs no measurable time: at d 256 a pass
// took 115 us at md 10 (65 MB of scratch, more than L2) and 124 us at md 6.
constexpr int kWideFixed = 10;  // scratch arrays besides the two stacks
enum WideArray { kTh, kG, kEp0, kEp1, kEm0, kEm1, kEg0, kEg1, kSp, kSg };

size_t wide_scratch_per_block(int D, int md) {
  return sizeof(float) * kTileChains * (size_t)(kWideFixed + 2 * md) * D;
}

// One chain's scratch as its lanes see it: array k's register i of lane l
// lies at at[k D + 32 i] (at already offset by l).
struct Scratch {
  float* at;
  int D;
  __device__ __forceinline__ void load(int k, float (&v)[kWideRegs]) const {
#pragma unroll
    for (int i = 0; i < kWideRegs; ++i)
      v[i] = 32 * i < D ? at[(size_t)k * D + 32 * i] : 0.f;
  }
  __device__ __forceinline__ void store(int k,
                                        const float (&v)[kWideRegs]) const {
#pragma unroll
    for (int i = 0; i < kWideRegs; ++i)
      if (32 * i < D) at[(size_t)k * D + 32 * i] = v[i];
  }
  __device__ __forceinline__ void copy(int to, int from) const {
#pragma unroll
    for (int i = 0; i < kWideRegs; ++i)
      if (32 * i < D)
        at[(size_t)to * D + 32 * i] = at[(size_t)from * D + 32 * i];
  }
  __device__ __forceinline__ int ckp(int s) const { return kWideFixed + s; }
  __device__ __forceinline__ int ckm(int s, int md) const {
    return kWideFixed + md + s;
  }
};

// The per-chain scalars of one transition: the same bits in all 32 lanes.
struct WideTree {
  float lp, elp0, elp1, wlp, slp;
  float H0, u_slice, dirn, n1, lw1, ntot, lwtot;
  int t, j, k, nd;
  bool run, ok, sdv, dv;
};

// Doubling T.j starts from the edge its direction points to (NUTS.jl:150):
// the walker loads it, and the proposal seed is the walker.
template <bool MS>
__device__ __forceinline__ void wide_begin_doubling(
    WideTree& T, const NutsArgs& a, const Scratch& S, int c,
    float (&wp)[kWideRegs], float (&wm)[kWideRegs], float (&wg)[kWideRegs]) {
  T.dirn = direction<MS>(a, c, T.t, T.j);
  const bool plus = T.dirn > 0.f;
  S.load(plus ? kEp1 : kEp0, wp);
  S.load(plus ? kEm1 : kEm0, wm);
  S.load(plus ? kEg1 : kEg0, wg);
  T.wlp = plus ? T.elp1 : T.elp0;
  S.store(kSp, wp);
  S.store(kSg, wg);
  T.slp = T.wlp;
  T.n1 = 0.f;
  T.lw1 = -CUDART_INF_F;
  T.ok = true;
  T.sdv = false;
  T.k = 0;
}

// A new tree at the chosen state (kTh, kG, T.lp) with momentum m and the
// slice's log-uniform.  Every lane of the warp calls it.
template <bool MS>
__device__ __forceinline__ void wide_start_tree(
    WideTree& T, const NutsArgs& a, const Wide& w, const Scratch& S, int c,
    const float (&m)[kWideRegs], float logu, float (&wp)[kWideRegs],
    float (&wm)[kWideRegs], float (&wg)[kWideRegs]) {
  float v[kWideRegs];
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) v[i] = m[i] * m[i];
  T.H0 = -T.lp + 0.5f * wide_chain_sum(w, v);
  T.u_slice = a.multinomial ? -T.H0 : logu - T.H0;  // NUTS.jl:141
  S.copy(kEp0, kTh);
  S.copy(kEp1, kTh);
  S.store(kEm0, m);
  S.store(kEm1, m);
  S.copy(kEg0, kG);
  S.copy(kEg1, kG);
  T.elp0 = T.elp1 = T.lp;
  T.ntot = 1.f;  // the initial point, weight exp(H0 - H0)
  T.lwtot = 0.f;
  T.nd = 0;
  T.dv = false;
  T.j = 0;
  wide_begin_doubling<MS>(T, a, S, c, wp, wm, wg);
}

// Kernel 9's draws of transition t of chain c: the momenta (0 past d) and
// the slice's log-uniform.
__device__ __forceinline__ float wide_draw(const NutsArgs& a, int d, int c,
                                           int t, float (&m)[kWideRegs]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) {
    const int j = lane + 32 * i;
    m[i] = j < d ? momentum(a.key, c, t, j) : 0.f;
  }
  return log_uniform(a.key, c, t);
}

// nuts_tile_kernel on the wide tile.  a.scratch holds gridDim.x slices of
// wide_scratch_per_block(D, md) bytes.
template <bool MS>
__global__ void __launch_bounds__(kTrajThreads, 1)
nuts_wide_kernel(Glm p, NutsArgs a) {
  __shared__ int next_tile;
  const Wide w = wide_at(p);
  const int oc = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Scratch S{a.scratch +
                      ((size_t)blockIdx.x * kTileChains + oc) *
                          (kWideFixed + 2 * a.md) * w.D +
                      lane,
                  w.D};
  wide_init(p, w);  // resident rows staged once for all its tiles
  const int tiles = (a.C + kTileChains - 1) / kTileChains;
  for (int tile = blockIdx.x; tile < tiles;) {
    const int c = tile * kTileChains + oc;
    const bool real = c < a.C;
    const int cs = min(c, a.C - 1);  // warps past C shadow the last chain
    float wp[kWideRegs], wm[kWideRegs], wg[kWideRegs];
    WideTree T;
    wide_load(wp, a.th_in, cs, p.d);
    S.store(kTh, wp);
    wide_load(wg, a.g_in, cs, p.d);
    S.store(kG, wg);
    T.lp = a.lp_in[cs];
    T.t = 0;
    {
      float m[kWideRegs], logu;
      if (MS) {
        logu = wide_draw(a, p.d, cs, 0, m);
      } else {
        wide_load(m, a.m0, cs, p.d);
        logu = a.logu[cs];
      }
      wide_start_tree<MS>(T, a, w, S, cs, m, logu, wp, wm, wg);
    }
    T.run = real;

    for (;;) {
      if (!__syncthreads_or(T.run)) break;
      // a half kick and a drift of the walker; a chain without a leaf to
      // take puts its chosen state in the tile
      const float es = T.dirn * a.eps;
      if (T.run) {
#pragma unroll
        for (int i = 0; i < kWideRegs; ++i) {
          wm[i] = wm[i] + 0.5f * es * wg[i];
          wp[i] = wp[i] + es * wm[i];
        }
        wide_put_theta(w, oc, wp);
      } else {
        float th[kWideRegs];
        S.load(kTh, th);
        wide_put_theta(w, oc, th);
      }
      wide_rows(p, w, true);
      if (!T.run) continue;  // the warp's chain: uniform

      // the leaf's gradient and lp as wide_grad forms them (glm_hmc.cu)
      float pg[kWideRegs], v[kWideRegs];
      wide_prior_grad(p, w, wp, pg);
#pragma unroll
      for (int i = 0; i < kWideRegs; ++i) {
        const int j = lane + 32 * i;
        wg[i] = j < p.d ? wide_gsum(w, oc, j) - pg[i] : 0.f;
        v[i] = wp[i] * pg[i];
      }
      T.wlp = (float)(sum_ll(w.pll, oc, kTrajWarps) -
                      0.5 * (double)wide_chain_sum(w, v));
#pragma unroll
      for (int i = 0; i < kWideRegs; ++i) {
        wm[i] = wm[i] + 0.5f * es * wg[i];
        v[i] = wm[i] * wm[i];
      }
      float H = -T.wlp + 0.5f * wide_chain_sum(w, v);
      if (isnan(H)) H = CUDART_INF_F;
      const bool diverged = T.u_slice >= kDeltaMax - H;  // NUTS.jl:92
      // reservoir draw, indexed by the transition-global leaf number
      const float u_leaf = leaf_u<MS>(a, c, T.t, (1 << T.j) - 1 + T.k);
      bool take;
      if (a.multinomial) {
        const float lw_leaf = diverged ? -CUDART_INF_F : T.H0 - H;
        const float lw_new = logaddexp(T.lw1, lw_leaf);
        take = !diverged && logf(u_leaf) < lw_leaf - lw_new;
        T.lw1 = lw_new;
        if (!diverged) T.n1 += 1.f;
      } else {
        const bool valid = T.u_slice <= -H;  // NUTS.jl:91
        const float nf = T.n1 + (valid ? 1.f : 0.f);
        take = valid && u_leaf * nf < 1.f;
        T.n1 = nf;
      }
      if (take) {
        S.store(kSp, wp);
        S.store(kSg, wg);
        T.slp = T.wlp;
      }
      if (diverged) {
        T.sdv = true;
        T.ok = false;
      }
      if ((T.k & 1) == 0) {  // checkpoint store at slot popcount(k)
        const int s = __popc(T.k);
        S.store(S.ckp(s), wp);
        S.store(S.ckm(s, a.md), wm);
      } else {  // spans ending at odd k: slots popc(k >> 1) -
                // trailing_ones(k) + 1 .. popc(k >> 1) (NUTS.jl:50)
        const int hi = __popc(T.k >> 1);
        for (int s = hi - (__ffs(~T.k) - 1) + 1; s <= hi; ++s) {
          float cp[kWideRegs], cm[kWideRegs], da[kWideRegs], db[kWideRegs];
          S.load(S.ckp(s), cp);
          S.load(S.ckm(s, a.md), cm);
#pragma unroll
          for (int i = 0; i < kWideRegs; ++i) {
            const float dl = T.dirn * (wp[i] - cp[i]);
            da[i] = dl * cm[i];
            db[i] = dl * wm[i];
          }
          if (wide_chain_sum(w, da) < 0.f || wide_chain_sum(w, db) < 0.f)
            T.ok = false;
        }
      }
      ++T.k;
      if (T.ok && T.k < (1 << T.j)) continue;

      // the doubling ends: the walker's end is the new edge, then the outer
      // merge (NUTS.jl:160; biased progressive for multinomial)
      const bool plus = T.dirn > 0.f;
      S.store(plus ? kEp1 : kEp0, wp);
      S.store(plus ? kEm1 : kEm0, wm);
      S.store(plus ? kEg1 : kEg0, wg);
      (plus ? T.elp1 : T.elp0) = T.wlp;
      const float u = merge_u<MS>(a, c, T.t, T.j);
      bool merge;
      if (a.multinomial) {
        merge = T.ok && logf(u) < T.lw1 - T.lwtot;
        if (T.ok) T.lwtot = logaddexp(T.lwtot, T.lw1);
      } else {
        merge = T.ok && u * T.ntot < T.n1;
      }
      if (merge) {
        S.copy(kTh, kSp);
        S.copy(kG, kSg);
        T.lp = T.slp;
      }
      T.ntot += T.n1;
      // overall u-turn between the extreme states (NUTS.jl:165); the walker
      // is the edge it just wrote
      float op[kWideRegs], om[kWideRegs], ua[kWideRegs], ub[kWideRegs];
      S.load(plus ? kEp0 : kEp1, op);
      S.load(plus ? kEm0 : kEm1, om);
#pragma unroll
      for (int i = 0; i < kWideRegs; ++i) {
        const float dp = plus ? wp[i] - op[i] : op[i] - wp[i];
        ua[i] = dp * (plus ? om[i] : wm[i]);
        ub[i] = dp * (plus ? wm[i] : om[i]);
      }
      const bool turned =
          wide_chain_sum(w, ua) < 0.f || wide_chain_sum(w, ub) < 0.f;
      T.nd += 1;
      T.dv = T.dv || T.sdv;
      ++T.j;
      if (T.ok && !turned && T.j < a.md) {
        wide_begin_doubling<MS>(T, a, S, c, wp, wm, wg);
        continue;
      }
      T.run = false;
      if (!MS) continue;

      // kernel 9: the tree ended; write its transition's rows and, while
      // transitions remain, start the next one at once.  The transition
      // started where the last one's row (or th_in) stands.
      const size_t row = (size_t)T.t * a.C + c;
      const float* th0 =
          T.t ? a.r_th + (row - a.C) * p.d : a.th_in + (size_t)c * p.d;
      float th[kWideRegs];
      S.load(kTh, th);
      bool moved = false;
#pragma unroll
      for (int i = 0; i < kWideRegs; ++i) {
        const int j = lane + 32 * i;
        if (j < p.d) moved = moved || th[i] != th0[j];
      }
      moved = __any_sync(0xffffffffu, moved);
      wide_store(a.r_th, th, row, p.d);
      S.load(kG, th);
      wide_store(a.r_g, th, row, p.d);
      if (lane == 0) {
        a.r_lp[row] = T.lp;
        a.r_acc[row] = moved ? 1 : 0;
        a.r_nd[row] = T.nd;
        a.r_div[row] = T.dv ? 1 : 0;
      }
      if (++T.t < a.k_trans) {
        float m[kWideRegs];
        const float logu = wide_draw(a, p.d, c, T.t, m);
        wide_start_tree<MS>(T, a, w, S, c, m, logu, wp, wm, wg);
        T.run = true;
      }
    }

    if (real) {
      S.load(kTh, wp);
      wide_store(a.th_out, wp, c, p.d);
      S.load(kG, wg);
      wide_store(a.g_out, wg, c, p.d);
      if (lane == 0) {
        a.lp_out[c] = T.lp;
        if (!MS) {
          a.nd_out[c] = T.nd;
          a.div_out[c] = T.dv ? 1 : 0;
        }
      }
    }
    // the tile queue, as nuts_tile_kernel takes it
    if (threadIdx.x == 0) {
      const int ticket = atomicAdd(a.queue, 1);
      if (ticket == tiles - 1) *a.queue = 0;
      next_tile = gridDim.x + ticket;
    }
    __syncthreads();
    tile = next_tile;
  }
}

// ---- the very-wide tile and the chunked tier: kWideMax < d <= kXChunkDMax ---
// The same tree on glm_tile.cuh's very-wide layout, as hmc_xwide
// (glm_hmc.cu) runs the HMC transitions: warp c holds chain c of the tile
// and its lanes stride over the coordinates; each leaf's gradient is one
// xwide_grad of the whole block (left out of line there).  Above 256
// parameters the wide kernel's walker (3 D / 32 registers a lane, 96 at D
// 1024) no longer fits beside the very-wide gradient, so no array of a
// chain stays in registers:
//
// - the walker's position is the warp's row of sth in shared memory, where
//   xwide_grad reads theta (a chain without a leaf to take copies its
//   chosen state there);
// - every other array of D floats (the walker's momentum and gradient, the
//   chosen state, both edges, the proposal and the two checkpoint stacks:
//   12 + 2 md of them) is a row of the block's slice of the scratch buffer,
//   laid out [array][chain of the tile][coordinate], so that a warp's
//   access of 32 coordinates is one 128-byte line and xwide_grad writes
//   the gradient of all 16 chains into the walker's gradient array.  Only
//   the warp that owns a row touches it, apart from that gradient, which
//   the barrier at the end of xwide_grad hands over.
//
// Every per-chain scalar comes from values that are the same bits in all
// 32 lanes: lp from xwide_grad, |m|^2 and the dot products of the span
// checks and the u-turn from a loop over D in passes of 32 and a butterfly
// (xw_sum, as xw_sq), the draws from the chain's own counters; so a warp
// takes every branch of its chain together.  A leaf's bookkeeping moves a
// few rows (a copy is 2 D floats a lane's pass; at most md span checks of
// 3 D reads), against the gradient's 4 d N multiply-adds a chain.  The
// slice is 2 MB a block at D 1024 and md 10 (277 MB over 132 blocks).
//
// Above kXWideMax the same kernel runs on the chunked tier (CH), whose
// gradient xchunk_grad walks d in column chunks of at most 512 and reads
// the 16 chains' theta from a (16, D) array in device memory: sth holds
// one chunk of it (33 KB), where a whole row set would take 16 (D + 4)
// floats (256 KB at D 4096, more than a block has).  So the walker's
// position moves to one more array of the slice, after the two stacks
// (13 + 2 md rows a chain), which the gradient reads as thp; the rest is
// the very-wide kernel's, line for line.  The slice is 8.7 MB a block at
// D 4096 and md 10 (1.14 GB over 132 blocks), 34.6 MB at D 16384.
enum XNutsArray { kWm = kWideFixed, kWg, kXNutsFixed };

__host__ __device__ inline size_t xwide_scratch_per_block(int D, int md,
                                                          bool chunked) {
  return sizeof(float) * kTileChains *
         (size_t)(kXNutsFixed + 2 * md + (chunked ? 1 : 0)) * D;
}

// The rows of the block's slice as warp c sees them: array k's row of
// chain c.
struct XRows {
  float* slice;
  int D, c;
  __device__ __forceinline__ float* operator()(int k) const {
    return slice + ((size_t)k * kTileChains + c) * D;
  }
  __device__ __forceinline__ float* ckp(int s) const {
    return (*this)(kXNutsFixed + s);
  }
  __device__ __forceinline__ float* ckm(int s, int md) const {
    return (*this)(kXNutsFixed + md + s);
  }
  // the walker's position on the chunked tier, after the two stacks
  __device__ __forceinline__ float* wpos(int md) const {
    return (*this)(kXNutsFixed + 2 * md);
  }
};

// The sum of the lanes' partials s: the full-warp butterfly, the same bits
// in every lane.  Every lane of the warp must call it.
__device__ __forceinline__ float xw_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Doubling T.j starts from the edge its direction points to (NUTS.jl:150):
// the walker (wp, the momentum and gradient rows) loads it, and the
// proposal seed is the walker.
template <bool MS>
__device__ __forceinline__ void xw_begin_doubling(WideTree& T,
                                                  const NutsArgs& a,
                                                  const XRows& S, float* wp,
                                                  int c) {
  T.dirn = direction<MS>(a, c, T.t, T.j);
  const bool plus = T.dirn > 0.f;
  const float* ep = S(plus ? kEp1 : kEp0);
  const float* em = S(plus ? kEm1 : kEm0);
  const float* eg = S(plus ? kEg1 : kEg0);
  float *wm = S(kWm), *wg = S(kWg), *sp = S(kSp), *sg = S(kSg);
  for (int j = threadIdx.x & 31; j < S.D; j += 32) {
    const float pj = ep[j], gj = eg[j];
    wp[j] = pj;
    sp[j] = pj;
    wm[j] = em[j];
    wg[j] = gj;
    sg[j] = gj;
  }
  T.wlp = plus ? T.elp1 : T.elp0;
  T.slp = T.wlp;
  T.n1 = 0.f;
  T.lw1 = -CUDART_INF_F;
  T.ok = true;
  T.sdv = false;
  T.k = 0;
}

// A new tree at the chosen state (rows kTh, kG, T.lp) with the momentum in
// row kWm and the slice's log-uniform.  Every lane of the warp calls it.
template <bool MS>
__device__ __forceinline__ void xw_start_tree(WideTree& T, const NutsArgs& a,
                                              const XRows& S, float logu,
                                              float* wp, int c) {
  const float *m = S(kWm), *th = S(kTh), *g = S(kG);
  float *ep0 = S(kEp0), *ep1 = S(kEp1), *em0 = S(kEm0), *em1 = S(kEm1);
  float *eg0 = S(kEg0), *eg1 = S(kEg1);
  float s = 0.f;
  for (int j = threadIdx.x & 31; j < S.D; j += 32) {
    const float mj = m[j], tj = th[j], gj = g[j];
    s = fmaf(mj, mj, s);
    ep0[j] = tj;
    ep1[j] = tj;
    em0[j] = mj;
    em1[j] = mj;
    eg0[j] = gj;
    eg1[j] = gj;
  }
  T.H0 = -T.lp + 0.5f * xw_sum(s);
  T.u_slice = a.multinomial ? -T.H0 : logu - T.H0;  // NUTS.jl:141
  T.elp0 = T.elp1 = T.lp;
  T.ntot = 1.f;  // the initial point, weight exp(H0 - H0)
  T.lwtot = 0.f;
  T.nd = 0;
  T.dv = false;
  T.j = 0;
  xw_begin_doubling<MS>(T, a, S, wp, c);
}

// Kernel 9's draws of transition t of chain c: the momenta into m (0 past
// d) and the slice's log-uniform.
__device__ __forceinline__ float xw_draw(const NutsArgs& a, int d, int D,
                                         int c, int t, float* m) {
  for (int j = threadIdx.x & 31; j < D; j += 32)
    m[j] = j < d ? momentum(a.key, c, t, j) : 0.f;
  return log_uniform(a.key, c, t);
}

// nuts_tile_kernel on the very-wide tile (CH false) or the chunked tier
// (CH true).  a.scratch holds gridDim.x slices of
// xwide_scratch_per_block(D, md, CH) bytes.
template <bool MS, bool CH>
__global__ void __launch_bounds__(kTrajThreads, 1)
nuts_xwide_kernel(Glm p, NutsArgs a) {
  __shared__ int next_tile;
  int D;
  float* sth;
  if constexpr (CH) {
    const XChunk xc = xchunk_at(p);
    xwide_init(p, xc.x);
    D = xc.D;
    sth = nullptr;
  } else {
    const XWide x = xwide_at(p);
    xwide_init(p, x);
    D = x.D;
    sth = x.sth;
  }
  const int oc = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const slice =
      a.scratch + (size_t)blockIdx.x * xwide_scratch_per_block(D, a.md, CH) /
                      sizeof(float);
  const XRows S{slice, D, oc};
  // the walker's position: the warp's row of sth, or of the slice's array
  // after the stacks, whose 16 rows the chunked gradient reads
  float* const thp =
      CH ? slice + (size_t)(kXNutsFixed + 2 * a.md) * kTileChains * D : sth;
  float* const wp = CH ? S.wpos(a.md) : sth + oc * (D + 4);
  float* const wm = S(kWm);
  const float* const wg = S(kWg);
  float* const gall = slice + (size_t)kWg * kTileChains * D;  // all 16 rows
  const int tiles = (a.C + kTileChains - 1) / kTileChains;
  for (int tile = blockIdx.x; tile < tiles;) {
    const int c = tile * kTileChains + oc;
    const bool real = c < a.C;
    const int cs = min(c, a.C - 1);  // warps past C shadow the last chain
    WideTree T;
    xw_load(S(kTh), D, a.th_in, cs, p.d);
    xw_load(S(kG), D, a.g_in, cs, p.d);
    T.lp = a.lp_in[cs];
    T.t = 0;
    float logu;
    if (MS) {
      logu = xw_draw(a, p.d, D, cs, 0, wm);
    } else {
      xw_load(wm, D, a.m0, cs, p.d);
      logu = a.logu[cs];
    }
    xw_start_tree<MS>(T, a, S, logu, wp, cs);
    T.run = real;

    for (;;) {
      if (!__syncthreads_or(T.run)) break;
      // a half kick and a drift of the walker; a chain without a leaf to
      // take puts its chosen state in the tile
      const float es = T.dirn * a.eps;
      if (T.run) {
        for (int j = lane; j < D; j += 32) {
          const float m = wm[j] + 0.5f * es * wg[j];
          wm[j] = m;
          wp[j] = wp[j] + es * m;
        }
      } else {
        xw_copy(wp, S(kTh), D);
      }
      const float lp = xw_grad<CH>(p, thp, gall, true);
      if (!T.run) continue;  // the warp's chain: uniform

      T.wlp = lp;
      float s = 0.f;
      for (int j = lane; j < D; j += 32) {
        const float m = wm[j] + 0.5f * es * wg[j];
        wm[j] = m;
        s = fmaf(m, m, s);
      }
      float H = -T.wlp + 0.5f * xw_sum(s);
      if (isnan(H)) H = CUDART_INF_F;
      const bool diverged = T.u_slice >= kDeltaMax - H;  // NUTS.jl:92
      // reservoir draw, indexed by the transition-global leaf number
      const float u_leaf = leaf_u<MS>(a, c, T.t, (1 << T.j) - 1 + T.k);
      bool take;
      if (a.multinomial) {
        const float lw_leaf = diverged ? -CUDART_INF_F : T.H0 - H;
        const float lw_new = logaddexp(T.lw1, lw_leaf);
        take = !diverged && logf(u_leaf) < lw_leaf - lw_new;
        T.lw1 = lw_new;
        if (!diverged) T.n1 += 1.f;
      } else {
        const bool valid = T.u_slice <= -H;  // NUTS.jl:91
        const float nf = T.n1 + (valid ? 1.f : 0.f);
        take = valid && u_leaf * nf < 1.f;
        T.n1 = nf;
      }
      if (take) {
        xw_copy(S(kSp), wp, D);
        xw_copy(S(kSg), wg, D);
        T.slp = T.wlp;
      }
      if (diverged) {
        T.sdv = true;
        T.ok = false;
      }
      if ((T.k & 1) == 0) {  // checkpoint store at slot popcount(k)
        const int sl = __popc(T.k);
        xw_copy(S.ckp(sl), wp, D);
        xw_copy(S.ckm(sl, a.md), wm, D);
      } else {  // spans ending at odd k: slots popc(k >> 1) -
                // trailing_ones(k) + 1 .. popc(k >> 1) (NUTS.jl:50)
        const int hi = __popc(T.k >> 1);
        for (int sl = hi - (__ffs(~T.k) - 1) + 1; sl <= hi; ++sl) {
          const float *cp = S.ckp(sl), *cm = S.ckm(sl, a.md);
          float da = 0.f, db = 0.f;
          for (int j = lane; j < D; j += 32) {
            const float dl = T.dirn * (wp[j] - cp[j]);
            da = fmaf(dl, cm[j], da);
            db = fmaf(dl, wm[j], db);
          }
          if (xw_sum(da) < 0.f || xw_sum(db) < 0.f) T.ok = false;
        }
      }
      ++T.k;
      if (T.ok && T.k < (1 << T.j)) continue;

      // the doubling ends: the walker's end is the new edge, then the outer
      // merge (NUTS.jl:160; biased progressive for multinomial) and the
      // overall u-turn between the extreme states (NUTS.jl:165), whose dot
      // products run in the same pass as the edge's store
      const bool plus = T.dirn > 0.f;
      float* ep = S(plus ? kEp1 : kEp0);
      float* em = S(plus ? kEm1 : kEm0);
      float* eg = S(plus ? kEg1 : kEg0);
      const float* op = S(plus ? kEp0 : kEp1);
      const float* om = S(plus ? kEm0 : kEm1);
      float ua = 0.f, ub = 0.f;
      for (int j = lane; j < D; j += 32) {
        const float pj = wp[j], mj = wm[j], oj = op[j], omj = om[j];
        ep[j] = pj;
        em[j] = mj;
        eg[j] = wg[j];
        const float dp = plus ? pj - oj : oj - pj;
        ua = fmaf(dp, plus ? omj : mj, ua);
        ub = fmaf(dp, plus ? mj : omj, ub);
      }
      (plus ? T.elp1 : T.elp0) = T.wlp;
      const float u = merge_u<MS>(a, c, T.t, T.j);
      bool merge;
      if (a.multinomial) {
        merge = T.ok && logf(u) < T.lw1 - T.lwtot;
        if (T.ok) T.lwtot = logaddexp(T.lwtot, T.lw1);
      } else {
        merge = T.ok && u * T.ntot < T.n1;
      }
      if (merge) {
        xw_copy(S(kTh), S(kSp), D);
        xw_copy(S(kG), S(kSg), D);
        T.lp = T.slp;
      }
      T.ntot += T.n1;
      const bool turned = xw_sum(ua) < 0.f || xw_sum(ub) < 0.f;
      T.nd += 1;
      T.dv = T.dv || T.sdv;
      ++T.j;
      if (T.ok && !turned && T.j < a.md) {
        xw_begin_doubling<MS>(T, a, S, wp, c);
        continue;
      }
      T.run = false;
      if (!MS) continue;

      // kernel 9: the tree ended; write its transition's rows and, while
      // transitions remain, start the next one at once.  The transition
      // started where the last one's row (or th_in) stands.
      const size_t row = (size_t)T.t * a.C + c;
      const float* th0 =
          T.t ? a.r_th + (row - a.C) * p.d : a.th_in + (size_t)c * p.d;
      const float* th = S(kTh);
      bool moved = false;
      for (int j = lane; j < p.d; j += 32) moved = moved || th[j] != th0[j];
      moved = __any_sync(0xffffffffu, moved);
      xw_store(a.r_th, row, p.d, th);
      xw_store(a.r_g, row, p.d, S(kG));
      if (lane == 0) {
        a.r_lp[row] = T.lp;
        a.r_acc[row] = moved ? 1 : 0;
        a.r_nd[row] = T.nd;
        a.r_div[row] = T.dv ? 1 : 0;
      }
      if (++T.t < a.k_trans) {
        logu = xw_draw(a, p.d, D, c, T.t, wm);
        xw_start_tree<MS>(T, a, S, logu, wp, c);
        T.run = true;
      }
    }

    if (real) {
      xw_store(a.th_out, c, p.d, S(kTh));
      xw_store(a.g_out, c, p.d, S(kG));
      if (lane == 0) {
        a.lp_out[c] = T.lp;
        if (!MS) {
          a.nd_out[c] = T.nd;
          a.div_out[c] = T.dv ? 1 : 0;
        }
      }
    }
    // the tile queue, as nuts_tile_kernel takes it
    if (threadIdx.x == 0) {
      const int ticket = atomicAdd(a.queue, 1);
      if (ticket == tiles - 1) *a.queue = 0;
      next_tile = gridDim.x + ticket;
    }
    __syncthreads();
    tile = next_tile;
  }
}

// ---- host side -------------------------------------------------------------

// The shared-memory plan at (d, N, md), D = glm_bound_for(d): on the
// narrow tile traj_grad's, with the two checkpoint stacks of md slots as
// the kernel's own; on the wide tile wide_plan's, on the very-wide one
// xwide_plan's and on the chunked tier xchunk_plan's (the stacks live in
// the scratch buffer).
TrajPlan nuts_plan(int d, int D, int N, int md) {
  if (D > kXWideMax) return xchunk_plan(d);
  if (D > kWideMax) return xwide_plan(D);
  if (D > kNarrowMax) return wide_plan(D, N);
  return traj_plan(D, N, 2 * sizeof(float) * (size_t)md * kTileChains * D);
}

// Bytes of one block's slice of the tree's scratch at (D, md): none on the
// narrow tile.
size_t nuts_scratch_per_block(int D, int md) {
  return D > kWideMax     ? xwide_scratch_per_block(D, md, D > kXWideMax)
         : D > kNarrowMax ? wide_scratch_per_block(D, md)
                          : 0;
}

bool nuts_args_ok(int d, int N, int kind, const NutsArgs& a) {
  return glm_bound_for(d) && N >= 1 && kind >= 0 && kind <= 3 && a.C >= 1 &&
         a.md >= 1 && a.md <= kMaxDoublings && a.k_trans >= 1;
}

template <bool MS>
using NutsKernel = void (*)(Glm, NutsArgs);

// The kernel at bound D: the narrow tile's instantiation for D <= 32, the
// wide tile's up to kWideMax, the very-wide tile's up to kXWideMax and the
// chunked tier's above (D a run-time value on all three).
template <bool MS>
NutsKernel<MS> nuts_kernel_for(int D) {
  switch (D) {
    case 8: return nuts_tile_kernel<8, MS>;
    case 16: return nuts_tile_kernel<16, MS>;
    case 32: return nuts_tile_kernel<32, MS>;
    default:
      return D > kXWideMax  ? nuts_xwide_kernel<MS, true>
             : D > kWideMax ? nuts_xwide_kernel<MS, false>
                            : nuts_wide_kernel<MS>;
  }
}

// Blocks resident per SM of the kernel at (D, N, md) and its plan.
template <bool MS>
cudaError_t nuts_occupancy(int D, const TrajPlan& tp, int* per_sm) {
  const NutsKernel<MS> kernel = nuts_kernel_for<MS>(D);
  cudaError_t e = prepare(kernel, tp.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kTrajThreads, tp.smem);
  return e;
}

cudaError_t sm_count(int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// Launch the kernel of bound D: persistent blocks, as many as fit at once
// (and, above the narrow tile, the scratch buffer of scratch_bytes must
// hold a slice for each).
template <bool MS>
int launch_nuts(const float* xt, const float* y, const float* w,
                const float* o, const float* lamv, const float* lamm, int N,
                int d, int kind, float lam, const NutsArgs& a,
                long long scratch_bytes, void* stream) {
  if (!nuts_args_ok(d, N, kind, a)) return (int)cudaErrorInvalidValue;
  const int D = glm_bound_for(d);
  const TrajPlan tp = nuts_plan(d, D, N, a.md);
  if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
  const Glm p{xt, y, w, o, lamv, lamm, N, d, kind, lam, tp.rows,
              tp.resident};
  const int tiles = (a.C + kTileChains - 1) / kTileChains;
  int sms, per_sm;
  cudaError_t e = sm_count(&sms);
  if (e == cudaSuccess) e = nuts_occupancy<MS>(D, tp, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const int blocks = min(tiles, sms * max(per_sm, 1));
  if (D > kNarrowMax &&
      (!a.scratch || (size_t)scratch_bytes <
                         blocks * nuts_scratch_per_block(D, a.md)))
    return (int)cudaErrorInvalidValue;
  nuts_kernel_for<MS>(D)<<<blocks, kTrajThreads, tp.smem,
                           (cudaStream_t)stream>>>(p, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nuts_max_doublings() { return kMaxDoublings; }

int nuts_max_dim() { return kXChunkDMax; }

const char* nuts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int glm_nuts_transition(const float* xt, const float* y, const float* w,
                        const float* o, const float* lamv,
                        const float* lamm, int N, int d, int C,
                        const float* th_in, const float* lp_in,
                        const float* g_in, const float* m0, const float* logu,
                        const float* dirn, const float* merge,
                        const float* leaf, float* th_out, float* g_out,
                        float* lp_out, int* nd_out, unsigned char* div_out,
                        float eps, float lam, int md, int kind,
                        int multinomial, int* queue, float* scratch,
                        long long scratch_bytes, void* stream) {
  NutsArgs a{};
  a.C = C;
  a.md = md;
  a.multinomial = multinomial;
  a.k_trans = 1;
  a.eps = eps;
  a.th_in = th_in;
  a.lp_in = lp_in;
  a.g_in = g_in;
  a.m0 = m0;
  a.logu = logu;
  a.dirn = dirn;
  a.merge = merge;
  a.leaf = leaf;
  a.th_out = th_out;
  a.g_out = g_out;
  a.lp_out = lp_out;
  a.nd_out = nd_out;
  a.div_out = div_out;
  a.queue = queue;
  a.scratch = scratch;
  return launch_nuts<false>(xt, y, w, o, lamv, lamm, N, d, kind, lam, a,
                            scratch_bytes, stream);
}

int glm_nuts_multistep(const float* xt, const float* y, const float* w,
                       const float* o, const float* lamv, const float* lamm,
                       int N, int d, int C,
                       const float* th_in, const float* lp_in,
                       const float* g_in, float* th_out, float* g_out,
                       float* lp_out, float* r_th, float* r_g, float* r_lp,
                       unsigned char* r_acc, int* r_nd, unsigned char* r_div,
                       float eps, float lam, int md, int kind, int multinomial,
                       int k_trans, unsigned long long seed, int* queue,
                       float* scratch, long long scratch_bytes,
                       void* stream) {
  NutsArgs a{};
  a.C = C;
  a.md = md;
  a.multinomial = multinomial;
  a.k_trans = k_trans;
  a.eps = eps;
  a.key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  a.th_in = th_in;
  a.lp_in = lp_in;
  a.g_in = g_in;
  a.th_out = th_out;
  a.g_out = g_out;
  a.lp_out = lp_out;
  a.r_th = r_th;
  a.r_g = r_g;
  a.r_lp = r_lp;
  a.r_acc = r_acc;
  a.r_nd = r_nd;
  a.r_div = r_div;
  a.queue = queue;
  a.scratch = scratch;
  return launch_nuts<true>(xt, y, w, o, lamv, lamm, N, d, kind, lam, a,
                           scratch_bytes, stream);
}

// How the kernels run at (d, N, md): blocks of kernel 8 resident per SM
// (from the occupancy calculator), dynamic shared memory per block, whether
// all rows stay resident, and the bytes of scratch a launch of either
// kernel needs on this device at most (0 on the narrow tile).  Returns a
// CUDA error code.
int glm_nuts_plan(int d, int N, int md, int* blocks_per_sm, int* smem,
                  int* resident, long long* scratch_bytes) {
  const int D = glm_bound_for(d);
  if (!D || N < 1 || md < 1 || md > kMaxDoublings)
    return (int)cudaErrorInvalidValue;
  const TrajPlan tp = nuts_plan(d, D, N, md);
  if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
  *smem = (int)tp.smem;
  *resident = tp.resident ? 1 : 0;
  int sms, per_ms;
  cudaError_t e = sm_count(&sms);
  if (e == cudaSuccess) e = nuts_occupancy<false>(D, tp, blocks_per_sm);
  if (e == cudaSuccess) e = nuts_occupancy<true>(D, tp, &per_ms);
  if (e != cudaSuccess) return (int)e;
  *scratch_bytes = (long long)sms * max(max(*blocks_per_sm, per_ms), 1) *
                   (long long)nuts_scratch_per_block(D, md);
  return 0;
}

}  // extern "C"
