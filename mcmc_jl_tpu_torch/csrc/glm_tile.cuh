// The chain-tile GLM gradient on the tensor cores, shared by the four HMC
// kernels (glm_hmc.cu: trajectory, step, multistep and the Halton
// multistep rows), the N-tiled kernel
// (glm_bign.cu partial_tile_kernel) and the two NUTS kernels (glm_nuts.cu
// nuts_tile_kernel).  traj_grad is one gradient of a tile's 16 chains with
// the rows split over 16 warps: the HMC kernels take one per drift, the
// NUTS kernels one per leaf.  After it come the per-chain helpers of those
// kernels: a chain's sum over its lanes and its Philox draws.
//
// For a tile of 16 chains (one warp) and a group of 8 observation rows it
// computes, as the Pallas kernels do (pallas_glm.py:164-181,
// pallas_glm_bign.py:67-84), two block products with the link between them:
//   1. Z = Theta X^T + o            (16 x 8, K = d)
//   2. R = w * resid(Z, y), and ll = w * ll(Z, y) where wanted, in registers
//   3. G += R X                     (16 x D, K = the 8 rows)
// The model is the one of glm_common.cuh.  It is the structure of attention
// with the link in place of the softmax and K = V = X: the first product's
// accumulator is the second product's A operand.  The second product's K
// order (the rows) is free, so it reads row 2q as k = q and row 2q + 1 as
// k = q + 4: the accumulator of mma m16n8k8 holds (chain g, rows 2q, 2q + 1)
// and (chain g + 8, rows 2q, 2q + 1) in lane 4g + q, which is exactly the A
// fragment of that order.  No shuffle, no trip through shared memory.
//
// Float32 accuracy from TF32 tensor cores (3xTF32): every operand is split
// a = a_hi + a_lo with both parts truncated to TF32, and a product is
// a_hi b_hi + a_hi b_lo + a_lo b_hi with float32 accumulators; the dropped
// a_lo b_lo is about 2^-22 of the product, below float32 rounding of the
// sums.  The small terms accumulate apart from the large one (two
// accumulators), which also halves the dependent chain of mma latencies.
// X is split once, when it is staged in shared memory, into hi and lo rows
// of stride D + 4 floats: with that stride the fragment loads of both
// products hit 32 distinct banks.  d is padded to D = 8, 16 or 32 with zero
// columns (in X and in theta), which contribute exact zeros.
//
// Rows past the end of a ragged last tile are not padded with zero weights:
// their X, y, w and o are zero in shared memory (finite), and the residual
// and ll of those rows are masked to zero in registers.
//
// Rows are staged either once (resident) or streamed through shared memory
// in tiles: cp.async copies the next tile (4 bytes a thread, any N and any
// alignment) into one of two raw buffers while the current tile, already
// split, is computed.  Everything here is inlined into the kernels (no
// lambdas, no calls): a routine left out of line would take the staged
// rows through generic pointers and the fragments through local memory.
#pragma once

#include "glm_common.cuh"

namespace {

constexpr int kTileChains = 16;        // chains of one warp's m16 tile
// dynamic shared memory a tile kernel plans for (the card allows 227 KB)
constexpr int kTileSmemCap = 220 * 1024;

// Parameter bound of the tile kernels: d padded to a multiple of the mma
// depth (8), as 8, 16 or 32.
int tile_bound_for(int d) {
  return d < 1 ? 0 : d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : 0;
}

__host__ __device__ constexpr int tile_stride(int D) { return D + 4; }
// floats of one staged row: x hi, x lo, y, w, o
__host__ __device__ constexpr int tile_row_floats(int D) {
  return 2 * tile_stride(D) + 3;
}
// floats of one raw (unsplit) row in each of the two cp.async buffers
__host__ __device__ constexpr int raw_row_floats(int D) { return D + 3; }

// A staged tile of `cap` rows (cap a multiple of 8) in shared memory.
struct Rows {
  float* xh;  // (cap, D + 4): TF32 high part of x
  float* xl;  // (cap, D + 4): TF32 low part, x - hi truncated to TF32
  float* y;   // (cap,)
  float* w;   // (cap,)  1 without weights, 0 past the tile's end
  float* o;   // (cap,)  0 without offsets
};

template <int D>
__device__ __forceinline__ Rows rows_at(float* base, int cap) {
  const int S = tile_stride(D);
  float* v = base + 2 * cap * S;
  return Rows{base, base + cap * S, v, v + cap, v + 2 * cap};
}

// x = hi + lo + O(2^-22 |x|): hi is x truncated to TF32 (its 10 leading
// mantissa bits), lo the exact remainder x - hi truncated the same way.
// Two bit masks and a subtraction, where cvt.rna.tf32 costs more.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += a b on one m16n8k8 TF32 tile, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Split x into the hi and lo rows of a staged tile.
template <int D>
__device__ __forceinline__ void store_x(const Rows& t, int i, int j, float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  t.xh[i * tile_stride(D) + j] = __uint_as_float(hi);
  t.xl[i * tile_stride(D) + j] = __uint_as_float(lo);
}

// Stage rows [n0, n0 + nt) straight from device memory (the resident case,
// once per launch).  Rows nt .. round8(nt) are zero.  Every thread calls it.
template <int D>
__device__ void stage_rows(const Glm& p, const Rows& t, int n0, int nt) {
  const int n8 = (nt + 7) & ~7;
  for (int j = 0; j < D; ++j)
    for (int i = threadIdx.x; i < n8; i += blockDim.x)
      store_x<D>(t, i, j,
                 (j < p.d && i < nt) ? p.xt[(size_t)j * p.N + n0 + i] : 0.f);
  for (int i = threadIdx.x; i < n8; i += blockDim.x) {
    const bool v = i < nt;
    t.y[i] = v ? p.y[n0 + i] : 0.f;
    t.w[i] = v ? (p.w ? p.w[n0 + i] : 1.f) : 0.f;
    t.o[i] = v ? (p.o ? p.o[n0 + i] : 0.f) : 0.f;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [n0, n0 + nt) into a raw buffer of R rows: line j < d
// holds x_j, lines D, D + 1, D + 2 hold y, w, o (w and o only when given).
template <int D>
__device__ void issue_rows(const Glm& p, float* raw, int R, int n0, int nt) {
  for (int j = 0; j < p.d + 3; ++j) {
    const float* src;
    int line;
    if (j < p.d) {
      src = p.xt + (size_t)j * p.N;
      line = j;
    } else if (j == p.d) {
      src = p.y;
      line = D;
    } else if (j == p.d + 1) {
      src = p.w;
      line = D + 1;
    } else {
      src = p.o;
      line = D + 2;
    }
    if (!src) continue;
    for (int i = threadIdx.x; i < nt; i += blockDim.x)
      cp_async4(raw + line * R + i, src + n0 + i);
  }
}

// Split an arrived raw buffer of nt rows into the staged tile.
template <int D>
__device__ void split_rows(const Glm& p, const float* raw, int R,
                           const Rows& t, int nt) {
  const int n8 = (nt + 7) & ~7;
  for (int j = 0; j < D; ++j)
    for (int i = threadIdx.x; i < n8; i += blockDim.x)
      store_x<D>(t, i, j, (j < p.d && i < nt) ? raw[j * R + i] : 0.f);
  for (int i = threadIdx.x; i < n8; i += blockDim.x) {
    const bool v = i < nt;
    t.y[i] = v ? raw[D * R + i] : 0.f;
    t.w[i] = v ? (p.w ? raw[(D + 1) * R + i] : 1.f) : 0.f;
    t.o[i] = v ? (p.o ? raw[(D + 2) * R + i] : 0.f) : 0.f;
  }
}

// Streaming rows [n0, n1) through shared memory in tiles of R rows:
//   stream_begin<D>(p, raw, R, n0, n1);
//   for (int t0 = n0, buf = 0; t0 < n1; t0 += R, buf ^= 1) {
//     const int nt = stream_next<D>(p, raw, t, R, t0, n1, buf);
//     ... compute on the staged tile t of nt rows ...
//   }
// The next tile's copy is in flight while a tile is computed.  Two barriers
// a tile; every thread of the block takes part.  `raw` holds
// 2 * (D + 3) * R floats, `t` R rows.
template <int D>
__device__ __forceinline__ void stream_begin(const Glm& p, float* raw, int R,
                                             int n0, int n1) {
  issue_rows<D>(p, raw, R, n0, min(R, n1 - n0));
  cp_async_commit();
}

// Stage tile [t0, t0 + R) from raw buffer buf and start copying the next
// one into the other buffer; returns the tile's row count.
template <int D>
__device__ __forceinline__ int stream_next(const Glm& p, float* raw,
                                           const Rows& t, int R, int t0,
                                           int n1, int buf) {
  const int raw_sz = raw_row_floats(D) * R;
  const int nt = min(R, n1 - t0), t1 = t0 + R;
  if (t1 < n1) {
    issue_rows<D>(p, raw + (buf ^ 1) * raw_sz, R, t1, min(R, n1 - t1));
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // this tile's copies landed; the last tile is done
  split_rows<D>(p, raw + buf * raw_sz, R, t, nt);
  __syncthreads();
  return nt;
}

// Theta's A fragments (hi and lo) for the warp's 16 chains: lane 4g + q
// holds theta(g, 8kb + q), theta(g + 8, 8kb + q), theta(g, 8kb + q + 4),
// theta(g + 8, 8kb + q + 4).  th_g and th_g8 are the rows of chains g and
// g + 8 (d valid columns); columns past d are zero.
template <int D>
__device__ __forceinline__ void theta_frags(const float* th_g,
                                            const float* th_g8, int d,
                                            uint32_t (&ah)[D / 8][4],
                                            uint32_t (&al)[D / 8][4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int kb = 0; kb < D / 8; ++kb) {
    const int j0 = 8 * kb + q, j1 = j0 + 4;
    split_tf32(j0 < d ? th_g[j0] : 0.f, ah[kb][0], al[kb][0]);
    split_tf32(j0 < d ? th_g8[j0] : 0.f, ah[kb][1], al[kb][1]);
    split_tf32(j1 < d ? th_g[j1] : 0.f, ah[kb][2], al[kb][2]);
    split_tf32(j1 < d ? th_g8[j1] : 0.f, ah[kb][3], al[kb][3]);
  }
}

// 1 / u for u in [1, 2]: the approximate reciprocal and one Newton step,
// within an ulp of 1.f / u and without the division's special-case branch.
__device__ __forceinline__ float rcp_1_2(float u) {
  float q;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(q) : "f"(u));
  return fmaf(q, fmaf(-u, q, 1.f), q);
}

// log1p(e) for e in [0, 1] as e P(e): P is the degree-9 least-squares fit
// of log1p(x) / x on [0, 1] (numpy Chebyshev.fit on 400,001 points, turned
// into powers and rounded to float), within 2 ulps of log1p in float32 with
// fused multiply-adds (tests/test_torch_glm_kernels.py checks it): ten
// operations where log1pf takes about twice as many and branches.
__device__ __forceinline__ float log1p_01(float e) {
  float p = -3.214031691e-03f;
  p = fmaf(p, e, 1.964914054e-02f);
  p = fmaf(p, e, -5.643496662e-02f);
  p = fmaf(p, e, 1.053322032e-01f);
  p = fmaf(p, e, -1.525144577e-01f);
  p = fmaf(p, e, 1.965148896e-01f);
  p = fmaf(p, e, -2.494780868e-01f);
  p = fmaf(p, e, 3.332909942e-01f);
  p = fmaf(p, e, -4.999985099e-01f);
  p = fmaf(p, e, 1.000000000e+00f);
  return p * e;
}

// The link of glm_common.cuh with its kind fixed at compile time, so that
// the row loop has no branch and the elements of a lane interleave.  The
// logistic takes q = 1 / (1 + e) once, sigmoid(z) as q or e q, and
// log1p(e) from log1p_01: within a few ulps of link's, branch-free.
template <int KIND, bool LL>
__device__ __forceinline__ void tile_link(float z, float y, float& r,
                                          float& ll) {
  if (KIND == kLogistic) {
    const float e = expf(-fabsf(z));
    const float u = 1.f + e;
    const float q = rcp_1_2(u);
    r = y - (z >= 0.f ? q : e * q);
    if (LL) ll = z * y - (fmaxf(z, 0.f) + log1p_01(e));
  } else if (KIND == kLinear) {
    r = y - z;
    if (LL) ll = -0.5f * r * r;
  } else if (KIND == kPoisson) {
    const float e = expf(z);
    r = y - e;
    if (LL) ll = y * z - e;
  } else {
    link(kProbit, z, y, LL, r, ll);
  }
}

// One group of 8 rows (r0 .. r0 + 7) of a staged tile of nt rows for the
// warp's 16 chains; see chain_tile_rows.
template <int D, bool LL, int KIND, bool FULL>
__device__ __forceinline__ void row_group(
    const Rows& t, int nt, int r0, const uint32_t (&ah)[D / 8][4],
    const uint32_t (&al)[D / 8][4], float (&gb)[D / 8][4],
    float (&gs)[D / 8][4], double (&ll)[2]) {
  constexpr int S = tile_stride(D);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  // 1. Z = Theta X^T + o: B(k, n) = x(row r0 + n, col k)
  const float2 o2 = *reinterpret_cast<const float2*>(t.o + r0 + 2 * q);
  float zb[4] = {o2.x, o2.y, o2.x, o2.y};
  float zs[4] = {0.f, 0.f, 0.f, 0.f};
  const float* xh = t.xh + (r0 + g) * S;
  const float* xl = t.xl + (r0 + g) * S;
#pragma unroll
  for (int kb = 0; kb < D / 8; ++kb) {
    const uint32_t bh0 = __float_as_uint(xh[8 * kb + q]);
    const uint32_t bh1 = __float_as_uint(xh[8 * kb + q + 4]);
    const uint32_t bl0 = __float_as_uint(xl[8 * kb + q]);
    const uint32_t bl1 = __float_as_uint(xl[8 * kb + q + 4]);
    mma_tf32(zs, al[kb], bh0, bh1);
    mma_tf32(zs, ah[kb], bl0, bl1);
    mma_tf32(zb, ah[kb], bh0, bh1);
  }
  // 2. the link on Z in registers: element e is (chain g + 8 (e >> 1),
  // row r0 + 2q + (e & 1))
  const float2 y2 = *reinterpret_cast<const float2*>(t.y + r0 + 2 * q);
  const float2 w2 = *reinterpret_cast<const float2*>(t.w + r0 + 2 * q);
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool odd = e & 1;
    const bool valid = FULL || r0 + 2 * q + (int)odd < nt;
    const float yn = odd ? y2.y : y2.x, wn = odd ? w2.y : w2.x;
    float rr, l = 0.f;
    tile_link<KIND, LL>(zb[e] + zs[e], yn, rr, l);
    r[e] = valid ? rr * wn : 0.f;
    if (LL && valid) ll[e >> 1] += (double)(wn * l);
  }
  // 3. G += R X with k = q <-> row 2q and k = q + 4 <-> row 2q + 1: the A
  // fragment is (r[0], r[2], r[1], r[3])
  uint32_t rh[4], rl[4];
  split_tf32(r[0], rh[0], rl[0]);
  split_tf32(r[2], rh[1], rl[1]);
  split_tf32(r[1], rh[2], rl[2]);
  split_tf32(r[3], rh[3], rl[3]);
  const float* x0h = t.xh + (r0 + 2 * q) * S;
  const float* x0l = t.xl + (r0 + 2 * q) * S;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const uint32_t bh0 = __float_as_uint(x0h[8 * nb + g]);
    const uint32_t bh1 = __float_as_uint(x0h[S + 8 * nb + g]);
    const uint32_t bl0 = __float_as_uint(x0l[8 * nb + g]);
    const uint32_t bl1 = __float_as_uint(x0l[S + 8 * nb + g]);
    mma_tf32(gs[nb], rl, bh0, bh1);
    mma_tf32(gs[nb], rh, bl0, bl1);
    mma_tf32(gb[nb], rh, bh0, bh1);
  }
}

template <int D, bool LL, int KIND>
__device__ __forceinline__ void tile_rows(const Rows& t, int nt, int rg0, int step,
                          const uint32_t (&ah)[D / 8][4],
                          const uint32_t (&al)[D / 8][4],
                          float (&gb)[D / 8][4], float (&gs)[D / 8][4],
                          double (&ll)[2]) {
  const int full = nt >> 3, groups = (nt + 7) >> 3;
  int rg = rg0;
  // two independent full groups per step: their loads, products and links
  // interleave, which hides the latency one group alone leaves exposed
  for (; rg + step < full; rg += 2 * step) {
    row_group<D, LL, KIND, true>(t, nt, 8 * rg, ah, al, gb, gs, ll);
    row_group<D, LL, KIND, true>(t, nt, 8 * (rg + step), ah, al, gb, gs,
                                 ll);
  }
  for (; rg < groups; rg += step) {
    if (rg < full)
      row_group<D, LL, KIND, true>(t, nt, 8 * rg, ah, al, gb, gs, ll);
    else  // the ragged last group: rows past nt masked
      row_group<D, LL, KIND, false>(t, nt, 8 * rg, ah, al, gb, gs, ll);
  }
}

// The chain-tile gradient over the row groups rg0, rg0 + step, ... of a
// staged tile of nt rows.  Accumulates G (16 chains x D) as a large part gb
// and a small part gs (their sum is G): lane 4g + q holds, for n-block nb,
// G(g, 8nb + 2q), G(g, 8nb + 2q + 1), G(g + 8, 8nb + 2q), G(g + 8, 8nb +
// 2q + 1).  With LL, ll[0] and ll[1] gather the lane's terms w ll of chains
// g and g + 8 in double.
template <int D, bool LL>
__device__ __forceinline__ void chain_tile_rows(
    int kind, const Rows& t, int nt, int rg0, int step,
    const uint32_t (&ah)[D / 8][4], const uint32_t (&al)[D / 8][4],
    float (&gb)[D / 8][4], float (&gs)[D / 8][4], double (&ll)[2]) {
  switch (kind) {
    case kLogistic:
      tile_rows<D, LL, kLogistic>(t, nt, rg0, step, ah, al, gb, gs, ll);
      break;
    case kLinear:
      tile_rows<D, LL, kLinear>(t, nt, rg0, step, ah, al, gb, gs, ll);
      break;
    case kPoisson:
      tile_rows<D, LL, kPoisson>(t, nt, rg0, step, ah, al, gb, gs, ll);
      break;
    default:
      tile_rows<D, LL, kProbit>(t, nt, rg0, step, ah, al, gb, gs, ll);
      break;
  }
}

// Sum a double over the four lanes of a quad (lanes 4g .. 4g + 3), in one
// fixed order: every lane of the quad gets the same bits.
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// ---- the tile gradient of 16 chains, shared by the tile kernels ----------

constexpr int kTrajWarps = 16;                 // warps split a tile's rows
constexpr int kTrajThreads = 32 * kTrajWarps;
constexpr int kTrajStreamMax = 512;            // rows per streamed tile

// Shared memory of a kernel that runs traj_grad, in this order: per-warp ll
// partials (kTrajWarps x 16 doubles), per-warp gradient partials
// (kTrajWarps x 16 x D floats), the tile's theta (16 x D), `extra` bytes of
// the kernel's own (a multiple of 8), then the rows: all of them
// (resident), or two raw cp.async buffers and one staged tile.
struct TrajPlan {
  int rows;       // rows staged: round8(N) when resident, else the tile
  bool resident;
  size_t smem;    // bytes
};

TrajPlan traj_plan(int D, int N, size_t extra = 0) {
  const size_t fixed = sizeof(double) * kTrajWarps * kTileChains +
                       sizeof(float) * (kTrajWarps + 1) * kTileChains * D +
                       extra;
  const size_t row = sizeof(float) * tile_row_floats(D);
  const size_t n8 = ((size_t)N + 7) & ~(size_t)7;
  if (fixed + n8 * row <= (size_t)kTileSmemCap)
    return {(int)n8, true, fixed + n8 * row};
  const size_t per = row + 2 * sizeof(float) * raw_row_floats(D);
  int R = (int)((kTileSmemCap - fixed) / per) & ~7;
  if (R > kTrajStreamMax) R = kTrajStreamMax;
  return {R, false, fixed + R * per};
}

// One gradient of the block's 16 chains at the theta in sth: the warps
// split the row groups, each leaves its partial G in part and, with
// want_ll, its ll partials in pll.  Starts and ends on a barrier.
template <int D>
__device__ __forceinline__ void traj_grad(const Glm& p, const Rows& t,
                                          float* raw, const float* sth,
                                          float* part, double* pll,
                                          bool want_ll) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  __syncthreads();  // theta (and resident rows) written
  uint32_t ah[D / 8][4], al[D / 8][4];
  theta_frags<D>(sth + g * D, sth + (g + 8) * D, D, ah, al);
  float gb[D / 8][4], gs[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) gb[nb][e] = gs[nb][e] = 0.f;
  double ll[2] = {0.0, 0.0};
  // resident: one pass over all rows (p.tile >= N); else tile by tile
  if (!p.resident) stream_begin<D>(p, raw, p.tile, 0, p.N);
  for (int t0 = 0, buf = 0; t0 < p.N; t0 += p.tile, buf ^= 1) {
    const int nt =
        p.resident ? p.N : stream_next<D>(p, raw, t, p.tile, t0, p.N, buf);
    if (want_ll)
      chain_tile_rows<D, true>(p.kind, t, nt, warp, kTrajWarps, ah, al, gb,
                               gs, ll);
    else
      chain_tile_rows<D, false>(p.kind, t, nt, warp, kTrajWarps, ah, al, gb,
                                gs, ll);
  }
  float* pw = part + warp * kTileChains * D;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int j = 8 * nb + 2 * q;
    pw[g * D + j] = gb[nb][0] + gs[nb][0];
    pw[g * D + j + 1] = gb[nb][1] + gs[nb][1];
    pw[(g + 8) * D + j] = gb[nb][2] + gs[nb][2];
    pw[(g + 8) * D + j + 1] = gb[nb][3] + gs[nb][3];
  }
  if (want_ll) {
    const double a = quad_sum(ll[0]), b = quad_sum(ll[1]);
    if (q == 0) {
      pll[warp * kTileChains + g] = a;
      pll[warp * kTileChains + g + 8] = b;
    }
  }
  __syncthreads();
}

// ---- per-chain values in a tile kernel ------------------------------------
// Thread e < 16 D owns coordinate e % D of chain e / D.  D is 8, 16 or 32,
// so the D lanes of a chain are contiguous lanes of one warp, and the
// owning threads are whole warps.

// Sum of v over the D lanes of one chain: every lane gets the same bits
// (each step adds the same two values in either order).  Every lane of the
// warp must call it.
template <int D>
__device__ __forceinline__ float chain_sum(float v) {
#pragma unroll
  for (int o = D / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The prior's gradient term of the lane's coordinate oj of its chain, whose
// coordinate there is th: lam th, or with a (d, d) matrix A (the dense fold,
// p.lamm) (theta A)_oj = sum_k theta_k A[k, oj], theta_k taken from lane k
// of the chain by shuffle and A read through the read-only path (at most
// 4 KB: it stays in L1, so the plans keep their shared memory).  The prior
// term of lp is then chain_sum(th * prior_grad), the same bits in all the
// chain's lanes.  0 past d.  Every lane of the warp must call it.
template <int D>
__device__ __forceinline__ float prior_grad(const Glm& p, float lam, float th,
                                            int oj) {
  if (!p.lamm) return lam * th;
  float pg = 0.f;
  for (int k = 0; k < p.d; ++k) {
    const float tk = __shfl_sync(0xffffffffu, th, k, D);
    if (oj < p.d) pg = fmaf(tk, __ldg(p.lamm + k * p.d + oj), pg);
  }
  return pg;
}

// Philox draws of (chain c, transition t), shared by the multistep HMC
// kernels 3 and 3b (glm_hmc.cu) and the multistep NUTS kernel
// (glm_nuts.cu): the momenta take draws 0 .. D/2 - 1, the MH or slice
// uniform draw kSliceDraw.
// ops/glm_kernels.py glm_multistep_draws replays them on the host.
constexpr uint32_t kSliceDraw = 0xFFFFFFFFu;

// Coordinate j of the momentum: two normals per Philox draw, counter
// (c, t, j / 2, 0), Box-Muller on (x, y) for even j and (z, w) for odd j.
__device__ __forceinline__ float momentum(uint2 key, int c, int t, int j) {
  const uint4 b = philox(
      make_uint4((uint32_t)c, (uint32_t)t, (uint32_t)(j / 2), 0u), key);
  return (j & 1) ? box_muller(b.z, b.w) : box_muller(b.x, b.y);
}

// log u of the uniform u = 1 - U[0, 1), counter (c, t, kSliceDraw, 0).
__device__ __forceinline__ float log_uniform(uint2 key, int c, int t) {
  return logf(1.f - u01(philox(make_uint4((uint32_t)c, (uint32_t)t,
                                          kSliceDraw, 0u), key).x));
}

}  // namespace

#define TILE_DISPATCH(D_, CALL)                        \
  switch (D_) {                                        \
    case 8: CALL(8); break;                            \
    case 16: CALL(16); break;                          \
    case 32: CALL(32); break;                          \
    default: return (int)cudaErrorInvalidValue;        \
  }
