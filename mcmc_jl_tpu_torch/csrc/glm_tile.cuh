// The chain-tile GLM gradient on the tensor cores, shared by the four HMC
// kernels (glm_hmc.cu: trajectory, step, multistep and the Halton
// multistep rows), the N-tiled kernel
// (glm_bign.cu partial_tile_kernel) and the two NUTS kernels (glm_nuts.cu
// nuts_tile_kernel; above d 32 nuts_wide_kernel on the wide tile, above d
// 256 nuts_xwide_kernel on the very-wide tile).
// traj_grad is one gradient of a tile's 16 chains with the rows split over
// 16 warps: the HMC kernels take one per drift, the NUTS kernels one per
// leaf.  After it come the per-chain helpers of those
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
// a = a_hi + a_lo with both parts rounded to the nearest TF32, and a
// product is a_hi b_hi + a_hi b_lo + a_lo b_hi with float32 accumulators;
// the dropped a_lo b_lo is at most 2^-22 of the product and of either
// sign, below float32 rounding of the sums.  (Truncated parts would drop
// terms of the product's own sign: every product shrinks by about 2^-21,
// a bias that exp() of a Poisson link turns into gradient errors several
// times float32's.)  The small terms accumulate apart from the large one
// (two accumulators), which also halves the dependent chain of mma
// latencies.
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
// lambdas, no calls, but for the very-wide tile's xwide_grad and the
// chunked tier's xchunk_grad): a routine
// left out of line would take the staged rows through generic pointers
// and the fragments through local memory.
//
// That layout holds for d <= 32 (the narrow tile, D = 8, 16 or 32, a
// template parameter).  Above 32 the wide tile takes d up to kWideMax with
// D, d padded to a multiple of 32, a run-time value: one instantiation
// serves every width.  Above kWideMax the very-wide tile near the end of
// this file takes the HMC and N-tiled kernels up to kXWideMax, the chain
// state in device memory; above kXWideMax the chunked tier at the end takes
// them up to kXChunkDMax, walking d in column chunks.
#pragma once

#include "glm_common.cuh"

namespace {

constexpr int kTileChains = 16;        // chains of one warp's m16 tile
// dynamic shared memory a tile kernel plans for (the card allows 227 KB)
constexpr int kTileSmemCap = 220 * 1024;

constexpr int kNarrowMax = 32;   // the narrow tile: D = 8, 16, 32
constexpr int kWideMax = 256;    // the wide tile: D = 64, 96, ..., 256
constexpr int kXWideMax = 1024;  // the very-wide tile: D = 288, ..., 1024

// Parameter bound of the tile kernels: d padded to 8, 16 or 32 (the narrow
// tile), above 32 to a multiple of 32 up to kWideMax (the wide tile); 0
// where no tile takes d.
int tile_bound_for(int d) {
  return d < 1 ? 0 : d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32
         : d <= kWideMax ? (d + 31) & ~31 : 0;
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
  float* xl;  // (cap, D + 4): TF32 low part, x - hi rounded to TF32
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

// x rounded to the nearest TF32 (its 10 leading mantissa bits), ties away
// from zero, as cvt.rna.tf32.f32 rounds: add half of the dropped bits'
// weight to the magnitude and clear them.  Two integer operations: on an
// H100, cvt.rna.tf32 made the very-wide kernels 18% slower and a guard
// that keeps infinities 35% (a non-finite x gives a NaN product either
// way).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + e with |e| <= 2^-22 |x| of either sign: hi is x rounded to
// TF32, lo the exact remainder x - hi rounded the same way (left unrounded,
// the tensor cores would truncate it: an error twice as large, which the
// narrow tile's Poisson gradients show).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
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

// c += a b in 3xTF32 through a zeroed accumulator: the three products
// (small ones first) summed on the tensor cores, then added to c by one
// float32 addition a element, which rounds to nearest.  The tensor cores
// round their sums toward zero, so a long chain of mma into one
// accumulator loses about half an ulp of the running sum a step, all of
// one sign; here each step loses that only on its own terms.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float t[4];
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh0), "r"(bh1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
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

// cp_async4, or with `valid` false four zero bytes written in its place
// (src-size 0: nothing is read from src)
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
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

// The link on a row group's Z in registers (element e: chain g + 8 (e >> 1),
// row r0 + 2q + (e & 1)) with its y and w at yr, wr (the group's rows):
// R = w resid, zero past nt, and with LL the w ll terms of chains g and
// g + 8 into ll.
template <int KIND, bool LL, bool FULL>
__device__ __forceinline__ void group_link(const float (&z)[4],
                                           const float* yr, const float* wr,
                                           int nt, int r0, float (&r)[4],
                                           double (&ll)[2]) {
  const int q = threadIdx.x & 3;
  const float2 y2 = *reinterpret_cast<const float2*>(yr + r0 + 2 * q);
  const float2 w2 = *reinterpret_cast<const float2*>(wr + r0 + 2 * q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool odd = e & 1;
    const bool valid = FULL || r0 + 2 * q + (int)odd < nt;
    const float yn = odd ? y2.y : y2.x, wn = odd ? w2.y : w2.x;
    float rr, l = 0.f;
    tile_link<KIND, LL>(z[e], yn, rr, l);
    r[e] = valid ? rr * wn : 0.f;
    if (LL && valid) ll[e >> 1] += (double)(wn * l);
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
  // 2. the link on Z in registers
  const float z[4] = {zb[0] + zs[0], zb[1] + zs[1], zb[2] + zs[2],
                      zb[3] + zs[3]};
  float r[4];
  group_link<KIND, LL, FULL>(z, t.y, t.w, nt, r0, r, ll);
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

// The warp's ll partials of its 16 chains into pll[warp][16] (lane 4g holds
// chains g and g + 8 after the quad sum); every lane calls it.
__device__ __forceinline__ void put_ll(double* pll, const double (&ll)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const double a = quad_sum(ll[0]), b = quad_sum(ll[1]);
  if ((lane & 3) == 0) {
    pll[warp * kTileChains + (lane >> 2)] = a;
    pll[warp * kTileChains + (lane >> 2) + 8] = b;
  }
}

// Chain c's log-likelihood from the nw warps' partials, in warp order.
__device__ __forceinline__ double sum_ll(const double* pll, int c, int nw) {
  double ll = 0.0;
  for (int k = 0; k < nw; ++k) ll += pll[k * kTileChains + c];
  return ll;
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
  int rows;       // rows staged: round8(N) when resident, else the tile;
                  // 0 when not even 8 rows fit (a launch then refuses)
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
  if (fixed + 8 * per > (size_t)kTileSmemCap) return {0, false, 0};
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
  if (want_ll) put_ll(pll, ll);
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

// ---- the wide tile: 32 < d <= kWideMax -------------------------------------
// Above 32 parameters the narrow layout breaks in four places: theta's
// fragments and G's accumulators in registers (2 D a lane: 512 at D 256),
// the 16 warps' gradient partials in shared memory (16 x 16 x D floats: 256
// KB at D 256), the rows (2 KB each at D 256) and the ownership of one
// coordinate a thread.  The wide tile keeps the block (16 warps, 512
// threads, a tile of 16 chains, persistent blocks walking the tiles) and
// changes all four:
//
// - Ownership: warp c holds chain c of the tile, lane l its coordinates
//   l, l + 32, ..., l + D - 32 (D / 32 <= kWideRegs registers an array).
//   wide_chain_sum adds a lane's registers in order, then the full-warp
//   butterfly: every lane gets the same bits.
// - Stage 1, Z = Theta X^T + o and the link: the warps split the row groups
//   of a tile as traj_grad does; theta's A fragments come by k-block from
//   the tile's shared copy, split once into hi and lo and stored in
//   fragment order (one 16-byte load a lane for each of hi and lo), so
//   nothing of width D lives in registers.  Each group's R (16 x 8) goes to
//   shared memory (rbuf), its ll to the warp's double registers.
// - Stage 2, G += R X: the warps split the columns of G, not the rows: warp
//   w takes n-blocks w / S + (16 / S) i of D / 8 (at most kWideUnits, with
//   gb and gs in registers: 8 a unit) over the row groups rg = w % S + S k.
//   S (1, 2 or 4: wide_split) row splits balance the n-blocks over the 16
//   warps where D / 8 is not a multiple of 16 (D 64, 96, 160, 192; D 224
//   keeps 28 n-blocks over 16 warps, 7/8 of the work of the busiest).
//   The partials then number S x 16 x D floats, not 16 x 16 x D, and are
//   summed by the coordinate's owner in split order: the same bits on
//   every launch, with no atomics.  The cost against splitting the rows
//   (as the narrow tile does): one barrier and a 16 x 8 round trip of R
//   through shared memory per row group; the gain is registers and shared
//   memory that do not grow with D.  The other way, the rows split over
//   the warps and G's n-blocks taken in chunks that fit in registers,
//   either keeps each warp's whole 16 x D partial somewhere (16 x 16 x D
//   floats of shared memory again) or recomputes Z and the link once a
//   chunk (D / chunk times the first product).
// - Rows: stored as plain float32, row-major with stride D + 4, and split
//   into TF32 hi and lo where a fragment is loaded (three operations an
//   element): half the shared memory of the narrow tile's split copy, so a
//   streamed tile holds 120 rows at D 160 and 72 at D 256.  cp.async writes
//   them straight into one of two buffers: a warp copies a block of 8 rows
//   x 4 columns, whose reads are four full 32-byte sectors of XT and whose
//   writes hit 32 distinct banks (4 i + j for stride D + 4).  Row-major
//   with stride D + 4 the fragment loads are conflict-free too: stage 1
//   reads x(r0 + g, 8 kb + q), bank 4 g + q; stage 2 x(r0 + 2 q (+1),
//   8 nb + g), bank 8 q + g (+4).  Rows never copied are zero (the
//   buffers are zeroed once a launch, so columns past d are exact zeros);
//   the rows past a ragged tile's end hold finite values of an earlier
//   tile, and their residual is masked to zero in registers.
//
// Each streamed tile costs three barriers (copy landed, stage 1 done,
// compute done before its buffer is refilled).
constexpr int kWideRegs = kWideMax / 32;  // coordinates a lane holds
constexpr int kWideUnits = 4;             // stage-2 n-blocks a warp holds

// Stage 2's split of the n-blocks: S row splits and nbw = ceil(NB S / 16)
// n-blocks a warp, S in {1, 2, 4} the one that balances the n-blocks best
// with nbw <= kWideUnits (the smallest such S on a tie).
struct WideSplit {
  int S, nbw;
};

__host__ __device__ inline int wide_width(int d) { return (d + 31) & ~31; }

__host__ __device__ inline WideSplit wide_split(int D) {
  const int NB = D / 8;
  WideSplit best{1, (NB + 15) / 16};
  for (int S = 2; S <= 4; S *= 2) {
    const int nbw = (NB * S + 15) / 16;
    if (nbw > kWideUnits) break;
    // balance NB S / (16 nbw): strictly better than best's
    if (S * best.nbw > best.S * nbw) best = WideSplit{S, nbw};
  }
  return best;
}

// floats of one buffered row: x (stride D + 4), then y, w, o
__host__ __device__ constexpr int wide_row_floats(int D) { return D + 7; }
// rbuf's row stride (one row a chain): 8 mod 32, so that the float2 loads
// of a half-warp (8 g + 2 q) hit distinct banks
__host__ __device__ inline int wide_rstride(int R) { return ((R + 31) & ~31) + 8; }
// gpart's row stride (one row a split and chain): 8 mod 32, as rbuf's
__host__ __device__ constexpr int wide_gstride(int D) { return D + 8; }

// Shared memory of a wide-tile kernel, in this order: the warps' ll
// partials (kTrajWarps x 16 doubles), theta's A fragments hi and lo (16 D
// floats each), the stage-2 partials gpart (S x 16 x (D + 8)), rbuf (16 x
// RS), then one buffer of all rows (resident) or two of R rows (streamed).
size_t wide_smem(int D, int R, int nbuf) {
  const WideSplit ws = wide_split(D);
  return sizeof(double) * kTrajWarps * kTileChains +
         sizeof(float) * ((size_t)2 * kTileChains * D +
                          (size_t)ws.S * kTileChains * wide_gstride(D) +
                          (size_t)kTileChains * wide_rstride(R) +
                          (size_t)nbuf * R * wide_row_floats(D));
}

// The plan of a wide-tile kernel at (D, N): all rows resident when they fit
// (and `resident` allows), else the largest streamed tile (a multiple of 8,
// at most kTrajStreamMax rows).  rows = 0 when not even 8 rows fit.
TrajPlan wide_plan(int D, int N, bool resident = true) {
  const int n8 = (N + 7) & ~7;
  if (resident && wide_smem(D, n8, 1) <= (size_t)kTileSmemCap)
    return {n8, true, wide_smem(D, n8, 1)};
  int R = kTrajStreamMax;
  while (R >= 8 && wide_smem(D, R, 2) > (size_t)kTileSmemCap) R -= 8;
  if (R < 8) return {0, false, 0};
  return {R, false, wide_smem(D, R, 2)};
}

// The block's view of that shared memory.
struct Wide {
  int D, S, R, RS;       // width, stage-2 split, rows a buffer, rbuf stride
  double* pll;           // (kTrajWarps, 16)
  float* thf;            // hi (16 D) then lo (16 D), fragment order
  float* gpart;          // (S, 16, D + 8)
  float* rbuf;           // (16, RS): R of the tile in flight
  float* buf;            // one or two buffers of R rows
};

__device__ __forceinline__ Wide wide_at(const Glm& p) {
  extern __shared__ double tile_sm[];
  Wide w;
  w.D = wide_width(p.d);
  w.S = wide_split(w.D).S;
  w.R = p.tile;
  w.RS = wide_rstride(p.tile);
  w.pll = tile_sm;
  w.thf = reinterpret_cast<float*>(w.pll + kTrajWarps * kTileChains);
  w.gpart = w.thf + 2 * kTileChains * w.D;
  w.rbuf = w.gpart + w.S * kTileChains * wide_gstride(w.D);
  w.buf = w.rbuf + kTileChains * w.RS;
  return w;
}

__device__ __forceinline__ float* wide_buffer(const Wide& w, int b) {
  return w.buf + (size_t)b * w.R * wide_row_floats(w.D);
}

// Start copying rows [n0, n0 + nt) into buffer dst of R rows at width D
// (the wide and the very-wide tile's layout): warp w takes the column
// blocks w, w + 16, ... of 4 columns, 8 rows a copy.
__device__ __forceinline__ void wide_issue(const Glm& p, int D, int R,
                                           float* dst, int n0, int nt) {
  const int XS = D + 4, lane = threadIdx.x & 31;
  float* yb = dst + R * XS;
  for (int j = 4 * (threadIdx.x >> 5) + (lane >> 3); j < (p.d + 3) / 4 * 4;
       j += 4 * (blockDim.x >> 5)) {
    if (j >= p.d) continue;
    const float* src = p.xt + (size_t)j * p.N + n0;
    for (int i = lane & 7; i < nt; i += 8) cp_async4(dst + i * XS + j, src + i);
  }
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    cp_async4(yb + i, p.y + n0 + i);
    if (p.w) cp_async4(yb + R + i, p.w + n0 + i);
    if (p.o) cp_async4(yb + 2 * R + i, p.o + n0 + i);
  }
}

__device__ __forceinline__ void wide_issue(const Glm& p, const Wide& w,
                                           float* dst, int n0, int nt) {
  wide_issue(p, w.D, w.R, dst, n0, nt);
}

// Zero the buffers (w = 1 without weights), then, resident, stage all rows.
// Every thread calls it, once a launch; ends on a barrier.
__device__ __forceinline__ void wide_init(const Glm& p, const Wide& w) {
  const int per = w.R * wide_row_floats(w.D), wat = w.R * (w.D + 5);
  const int n = (p.resident ? 1 : 2) * per;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k = e % per;
    w.buf[e] = (!p.w && k >= wat && k < wat + w.R) ? 1.f : 0.f;
  }
  __syncthreads();
  if (p.resident) {
    wide_issue(p, w, w.buf, 0, p.N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
}

// Streaming rows [n0, n1) in tiles of R rows, as stream_begin/stream_next:
//   wide_begin(p, w, n0, n1);
//   for (int t0 = n0, b = 0; t0 < n1; t0 += w.R, b ^= 1) {
//     const int nt = wide_next(p, w, t0, n1, b);
//     ... compute on wide_buffer(w, b), nt rows ...
//   }
__device__ __forceinline__ void wide_begin(const Glm& p, const Wide& w, int n0,
                                           int n1) {
  wide_issue(p, w, w.buf, n0, min(w.R, n1 - n0));
  cp_async_commit();
}

// Starts on a barrier (every warp is done with the other buffer and with
// rbuf), starts copying the next tile into the other buffer, and waits for
// this one: returns its row count.
__device__ __forceinline__ int wide_next(const Glm& p, const Wide& w, int t0,
                                         int n1, int b) {
  const int nt = min(w.R, n1 - t0), t1 = t0 + w.R;
  __syncthreads();
  if (t1 < n1) {
    wide_issue(p, w, wide_buffer(w, b ^ 1), t1, min(w.R, n1 - t1));
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return nt;
}

// Write chain c's theta (lane l's coordinates l + 32 i) into the tile's A
// fragments: column j of chain c is element 2 (j % 8 / 4) + c / 8 of lane
// 4 (c % 8) + j % 4 in k-block j / 8.  Coordinates past d must be 0.
__device__ __forceinline__ void wide_put_theta(const Wide& w, int c,
                                               const float (&th)[kWideRegs]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) {
    if (32 * i >= w.D) break;
    const int j = lane + 32 * i, k = j & 7;
    const int at = 4 * (32 * (j >> 3) + 4 * (c & 7) + (k & 3)) +
                   2 * (k >> 2) + (c >> 3);
    uint32_t hi, lo;
    split_tf32(th[i], hi, lo);
    w.thf[at] = __uint_as_float(hi);
    w.thf[kTileChains * w.D + at] = __uint_as_float(lo);
  }
}

// One k-block of Z += Theta X^T: theta's A fragments (hi h, lo l) and x's
// columns 8 kb + q, + 4 of the row at xr, into the pair (zb, zs).
__device__ __forceinline__ void wide_kblock(const float4& h, const float4& l,
                                            const float* xr, float (&zb)[4],
                                            float (&zs)[4]) {
  const uint32_t ah[4] = {__float_as_uint(h.x), __float_as_uint(h.y),
                          __float_as_uint(h.z), __float_as_uint(h.w)};
  const uint32_t al[4] = {__float_as_uint(l.x), __float_as_uint(l.y),
                          __float_as_uint(l.z), __float_as_uint(l.w)};
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(xr[0], bh0, bl0);
  split_tf32(xr[4], bh1, bl1);
  mma_tf32(zs, al, bh0, bh1);
  mma_tf32(zs, ah, bl0, bl1);
  mma_tf32(zb, ah, bh0, bh1);
}

// Stage 1 on one group of 8 rows (r0 .. r0 + 7) of buffer xb holding nt
// rows: Z of the tile's 16 chains, the link, R into rbuf and, with LL, the
// lane's w ll terms of chains g and g + 8 into ll (as row_group).  The
// k-blocks go in pairs into two accumulator pairs (D / 8 is a multiple of
// 4), so that two chains of dependent products overlap.
template <int KIND, bool LL, bool FULL>
__device__ __forceinline__ void wide_z(const Wide& w, const float* xb, int nt,
                                       int r0, double (&ll)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int XS = w.D + 4;
  const float* yb = xb + w.R * XS;
  const float2 o2 = *reinterpret_cast<const float2*>(yb + 2 * w.R + r0 + 2 * q);
  float zb[4] = {o2.x, o2.y, o2.x, o2.y};
  float zs[4] = {0.f, 0.f, 0.f, 0.f};
  float zb1[4] = {0.f, 0.f, 0.f, 0.f}, zs1[4] = {0.f, 0.f, 0.f, 0.f};
  const float* xr = xb + (r0 + g) * XS + q;
  const float4* fh = reinterpret_cast<const float4*>(w.thf) + lane;
  const float4* fl = fh + 4 * w.D;
#pragma unroll 2
  for (int kb = 0; kb < w.D / 8; kb += 2) {
    wide_kblock(fh[32 * kb], fl[32 * kb], xr + 8 * kb, zb, zs);
    wide_kblock(fh[32 * kb + 32], fl[32 * kb + 32], xr + 8 * kb + 8, zb1,
                zs1);
  }
  const float z[4] = {(zb[0] + zb1[0]) + (zs[0] + zs1[0]),
                      (zb[1] + zb1[1]) + (zs[1] + zs1[1]),
                      (zb[2] + zb1[2]) + (zs[2] + zs1[2]),
                      (zb[3] + zb1[3]) + (zs[3] + zs1[3])};
  float r[4];
  group_link<KIND, LL, FULL>(z, yb, yb + w.R, nt, r0, r, ll);
  float* rp = w.rbuf + g * w.RS + r0 + 2 * q;
  *reinterpret_cast<float2*>(rp) = make_float2(r[0], r[1]);
  *reinterpret_cast<float2*>(rp + 8 * w.RS) = make_float2(r[2], r[3]);
}

template <int KIND, bool LL>
__device__ __forceinline__ void wide_stage1_k(const Wide& w, const float* xb,
                                              int nt, double (&ll)[2]) {
  const int full = nt >> 3, groups = (nt + 7) >> 3;
  for (int rg = threadIdx.x >> 5; rg < groups; rg += kTrajWarps) {
    if (rg < full)
      wide_z<KIND, LL, true>(w, xb, nt, 8 * rg, ll);
    else  // the ragged last group: rows past nt masked
      wide_z<KIND, LL, false>(w, xb, nt, 8 * rg, ll);
  }
}

// Stage 1 of a tile: the warps split its row groups.
template <bool LL>
__device__ __forceinline__ void wide_stage1(int kind, const Wide& w,
                                            const float* xb, int nt,
                                            double (&ll)[2]) {
  switch (kind) {
    case kLogistic: wide_stage1_k<kLogistic, LL>(w, xb, nt, ll); break;
    case kLinear: wide_stage1_k<kLinear, LL>(w, xb, nt, ll); break;
    case kPoisson: wide_stage1_k<kPoisson, LL>(w, xb, nt, ll); break;
    default: wide_stage1_k<kProbit, LL>(w, xb, nt, ll); break;
  }
}

// Stage 2 of a tile (after stage 1's barrier): G += R X for the warp's
// n-blocks over its row split's groups.  The A fragment reads row 2q as
// k = q and row 2q + 1 as k = q + 4, as row_group's third step does; gb
// and gs hold unit i's G(g, 8 nb + 2q (+1)), G(g + 8, 8 nb + 2q (+1)).
__device__ __forceinline__ void wide_stage2(const Wide& w, const float* xb,
                                            int nt,
                                            float (&gb)[kWideUnits][4],
                                            float (&gs)[kWideUnits][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nb0 = warp / w.S, step = kTrajWarps / w.S, NB = w.D / 8;
  const int XS = w.D + 4, groups = (nt + 7) >> 3;
#pragma unroll 2
  for (int rg = warp % w.S; rg < groups; rg += w.S) {
    const int r0 = 8 * rg;
    const float2 a = *reinterpret_cast<const float2*>(w.rbuf + g * w.RS + r0 +
                                                      2 * q);
    const float2 b = *reinterpret_cast<const float2*>(
        w.rbuf + (g + 8) * w.RS + r0 + 2 * q);
    uint32_t rh[4], rl[4];
    split_tf32(a.x, rh[0], rl[0]);
    split_tf32(b.x, rh[1], rl[1]);
    split_tf32(a.y, rh[2], rl[2]);
    split_tf32(b.y, rh[3], rl[3]);
    const float* x0 = xb + (r0 + 2 * q) * XS + g;
#pragma unroll
    for (int i = 0; i < kWideUnits; ++i) {
      const int nb = nb0 + step * i;
      if (nb < NB) {  // unit warp + 16 i < S NB
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x0[8 * nb], bh0, bl0);
        split_tf32(x0[XS + 8 * nb], bh1, bl1);
        mma_tf32(gs[i], rl, bh0, bh1);
        mma_tf32(gs[i], rh, bl0, bl1);
        mma_tf32(gb[i], rh, bh0, bh1);
      }
    }
  }
}

__device__ __forceinline__ void wide_zero(float (&gb)[kWideUnits][4],
                                          float (&gs)[kWideUnits][4]) {
#pragma unroll
  for (int i = 0; i < kWideUnits; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) gb[i][e] = gs[i][e] = 0.f;
}

// Put the warp's stage-2 sums into its row split's slice of gpart and zero
// them; ends on a barrier, after which wide_gsum reads G.
__device__ __forceinline__ void wide_flush(const Wide& w,
                                           float (&gb)[kWideUnits][4],
                                           float (&gs)[kWideUnits][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, GS = wide_gstride(w.D);
  const int nb0 = warp / w.S, step = kTrajWarps / w.S, NB = w.D / 8;
  float* base = w.gpart + ((warp % w.S) * kTileChains + g) * GS + 2 * q;
#pragma unroll
  for (int i = 0; i < kWideUnits; ++i) {
    const int nb = nb0 + step * i;
    if (nb < NB) {
      *reinterpret_cast<float2*>(base + 8 * nb) =
          make_float2(gb[i][0] + gs[i][0], gb[i][1] + gs[i][1]);
      *reinterpret_cast<float2*>(base + 8 * GS + 8 * nb) =
          make_float2(gb[i][2] + gs[i][2], gb[i][3] + gs[i][3]);
    }
  }
  wide_zero(gb, gs);
  __syncthreads();
}

// G(chain c, column j) after wide_flush: the row splits' sums in order.
__device__ __forceinline__ float wide_gsum(const Wide& w, int c, int j) {
  const float* pc = w.gpart + c * wide_gstride(w.D) + j;
  float acc = pc[0];
  for (int s = 1; s < w.S; ++s)
    acc += pc[s * kTileChains * wide_gstride(w.D)];
  return acc;
}

// One pass over all N rows for the block's 16 chains at the theta in thf
// (written before the call): leaves G in gpart (wide_gsum) and, with
// want_ll, the warps' ll partials in pll (sum_ll).  Every thread calls it;
// ends on a barrier.
__device__ __forceinline__ void wide_rows(const Glm& p, const Wide& w,
                                          bool want_ll) {
  float gb[kWideUnits][4], gs[kWideUnits][4];
  wide_zero(gb, gs);
  double ll[2] = {0.0, 0.0};
  if (p.resident)
    __syncthreads();  // theta written
  else
    wide_begin(p, w, 0, p.N);  // wide_next's first barrier: theta written
  for (int t0 = 0, b = 0; t0 < p.N; t0 += w.R, b ^= 1) {
    const int nt = p.resident ? p.N : wide_next(p, w, t0, p.N, b);
    const float* xb = wide_buffer(w, b);
    if (want_ll)
      wide_stage1<true>(p.kind, w, xb, nt, ll);
    else
      wide_stage1<false>(p.kind, w, xb, nt, ll);
    __syncthreads();
    wide_stage2(w, xb, nt, gb, gs);
  }
  if (want_ll) put_ll(w.pll, ll);
  wide_flush(w, gb, gs);
}

// Row `row` of a (rows, d) array into the lane's coordinates (0 past d),
// and back.
__device__ __forceinline__ void wide_load(float (&dst)[kWideRegs],
                                          const float* src, size_t row,
                                          int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) {
    const int j = lane + 32 * i;
    dst[i] = j < d ? src[row * d + j] : 0.f;
  }
}

__device__ __forceinline__ void wide_store(float* dst,
                                           const float (&src)[kWideRegs],
                                           size_t row, int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) {
    const int j = lane + 32 * i;
    if (j < d) dst[row * d + j] = src[i];
  }
}

// Sum of v over a chain's coordinates: the lane's registers in order, then
// the full-warp butterfly (each step adds the same two values in either
// order), so every lane gets the same bits.  Every lane of the warp must
// call it.
__device__ __forceinline__ float wide_chain_sum(const Wide& w,
                                                const float (&v)[kWideRegs]) {
  float s = v[0];
#pragma unroll
  for (int i = 1; i < kWideRegs; ++i)
    if (32 * i < w.D) s += v[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The prior's gradient term of the lane's coordinates (prior_grad on the
// wide ownership): lam th, with lam the (d,) row's or the scalar; with a
// (d, d) matrix A, (theta A)_j = sum_k theta_k A[k, j] in k order, theta_k
// taken from lane k % 32, register k / 32.  A is read through the
// read-only path, row k coalesced over the lanes; at d 256 it is 256 KB
// and no longer stays in L1, so every warp reads it from L2: 4 d^2 bytes
// and 2 d^2 operations a chain and gradient, against the likelihood's
// 4 d N operations (d / 2N of them: 7.5% at d 150, N 1000).  0 past d.
// Every lane of the warp must call it.
__device__ __forceinline__ void wide_prior_grad(const Glm& p, const Wide& w,
                                                const float (&th)[kWideRegs],
                                                float (&pg)[kWideRegs]) {
  const int lane = threadIdx.x & 31;
  if (!p.lamm) {
#pragma unroll
    for (int i = 0; i < kWideRegs; ++i) {
      const int j = lane + 32 * i;
      pg[i] = j < p.d ? (p.lamv ? __ldg(p.lamv + j) : p.lam) * th[i] : 0.f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) pg[i] = 0.f;
#pragma unroll
  for (int kr = 0; kr < kWideRegs; ++kr) {
    if (32 * kr >= p.d) break;
    for (int kl = 0; kl < 32; ++kl) {
      const float tk = __shfl_sync(0xffffffffu, th[kr], kl);
      const int k = 32 * kr + kl;
      if (k >= p.d) break;  // warp-uniform
      const float* ak = p.lamm + (size_t)k * p.d + lane;
#pragma unroll
      for (int i = 0; i < kWideRegs; ++i)
        if (lane + 32 * i < p.d) pg[i] = fmaf(tk, __ldg(ak + 32 * i), pg[i]);
    }
  }
}

// ---- the very-wide tile: kWideMax < d <= kXWideMax --------------------------
// Replaces the same Pallas bodies as the wide tile (pallas_glm.py _kernel,
// _step_kernel, _multistep_kernel; pallas_glm_bign.py _grad_kernel), which
// bound d only by their 100 MiB of VMEM.  Above 256 parameters the wide
// tile breaks in four places: the chain state in registers (theta, m, g
// and the proposal's theta and g, D / 32 registers each: 160 a lane at D
// 1024), theta's split A fragments in shared memory (128 KB at D 1024),
// stage 2's n-blocks (D / 8 = 128 over 16 warps, more than kWideUnits) and
// the rows (4.1 KB each at D 1024, two streamed buffers beside the rest).
// The very-wide tile keeps the block (16 warps, a tile of 16 chains,
// persistent blocks) and changes all four:
//
// - Chain state in device memory: the HMC kernels keep a chain's theta, g,
//   m and the proposal's g in a slot of kXArrays x 16 x D floats a block
//   (the wrapper's scratch), the proposal's theta (the theta of the
//   gradient in flight) in shared memory as plain float32 rows of stride
//   D + 4 (sth: 64 KB at D 1024).  Warp c owns chain c's rows and its lanes
//   stride over the coordinates, so every access is coalesced; the kicks,
//   drifts, the kinetic energy and the MH copies loop over D in passes of
//   32.  At 132 blocks and D 1024 the slots take 34 MB, which L2 holds.
// - Stage 1, Z = Theta X^T + o, split over k: a streamed tile of R rows
//   has R / 8 row groups and the 16 warps take (row group, k-slice) units,
//   KS = 128 / R k-slices of the D / 8 k-blocks; theta's and x's fragments
//   are split into TF32 hi and lo where they are loaded.  Each warp leaves
//   its partial Z (16 x 8) in zbuf; after a barrier warp rg sums its row
//   group's KS partials onto o in slice order, applies the link and writes
//   R to rbuf, its ll into its double registers.
// - Stage 2, G += R X: warp w takes the n-blocks w + 16 i (i < kXUnits: 8
//   at D 1024) over all the tile's row groups, one float32 accumulator a
//   unit (32 registers where a big and a small one would take 64); each
//   row group's three 3xTF32 products are summed apart and added to it
//   rounded to nearest (mma_3xtf32), as the matrix prior's k-blocks are.
//   No row splits, so each G element has one owner: no
//   partial sums in shared memory, no atomics, the same bits on every
//   launch.  At the end of a gradient the owners apply the prior in their
//   fragment layout (with a (d, d) matrix A one more block product on the
//   tensor cores, Theta A, A's fragments read from device memory: d^2 a
//   chain and gradient) and write g = G - prior to the slot.
// - Rows: the wide tile's buffers (plain float32, stride D + 4, split where
//   loaded), always streamed: the largest R in {128, 64, 32, 16, 8} whose
//   two buffers fit beside sth (R 64 at D 288, 32 at D 512, 16 at D 1024).
//   The next tile's cp.async copy starts right after the barrier that
//   lands the current one and overlaps its whole computation.
//
// Each tile costs three barriers (copy landed, Z partials written, R
// written).  The N-tiled kernel (glm_bign.cu partial_xwide_kernel) runs the
// same pass over its split of N for the theta of 16 chains and adds the
// float sums into its double partials every kXFlushRows rows.
constexpr int kXUnits = kXWideMax / 8 / kTrajWarps;  // stage-2 n-blocks a warp
constexpr int kXArrays = 4;       // theta, g, m, g': a chain's slot rows
constexpr int kXFlushRows = 256;  // N-tiled kernel: rows between flushes

// Parameter bound of the NUTS kernels, and of the HMC and N-tiled kernels
// up to kXWideMax (glm_bound_for): tile_bound_for's up to kWideMax, above
// it d padded to a multiple of 32 up to kXWideMax; 0 where no tile takes d.
int hmc_bound_for(int d) {
  return d > kWideMax && d <= kXWideMax ? (d + 31) & ~31 : tile_bound_for(d);
}

// Bytes of the HMC kernels' device-memory slot of one block at width D.
size_t xwide_slot_bytes(int D) {
  return sizeof(float) * (size_t)kXArrays * kTileChains * D;
}

// Shared memory of a very-wide-tile kernel, in this order: the warps' ll
// partials (kTrajWarps x 16 doubles), sth (16 x (D + 4)), zbuf (16 units x
// 128 floats), rbuf (16 x RS), two buffers of R rows.
size_t xwide_smem(int D, int R) {
  return sizeof(double) * kTrajWarps * kTileChains +
         sizeof(float) * ((size_t)kTileChains * (D + 4) +
                          (size_t)kTrajWarps * 128 +
                          (size_t)kTileChains * wide_rstride(R) +
                          (size_t)2 * R * wide_row_floats(D));
}

// The plan at D: the largest streamed tile R in {128, ..., 8} that fits
// (R / 8 row groups times 128 / R k-slices make the 16 warps' units).
TrajPlan xwide_plan(int D) {
  for (int R = 128; R >= 8; R >>= 1)
    if (xwide_smem(D, R) <= (size_t)kTileSmemCap)
      return {R, false, xwide_smem(D, R)};
  return {0, false, 0};
}

// The block's view of that shared memory.
struct XWide {
  int D, R, KS, RS;  // width, rows a buffer, stage-1 k-slices, rbuf stride
  double* pll;       // (kTrajWarps, 16)
  float* sth;        // (16, D + 4): theta of the gradient in flight
  float* zbuf;       // (16 units, 32 lanes, 4): stage 1's partial Z; at the
                     // end of a gradient the warps' prior quad partials
  float* rbuf;       // (16, RS): R of the tile in flight
  float* buf;        // two buffers of R rows
};

__device__ __forceinline__ XWide xwide_at(const Glm& p) {
  extern __shared__ double tile_sm[];
  XWide x;
  x.D = (p.d + 31) & ~31;
  x.R = p.tile;
  x.KS = 128 / p.tile;
  x.RS = wide_rstride(p.tile);
  x.pll = tile_sm;
  x.sth = reinterpret_cast<float*>(x.pll + kTrajWarps * kTileChains);
  x.zbuf = x.sth + kTileChains * (x.D + 4);
  x.rbuf = x.zbuf + kTrajWarps * 128;
  x.buf = x.rbuf + kTileChains * x.RS;
  return x;
}

__device__ __forceinline__ float* xwide_buffer(const XWide& x, int b) {
  return x.buf + (size_t)b * x.R * wide_row_floats(x.D);
}

// Zero both buffers (w = 1 without weights): columns past d stay exact
// zeros, rows past a ragged tile's end finite.  Every thread calls it,
// once a launch; ends on a barrier.
__device__ __forceinline__ void xwide_init(const Glm& p, const XWide& x) {
  const int per = x.R * wide_row_floats(x.D), wat = x.R * (x.D + 5);
  for (int e = threadIdx.x; e < 2 * per; e += blockDim.x) {
    const int k = e % per;
    x.buf[e] = (!p.w && k >= wat && k < wat + x.R) ? 1.f : 0.f;
  }
  __syncthreads();
}

// One k-block of the partial Z: theta's A fragment from the sth rows of
// chains g (t0) and g + 8 (t8) and x's B fragment from row r0 + g (xr),
// columns 8 kb + q and + 4 (q already in the pointers), split where loaded.
__device__ __forceinline__ void xwide_kblock(const float* t0, const float* t8,
                                             const float* xr, int kb,
                                             float (&zb)[4], float (&zs)[4]) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
  split_tf32(t0[8 * kb], ah[0], al[0]);
  split_tf32(t8[8 * kb], ah[1], al[1]);
  split_tf32(t0[8 * kb + 4], ah[2], al[2]);
  split_tf32(t8[8 * kb + 4], ah[3], al[3]);
  split_tf32(xr[8 * kb], bh0, bl0);
  split_tf32(xr[8 * kb + 4], bh1, bl1);
  mma_tf32(zs, al, bh0, bh1);
  mma_tf32(zs, ah, bl0, bl1);
  mma_tf32(zb, ah, bh0, bh1);
}

// Stage 1 of a tile of nt rows in buffer xb: warp w's unit is row group
// w / KS and the k-blocks w % KS, + KS, ...; its partial Z (lane 4g + q:
// chains g, g + 8 at rows 2q, 2q + 1, as row_group's accumulator) goes to
// zbuf unit w.  Row groups past nt are skipped.  Both loads of a k-block
// hit 32 distinct banks (4 g + q for stride D + 4).
__device__ __forceinline__ void xwide_stage1(const XWide& x, const float* xb,
                                             int nt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 8 * (warp / x.KS), NKB = x.D / 8;
  if (r0 >= nt) return;
  const int TS = x.D + 4;
  const float* t0 = x.sth + g * TS + q;
  const float* t8 = t0 + 8 * TS;
  const float* xr = xb + (r0 + g) * TS + q;
  float zb[4] = {0.f, 0.f, 0.f, 0.f}, zs[4] = {0.f, 0.f, 0.f, 0.f};
  float zb1[4] = {0.f, 0.f, 0.f, 0.f}, zs1[4] = {0.f, 0.f, 0.f, 0.f};
  int kb = warp % x.KS;
  // two k-blocks a step into two accumulator pairs: their mma chains overlap
  for (; kb + x.KS < NKB; kb += 2 * x.KS) {
    xwide_kblock(t0, t8, xr, kb, zb, zs);
    xwide_kblock(t0, t8, xr, kb + x.KS, zb1, zs1);
  }
  if (kb < NKB) xwide_kblock(t0, t8, xr, kb, zb, zs);
  reinterpret_cast<float4*>(x.zbuf)[warp * 32 + lane] =
      make_float4((zb[0] + zb1[0]) + (zs[0] + zs1[0]),
                  (zb[1] + zb1[1]) + (zs[1] + zs1[1]),
                  (zb[2] + zb1[2]) + (zs[2] + zs1[2]),
                  (zb[3] + zb1[3]) + (zs[3] + zs1[3]));
}

// The link of a tile (after stage 1's barrier): warp rg < R / 8 takes row
// group rg, Z = o + its KS partials in slice order, R into rbuf (as
// wide_z) and with LL the w ll terms into ll.
template <int KIND, bool LL>
__device__ __forceinline__ void xwide_link_k(const XWide& x, const float* xb,
                                             int nt, double (&ll)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, r0 = 8 * warp;
  if (warp >= x.R / 8 || r0 >= nt) return;
  const float* yb = xb + x.R * (x.D + 4);
  const float2 o2 = *reinterpret_cast<const float2*>(yb + 2 * x.R + r0 + 2 * q);
  float z[4] = {o2.x, o2.y, o2.x, o2.y};
  const float4* zp = reinterpret_cast<const float4*>(x.zbuf) +
                     warp * x.KS * 32 + lane;
  for (int ks = 0; ks < x.KS; ++ks) {
    const float4 v = zp[32 * ks];
    z[0] += v.x;
    z[1] += v.y;
    z[2] += v.z;
    z[3] += v.w;
  }
  float r[4];
  if (r0 + 8 <= nt)
    group_link<KIND, LL, true>(z, yb, yb + x.R, nt, r0, r, ll);
  else  // the ragged last group: rows past nt masked
    group_link<KIND, LL, false>(z, yb, yb + x.R, nt, r0, r, ll);
  float* rp = x.rbuf + g * x.RS + r0 + 2 * q;
  *reinterpret_cast<float2*>(rp) = make_float2(r[0], r[1]);
  *reinterpret_cast<float2*>(rp + 8 * x.RS) = make_float2(r[2], r[3]);
}

template <bool LL>
__device__ __forceinline__ void xwide_link(int kind, const XWide& x,
                                           const float* xb, int nt,
                                           double (&ll)[2]) {
  switch (kind) {
    case kLogistic: xwide_link_k<kLogistic, LL>(x, xb, nt, ll); break;
    case kLinear: xwide_link_k<kLinear, LL>(x, xb, nt, ll); break;
    case kPoisson: xwide_link_k<kPoisson, LL>(x, xb, nt, ll); break;
    default: xwide_link_k<kProbit, LL>(x, xb, nt, ll); break;
  }
}

// Stage 2 of a tile (after the link's barrier): G += R X for the warp's
// n-blocks w + 16 i over all the tile's row groups, with the A fragment
// and the row order of wide_stage2; ga[i] holds G(g, 8 nb + 2q (+1)),
// G(g + 8, 8 nb + 2q (+1)).
__device__ __forceinline__ void xwide_stage2(const XWide& x, const float* xb,
                                             int nt,
                                             float (&ga)[kXUnits][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int NB = x.D / 8, XS = x.D + 4, groups = (nt + 7) >> 3;
  for (int rg = 0; rg < groups; ++rg) {
    const int r0 = 8 * rg;
    const float2 a = *reinterpret_cast<const float2*>(x.rbuf + g * x.RS + r0 +
                                                      2 * q);
    const float2 b = *reinterpret_cast<const float2*>(
        x.rbuf + (g + 8) * x.RS + r0 + 2 * q);
    uint32_t rh[4], rl[4];
    split_tf32(a.x, rh[0], rl[0]);
    split_tf32(b.x, rh[1], rl[1]);
    split_tf32(a.y, rh[2], rl[2]);
    split_tf32(b.y, rh[3], rl[3]);
    const float* x0 = xb + (r0 + 2 * q) * XS + g;
#pragma unroll
    for (int i = 0; i < kXUnits; ++i) {
      const int nb = warp + kTrajWarps * i;
      if (nb < NB) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x0[8 * nb], bh0, bl0);
        split_tf32(x0[XS + 8 * nb], bh1, bl1);
        mma_3xtf32(ga[i], rh, rl, bh0, bh1, bl0, bl1);
      }
    }
  }
}

__device__ __forceinline__ void xwide_zero(float (&ga)[kXUnits][4]) {
#pragma unroll
  for (int i = 0; i < kXUnits; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ga[i][e] = 0.f;
}

// One pass over rows [n0, n1) for the block's 16 chains at the theta in sth
// (written before the call): G += R X into ga and, with LL, the w ll terms
// into ll.  Every thread calls it; starts on a barrier (sth written, every
// warp done with both buffers), and leaves zbuf and rbuf free once every
// warp is past stage 2 of the last tile.
template <bool LL>
__device__ __forceinline__ void xwide_rows(const Glm& p, const XWide& x,
                                           int n0, int n1,
                                           float (&ga)[kXUnits][4],
                                           double (&ll)[2]) {
  __syncthreads();
  wide_issue(p, x.D, x.R, x.buf, n0, min(x.R, n1 - n0));
  cp_async_commit();
  for (int t0 = n0, b = 0; t0 < n1; t0 += x.R, b ^= 1) {
    const int nt = min(x.R, n1 - t0), t1 = t0 + x.R;
    const float* xb = xwide_buffer(x, b);
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; every warp done with the last one
    if (t1 < n1) {    // the next tile copies while this one is computed
      wide_issue(p, x.D, x.R, xwide_buffer(x, b ^ 1), t1, min(x.R, n1 - t1));
      cp_async_commit();
    }
    xwide_stage1(x, xb, nt);
    __syncthreads();  // the partial Z written
    xwide_link<LL>(p.kind, x, xb, nt, ll);
    __syncthreads();  // R written
    xwide_stage2(x, xb, nt, ga);
  }
}

// The prior's gradient term of the warp's units in ga's layout (0 past d):
// lam theta with lam the (d,) row's or the scalar, theta from sth; with a
// (d, d) matrix A, PG = Theta A as one more block product on the tensor
// cores, K = d in k-blocks of 8 with the k order of stage 2 (k = q <-> row
// 8 kb + 2q, k = q + 4 <-> row 8 kb + 2q + 1), Theta's A fragment from sth
// and A's B fragment A[8 kb + 2q (+1), 8 nb + g] through the read-only
// path from device memory (4 MB at d 1024, read once a block and
// gradient).
__device__ __forceinline__ void xwide_prior(const Glm& p, const XWide& x,
                                            float (&pa)[kXUnits][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int NB = x.D / 8, TS = x.D + 4;
  const float* t0 = x.sth + g * TS;
  const float* t8 = t0 + 8 * TS;
  xwide_zero(pa);
  if (!p.lamm) {
#pragma unroll
    for (int i = 0; i < kXUnits; ++i) {
      const int j = 8 * (warp + kTrajWarps * i) + 2 * q;
      if (warp + kTrajWarps * i < NB) {
        const float l0 = j < p.d ? (p.lamv ? __ldg(p.lamv + j) : p.lam) : 0.f;
        const float l1 =
            j + 1 < p.d ? (p.lamv ? __ldg(p.lamv + j + 1) : p.lam) : 0.f;
        pa[i][0] = l0 * t0[j];
        pa[i][1] = l1 * t0[j + 1];
        pa[i][2] = l0 * t8[j];
        pa[i][3] = l1 * t8[j + 1];
      }
    }
    return;
  }
  for (int kb = 0; 8 * kb < p.d; ++kb) {
    const int k0 = 8 * kb + 2 * q, k1 = k0 + 1;
    uint32_t ah[4], al[4];
    split_tf32(t0[k0], ah[0], al[0]);
    split_tf32(t8[k0], ah[1], al[1]);
    split_tf32(t0[k1], ah[2], al[2]);
    split_tf32(t8[k1], ah[3], al[3]);
    const float* a0 = p.lamm + (size_t)k0 * p.d;
#pragma unroll
    for (int i = 0; i < kXUnits; ++i) {
      const int nb = warp + kTrajWarps * i, col = 8 * nb + g;
      if (nb < NB) {
        const bool cin = col < p.d;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(cin && k0 < p.d ? __ldg(a0 + col) : 0.f, bh0, bl0);
        split_tf32(cin && k1 < p.d ? __ldg(a0 + p.d + col) : 0.f, bh1, bl1);
        mma_3xtf32(pa[i], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// One gradient of the block's 16 chains at the theta in sth: g = G - prior
// term into the (16, D) slot array gdst (0 past d) and, with want_ll, lp,
// the same bits in all the chain's lanes (the warps' ll partials in warp
// order; the prior term 1/2 theta . pg from the owners' partials, summed
// over each quad, then over the warps in order).  Every thread calls it;
// ends on a barrier, after which warp c reads its row of gdst.  The one
// routine of this file left out of line: the HMC kernels call it from six
// places, which inlined took nvcc about 100 s more; it takes the model by
// value and finds the block's shared memory itself (xwide_at), so its
// loads stay shared-memory loads.
__device__ __noinline__ float xwide_grad(const Glm p, float* gdst,
                                         bool want_ll) {
  const XWide x = xwide_at(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int NB = x.D / 8, TS = x.D + 4;
  float ga[kXUnits][4];
  xwide_zero(ga);
  double ll[2] = {0.0, 0.0};
  if (want_ll)
    xwide_rows<true>(p, x, 0, p.N, ga, ll);
  else
    xwide_rows<false>(p, x, 0, p.N, ga, ll);
  float pa[kXUnits][4];
  xwide_prior(p, x, pa);
  const float* t0 = x.sth + g * TS;
  const float* t8 = t0 + 8 * TS;
  float qa = 0.f, qb = 0.f;
#pragma unroll
  for (int i = 0; i < kXUnits; ++i) {
    const int nb = warp + kTrajWarps * i, j = 8 * nb + 2 * q;
    if (nb < NB) {
      *reinterpret_cast<float2*>(gdst + g * x.D + j) =
          make_float2(ga[i][0] - pa[i][0], ga[i][1] - pa[i][1]);
      *reinterpret_cast<float2*>(gdst + (g + 8) * x.D + j) =
          make_float2(ga[i][2] - pa[i][2], ga[i][3] - pa[i][3]);
      qa = fmaf(t0[j + 1], pa[i][1], fmaf(t0[j], pa[i][0], qa));
      qb = fmaf(t8[j + 1], pa[i][3], fmaf(t8[j], pa[i][2], qb));
    }
  }
  if (want_ll) {
    put_ll(x.pll, ll);
    const float sa = (float)quad_sum(qa), sb = (float)quad_sum(qb);
    if (q == 0) {  // zbuf is free: every warp is past the last link
      x.zbuf[warp * kTileChains + g] = sa;
      x.zbuf[warp * kTileChains + g + 8] = sb;
    }
  }
  __syncthreads();
  if (!want_ll) return 0.f;
  float quad = 0.f;
  for (int w = 0; w < kTrajWarps; ++w) quad += x.zbuf[w * kTileChains + warp];
  return (float)(sum_ll(x.pll, warp, kTrajWarps) - 0.5 * (double)quad);
}

// Row `row` of a (rows, d) array into a chain's row dst of width D (0 past
// d), and back; the warp's lanes stride over the coordinates.
__device__ __forceinline__ void xw_load(float* dst, int D, const float* src,
                                        size_t row, int d) {
  for (int j = threadIdx.x & 31; j < D; j += 32)
    dst[j] = j < d ? src[row * d + j] : 0.f;
}

__device__ __forceinline__ void xw_store(float* dst, size_t row, int d,
                                         const float* src) {
  for (int j = threadIdx.x & 31; j < d; j += 32) dst[row * d + j] = src[j];
}

__device__ __forceinline__ void xw_copy(float* dst, const float* src, int D) {
  for (int j = threadIdx.x & 31; j < D; j += 32) dst[j] = src[j];
}

// Above kXSumFloatMax parameters a chain's sums over its coordinates (|m|^2
// in H, the NUTS span and u-turn dot products) are carried in double: D /
// 32 float32 terms a lane, summed in order, drift by about 1e-2 of H at d
// 32768 and 3e-2 at 131072, ten times the plain version's blocked sum,
// enough to part a percent of the chains' accept, slice and u-turn
// decisions from it.  Up to it they stay float32, with the bits they had.
constexpr int kXSumFloatMax = 16384;

// |v|^2 of a chain's row in double, then the full-warp butterfly: xw_sq
// past kXSumFloatMax, out of line (every very-wide HMC instantiation calls
// it, and inlined its double path slowed their build).
__device__ __noinline__ float xw_sq_wide(const float* v, int D) {
  double s = 0.0;
  for (int j = threadIdx.x & 31; j < D; j += 32)
    s = fma((double)v[j], (double)v[j], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return (float)s;
}

// |v|^2 of a chain's row: the lane's coordinates in order, then the
// full-warp butterfly, so every lane gets the same bits (in double past
// kXSumFloatMax).  Every lane of the warp must call it.
__device__ __forceinline__ float xw_sq(const float* v, int D) {
  if (D > kXSumFloatMax) return xw_sq_wide(v, D);
  float s = 0.f;
  for (int j = threadIdx.x & 31; j < D; j += 32) s = fmaf(v[j], v[j], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// ---- the chunked tier: kXWideMax < d <= kXChunkDMax ------------------------
// Replaces the same Pallas bodies once more (pallas_glm.py _kernel,
// _step_kernel, _multistep_kernel; pallas_glm_bign.py _grad_kernel), whose
// only bound on d is their 100 MiB of VMEM.  Above 1024 parameters the
// very-wide tile breaks: sth, the theta of the gradient in flight, takes 16
// (D + 4) floats of shared memory (256 KB at D 4096, more than a block
// has); the rows' two buffers no longer fit beside it; stage 2's
// accumulators are sized by kXWideMax at compile time; and stage 2 needs
// the residual of a row, which needs Z over all of d first.  The chunked
// tier keeps the very-wide block (16 warps, a tile of 16 chains, persistent
// blocks, the chain state in a device-memory slot) and walks d in n chunks
// of DC <= kXChunk columns (d padded to D = n DC) and N in blocks of
// kXBlockRows rows, with two passes over each row block:
//
// - Pass A, for each chunk: the chunk's columns of the 16 chains' theta are
//   staged in sth (16 rows of stride DC + 4), the row block's tiles of the
//   chunk's columns stream through the two buffers, stage 1 leaves each
//   unit's partial Z in zbuf (xwide_stage1 on the chunk), and the warp of
//   each row group adds the k-slices' partials in slice order onto the
//   group's Z in zres (shared memory, 16 x kXBlockRows floats in the lane
//   order of stage 2's A fragments; the first chunk starts from o).  After
//   the last chunk that warp applies the link: R = w resid replaces Z in
//   zres and the w ll terms go to its double registers.
// - Pass B, for each chunk: the row block's tiles of the chunk's columns
//   stream again and stage 2 adds R X_c to the chunk's float accumulators
//   (n-blocks w + 16 i of the chunk, kXChunkUnits a warp, R's fragments
//   read from zres), which their owner hands on: the HMC kernels add them
//   to g's row in the slot (the first row block writes it), the N-tiled
//   kernel to its double partials.
//
// X is read twice a gradient (8 N d bytes for the tile's 16 chains, from
// L2 while X fits there), theta once a row block (64 d bytes a 512 rows).
// Every G element keeps one owner lane and one order of sums: the same bits
// on every launch.  The HMC kernels keep the proposal's theta in a fifth
// slot array (sth holds only a chunk of it) and apply the prior after the
// last row block, chunk by chunk, in the owners' layout (xchunk_prior: lam
// theta, or Theta A on the tensor cores with Theta's fragments read from
// the slot).  Shared memory at DC 512: sth 33 KB, zbuf 8 KB, zres 32 KB, two
// buffers of 32 rows 130 KB: 204 KB, one block an SM.  Nothing depends on
// d but the slot (320 D bytes a block: 42 MB at D 131072) and the loops'
// trip counts.  kXChunkDMax is 2^17, the width at which the Pallas
// kernels' VMEM still holds the design of a small-N GLM (N about 190);
// every index that can pass 2^31 (a chain row of a (C, d) array, a block's
// slot, a (d, d) matrix's row, a column of X) is a size_t.
constexpr int kXChunk = 512;         // columns of a chunk, at most
constexpr int kXBlockRows = 512;     // rows whose Z, then R, stay in zres
constexpr int kXChunkDMax = 131072;  // the chunked tier's bound: 2^17
constexpr int kXChunkArrays = 5;     // theta, g, m, g', theta': slot rows
constexpr int kXChunkUnits = kXChunk / 8 / kTrajWarps;  // stage-2 n-blocks

// The chunks of width d: n = ceil(d / kXChunk) of DC = ceil(d / n) rounded
// up to 32 columns (352 at d 1025-1056, 512 at d 2048 and 4096).
__host__ __device__ inline int xchunk_n(int d) {
  return (d + kXChunk - 1) / kXChunk;
}
__host__ __device__ inline int xchunk_dc(int d) {
  const int n = xchunk_n(d);
  return ((d + n - 1) / n + 31) & ~31;
}

// Parameter bound of the HMC and N-tiled kernels: hmc_bound_for's up to
// kXWideMax, above it n DC up to kXChunkDMax; 0 where no tile takes d.
int glm_bound_for(int d) {
  return d > kXWideMax && d <= kXChunkDMax ? xchunk_n(d) * xchunk_dc(d)
                                           : hmc_bound_for(d);
}

// Bytes of the HMC kernels' device-memory slot of one block at width D.
size_t xchunk_slot_bytes(int D) {
  return sizeof(float) * (size_t)kXChunkArrays * kTileChains * D;
}

// Shared memory of a chunked-tier kernel, in this order: the warps' ll
// partials (kTrajWarps x 16 doubles), sth (16 x (DC + 4)), zbuf (16 units
// x 128 floats), zres (16 x kXBlockRows), two buffers of R rows of DC
// columns.
size_t xchunk_smem(int DC, int R) {
  return sizeof(double) * kTrajWarps * kTileChains +
         sizeof(float) * ((size_t)kTileChains * (DC + 4) +
                          (size_t)kTrajWarps * 128 +
                          (size_t)kTileChains * kXBlockRows +
                          (size_t)2 * R * wide_row_floats(DC));
}

// The plan at d: the largest streamed tile R in {128, ..., 8} that fits
// (R / 8 row groups times 128 / R k-slices make stage 1's 16 units; R
// divides kXBlockRows).  R 32 at every DC up to 512.
TrajPlan xchunk_plan(int d) {
  const int DC = xchunk_dc(d);
  for (int R = 128; R >= 8; R >>= 1)
    if (xchunk_smem(DC, R) <= (size_t)kTileSmemCap)
      return {R, false, xchunk_smem(DC, R)};
  return {0, false, 0};
}

// The block's view of that shared memory: x is the very-wide tile's view of
// one chunk (x.D = DC, no rbuf), so that xwide_init, xwide_buffer and
// xwide_stage1 serve the chunks as they are.
struct XChunk {
  XWide x;
  int n, D;     // chunks, padded width n DC
  float* zres;  // (kXBlockRows / 8 groups, 32 lanes, 4): Z, then R
};

__device__ __forceinline__ XChunk xchunk_at(const Glm& p) {
  extern __shared__ double tile_sm[];
  XChunk c;
  c.n = xchunk_n(p.d);
  c.x.D = xchunk_dc(p.d);
  c.D = c.n * c.x.D;
  c.x.R = p.tile;
  c.x.KS = 128 / p.tile;
  c.x.RS = 0;
  c.x.pll = tile_sm;
  c.x.sth = reinterpret_cast<float*>(c.x.pll + kTrajWarps * kTileChains);
  c.x.zbuf = c.x.sth + kTileChains * (c.x.D + 4);
  c.zres = c.x.zbuf + kTrajWarps * 128;
  c.x.rbuf = nullptr;
  c.x.buf = c.zres + kTileChains * kXBlockRows;
  return c;
}

// Start copying rows [n0, n0 + nt) of columns [c0, c0 + DC) into buffer
// dst, with wide_issue's layout and split of the work; the columns past d
// (the last chunk's padding) are zero-filled, so that no other chunk's
// columns linger there.
__device__ __forceinline__ void xchunk_issue(const Glm& p, const XWide& x,
                                             float* dst, int c0, int n0,
                                             int nt) {
  const int XS = x.D + 4, lane = threadIdx.x & 31;
  float* yb = dst + x.R * XS;
  for (int j = 4 * (threadIdx.x >> 5) + (lane >> 3); j < x.D;
       j += 4 * (blockDim.x >> 5)) {
    const bool in = c0 + j < p.d;
    const float* src = p.xt + (size_t)(in ? c0 + j : 0) * p.N + n0;
    for (int i = lane & 7; i < nt; i += 8)
      cp_async4_zfill(dst + i * XS + j, src + i, in);
  }
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    cp_async4(yb + i, p.y + n0 + i);
    if (p.w) cp_async4(yb + x.R + i, p.w + n0 + i);
    if (p.o) cp_async4(yb + 2 * x.R + i, p.o + n0 + i);
  }
}

// Columns [c0, c0 + DC) of the warp's chain row src (0 past d) into its
// sth row.
__device__ __forceinline__ void xchunk_theta(const XWide& x, const float* src,
                                             int c0, int d) {
  float* dst = x.sth + (threadIdx.x >> 5) * (x.D + 4);
  for (int j = threadIdx.x & 31; j < x.D; j += 32)
    dst[j] = c0 + j < d ? src[c0 + j] : 0.f;
}

// After stage 1 of a tile of nt rows whose first row group is group g0 of
// the row block: warp rg < R / 8 adds its row group's KS partials in slice
// order onto the group's Z in zres (onto o for the first chunk) and, after
// the last chunk, applies the link (as xwide_link_k): R replaces Z, and
// the w ll terms go into ll.  One instantiation a link, the rows past nt
// masked and ll summed in every group (the very-wide tile's four a link
// add nothing here but nvcc's time: a row's link is 1 / d of its work).
template <int KIND>
__device__ __forceinline__ void xchunk_link_k(const XChunk& c, const float* xb,
                                              int nt, int g0, bool first,
                                              bool last, double (&ll)[2]) {
  const XWide& x = c.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3, r0 = 8 * warp;
  if (warp >= x.R / 8 || r0 >= nt) return;
  const float* yb = xb + x.R * (x.D + 4);
  float4* zp = reinterpret_cast<float4*>(c.zres) + (g0 + warp) * 32 + lane;
  float z[4];
  if (first) {
    const float2 o2 =
        *reinterpret_cast<const float2*>(yb + 2 * x.R + r0 + 2 * q);
    z[0] = z[2] = o2.x;
    z[1] = z[3] = o2.y;
  } else {
    const float4 v = *zp;
    z[0] = v.x;
    z[1] = v.y;
    z[2] = v.z;
    z[3] = v.w;
  }
  const float4* pp = reinterpret_cast<const float4*>(x.zbuf) +
                     warp * x.KS * 32 + lane;
  for (int ks = 0; ks < x.KS; ++ks) {
    const float4 v = pp[32 * ks];
    z[0] += v.x;
    z[1] += v.y;
    z[2] += v.z;
    z[3] += v.w;
  }
  if (!last) {
    *zp = make_float4(z[0], z[1], z[2], z[3]);
    return;
  }
  float r[4];
  group_link<KIND, true, false>(z, yb, yb + x.R, nt, r0, r, ll);
  *zp = make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void xchunk_link(int kind, const XChunk& c,
                                            const float* xb, int nt, int g0,
                                            bool first, bool last,
                                            double (&ll)[2]) {
  switch (kind) {
    case kLogistic:
      xchunk_link_k<kLogistic>(c, xb, nt, g0, first, last, ll);
      break;
    case kLinear:
      xchunk_link_k<kLinear>(c, xb, nt, g0, first, last, ll);
      break;
    case kPoisson:
      xchunk_link_k<kPoisson>(c, xb, nt, g0, first, last, ll);
      break;
    default:
      xchunk_link_k<kProbit>(c, xb, nt, g0, first, last, ll);
      break;
  }
}

// Pass A over rows [b0, b1) (at most kXBlockRows) for the warps' chain rows
// src (each warp its own, width d): R of the row block into zres and the w
// ll terms into ll.  Every thread calls it; starts on a barrier.
__device__ __forceinline__ void xchunk_pass_a(const Glm& p, const XChunk& c,
                                              const float* src, int b0,
                                              int b1, double (&ll)[2]) {
  const XWide& x = c.x;
  for (int k = 0; k < c.n; ++k) {
    const int c0 = k * x.D;
    __syncthreads();  // every warp done with sth, zbuf and both buffers
    xchunk_theta(x, src, c0, p.d);
    xchunk_issue(p, x, x.buf, c0, b0, min(x.R, b1 - b0));
    cp_async_commit();
    for (int t0 = b0, b = 0; t0 < b1; t0 += x.R, b ^= 1) {
      const int nt = min(x.R, b1 - t0), t1 = t0 + x.R;
      const float* xb = xwide_buffer(x, b);
      cp_async_wait<0>();
      __syncthreads();  // this tile and sth landed; every warp done with the
                        // last tile
      if (t1 < b1) {
        xchunk_issue(p, x, xwide_buffer(x, b ^ 1), c0, t1, min(x.R, b1 - t1));
        cp_async_commit();
      }
      xwide_stage1(x, xb, nt);
      __syncthreads();  // the partial Z written
      xchunk_link(p.kind, c, xb, nt, (t0 - b0) >> 3, k == 0, k == c.n - 1,
                  ll);
    }
  }
}

// Stage 2 of a tile of nt rows whose first row group is group g0 of the row
// block: G_c += R X_c for the warp's n-blocks w + 16 i of the chunk, R's A
// fragment (xwide_stage2's) from zres.
__device__ __forceinline__ void xchunk_stage2(const XChunk& c, const float* xb,
                                              int nt, int g0,
                                              float (&ga)[kXChunkUnits][4]) {
  const XWide& x = c.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int NB = x.D / 8, XS = x.D + 4, groups = (nt + 7) >> 3;
  const float4* rz = reinterpret_cast<const float4*>(c.zres) + g0 * 32 + lane;
  for (int rg = 0; rg < groups; ++rg) {
    // (chain g: rows 2q, 2q + 1; chain g + 8: rows 2q, 2q + 1)
    const float4 r = rz[32 * rg];
    uint32_t rh[4], rl[4];
    split_tf32(r.x, rh[0], rl[0]);
    split_tf32(r.z, rh[1], rl[1]);
    split_tf32(r.y, rh[2], rl[2]);
    split_tf32(r.w, rh[3], rl[3]);
    const float* x0 = xb + (8 * rg + 2 * q) * XS + g;
#pragma unroll
    for (int i = 0; i < kXChunkUnits; ++i) {
      const int nb = warp + kTrajWarps * i;
      if (nb < NB) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x0[8 * nb], bh0, bl0);
        split_tf32(x0[XS + 8 * nb], bh1, bl1);
        mma_3xtf32(ga[i], rh, rl, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// Pass B of chunk k over rows [b0, b1) (after pass A): G_c of the row block
// into ga, zeroed here.  Every thread calls it; starts on a barrier.
__device__ __forceinline__ void xchunk_pass_b(const Glm& p, const XChunk& c,
                                              int k, int b0, int b1,
                                              float (&ga)[kXChunkUnits][4]) {
  const XWide& x = c.x;
  const int c0 = k * x.D;
#pragma unroll
  for (int i = 0; i < kXChunkUnits; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ga[i][e] = 0.f;
  __syncthreads();  // every warp done with both buffers; zres written
  xchunk_issue(p, x, x.buf, c0, b0, min(x.R, b1 - b0));
  cp_async_commit();
  for (int t0 = b0, b = 0; t0 < b1; t0 += x.R, b ^= 1) {
    const int nt = min(x.R, b1 - t0), t1 = t0 + x.R;
    const float* xb = xwide_buffer(x, b);
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; every warp done with the last one
    if (t1 < b1) {
      xchunk_issue(p, x, xwide_buffer(x, b ^ 1), c0, t1, min(x.R, b1 - t1));
      cp_async_commit();
    }
    xchunk_stage2(c, xb, nt, (t0 - b0) >> 3, ga);
  }
}

// The prior's gradient term of chunk k in the owners' layout (xwide_prior's,
// 0 past d), theta from the slot rows thp (16, D): lam theta, or with a (d,
// d) matrix A, PG_c = Theta A[:, c] on the tensor cores, K = d in k-blocks
// of 8, Theta's A fragment from thp, A's B fragment from device memory.
__device__ __forceinline__ void xchunk_prior(const Glm& p, const XChunk& c,
                                             const float* thp, int k,
                                             float (&pa)[kXChunkUnits][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int NB = c.x.D / 8, c0 = k * c.x.D;
  const float* t0 = thp + (size_t)g * c.D;
  const float* t8 = t0 + (size_t)8 * c.D;
#pragma unroll
  for (int i = 0; i < kXChunkUnits; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[i][e] = 0.f;
  if (!p.lamm) {
#pragma unroll
    for (int i = 0; i < kXChunkUnits; ++i) {
      const int j = c0 + 8 * (warp + kTrajWarps * i) + 2 * q;
      if (warp + kTrajWarps * i < NB) {
        const float l0 = j < p.d ? (p.lamv ? __ldg(p.lamv + j) : p.lam) : 0.f;
        const float l1 =
            j + 1 < p.d ? (p.lamv ? __ldg(p.lamv + j + 1) : p.lam) : 0.f;
        pa[i][0] = l0 * t0[j];
        pa[i][1] = l1 * t0[j + 1];
        pa[i][2] = l0 * t8[j];
        pa[i][3] = l1 * t8[j + 1];
      }
    }
    return;
  }
  for (int kb = 0; 8 * kb < p.d; ++kb) {
    const int k0 = 8 * kb + 2 * q, k1 = k0 + 1;
    uint32_t ah[4], al[4];
    split_tf32(t0[k0], ah[0], al[0]);
    split_tf32(t8[k0], ah[1], al[1]);
    split_tf32(t0[k1], ah[2], al[2]);
    split_tf32(t8[k1], ah[3], al[3]);
    const float* a0 = p.lamm + (size_t)k0 * p.d;
#pragma unroll
    for (int i = 0; i < kXChunkUnits; ++i) {
      const int nb = warp + kTrajWarps * i, col = c0 + 8 * nb + g;
      if (nb < NB) {
        const bool cin = col < p.d;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(cin && k0 < p.d ? __ldg(a0 + col) : 0.f, bh0, bl0);
        split_tf32(cin && k1 < p.d ? __ldg(a0 + p.d + col) : 0.f, bh1, bl1);
        mma_3xtf32(pa[i], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// One gradient of the block's 16 chains at the theta rows thp (16, D) of
// the slot: g = G - prior term into the (16, D) slot array gdst (0 past d)
// and, with want_ll, lp as xwide_grad gives it (the warps' ll partials in
// warp order, the prior term 1/2 theta . pg from the owners' partials).
// G of each row block is added to gdst by its owner, so gdst's rows hold
// G's partial sums until the prior is applied; ll is summed in every pass
// A and used only with want_ll.  Every thread calls it;
// ends on a barrier, after which warp c reads its row of gdst.  Left out of
// line, as xwide_grad.
__device__ __noinline__ float xchunk_grad(const Glm p, const float* thp,
                                          float* gdst, bool want_ll) {
  const XChunk c = xchunk_at(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int NB = c.x.D / 8, D = c.D;
  double ll[2] = {0.0, 0.0};
  for (int b0 = 0; b0 < p.N; b0 += kXBlockRows) {
    const int b1 = min(p.N, b0 + kXBlockRows);
    xchunk_pass_a(p, c, thp + (size_t)warp * D, b0, b1, ll);
    for (int k = 0; k < c.n; ++k) {
      float ga[kXChunkUnits][4];
      xchunk_pass_b(p, c, k, b0, b1, ga);
#pragma unroll
      for (int i = 0; i < kXChunkUnits; ++i) {
        const int nb = warp + kTrajWarps * i;
        if (nb >= NB) continue;
        const int j = k * c.x.D + 8 * nb + 2 * q;
        float2* r0 = reinterpret_cast<float2*>(gdst + g * D + j);
        float2* r8 = reinterpret_cast<float2*>(gdst + (g + 8) * D + j);
        if (b0 == 0) {
          *r0 = make_float2(ga[i][0], ga[i][1]);
          *r8 = make_float2(ga[i][2], ga[i][3]);
        } else {
          const float2 u = *r0, v = *r8;
          *r0 = make_float2(u.x + ga[i][0], u.y + ga[i][1]);
          *r8 = make_float2(v.x + ga[i][2], v.y + ga[i][3]);
        }
      }
    }
  }
  const float* t0 = thp + g * D;
  const float* t8 = t0 + 8 * D;
  float qa = 0.f, qb = 0.f;
  for (int k = 0; k < c.n; ++k) {
    float pa[kXChunkUnits][4];
    xchunk_prior(p, c, thp, k, pa);
#pragma unroll
    for (int i = 0; i < kXChunkUnits; ++i) {
      const int nb = warp + kTrajWarps * i;
      if (nb >= NB) continue;
      const int j = k * c.x.D + 8 * nb + 2 * q;
      float2* r0 = reinterpret_cast<float2*>(gdst + g * D + j);
      float2* r8 = reinterpret_cast<float2*>(gdst + (g + 8) * D + j);
      const float2 u = *r0, v = *r8;
      *r0 = make_float2(u.x - pa[i][0], u.y - pa[i][1]);
      *r8 = make_float2(v.x - pa[i][2], v.y - pa[i][3]);
      qa = fmaf(t0[j + 1], pa[i][1], fmaf(t0[j], pa[i][0], qa));
      qb = fmaf(t8[j + 1], pa[i][3], fmaf(t8[j], pa[i][2], qb));
    }
  }
  if (want_ll) {
    put_ll(c.x.pll, ll);
    const float sa = (float)quad_sum(qa), sb = (float)quad_sum(qb);
    if (q == 0) {  // zbuf is free: every warp is past the last link
      c.x.zbuf[warp * kTileChains + g] = sa;
      c.x.zbuf[warp * kTileChains + g + 8] = sb;
    }
  }
  __syncthreads();
  if (!want_ll) return 0.f;
  float quad = 0.f;
  for (int w = 0; w < kTrajWarps; ++w) quad += c.x.zbuf[w * kTileChains + warp];
  return (float)(sum_ll(c.x.pll, warp, kTrajWarps) - 0.5 * (double)quad);
}

// One gradient of the tile at the theta rows thp: xwide_grad's (theta in
// sth, thp unread), or on the chunked tier (CH) xchunk_grad's; the
// very-wide HMC and NUTS kernels take their tier from CH.
template <bool CH>
__device__ __forceinline__ float xw_grad(const Glm& p, const float* thp,
                                         float* gp, bool want_ll) {
  if constexpr (CH)
    return xchunk_grad(p, thp, gp, want_ll);
  else
    return xwide_grad(p, gp, want_ll);
}

}  // namespace

#define TILE_DISPATCH(D_, CALL)                        \
  switch (D_) {                                        \
    case 8: CALL(8); break;                            \
    case 16: CALL(16); break;                          \
    case 32: CALL(32); break;                          \
    default: return (int)cudaErrorInvalidValue;        \
  }
