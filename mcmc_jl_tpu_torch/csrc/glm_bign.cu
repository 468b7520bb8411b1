// N-tiled GLM log-target and gradient for Hopper (sm_90a).
//
// Replaces the Pallas kernel of mcmc_jl_tpu/ops/pallas_glm_bign.py:
//   glm_logp_grad_tiled  <- _grad_kernel (via glm_logp_grad_tiled)
// which carries every GLM run with more than BIGN_THRESHOLD = 16384
// observations: one (logp, grad) evaluation for all chains per call.
//
// Model: for every chain c
//   lp_c = sum_n w_n ll(z_cn, y_n) - 1/2 sum_j lam_j theta_cj^2
//   g_c  = sum_n w_n resid(z_cn, y_n) x_n - lam o theta_c
// with z_cn = x_n . theta_c + o_n; lam is a scalar or a (d,) row (the
// diagonal-metric fold of the warm-start pipeline), or a symmetric (d, d)
// matrix A (the dense-metric fold): then g_c ends in - theta_c A and lp_c in
// - 1/2 theta_c' A theta_c.
//
// What bounds it on the H100: per chain and observation 2d multiply-adds
// (the two skinny products theta X^T and r X) and one link evaluation with
// its log-likelihood term.  At C = 4096, N = 100,000, d = 10 that is
// 1.6e10 FLOP, 0.25 ms at the 67 TFLOP/s FP32 peak; the 4.1e8 links need
// 1.2e9 special-function results (expf, the reciprocal, the log), 0.29 ms at
// 16 per clock per SM; X (4 MB) stays in the 50 MB L2 across chain blocks,
// so bytes do not bound it.  With the products on the tensor cores, what
// is left is instruction issue on the CUDA cores: about 45 instructions per
// chain and observation, over half of them the link's (expf, the
// reciprocal, the log1p polynomial, the selects and the double sum of ll),
// the rest the fragment loads and the TF32 splits.
//
// Design.  The TPU walks the observation tiles in order and accumulates into
// output blocks that stay resident.  On Hopper blocks run in no order, so:
// - the grid is (chain blocks of 128, splits of N): each CTA takes 128
//   chains, 16 per warp, and one contiguous range of observations; the
//   wrapper picks the splits so that up to 528 CTAs (two full waves of the
//   two blocks each SM holds) fill the 132 SMs even at 512 chains;
// - each CTA streams its rows through shared memory in tiles of 128 rows
//   with cp.async, double-buffered: the next tile copies while the current
//   one, split once into TF32 hi and lo parts, is computed; the last, ragged
//   tile is simply shorter (no padded rows, no zero weights: the rows past
//   its end are masked in registers);
// - on each tile every warp runs the chain-tile gradient of glm_tile.cuh
//   for its 16 chains: the two products on the tensor cores (mma.sync
//   m16n8k8, 3xTF32, float32 accumulators) with the link between them in
//   registers, two row groups at a time so that their latencies overlap;
// - each CTA writes one partial (g, ll) per chain, in double, to scratch the
//   wrapper allocates, and a second small kernel sums the partials of each
//   chain over the splits in a fixed order and applies the prior once.
// No float atomics, so two launches on the same inputs give the same bits.
// The gradient accumulates in float within a tile and in double across
// tiles; the log-likelihood in double throughout, as traj_grad does.
// wgmma with warp specialisation is later work; so is a cheaper link.
//
// Above d = 32 partial_wide_kernel runs the same sums on the wide tile of
// glm_tile.cuh.  At d 150, N 100,000, 512 chains: 3.1e10 FLOP, 0.46 ms at
// the FP32 peak; X (60 MB) is read by the 32 chain tiles of a split while
// they run together, so mostly once from memory (0.018 ms).  Above d = 256
// partial_xwide_kernel runs them on the very-wide tile, up to d = 1024,
// and above that partial_xchunk_kernel on the chunked tier, up to d =
// 16384.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "glm_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChains = kWarps * kTileChains;  // chains per block: 128
constexpr int kTile = 128;                     // rows per streamed tile

size_t partial_smem(int D) {
  return sizeof(float) * kTile * (2 * raw_row_floats(D) + tile_row_floats(D));
}

template <int D>
// two blocks per SM where the registers allow (d <= 16)
__global__ void __launch_bounds__(kThreads, D <= 16 ? 2 : 1)
partial_tile_kernel(Glm p, int C, int rows_per_split,
                    const float* __restrict__ th_in,
                    double* __restrict__ part) {
  extern __shared__ double tile_sm[];
  float* raw = reinterpret_cast<float*>(tile_sm);
  const Rows t = rows_at<D>(raw + 2 * raw_row_floats(D) * kTile, kTile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int cw = blockIdx.x * kChains + warp * kTileChains;  // warp's chains
  const bool active = cw < C;  // a warp past C still stages and syncs
  const int n0 = blockIdx.y * rows_per_split;
  const int n1 = min(p.N, n0 + rows_per_split);
  uint32_t ah[D / 8][4], al[D / 8][4];
  theta_frags<D>(th_in + (size_t)min(cw + g, C - 1) * p.d,  // shadow past C
                 th_in + (size_t)min(cw + g + 8, C - 1) * p.d, p.d, ah, al);
  double gsum[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) gsum[nb][e] = 0.0;
  double ll[2] = {0.0, 0.0};
  stream_begin<D>(p, raw, kTile, n0, n1);
  for (int t0 = n0, buf = 0; t0 < n1; t0 += kTile, buf ^= 1) {
    const int nt = stream_next<D>(p, raw, t, kTile, t0, n1, buf);
    if (!active) continue;
    float gb[D / 8][4], gs[D / 8][4];
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) gb[nb][e] = gs[nb][e] = 0.f;
    chain_tile_rows<D, true>(p.kind, t, nt, 0, 1, ah, al, gb, gs, ll);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gsum[nb][e] += (double)(gb[nb][e] + gs[nb][e]);
  }
  if (!active) return;
  const double lls[2] = {quad_sum(ll[0]), quad_sum(ll[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = cw + g + 8 * h;
    if (c >= C) continue;
    double* out = part + ((size_t)blockIdx.y * C + c) * (p.d + 1);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int j = 8 * nb + 2 * q;
      if (j < p.d) out[j] = gsum[nb][2 * h];
      if (j + 1 < p.d) out[j + 1] = gsum[nb][2 * h + 1];
    }
    if (q == 0) out[p.d] = lls[h];
  }
}

// Above d = 32: the wide tile of glm_tile.cuh on one tile of 16 chains (a
// warp a chain) and one contiguous range of observations a CTA, streamed
// in tiles of the wide plan's rows (120 at d 150).  The warps split each
// tile's row groups for Z and the link, then G's columns for R X
// (wide_stage2); after every tile the owners of the coordinates add the
// row splits' float sums into their double accumulators (as the narrow
// kernel's per-tile gsum), so the partial a CTA writes is the same bits on
// every launch.  The grid is (tiles of 16 chains, splits of N): at 512
// chains, 32 tiles by 8 splits, two waves of the one block an SM holds.
__global__ void __launch_bounds__(kTrajThreads, 1)
partial_wide_kernel(Glm p, int C, int rows_per_split,
                    const float* __restrict__ th_in,
                    double* __restrict__ part) {
  const Wide w = wide_at(p);
  wide_init(p, w);
  const int ct = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kTileChains + ct;
  const int n0 = blockIdx.y * rows_per_split;
  const int n1 = min(p.N, n0 + rows_per_split);
  float th[kWideRegs];
  wide_load(th, th_in, min(c, C - 1), p.d);  // a warp past C shadows C - 1
  wide_put_theta(w, ct, th);
  float gb[kWideUnits][4], gs[kWideUnits][4];
  wide_zero(gb, gs);
  double ll[2] = {0.0, 0.0}, gacc[kWideRegs];
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i) gacc[i] = 0.0;
  wide_begin(p, w, n0, n1);
  for (int t0 = n0, b = 0; t0 < n1; t0 += w.R, b ^= 1) {
    const int nt = wide_next(p, w, t0, n1, b);
    const float* xb = wide_buffer(w, b);
    wide_stage1<true>(p.kind, w, xb, nt, ll);
    __syncthreads();
    wide_stage2(w, xb, nt, gb, gs);
    wide_flush(w, gb, gs);
#pragma unroll
    for (int i = 0; i < kWideRegs; ++i)
      if (lane + 32 * i < p.d) gacc[i] += (double)wide_gsum(w, ct, lane + 32 * i);
  }
  put_ll(w.pll, ll);
  __syncthreads();
  if (c >= C) return;
  double* out = part + ((size_t)blockIdx.y * C + c) * (p.d + 1);
#pragma unroll
  for (int i = 0; i < kWideRegs; ++i)
    if (lane + 32 * i < p.d) out[lane + 32 * i] = gacc[i];
  if (lane == 0) out[p.d] = sum_ll(w.pll, ct, kTrajWarps);
}

// Above kWideMax: the very-wide tile of glm_tile.cuh on one tile of 16
// chains and one contiguous range of observations a CTA (the wide kernel's
// grid), streamed in tiles of the very-wide plan's R rows (16 at d 1024):
// stage 1 split over k, the link, stage 2 over all 16 warps' n-blocks
// (xwide_rows).  Each G element has one owner lane, which adds its float
// sums of kXFlushRows rows into the chain's double partial in place (the
// CTA's own rows of part: no atomics, the same bits on every launch).  At
// d 1024, N 20,000, 512 chains: 4.2e10 operations, 0.63 ms at the FP32
// peak; X (82 MB) is read by the 32 chain tiles of a split while they run
// together, once from memory (0.025 ms) and 32 times from L2.
__global__ void __launch_bounds__(kTrajThreads, 1)
partial_xwide_kernel(Glm p, int C, int rows_per_split,
                     const float* __restrict__ th_in,
                     double* __restrict__ part) {
  const XWide x = xwide_at(p);
  xwide_init(p, x);
  const int ct = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, NB = x.D / 8;
  const int c0 = blockIdx.x * kTileChains;
  const int n0 = blockIdx.y * rows_per_split;
  const int n1 = min(p.N, n0 + rows_per_split);
  // a warp past C shadows chain C - 1
  xw_load(x.sth + ct * (x.D + 4), x.D, th_in, min(c0 + ct, C - 1), p.d);
  float ga[kXUnits][4];
  double ll[2] = {0.0, 0.0};
  for (int f0 = n0; f0 < n1; f0 += kXFlushRows) {
    xwide_zero(ga);
    xwide_rows<true>(p, x, f0, min(n1, f0 + kXFlushRows), ga, ll);
#pragma unroll
    for (int i = 0; i < kXUnits; ++i) {
      const int nb = ct + kTrajWarps * i;
      if (nb >= NB) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + g + 8 * (e >> 1), j = 8 * nb + 2 * q + (e & 1);
        if (c >= C || j >= p.d) continue;
        double* out = part + ((size_t)blockIdx.y * C + c) * (p.d + 1) + j;
        *out = (f0 == n0 ? 0.0 : *out) + (double)ga[i][e];
      }
    }
  }
  put_ll(x.pll, ll);
  __syncthreads();
  if (c0 + ct < C && lane == 0)
    part[((size_t)blockIdx.y * C + c0 + ct) * (p.d + 1) + p.d] =
        sum_ll(x.pll, ct, kTrajWarps);
}

// Above kXWideMax: the chunked tier of glm_tile.cuh on the same grid (a
// tile of 16 chains and one contiguous range of observations a CTA): the
// range in row blocks of kXBlockRows, each pass A (Z over d's column chunks,
// then the link) and pass B (R X_c chunk by chunk).  The owner of each G
// element adds a row block's float sums into the chain's double partial in
// place, as partial_xwide_kernel does every kXFlushRows rows: no atomics,
// the same bits on every launch.  At d 4096, N 20,000, 512 chains: 1.7e11
// operations, 1.0 ms at the 3xTF32 rate (a third of the tensor cores' 495
// TFLOP/s); X (328 MB) no longer fits in L2, and each split's 32 chain
// tiles read their rows twice a gradient, 21 GB in all, 6.3 ms at the
// memory's 3.35 TB/s if nothing of it stayed in L2: bytes bound it.
__global__ void __launch_bounds__(kTrajThreads, 1)
partial_xchunk_kernel(Glm p, int C, int rows_per_split,
                      const float* __restrict__ th_in,
                      double* __restrict__ part) {
  const XChunk xc = xchunk_at(p);
  xwide_init(p, xc.x);
  const int ct = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, NB = xc.x.D / 8;
  const int c0 = blockIdx.x * kTileChains;
  const int n0 = blockIdx.y * rows_per_split;
  const int n1 = min(p.N, n0 + rows_per_split);
  // a warp past C shadows chain C - 1
  const float* src = th_in + (size_t)min(c0 + ct, C - 1) * p.d;
  double ll[2] = {0.0, 0.0};
  for (int f0 = n0; f0 < n1; f0 += kXBlockRows) {
    const int f1 = min(n1, f0 + kXBlockRows);
    xchunk_pass_a(p, xc, src, f0, f1, ll);
    for (int k = 0; k < xc.n; ++k) {
      float ga[kXChunkUnits][4];
      xchunk_pass_b(p, xc, k, f0, f1, ga);
#pragma unroll
      for (int i = 0; i < kXChunkUnits; ++i) {
        const int nb = ct + kTrajWarps * i;
        if (nb >= NB) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + g + 8 * (e >> 1);
          const int j = k * xc.x.D + 8 * nb + 2 * q + (e & 1);
          if (c >= C || j >= p.d) continue;
          double* out = part + ((size_t)blockIdx.y * C + c) * (p.d + 1) + j;
          *out = (f0 == n0 ? 0.0 : *out) + (double)ga[i][e];
        }
      }
    }
  }
  put_ll(xc.x.pll, ll);
  __syncthreads();
  if (c0 + ct < C && lane == 0)
    part[((size_t)blockIdx.y * C + c0 + ct) * (p.d + 1) + p.d] =
        sum_ll(xc.x.pll, ct, kTrajWarps);
}

// Sum each chain's partials over the splits in split order, then apply the
// prior as the HMC kernels do: g = acc - pg, lp = ll - 1/2 sum pg theta with
// pg = lam theta, or (theta A)_j = sum_k theta_k A[k, j] with the matrix.
// One warp a chain: lane l takes the coordinates l + 32 i (the d^2 of the
// matrix term spread over the lanes, A's rows read coalesced), and the
// lanes' shares of sum pg theta meet in a butterfly of fixed order.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(int C, int d, int splits, float lam,
              const float* __restrict__ lamv, const float* __restrict__ lamm,
              const float* __restrict__ th_in,
              const double* __restrict__ part, float* __restrict__ g_out,
              float* __restrict__ lp_out) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;  // whole warps
  const size_t row = (size_t)C * (d + 1);
  const double* pc = part + (size_t)c * (d + 1);
  const float* thc = th_in + (size_t)c * d;
  float quad = 0.f;
  for (int j = lane; j < d; j += 32) {
    double s = 0.0;
    for (int k = 0; k < splits; ++k) s += pc[k * row + j];
    const float th = thc[j];
    float pg = 0.f;
    if (lamm) {
      for (int k = 0; k < d; ++k) pg = fmaf(thc[k], lamm[(size_t)k * d + j], pg);
    } else {
      pg = (lamv ? lamv[j] : lam) * th;
    }
    g_out[(size_t)c * d + j] = (float)s - pg;
    quad = fmaf(pg, th, quad);
  }
  for (int o = 16; o > 0; o >>= 1) quad += __shfl_xor_sync(0xffffffffu, quad, o);
  if (lane) return;
  double ll = 0.0;
  for (int k = 0; k < splits; ++k) ll += pc[k * row + d];
  lp_out[c] = (float)(ll - 0.5 * (double)quad);
}

}  // namespace

extern "C" {

int bign_max_dim() { return kXChunkDMax; }

const char* bign_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// How partial_tile_kernel (d <= 32), partial_wide_kernel,
// partial_xwide_kernel (d > kWideMax) or partial_xchunk_kernel (d >
// kXWideMax) runs at d: blocks resident per SM (from the occupancy
// calculator) and dynamic shared memory per block.  Returns a CUDA error
// code.
int glm_tiled_plan(int d, int* blocks_per_sm, int* smem) {
  const int D = glm_bound_for(d);
  if (!D) return (int)cudaErrorInvalidValue;
  if (D > kXWideMax) {
    const TrajPlan tp = xchunk_plan(d);
    if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
    *smem = (int)tp.smem;
    cudaError_t e = prepare(partial_xchunk_kernel, tp.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, partial_xchunk_kernel, kTrajThreads, tp.smem);
    return (int)e;
  }
  if (D > kWideMax) {
    const TrajPlan tp = xwide_plan(D);
    if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
    *smem = (int)tp.smem;
    cudaError_t e = prepare(partial_xwide_kernel, tp.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, partial_xwide_kernel, kTrajThreads, tp.smem);
    return (int)e;
  }
  if (D > kNarrowMax) {
    const TrajPlan tp = wide_plan(D, 0, false);
    if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
    *smem = (int)tp.smem;
    cudaError_t e = prepare(partial_wide_kernel, tp.smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, partial_wide_kernel, kTrajThreads, tp.smem);
    return (int)e;
  }
  *smem = (int)partial_smem(D);
#define PLAN(DD)                                                            \
  {                                                                         \
    cudaError_t e = prepare(partial_tile_kernel<DD>, partial_smem(DD));     \
    if (e == cudaSuccess)                                                   \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
          blocks_per_sm, partial_tile_kernel<DD>, kThreads,                 \
          partial_smem(DD));                                                \
    if (e != cudaSuccess) return (int)e;                                    \
  }
  TILE_DISPATCH(D, PLAN)
#undef PLAN
  return 0;
}

// part: (splits, C, d + 1) doubles of scratch.  Every split must hold at
// least one observation: ceil(N / ceil(N / splits)) == splits.  The grid
// takes chains 128 a CTA for d <= 32, 16 above (ops/glm_bign.py
// splits_for).  The prior's reduce_kernel takes every d (its matrix term
// d^2 a chain, A's rows read coalesced).
int glm_logp_grad_tiled(const float* xt, const float* y, const float* w,
                        const float* o, const float* lamv, const float* lamm,
                        int N, int d, int C, const float* th_in, float* g_out,
                        float* lp_out, double* part, int splits, float lam,
                        int kind, void* stream) {
  const int D = glm_bound_for(d);
  if (!D || C < 1 || N < 1 || kind < 0 || kind > 3 || splits < 1 ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = (N + splits - 1) / splits;
  if ((N + rows - 1) / rows != splits) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D > kXWideMax) {
    const TrajPlan tp = xchunk_plan(d);
    if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
    const Glm p{xt, y, w, o, lamv, lamm, N, d, kind, lam, tp.rows, false};
    const dim3 grid((C + kTileChains - 1) / kTileChains, splits);
    cudaError_t e = prepare(partial_xchunk_kernel, tp.smem);
    if (e != cudaSuccess) return (int)e;
    partial_xchunk_kernel<<<grid, kTrajThreads, tp.smem, st>>>(p, C, rows,
                                                               th_in, part);
  } else if (D > kWideMax) {
    const TrajPlan tp = xwide_plan(D);
    if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
    const Glm p{xt, y, w, o, lamv, lamm, N, d, kind, lam, tp.rows, false};
    const dim3 grid((C + kTileChains - 1) / kTileChains, splits);
    cudaError_t e = prepare(partial_xwide_kernel, tp.smem);
    if (e != cudaSuccess) return (int)e;
    partial_xwide_kernel<<<grid, kTrajThreads, tp.smem, st>>>(p, C, rows,
                                                              th_in, part);
  } else if (D > kNarrowMax) {
    const TrajPlan tp = wide_plan(D, N, false);
    if (!tp.rows) return (int)cudaErrorInvalidConfiguration;
    const Glm p{xt, y, w, o, lamv, lamm, N, d, kind, lam, tp.rows, false};
    const dim3 grid((C + kTileChains - 1) / kTileChains, splits);
    cudaError_t e = prepare(partial_wide_kernel, tp.smem);
    if (e != cudaSuccess) return (int)e;
    partial_wide_kernel<<<grid, kTrajThreads, tp.smem, st>>>(p, C, rows,
                                                             th_in, part);
  } else {
    const Glm p{xt, y, w, o, lamv, lamm, N, d, kind, lam, kTile, false};
    const dim3 grid((C + kChains - 1) / kChains, splits);
#define LAUNCH(DD)                                                          \
  {                                                                         \
    const size_t smem = partial_smem(DD);                                   \
    cudaError_t e = prepare(partial_tile_kernel<DD>, smem);                 \
    if (e != cudaSuccess) return (int)e;                                    \
    partial_tile_kernel<DD><<<grid, kThreads, smem, st>>>(p, C, rows,       \
                                                          th_in, part);     \
  }
    TILE_DISPATCH(D, LAUNCH)
#undef LAUNCH
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(C + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      C, d, splits, lam, lamv, lamm, th_in, part, g_out, lp_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
