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
// diagonal-metric fold of the warm-start pipeline).
//
// What bounds it on the H100: per chain and observation 2d FMAs (the two
// skinny products theta X^T and r X) and one link evaluation (logistic:
// expf, a reciprocal and log1pf, 3-4 special-function results at 16 per
// clock per SM).  At C = 4096, N = 100,000, d = 10 that is 1.6e10 FLOP,
// 0.25 ms at the 67 TFLOP/s FP32 peak, and 4.1e8 links, about 0.35-0.45 ms
// on the special-function units; X (4 MB) stays in the 50 MB L2 across
// chain blocks, so bytes do not bound it.  At C = 1024, N = 1,000,000 X is
// 40 MB, read once per chain block: about 1 ms of links.
//
// Design.  The TPU walks the observation tiles in order and accumulates into
// output blocks that stay resident.  On Hopper blocks run in no order, so:
// - the grid is (chain blocks of 128, splits of N): each CTA takes 128
//   chains, one thread per chain with theta and the gradient accumulator in
//   registers (d <= 32), and one contiguous range of observations; the
//   wrapper picks the number of splits so that a few hundred CTAs fill the
//   132 SMs even at 512 chains;
// - each CTA stages its rows in shared memory tile by tile (every thread of
//   a warp reads the same row: a broadcast), and the last, ragged tile is
//   simply shorter: no padded rows, no zero weights;
// - each CTA writes one partial (g, ll) per chain, in double, to scratch the
//   wrapper allocates, and a second small kernel sums the partials of each
//   chain over the splits in a fixed order and applies the prior once.
// No float atomics, so two launches on the same inputs give the same bits.
// The gradient accumulates in float within a tile and in double across
// tiles; the log-likelihood in double throughout, as glm_eval does.
// One thread per chain on the CUDA cores came first because it is simple;
// wgmma for the two skinny products is later work.
//
// Every entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "glm_common.cuh"

namespace {

constexpr int kThreads = 128;  // chains per block
constexpr int kTile = 256;     // observation rows staged per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
partial_kernel(Glm p, int C, int rows_per_split,
               const float* __restrict__ th_in, double* __restrict__ part) {
  extern __shared__ float sm[];
  const int S = stride_for(D);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int cc = c < C ? c : C - 1;  // idle threads shadow the last chain
  const int n0 = blockIdx.y * rows_per_split;
  const int n1 = min(p.N, n0 + rows_per_split);
  float th[D];
  load_vec<D>(th, th_in, cc, p.d);
  double gsum[D];
#pragma unroll
  for (int j = 0; j < D; ++j) gsum[j] = 0.0;
  double ll_sum = 0.0;
  for (int t0 = n0; t0 < n1; t0 += kTile) {
    const int nt = min(kTile, n1 - t0);
    __syncthreads();
    load_rows<D>(p, sm, t0, nt);
    __syncthreads();
    float acc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = 0.f;
    for (int i = 0; i < nt; ++i) {
      const float* row = sm + i * S;
      float z = row[D + 2];
#pragma unroll
      for (int j = 0; j < D; ++j) z = fmaf(th[j], row[j], z);
      float r, ll;
      link(p.kind, z, row[D], true, r, ll);
      const float wn = row[D + 1];
      r *= wn;
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] = fmaf(r, row[j], acc[j]);
      ll_sum += (double)(wn * ll);
    }
#pragma unroll
    for (int j = 0; j < D; ++j) gsum[j] += (double)acc[j];
  }
  if (c < C) {
    double* out = part + ((size_t)blockIdx.y * C + c) * (p.d + 1);
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (j < p.d) out[j] = gsum[j];
    out[p.d] = ll_sum;
  }
}

// Sum each chain's partials over the splits in split order, then apply the
// prior as glm_eval does: g = acc - lam theta, lp = ll - 1/2 sum lam theta^2.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(int C, int d, int splits, float lam,
              const float* __restrict__ lamv, const float* __restrict__ th_in,
              const double* __restrict__ part, float* __restrict__ g_out,
              float* __restrict__ lp_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t row = (size_t)C * (d + 1);
  const double* pc = part + (size_t)c * (d + 1);
  float quad = 0.f;
  for (int j = 0; j < d; ++j) {
    double s = 0.0;
    for (int k = 0; k < splits; ++k) s += pc[k * row + j];
    const float th = th_in[(size_t)c * d + j];
    const float pg = (lamv ? lamv[j] : lam) * th;
    g_out[(size_t)c * d + j] = (float)s - pg;
    quad = fmaf(pg, th, quad);
  }
  double ll = 0.0;
  for (int k = 0; k < splits; ++k) ll += pc[k * row + d];
  lp_out[c] = (float)(ll - 0.5 * (double)quad);
}

}  // namespace

extern "C" {

int bign_max_dim() { return 32; }

const char* bign_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// part: (splits, C, d + 1) doubles of scratch.  Every split must hold at
// least one observation: ceil(N / ceil(N / splits)) == splits.
int glm_logp_grad_tiled(const float* xt, const float* y, const float* w,
                        const float* o, const float* lamv, int N, int d,
                        int C, const float* th_in, float* g_out,
                        float* lp_out, double* part, int splits, float lam,
                        int kind, void* stream) {
  const int D = bound_for(d);
  if (!D || C < 1 || N < 1 || kind < 0 || kind > 3 || splits < 1 ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = (N + splits - 1) / splits;
  if ((N + rows - 1) / rows != splits) return (int)cudaErrorInvalidValue;
  const Glm p{xt, y, w, o, lamv, N, d, kind, lam, kTile, false};
  const dim3 grid((C + kThreads - 1) / kThreads, splits);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(DD)                                                          \
  {                                                                         \
    const size_t smem = (size_t)kTile * stride_for(DD) * sizeof(float);     \
    partial_kernel<DD><<<grid, kThreads, smem, st>>>(p, C, rows, th_in,     \
                                                     part);                 \
  }
  GLM_DISPATCH(D, LAUNCH)
#undef LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      C, d, splits, lam, lamv, th_in, part, g_out, lp_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
