// Fused random-walk Metropolis on catalog targets for Hopper (sm_90a): k
// whole RWM transitions per launch with a per-coordinate proposal scale.
//
// Replaces the Pallas kernel mcmc_jl_tpu/ops/pallas_rwm.py _rwm_kernel
// (fused_target_rwm_steps).  Its two noise modes carry over: "input" reads
// pre-drawn normals z (C, k, d) and log-uniforms (C, k), for exact
// comparisons with the plain version; "hw" draws them inside the kernel from
// Philox keyed by a seed drawn per launch.  One Philox call serves four
// absolute steps ti = 4q .. 4q + 3 of a coordinate: counter (chain, q,
// coordinate, stream 2) gives two Box-Muller pairs, the words (x, y) the
// normals of steps 4q and 4q + 1 (cosine and sine branches), (z, w) those of
// 4q + 2 and 4q + 3 (rwm_normals); the MH uniform of step ti is word ti % 4 of
// counter (chain, q, 0, stream 3), taken as log(1 - u) as pallas_rwm.py:72-73
// does.  ops/rwm_kernels.py rwm_draws replays these draws on the host for
// the plain version: change both together.
//
// What bounds it on the H100: in "hw" mode theta and lp stay in registers
// across the k steps and device memory sees theta once in and once out, so
// the arithmetic does: per coordinate and step a quarter of a Philox call
// (ten rounds of two 32 x 32 -> 64-bit products), half a logf and a sqrtf,
// a sinpif or cospif, the proposal and one family term (a few FP32
// operations and a division, a logf or powf for some families); per chain
// and step the sum and the test.  The random numbers are most of it.  In
// "input" mode the noise (4 (d + 1) bytes per chain and step) is read once
// and bounds it.
//
// Two layouts, chosen up front from d (rwm_launch_for):
//
// d <= 32 (rwm_lane_kernel, target_lane.cuh): one chain per lane, 32 chains
// a block, W = kLaneWarps warps sharing their coordinates (coordinate j in
// warp j % W).
// Per step each warp forms its coordinates' proposals from normals drawn
// four steps at a time into registers, adds their family terms into a
// partial in a loop over its coordinates that is the same for every lane
// (the family branch warp-uniform, one copy of the families' code), and the
// last warp adds the step's log-uniform; after one barrier every warp sums
// the W partials in warp order and takes the same accept decision on the
// same bits.  Lanes past C shadow chain C - 1 and store nothing.
//
// d > 32 (rwm_kernel): one warp per chain, four chains per 128-thread
// block, lanes over coordinates (target_common.cuh; CPL 4 or 32 per lane),
// the normals drawn four steps at a time into registers at CPL 4 and one
// step at a time at CPL 32.
//
// Both round the proposal theta + scale z as the plain PyTorch version does
// (__fmul_rn, then __fadd_rn), so from the same noise the two see the same
// proposals and may part only where the MH ratio lies within rounding of
// log u.  A NaN ratio (-inf minus -inf) rejects.
//
// The entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "target_lane.cuh"

namespace {

__device__ __forceinline__ float pick(float4 v, uint32_t r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// The four normals of coordinate j at the absolute steps 4q .. 4q + 3.
__device__ __forceinline__ float4 rwm_normals(uint32_t c, uint32_t q,
                                              uint32_t j, uint2 key) {
  const uint4 b = philox(make_uint4(c, q, j, 2u), key);
  const float r0 = sqrtf(-2.f * logf(1.f - u01(b.x)));
  const float r1 = sqrtf(-2.f * logf(1.f - u01(b.z)));
  const float t0 = 2.f * u01(b.y), t1 = 2.f * u01(b.w);
  return make_float4(r0 * cospif(t0), r0 * sinpif(t0), r1 * cospif(t1),
                     r1 * sinpif(t1));
}

// The MH log-uniforms log(1 - u) of the absolute steps 4q .. 4q + 3.
__device__ __forceinline__ float4 rwm_logus(uint32_t c, uint32_t q,
                                            uint2 key) {
  const uint4 b = philox(make_uint4(c, q, 0u, 3u), key);
  return make_float4(logf(1.f - u01(b.x)), logf(1.f - u01(b.y)),
                     logf(1.f - u01(b.z)), logf(1.f - u01(b.w)));
}

// The normal of coordinate j at absolute step ti alone (one branch): one
// cospif, the sine branch as cos(pi (t - 1/2)).  t lies on the 2^-23 grid
// in [0, 2), so t - 1/2 is exact and the result within cospif's ulp of
// sinpif(t).
__device__ __forceinline__ float rwm_normal(uint32_t c, uint32_t ti,
                                            uint32_t j, uint2 key) {
  const uint4 b = philox(make_uint4(c, ti >> 2, j, 2u), key);
  const bool hi = ti & 2u;
  const float r = sqrtf(-2.f * logf(1.f - u01(hi ? b.z : b.x)));
  const float t = 2.f * u01(hi ? b.w : b.y);
  return r * cospif((ti & 1u) ? t - 0.5f : t);
}

// The MH log-uniform of absolute step ti alone.
__device__ __forceinline__ float rwm_logu(uint32_t c, uint32_t ti,
                                          uint2 key) {
  const uint4 b = philox(make_uint4(c, ti >> 2, 0u, 3u), key);
  const uint32_t r = ti & 3u;
  return logf(1.f - u01(r == 0 ? b.x : r == 1 ? b.y : r == 2 ? b.z : b.w));
}

// At CPL 4 the normals come four steps a Philox call, cached in registers
// (rwm_normals); at CPL 32 one call a coordinate and step (rwm_normal): 32
// cached float4 do not fit in registers, and cached in shared memory (64
// KB a block, two blocks an SM) d 1000 ran 1.25x slower than drawing each
// step (PERF.md section 6).
template <int CPL>
__global__ void __launch_bounds__(kThreads)
rwm_kernel(Target t, int C, int k_steps, int i0, uint2 key, int noise_hw,
           const float* __restrict__ th_in,
           const float* __restrict__ scale_row,
           const float* __restrict__ z_in, const float* __restrict__ logu_in,
           float* th_out, float* lp_out, float* acc_out) {
  constexpr bool kCache = CPL <= 4;
  extern __shared__ Row rows[];
  stage_rows(t, rows);
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (c >= C) return;  // the whole warp: no barrier follows
  const int d = t.d;
  float th[CPL], sc[CPL];
  load_lane<CPL>(th, th_in, c, d, lane);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + kWarp * i;
    sc[i] = j < d ? scale_row[j] : 0.f;
  }
  float lp = eval_lp<CPL>(rows, d, lane, th);
  float n_acc = 0.f;
  float4 nz[kCache ? CPL : 1], lu = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < k_steps; ++s) {
    const uint32_t ti = (uint32_t)(i0 + s);
    const size_t at = (size_t)c * k_steps + s;
    if constexpr (kCache) {
      if (noise_hw && (s == 0 || (ti & 3u) == 0)) {  // warp-uniform
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int j = lane + kWarp * i;
          if (j < d)
            nz[i] = rwm_normals((uint32_t)c, ti >> 2, (uint32_t)j, key);
        }
        lu = rwm_logus((uint32_t)c, ti >> 2, key);
      }
    }
    float prop[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int j = lane + kWarp * i;
      float z = 0.f;
      if (j < d) {
        if (!noise_hw)
          z = z_in[at * d + j];
        else if constexpr (kCache)
          z = pick(nz[i], ti & 3u);
        else
          z = rwm_normal((uint32_t)c, ti, (uint32_t)j, key);
      }
      prop[i] = __fadd_rn(th[i], __fmul_rn(sc[i], z));
    }
    float logu;
    if (!noise_hw)
      logu = logu_in[at];
    else if constexpr (kCache)
      logu = pick(lu, ti & 3u);
    else
      logu = rwm_logu((uint32_t)c, ti, key);
    const float lpp = eval_lp<CPL>(rows, d, lane, prop);
    if (mh_accept(lpp - lp, logu)) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) th[i] = prop[i];
      lp = lpp;
      n_acc += 1.f;
    }
  }
  store_lane<CPL>(th_out, th, c, d, lane);
  if (lane == 0) {
    lp_out[c] = lp;
    acc_out[c] = n_acc / (float)k_steps;
  }
}

// Shared memory of the lane kernel after the rows: the family loop's
// operands (D, 32), then the warps' partials, two buffers of (W, 2, 32)
// floats: each warp's lp partial (q 0) and, from the last warp, the step's
// log-uniform (q 1).
size_t rwm_lane_smem(int d, int D, int W) {
  return lane_rows_bytes(d) +
         sizeof(float) * ((size_t)D * kWarp + (size_t)2 * W * 2 * kWarp);
}

// One chain per lane; the W warps of a block share the coordinates of the
// block's 32 chains and take every accept decision on the same bits.
template <int D, int W>
__global__ void __launch_bounds__(W * kWarp)
rwm_lane_kernel(Target t, int C, int k_steps, int i0, uint2 key,
                int noise_hw, const float* __restrict__ th_in,
                const float* __restrict__ scale_row,
                const float* __restrict__ z_in,
                const float* __restrict__ logu_in, float* th_out,
                float* lp_out, float* acc_out) {
  constexpr int DW = lane_slots<W>(D);
  extern __shared__ float4 lane_sm[];
  const int d = t.d;
  const Row* rows = lane_rows(t, lane_sm);
  float* x = reinterpret_cast<float*>(reinterpret_cast<char*>(lane_sm) +
                                      lane_rows_bytes(d));
  float* xch = x + D * kWarp;  // [buf][warp][lp, log u][lane]
  const int w = threadIdx.x / kWarp;
  const int nown = lane_owned<W>(d);
  const bool draws_u = w == W - 1;  // the warp that adds the log-uniform
  const int c0 = blockIdx.x * kWarp + (threadIdx.x & (kWarp - 1));
  const int c = min(c0, C - 1);

  float th[DW], sc[DW];
#pragma unroll
  for (int jj = 0; jj < DW; ++jj) {
    const int j = lane_coord<W>(jj);
    th[jj] = j < d ? th_in[(size_t)c * d + j] : 0.f;
    sc[jj] = j < d ? scale_row[j] : 0.f;
    if (j < d) *lane_at<D>(x, 0, j) = th[jj];
  }
  __syncthreads();  // the rows
  int buf = 0;
  *partial_at<W>(xch, 2, buf, w, 0) =
      lane_family<D, W, true, false>(rows, x, nown);
  __syncthreads();
  float lp = partial_sum<W>(xch, 2, buf, 0);
  buf ^= 1;

  float n_acc = 0.f;
  float4 nz[DW], lu = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < k_steps; ++s) {
    const uint32_t ti = (uint32_t)(i0 + s);
    const size_t at = (size_t)c * k_steps + s;
    if (noise_hw && (s == 0 || (ti & 3u) == 0)) {  // block-uniform
#pragma unroll
      for (int jj = 0; jj < DW; ++jj)
        if (lane_coord<W>(jj) < d)
          nz[jj] = rwm_normals((uint32_t)c, ti >> 2,
                               (uint32_t)lane_coord<W>(jj), key);
      if (draws_u) lu = rwm_logus((uint32_t)c, ti >> 2, key);
    }
    float prop[DW];
#pragma unroll
    for (int jj = 0; jj < DW; ++jj) {
      const int j = lane_coord<W>(jj);
      float z = 0.f;  // past d: th and the scale are 0, so is the proposal
      if (j < d) z = noise_hw ? pick(nz[jj], ti & 3u) : z_in[at * d + j];
      prop[jj] = __fadd_rn(th[jj], __fmul_rn(sc[jj], z));
      if (j < d) *lane_at<D>(x, 0, j) = prop[jj];
    }
    *partial_at<W>(xch, 2, buf, w, 0) =
        lane_family<D, W, true, false>(rows, x, nown);
    if (draws_u)
      *partial_at<W>(xch, 2, buf, w, 1) =
          noise_hw ? pick(lu, ti & 3u) : logu_in[at];
    __syncthreads();
    const float lpp = partial_sum<W>(xch, 2, buf, 0);
    const float logu = *partial_at<W>(xch, 2, buf, W - 1, 1);
    buf ^= 1;
    if (mh_accept(lpp - lp, logu)) {
#pragma unroll
      for (int jj = 0; jj < DW; ++jj) th[jj] = prop[jj];
      lp = lpp;
      n_acc += 1.f;
    }
  }
  if (c0 < C) {
#pragma unroll
    for (int jj = 0; jj < DW; ++jj) {
      const int j = lane_coord<W>(jj);
      if (j < d) th_out[(size_t)c * d + j] = th[jj];
    }
    if (w == 0) {
      lp_out[c] = lp;
      acc_out[c] = n_acc / (float)k_steps;
    }
  }
}

using RwmKernel = void (*)(Target, int, int, int, uint2, int, const float*,
                           const float*, const float*, const float*, float*,
                           float*, float*);

// The kernel, grid and shared memory of a launch at (d, C), the layout
// decided from d alone: one chain per lane with kLaneWarps warps a block at
// d <= 32, one warp per chain above.  False when the kernels do not take it.
bool rwm_launch_for(int d, int C, LaneLaunch<RwmKernel>* L) {
  if (d < 1 || d > kMaxDim || C < 1) return false;
  const int D = lane_bound_for(d);
  if (!D) {
    L->kernel = cpl_for(d) == 4 ? rwm_kernel<4> : rwm_kernel<32>;
    L->blocks = blocks_for(C);
    L->threads = kThreads;
    L->smem = (size_t)d * sizeof(Row);
    return true;
  }
  L->kernel = D == 8    ? rwm_lane_kernel<8, kLaneWarps>
              : D == 16 ? rwm_lane_kernel<16, kLaneWarps>
                        : rwm_lane_kernel<32, kLaneWarps>;
  L->blocks = (C + kWarp - 1) / kWarp;
  L->threads = kLaneWarps * kWarp;
  L->smem = rwm_lane_smem(d, D, kLaneWarps);
  return true;
}

}  // namespace

extern "C" {

int target_rwm_steps(const int* codes, const float* params, int d, int C,
                     const float* th_in, const float* scale_row,
                     const float* z, const float* logu, float* th_out,
                     float* lp_out, float* acc_out, int k_steps, int i0,
                     unsigned long long seed, int noise_hw, void* stream) {
  LaneLaunch<RwmKernel> L;
  if (!rwm_launch_for(d, C, &L) || k_steps < 1 || i0 < 0 ||
      (!noise_hw && (z == nullptr || logu == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = lane_prepare(L);
  if (e != cudaSuccess) return (int)e;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  L.kernel<<<L.blocks, L.threads, L.smem, (cudaStream_t)stream>>>(
      Target{codes, params, d}, C, k_steps, i0, key, noise_hw, th_in,
      scale_row, z, logu, th_out, lp_out, acc_out);
  return (int)cudaGetLastError();
}

// How a launch at (d, C) runs: blocks, blocks resident per SM, threads and
// dynamic shared memory per block.
int target_rwm_plan(int d, int C, int* blocks, int* blocks_per_sm,
                    int* threads, int* smem) {
  LaneLaunch<RwmKernel> L;
  if (!rwm_launch_for(d, C, &L)) return (int)cudaErrorInvalidValue;
  return lane_plan(L, blocks, blocks_per_sm, threads, smem);
}

}  // extern "C"
