// Fused random-walk Metropolis on catalog targets for Hopper (sm_90a): k
// whole RWM transitions per launch with a per-coordinate proposal scale.
//
// Replaces the Pallas kernel mcmc_jl_tpu/ops/pallas_rwm.py _rwm_kernel
// (fused_target_rwm_steps).  Its two noise modes carry over: "input" reads
// pre-drawn normals z (C, k, d) and log-uniforms (C, k), for exact
// comparisons with the plain version; "hw" draws them inside the kernel from
// Philox, counted by (chain, absolute step i0 + s, coordinate, stream) with
// the proposals on stream 2 and the MH uniform on stream 3 and keyed by a
// seed drawn per launch: Box-Muller normals and log(1 - u), as
// pallas_rwm.py:72-73 does.  ops/rwm_kernels.py rwm_draws replays these
// draws on the host for the plain version: change both together.
//
// What bounds it on the H100: a step is one log-density evaluation, d
// family terms of a few FP32 operations and one logf or so each, and a warp
// reduction; theta and lp stay in registers across the k steps, so in "hw"
// mode device memory sees theta once in and once out per launch and the
// bound is arithmetic.  In "input" mode the noise (4 (d + 1) bytes per chain
// and step) is read once and bounds it.
//
// Design: one warp per chain, lanes over coordinates, rows in shared memory
// (target_common.cuh).  The proposal theta + scale z is rounded as the plain
// PyTorch version rounds it (__fmul_rn, then __fadd_rn), so from the same
// noise the two see the same proposals and may part only where the MH ratio
// lies within rounding of log u.  A NaN ratio (-inf minus -inf) rejects.
//
// The entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "target_common.cuh"

namespace {

template <int CPL>
__global__ void __launch_bounds__(kThreads)
rwm_kernel(Target t, int C, int k_steps, int i0, uint2 key, int noise_hw,
           const float* __restrict__ th_in,
           const float* __restrict__ scale_row,
           const float* __restrict__ z_in, const float* __restrict__ logu_in,
           float* th_out, float* lp_out, float* acc_out) {
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
  for (int s = 0; s < k_steps; ++s) {
    const uint32_t ti = (uint32_t)(i0 + s);
    const size_t at = (size_t)c * k_steps + s;
    float prop[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int j = lane + kWarp * i;
      float z = 0.f;
      if (j < d) {
        if (noise_hw) {
          uint4 b = philox(make_uint4((uint32_t)c, ti, (uint32_t)j, 2u), key);
          z = box_muller(b.x, b.y);
        } else {
          z = z_in[at * d + j];
        }
      }
      prop[i] = __fadd_rn(th[i], __fmul_rn(sc[i], z));
    }
    float logu;
    if (noise_hw) {
      const uint4 bu = philox(make_uint4((uint32_t)c, ti, 0u, 3u), key);
      logu = logf(1.f - u01(bu.x));
    } else {
      logu = logu_in[at];
    }
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

}  // namespace

extern "C" {

int target_rwm_steps(const int* codes, const float* params, int d, int C,
                     const float* th_in, const float* scale_row,
                     const float* z, const float* logu, float* th_out,
                     float* lp_out, float* acc_out, int k_steps, int i0,
                     unsigned long long seed, int noise_hw, void* stream) {
  const int cpl = cpl_for(d);
  if (!cpl || C < 1 || k_steps < 1 || i0 < 0 ||
      (!noise_hw && (z == nullptr || logu == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Target t{codes, params, d};
  const size_t smem = (size_t)d * sizeof(Row);
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(CC)                                                          \
  {                                                                         \
    cudaError_t e = cudaFuncSetAttribute(                                   \
        rwm_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,        \
        (int)smem);                                                         \
    if (e != cudaSuccess) return (int)e;                                    \
    rwm_kernel<CC><<<blocks_for(C), kThreads, smem, st>>>(                  \
        t, C, k_steps, i0, key, noise_hw, th_in, scale_row, z, logu,        \
        th_out, lp_out, acc_out);                                           \
  }
  TARGET_DISPATCH(cpl, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
