// The lane layout of the custom-target kernels at d <= 32 (target_hmc.cu's
// trajectory, multistep and gradient kernels, target_rwm.cu's RWM kernel,
// target_nuts.cu's NUTS kernel): one chain per lane, 32 chains a group, W
// warps a block sharing the group's coordinates (coordinate j in warp
// j % W).
//
// The loop over a warp's coordinates is outer and the same for every lane,
// so each coordinate's family (code[j], read from the rows in shared memory)
// is a warp-uniform branch taken with all lanes active; in the warp-per-chain
// layout (target_common.cuh) a warp's lanes hold different coordinates and
// every distinct family of a row runs serially.  That loop is not unrolled
// (lane_family), so a kernel holds one copy of the ten families' code, and
// its operands pass through shared memory laid out [array][coordinate][lane]
// so that a warp's access hits 32 banks.  A per-chain sum (lp, |m|^2, a dot)
// is a sum inside each thread over its warp's coordinates, then a sum of the
// W warps' partials in warp order after one barrier (partial_at,
// partial_sum): the same bits in every warp, so the W warps keep the same
// per-chain state and take the same decisions.
//
// A dense target (target_common.cuh) mixes the coordinates: each gradient
// pass is an exchange between the W warps.  Every warp writes its
// coordinates of z into a (D, 32) array; after a block barrier each forms
// its coordinates of theta = z L' into the family loop's array
// (lane_dense_theta, L staged in shared memory, a broadcast read); the
// family loop runs on theta in place; after a second barrier each forms its
// coordinates of g_z = g_theta L from every warp's g_theta
// (lane_dense_grad).  Two barriers a pass, which every warp of the block
// reaches, those that own no coordinate too.
//
// Everything here sits in an anonymous namespace: each source that includes
// it is built into a library of its own.
#pragma once

#include "target_common.cuh"

namespace {

constexpr int kLaneDMax = 32;  // largest d of the lane layout
// Warps that share a group's coordinates: always in the RWM and NUTS
// kernels, in target_hmc.cu's kernels once their groups outnumber the SMs
// (target_hmc.cu lane_warps; PERF.md section 6)
constexpr int kLaneWarps = 4;

// The lane layout's template bound for d: 8, 16 or 32 (0 outside 1..32).
int lane_bound_for(int d) {
  return d < 1 ? 0 : d <= 8 ? 8 : d <= 16 ? 16 : d <= kLaneDMax ? 32 : 0;
}

// Bytes of the d rows at the head of a lane kernel's shared memory, rounded
// up so that the float arrays after them stay 16-byte aligned.
__host__ __device__ constexpr size_t lane_rows_bytes(int d) {
  return ((size_t)d * sizeof(Row) + 15) & ~(size_t)15;
}

template <int D>
__device__ __forceinline__ float* lane_at(float* arr, int which, int j) {
  return arr + ((size_t)which * D + j) * kWarp + (threadIdx.x & (kWarp - 1));
}

// Warp w of a block owns coordinates j = w + W jj, jj < D / W: its slots of
// the register rows and of the shared arrays.
template <int W>
__host__ __device__ constexpr int lane_slots(int D) {
  return D / W;
}

template <int W>
__device__ __forceinline__ int lane_coord(int jj) {
  return (int)(threadIdx.x / kWarp) + W * jj;
}

// How many of the d coordinates this thread's warp owns.
template <int W>
__device__ __forceinline__ int lane_owned(int d) {
  return (d - (int)(threadIdx.x / kWarp) + W - 1) / W;
}

// Warp v's partial q of this lane (buffer buf), and the sum of the
// block's warps' partial q in warp order: the same bits in every warp.
template <int W>
__device__ __forceinline__ float* partial_at(float* xch, int nq, int buf,
                                             int v, int q) {
  return xch + (((size_t)buf * W + v) * nq + q) * kWarp +
         (threadIdx.x & (kWarp - 1));
}

template <int W>
__device__ __forceinline__ float partial_sum(float* xch, int nq, int buf,
                                             int q) {
  float s = *partial_at<W>(xch, nq, buf, 0, q);
#pragma unroll
  for (int v = 1; v < W; ++v) s += *partial_at<W>(xch, nq, buf, v, q);
  return s;
}

// The family terms of this warp's coordinates at the points x[j][lane]
// (shared memory, (D, 32)): returns the sum of their log-densities
// (WANT_LP) and, with WANT_G, leaves each derivative in place of its point.
// The loop is not unrolled: one copy of the ten families' code.
template <int D, int W, bool WANT_LP, bool WANT_G>
__device__ __forceinline__ float lane_family(const Row* rows, float* x,
                                             int nown) {
  float part = 0.f;
#pragma unroll 1
  for (int jj = 0; jj < nown; ++jj) {
    const int j = lane_coord<W>(jj);
    float* xp = lane_at<D>(x, 0, j);
    float dl;
    const float l = family_eval<WANT_LP, WANT_G>(rows[j], *xp, dl);
    if (WANT_G) *xp = dl;
    if (WANT_LP) part += l;
  }
  return part;
}

// Dense targets: theta_j = sum over k <= j of L_jk z_k (k ascending) for
// this warp's coordinates j, into x (D, 32), from every warp's z (D, 32),
// after the block barrier that publishes z.  Ls is L, (d, d) row-major in
// shared memory.
template <int D, int W>
__device__ __forceinline__ void lane_dense_theta(const float* Ls, float* z,
                                                 float* x, int d, int nown) {
  __syncthreads();
#pragma unroll 1
  for (int jj = 0; jj < nown; ++jj) {
    const int j = lane_coord<W>(jj);
    const float* row = Ls + j * d;
    float t = 0.f;
    for (int k = 0; k <= j; ++k) t = fmaf(row[k], *lane_at<D>(z, 0, k), t);
    *lane_at<D>(x, 0, j) = t;
  }
}

// Dense targets: g_z,k = sum over j >= k of L_jk g_theta,j (j ascending)
// for this warp's coordinates k, into g (zero past d), from every warp's
// g_theta in x, after the block barrier that publishes it.
template <int D, int W>
__device__ __forceinline__ void lane_dense_grad(const float* Ls, float* x,
                                                int d,
                                                float (&g)[lane_slots<W>(D)]) {
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < lane_slots<W>(D); ++jj) {
    const int k = lane_coord<W>(jj);
    float t = 0.f;
    for (int j = k; j < d; ++j)
      t = fmaf(Ls[j * d + k], *lane_at<D>(x, 0, j), t);
    g[jj] = t;
  }
}

// Stage L, (d, d) from the head of a dense target's factor, at Ls in
// shared memory (every thread calls it; the caller's first barrier
// publishes it).
__device__ __forceinline__ void lane_stage_factor(const float* L, float* Ls,
                                                  int d) {
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) Ls[i] = L[i];
}

// Stage the d rows at the head of the block's shared memory (every thread
// calls it; the caller's first barrier publishes them).
__device__ __forceinline__ Row* lane_rows(const Target& t, void* smem) {
  Row* rows = reinterpret_cast<Row*>(smem);
  for (int j = threadIdx.x; j < t.d; j += blockDim.x)
    rows[j] = Row{t.codes[j], t.params[4 * j], t.params[4 * j + 1],
                  t.params[4 * j + 2], t.params[4 * j + 3]};
  return rows;
}

// A launch: the kernel, its grid and its dynamic shared memory.
template <typename K>
struct LaneLaunch {
  K kernel;
  int blocks, threads;
  size_t smem;
};

// Raise the kernel's dynamic shared memory limit when a launch needs more
// than the default 48 KB.
template <typename K>
cudaError_t lane_prepare(const LaneLaunch<K>& L) {
  if (L.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(L.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)L.smem);
}

// The launch's plan: blocks, blocks resident per SM (from the occupancy
// calculator), threads and dynamic shared memory per block.
template <typename K>
int lane_plan(const LaneLaunch<K>& L, int* blocks, int* blocks_per_sm,
              int* threads, int* smem) {
  *blocks = L.blocks;
  *threads = L.threads;
  *smem = (int)L.smem;
  cudaError_t e = lane_prepare(L);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, L.kernel,
                                                      L.threads, L.smem);
  return (int)e;
}

}  // namespace

extern "C" {

// The largest d launched with one chain per lane; above it, one warp per
// chain (ops/target_kernels.py LANE_D_MAX).
int target_lane_max_dim() { return kLaneDMax; }

}  // extern "C"
