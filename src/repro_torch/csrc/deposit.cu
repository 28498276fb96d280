// CIC charge deposition (particle -> grid scatter) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `deposit_tpu` / `_deposit_kernel` of
// src/repro/kernels/deposit/kernel.py. That kernel restates the scatter as
// one-hot matmuls because the TPU has no scatter atomics; a GPU has them,
// so this is the scatter itself.
//
// It computes, for every particle p with w_p * alive_p != 0,
//   xi = x_p / dx (IEEE fp32 division), i0 = floor(xi), frac = xi - i0,
//   rho[clip(i0)]     += w_p * alive_p * (1 - frac)
//   rho[clip(i0 + 1)] += w_p * alive_p * frac
// with clip to [0, n_cells - 1], as src/repro/pic/grid.py::deposit_cic does.
// The caller zeroes rho and divides it by dx afterwards. Atomic order
// varies from run to run, so results agree with the plain version within
// rounding, not bitwise.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads x, w and alive once
// (12 B a particle) and writes rho once (4 B a cell), so it is bound by
// bytes (0.12 ms at N = 2^25); the ~10 flops a particle are far below the
// fp32 rate. The first version made two fp32 atomicAdds a particle into
// rho in L2 (67 M at N = 2^25) and ran at 18 % of that bound.
//
// Design: the grid is privatised in shared memory, cell-tiled over the
// blocks of a thread-block cluster. The 100,000-cell fp32 grid (400 KB)
// does not fit one block's 227 KB, but it fits kCluster = 2 blocks that
// each own a contiguous range of ceil(n_cells / 2) cells in their shared
// memory. Both blocks of a cluster stream the same share of the particles
// (the cluster is scheduled at once, so the second read of a tile is an L2
// hit and device memory sees each byte about once), with 16-byte loads of
// x, w and alive, the next tile's in flight while one is added (scalar
// loads for a tail, or throughout when a pointer is not 16-byte aligned).
// Each block adds only the weights that land in its own cells, with
// shared atomics; a particle whose cells x * (1/dx) puts
// clearly outside the block's range (more than a cell away: the product
// is within 1/16 of a cell of the IEEE quotient below 2^18 cells) skips
// the division. After a barrier each block adds its nonzero cells into rho
// once: one global atomic per nonzero cell per cluster, to consecutive
// addresses, instead of two random ones per particle.
// Measured while designing (variant builds, not kept): adding into the
// partner block's cells through distributed shared memory
// (`cluster.map_shared_rank`) was slower than the first version, since an
// fp32 atomic on shared memory is a compare-and-swap loop on this card
// (ATOMS.CAST.SPIN, and ATOM.E.CAST.SPIN for the remote one); clusters of
// 4 (two blocks an SM) and 512 threads a block were slower too.
// A grid larger than kCluster * 58,112 cells (the cluster's shared memory)
// takes the global-atomic loop below, the first version's scatter with the
// same 16-byte loads. The entry point reports which path ran.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

#ifndef DEPOSIT_CLUSTER  // -DDEPOSIT_CLUSTER=4 builds chip_variants.py's
#define DEPOSIT_CLUSTER 2  // other variant
#endif
constexpr int kCluster = DEPOSIT_CLUSTER;  // blocks a cluster
constexpr int kThreads = 1024;
constexpr int kMaxSmem = 232448;  // shared memory a block may use (227 KB)
constexpr int kMaxCellsPerBlock = kMaxSmem / 4;
constexpr int kGlobalThreads = 256;
constexpr int kGlobalMaxBlocks = 132 * 8;  // grid-stride: 8 blocks an SM

enum Path { kPathCluster = 1, kPathGlobal = 2 };

// calls add(cell, weight) for the two CIC weights of every live particle
// p = first, first + stride, ... for which near(x_p) holds
template <typename Near, typename Add>
__device__ __forceinline__ void scatter(const float* __restrict__ x,
                                        const float* __restrict__ w,
                                        const float* __restrict__ alive,
                                        long long n, int n_cells, float dx,
                                        bool vec, long long first,
                                        long long stride, Near near,
                                        Add add) {
  const int clip_max = n_cells - 1;
  auto one = [&](float xp, float wp, float ap) {
    const float wa = wp * ap;
    if (wa == 0.0f || !near(xp)) return;
    const float xi = __fdiv_rn(xp, dx);
    const int i0 = (int)floorf(xi);
    const float frac = xi - (float)i0;
    add(min(max(i0, 0), clip_max), wa * (1.0f - frac));
    add(min(max(i0 + 1, 0), clip_max), wa * frac);
  };
  long long done = 0;
  // 16-byte loads; the next step's are issued before this step's adds, so
  // two steps' loads are in flight
  if (vec) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* a4 = reinterpret_cast<const float4*>(alive);
    float4 xv, wv, av;
    if (first < n4) {
      xv = __ldg(x4 + first);
      wv = __ldg(w4 + first);
      av = __ldg(a4 + first);
    }
    for (long long q = first; q < n4; q += stride) {
      float4 xn, wn, an;
      if (q + stride < n4) {
        xn = __ldg(x4 + q + stride);
        wn = __ldg(w4 + q + stride);
        an = __ldg(a4 + q + stride);
      }
      one(xv.x, wv.x, av.x);
      one(xv.y, wv.y, av.y);
      one(xv.z, wv.z, av.z);
      one(xv.w, wv.w, av.w);
      xv = xn;
      wv = wn;
      av = an;
    }
    done = n4 << 2;
  }
  for (long long i = done + first; i < n; i += stride)
    one(__ldg(x + i), __ldg(w + i), __ldg(alive + i));
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
deposit_cic_cluster_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ alive,
                           float* __restrict__ rho, long long n, int n_cells,
                           int cpb, float dx, float inv_dx, bool vec) {
  extern __shared__ float cells[];  // this block's cells [lo, hi)
  cg::cluster_group cluster = cg::this_cluster();
  const int lo = (int)cluster.block_rank() * cpb;
  const int hi = min(lo + cpb, n_cells);
  for (int i = threadIdx.x; i < cpb; i += blockDim.x) cells[i] = 0.0f;
  __syncthreads();

  // the blocks of a cluster read the same particles
  const long long first =
      (long long)(blockIdx.x / kCluster) * blockDim.x + threadIdx.x;
  const long long stride = (long long)(gridDim.x / kCluster) * blockDim.x;
  const int clip_max = n_cells - 1;
  const float top = (float)n_cells + 4.0f;
  scatter(
      x, w, alive, n, n_cells, dx, vec, first, stride,
      [&](float xp) {  // may a cell of [lo, hi) get a weight of xp?
        const int ia = (int)floorf(fminf(fmaxf(xp * inv_dx, -4.0f), top));
        return min(max(ia - 1, 0), clip_max) < hi &&
               min(max(ia + 2, 0), clip_max) >= lo;
      },
      [&](int cell, float v) {
        if (cell >= lo && cell < hi) atomicAdd(cells + (cell - lo), v);
      });
  __syncthreads();

  for (int i = threadIdx.x; i < hi - lo; i += blockDim.x) {
    const float v = cells[i];
    if (v != 0.0f) atomicAdd(rho + lo + i, v);
  }
}

__global__ void __launch_bounds__(kGlobalThreads)
deposit_cic_global_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ alive,
                          float* __restrict__ rho, long long n, int n_cells,
                          float dx, bool vec) {
  scatter(x, w, alive, n, n_cells, dx, vec,
          (long long)blockIdx.x * blockDim.x + threadIdx.x,
          (long long)gridDim.x * blockDim.x, [](float) { return true; },
          [&](int cell, float v) { atomicAdd(rho + cell, v); });
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// Cells the cluster path takes at most; a larger grid takes the global
// path.
extern "C" int jbp_deposit_cluster_cells(void) {
  return kCluster * kMaxCellsPerBlock;
}

// x, w, alive: float32[n]; rho: float32[n_cells], zeroed by the caller.
// Launches one kernel on `stream`, writes the path it took to *path
// (1 cluster, 2 global) and returns the CUDA error.
extern "C" int jbp_deposit_cic(const void* x, const void* w, const void* alive,
                               void* rho, long long n, int n_cells, float dx,
                               int* path, void* stream) {
  if (n <= 0 || n_cells <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(x) && aligned16(w) && aligned16(alive);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_cells > jbp_deposit_cluster_cells()) {
    long long blocks = (n + kGlobalThreads - 1) / kGlobalThreads;
    if (blocks > kGlobalMaxBlocks) blocks = kGlobalMaxBlocks;
    deposit_cic_global_kernel<<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)alive, (float*)rho, n,
        n_cells, dx, vec);
    *path = kPathGlobal;
    return (int)cudaGetLastError();
  }
  const int cpb = (n_cells + kCluster - 1) / kCluster;
  const int smem = cpb * 4;
  cudaError_t err = cudaFuncSetAttribute(
      deposit_cic_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  // as many clusters as are resident at once on this device
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)deposit_cic_cluster_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters <= 0) return (int)cudaErrorInvalidConfiguration;
  // each cluster reads kThreads particles (or float4s) a step
  const long long need = (n + kThreads - 1) / kThreads;
  if (need < clusters) clusters = (int)need;
  deposit_cic_cluster_kernel<<<clusters * kCluster, kThreads, smem, st>>>(
      (const float*)x, (const float*)w, (const float*)alive, (float*)rho, n,
      n_cells, cpb, dx, 1.0f / dx, vec);
  *path = kPathCluster;
  return (int)cudaGetLastError();
}
