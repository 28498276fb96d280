// CIC charge deposition (particle -> grid scatter) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `deposit_tpu` / `_deposit_kernel` of
// src/repro/kernels/deposit/kernel.py. That kernel restates the scatter as
// one-hot matmuls because the TPU has no scatter atomics; a GPU has them, so
// this kernel is the plain scatter: one thread per particle, two float
// atomicAdds into rho in global memory.
//
// It computes, for every particle p with w_p * alive_p != 0,
//   xi = x_p / dx (IEEE fp32 division), i0 = floor(xi), frac = xi - i0,
//   rho[clip(i0)]     += w_p * alive_p * (1 - frac)
//   rho[clip(i0 + 1)] += w_p * alive_p * frac
// with clip to [0, n_cells - 1], as src/repro/pic/grid.py::deposit_cic does.
// The caller zeroes rho and divides it by dx afterwards.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads x, w and alive once
// (12 B a particle) and writes rho once (4 B a cell), so it is bound by
// bytes; the ~10 flops a particle are far below the fp32 rate. The two
// atomics a particle add 8 B of L2 traffic each; with 100,000 cells (400 KB
// of fp32) rho stays resident in the 50 MB L2, so the atomics resolve there
// and device memory sees mostly the streaming reads. Privatising rho in
// shared memory needs cell tiling at this grid size (400 KB > 227 KB a
// block) and is left for a later change. Atomic order varies from run to
// run, so results agree with the plain version within rounding, not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;   // grid-stride: 32 blocks per SM

__global__ void deposit_cic_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ alive,
                                   float* __restrict__ rho, long long n,
                                   int n_cells, float dx) {
  const int clip_max = n_cells - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const float wa = w[p] * alive[p];
    if (wa == 0.0f) continue;
    const float xi = __fdiv_rn(x[p], dx);
    const int i0 = (int)floorf(xi);
    const float frac = xi - (float)i0;
    const int i0c = min(max(i0, 0), clip_max);
    const int i1c = min(max(i0 + 1, 0), clip_max);
    atomicAdd(rho + i0c, wa * (1.0f - frac));
    atomicAdd(rho + i1c, wa * frac);
  }
}

}  // namespace

// x, w, alive: float32[n]; rho: float32[n_cells], zeroed by the caller.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int jbp_deposit_cic(const void* x, const void* w, const void* alive,
                               void* rho, long long n, int n_cells, float dx,
                               void* stream) {
  if (n > 0 && n_cells > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    deposit_cic_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (const float*)alive, (float*)rho, n,
        n_cells, dx);
  }
  return (int)cudaGetLastError();
}
