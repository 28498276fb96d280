// Blosc-style byte shuffle for NVIDIA Hopper (sm_90a): the transpose of a
// row-major uint8 matrix [rows, cols] into [cols, rows].
//
// Replaces the three TPU sites of src/repro/kernels/bitshuffle/kernel.py:
//   byte_shuffle_block (one codec block, the device-compress write path),
//   byte_shuffle_tpu   (the tiled shuffle)  -> rows = n_items, cols = itemsize
//   byte_unshuffle_tpu (the inverse)        -> rows = itemsize, cols = n_items
// One entry point takes (rows, cols); the unshuffle is the same transpose
// with the two swapped. One of the two sides must be at most kMaxShort
// (the item size, 2, 4 or 8 in the codec).
//
// Design: a block owns kTile positions of the long side and every byte of
// the short side, staged through shared memory, so that the global loads
// and the global stores are both unit-stride across a warp (coalesced):
// the short-row side is a contiguous run of kTile * short bytes, the other
// side is `short` runs of kTile contiguous bytes each. The last block of a
// ragged length masks its tail.
//
// Bound on an H100 SXM (3.35 TB/s): each byte is read once and written
// once, 2 x bytes of device-memory traffic, no arithmetic; the kernel is
// bound by bytes. A codec block is 1 MiB, so one call moves 2 MiB and is
// dominated by its launch; the write path issues one call a block.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;      // long-side positions per block
constexpr int kMaxShort = 16;    // largest short side (item size)
constexpr int kThreads = 256;

// in: [n, k] (k short, rows contiguous) -> out: [k, n]
__global__ void transpose_short_cols(const unsigned char* __restrict__ in,
                                     unsigned char* __restrict__ out,
                                     long long n, int k) {
  __shared__ unsigned char tile[kTile * kMaxShort];
  const long long i0 = (long long)blockIdx.x * kTile;
  const long long left = n - i0;
  const int t_n = (int)(left < kTile ? left : kTile);
  const int nbytes = t_n * k;
  const unsigned char* src = in + i0 * k;
  for (int b = threadIdx.x; b < nbytes; b += blockDim.x) tile[b] = src[b];
  __syncthreads();
  for (int b = threadIdx.x; b < nbytes; b += blockDim.x) {
    const int j = b / t_n;           // output row (byte significance)
    const int t = b - j * t_n;       // position along the long side
    out[(long long)j * n + i0 + t] = tile[t * k + j];
  }
}

// in: [k, n] (k short) -> out: [n, k] (rows contiguous)
__global__ void transpose_short_rows(const unsigned char* __restrict__ in,
                                     unsigned char* __restrict__ out,
                                     long long n, int k) {
  __shared__ unsigned char tile[kTile * kMaxShort];
  const long long i0 = (long long)blockIdx.x * kTile;
  const long long left = n - i0;
  const int t_n = (int)(left < kTile ? left : kTile);
  const int nbytes = t_n * k;
  for (int b = threadIdx.x; b < nbytes; b += blockDim.x) {
    const int j = b / t_n;
    const int t = b - j * t_n;
    tile[t * k + j] = in[(long long)j * n + i0 + t];
  }
  __syncthreads();
  unsigned char* dst = out + i0 * k;
  for (int b = threadIdx.x; b < nbytes; b += blockDim.x) dst[b] = tile[b];
}

}  // namespace

// in, out: uint8[rows * cols], distinct buffers. Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue when neither side
// is short enough.
extern "C" int jbp_byte_transpose(const void* in, void* out, long long rows,
                                  long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (cols <= kMaxShort) {
    const long long blocks = (rows + kTile - 1) / kTile;
    transpose_short_cols<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const unsigned char*)in, (unsigned char*)out, rows, (int)cols);
  } else if (rows <= kMaxShort) {
    const long long blocks = (cols + kTile - 1) / kTile;
    transpose_short_rows<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const unsigned char*)in, (unsigned char*)out, cols, (int)rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
