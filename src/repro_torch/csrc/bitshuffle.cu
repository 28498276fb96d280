// Blosc-style byte shuffle for NVIDIA Hopper (sm_90a): each codec block,
// a row-major uint8 matrix [n_items, itemsize], transposed into
// [itemsize, n_items], or back.
//
// Replaces the three TPU sites of src/repro/kernels/bitshuffle/kernel.py:
//   byte_shuffle_block (one codec block, the device-compress write path),
//   byte_shuffle_tpu   (the tiled shuffle),
//   byte_unshuffle_tpu (the inverse).
// One entry point serves them and the write path's whole leaf: the input
// is cut into blocks of `block` bytes (the last may be shorter), each
// shuffled on its own in the same launch. Block b, of length blen, maps
// byte j of item t to b*block + j*(blen/itemsize) + t. A block whose
// length is not a multiple of the item size is copied unchanged, as the
// host codec leaves it.
//
// Bound on an H100 SXM (3.35 TB/s): each byte is read once and written
// once, 2 x bytes of device-memory traffic, no arithmetic; the kernel is
// bound by bytes.
//
// Design: a thread moves 16 bytes of items at a time (32 for item size 8)
// with vector loads, transposes them in registers with byte permutes
// (prmt), and stores one word a plane: for item size 4, four items give
// one 32-bit word to each of the 4 planes, so a warp writes 128
// contiguous bytes a plane; item size 2 writes 8 bytes to each of 2
// planes, item size 8 writes 4 bytes to each of 8 planes. The unshuffle
// is the inverse permutation. No shared memory, no division per byte.
// Blocks whose geometry misses the vector path (items not a multiple of
// the group, or unaligned pointers) and other item sizes take a scalar
// path, one item a thread.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReps = 2;      // item groups a thread
constexpr int kMaxItem = 16;  // largest item size

// items a thread moves at once: 16 bytes of items, 4 items of 8 bytes;
// K == 0 (any item size, given at run time) moves one item
template <int K>
__host__ __device__ constexpr int group_items() {
  return K == 2 ? 8 : K == 4 ? 4 : K == 8 ? 4 : 1;
}

template <int K>
__host__ __device__ constexpr int tile_items() {
  return kThreads * kReps * group_items<K>();
}

// byte J of a, b, c and d, as the bytes 0..3 of one word
template <int J>
__device__ __forceinline__ uint32_t byte_of4(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  constexpr uint32_t kSel = J | ((J + 4) << 4);
  return __byte_perm(__byte_perm(a, b, kSel), __byte_perm(c, d, kSel),
                     0x5410);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// [n, K] -> [K, n] for the group of items at t; n % group_items<K>() == 0
template <int K>
__device__ __forceinline__ void load_items(const uint8_t* src, long long t,
                                           uint4 (&w)[2]) {
  w[0] = *reinterpret_cast<const uint4*>(src + t * K);
  if constexpr (K == 8)
    w[1] = *reinterpret_cast<const uint4*>(src + t * K + 16);
}

template <int K>
__device__ __forceinline__ void store_planes(uint8_t* dst, long long n,
                                             long long t, const uint4 (&w)[2]) {
  if constexpr (K == 2) {
    // w.x holds items 0 and 1: [i0b0, i0b1, i1b0, i1b1]
    *reinterpret_cast<uint2*>(dst + t) =
        make_uint2(__byte_perm(w[0].x, w[0].y, 0x6420),
                   __byte_perm(w[0].z, w[0].w, 0x6420));
    *reinterpret_cast<uint2*>(dst + n + t) =
        make_uint2(__byte_perm(w[0].x, w[0].y, 0x7531),
                   __byte_perm(w[0].z, w[0].w, 0x7531));
  } else if constexpr (K == 4) {
    const uint4 a = w[0];
    uint32_t* p = reinterpret_cast<uint32_t*>(dst + t);
    const long long s = n / 4;
    p[0] = byte_of4<0>(a.x, a.y, a.z, a.w);
    p[s] = byte_of4<1>(a.x, a.y, a.z, a.w);
    p[2 * s] = byte_of4<2>(a.x, a.y, a.z, a.w);
    p[3 * s] = byte_of4<3>(a.x, a.y, a.z, a.w);
  } else {  // K == 8: items 0, 1 in w[0] (lo, hi words), 2, 3 in w[1]
    const uint4 a = w[0], c = w[1];
    uint32_t* p = reinterpret_cast<uint32_t*>(dst + t);
    const long long s = n / 4;
    p[0] = byte_of4<0>(a.x, a.z, c.x, c.z);
    p[s] = byte_of4<1>(a.x, a.z, c.x, c.z);
    p[2 * s] = byte_of4<2>(a.x, a.z, c.x, c.z);
    p[3 * s] = byte_of4<3>(a.x, a.z, c.x, c.z);
    p[4 * s] = byte_of4<0>(a.y, a.w, c.y, c.w);
    p[5 * s] = byte_of4<1>(a.y, a.w, c.y, c.w);
    p[6 * s] = byte_of4<2>(a.y, a.w, c.y, c.w);
    p[7 * s] = byte_of4<3>(a.y, a.w, c.y, c.w);
  }
}

// [K, n] -> [n, K], the inverse of load_items + store_planes
template <int K>
__device__ __forceinline__ void load_planes(const uint8_t* src, long long n,
                                            long long t, uint32_t (&p)[8]) {
  if constexpr (K == 2) {
    const uint2 p0 = *reinterpret_cast<const uint2*>(src + t);
    const uint2 p1 = *reinterpret_cast<const uint2*>(src + n + t);
    p[0] = p0.x; p[1] = p0.y; p[2] = p1.x; p[3] = p1.y;
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src + t);
    const long long st = n / 4;
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = s[j * st];
  }
}

template <int K>
__device__ __forceinline__ void store_items(uint8_t* dst, long long t,
                                            const uint32_t (&p)[8]) {
  uint4* d = reinterpret_cast<uint4*>(dst + t * K);
  // p[0], p[1]: byte 0 of items 0-7; p[2], p[3]: byte 1 (item size 2)
  if constexpr (K == 2) {
    d[0] = make_uint4(__byte_perm(p[0], p[2], 0x5140),
                      __byte_perm(p[0], p[2], 0x7362),
                      __byte_perm(p[1], p[3], 0x5140),
                      __byte_perm(p[1], p[3], 0x7362));
  } else if constexpr (K == 4) {
    d[0] = make_uint4(byte_of4<0>(p[0], p[1], p[2], p[3]),
                      byte_of4<1>(p[0], p[1], p[2], p[3]),
                      byte_of4<2>(p[0], p[1], p[2], p[3]),
                      byte_of4<3>(p[0], p[1], p[2], p[3]));
  } else {  // K == 8: item i is (lo, hi) = (bytes 0-3, bytes 4-7)
    d[0] = make_uint4(byte_of4<0>(p[0], p[1], p[2], p[3]),
                      byte_of4<0>(p[4], p[5], p[6], p[7]),
                      byte_of4<1>(p[0], p[1], p[2], p[3]),
                      byte_of4<1>(p[4], p[5], p[6], p[7]));
    d[1] = make_uint4(byte_of4<2>(p[0], p[1], p[2], p[3]),
                      byte_of4<2>(p[4], p[5], p[6], p[7]),
                      byte_of4<3>(p[0], p[1], p[2], p[3]),
                      byte_of4<3>(p[4], p[5], p[6], p[7]));
  }
}

// the tile's item groups from t0 on: all loads first, then all stores
template <int K, bool kInverse>
__device__ __forceinline__ void vector_tile(const uint8_t* src, uint8_t* dst,
                                            long long n, long long t0) {
  constexpr int kG = group_items<K>();
  long long t[kReps];
#pragma unroll
  for (int r = 0; r < kReps; ++r)
    t[r] = t0 + (long long)(r * kThreads + threadIdx.x) * kG;
  if constexpr (!kInverse) {
    uint4 w[kReps][2];
#pragma unroll
    for (int r = 0; r < kReps; ++r)
      if (t[r] < n) load_items<K>(src, t[r], w[r]);
#pragma unroll
    for (int r = 0; r < kReps; ++r)
      if (t[r] < n) store_planes<K>(dst, n, t[r], w[r]);
  } else {
    uint32_t p[kReps][8];
#pragma unroll
    for (int r = 0; r < kReps; ++r)
      if (t[r] < n) load_planes<K>(src, n, t[r], p[r]);
#pragma unroll
    for (int r = 0; r < kReps; ++r)
      if (t[r] < n) store_items<K>(dst, t[r], p[r]);
  }
}

// One CUDA block a tile of tile_items<K>() items of one codec block;
// codec block b owns tiles [b * tiles_per_block, (b + 1) * tiles_per_block)
// and the short last block the tiles after them.
template <int K, bool kInverse>
__global__ void __launch_bounds__(kThreads)
shuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               long long nbytes, long long block, int itemsize,
               long long tiles_per_block) {
  constexpr int kTile = tile_items<K>();
  constexpr int kG = group_items<K>();
  const int isz = K ? K : itemsize;
  const long long b = blockIdx.x / tiles_per_block;
  const long long t0 = (blockIdx.x - b * tiles_per_block) * kTile;
  const long long base = b * block;
  const long long blen = min(block, nbytes - base);
  const uint8_t* src = in + base;
  uint8_t* dst = out + base;

  if (blen % isz) {  // the codec's no-op: the bytes pass through
    const long long hi = min(blen, (t0 + kTile) * isz);
    for (long long i = t0 * isz + threadIdx.x; i < hi; i += kThreads)
      dst[i] = src[i];
    return;
  }
  const long long n = blen / isz;
  if constexpr (K != 0) {
    if (n % kG == 0 && aligned16(src) && aligned16(dst)) {
      vector_tile<K, kInverse>(src, dst, n, t0);
      return;
    }
  }
  const long long t1 = min(n, t0 + kTile);
  for (long long t = t0 + threadIdx.x; t < t1; t += kThreads) {
    for (int j = 0; j < isz; ++j) {
      if (!kInverse)
        dst[j * n + t] = src[t * isz + j];
      else
        dst[t * isz + j] = src[j * n + t];
    }
  }
}

template <int K, bool kInverse>
int launch(const void* in, void* out, long long nbytes, long long block,
           int itemsize, cudaStream_t stream) {
  const long long tile_bytes = (long long)tile_items<K>() * itemsize;
  const long long tiles_per_block = (block + tile_bytes - 1) / tile_bytes;
  const long long tail = nbytes % block;
  const long long tiles = nbytes / block * tiles_per_block +
                          (tail + tile_bytes - 1) / tile_bytes;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  shuffle_kernel<K, kInverse><<<(unsigned)tiles, kThreads, 0, stream>>>(
      (const uint8_t*)in, (uint8_t*)out, nbytes, block, itemsize,
      tiles_per_block);
  return (int)cudaGetLastError();
}

template <bool kInverse>
int dispatch(const void* in, void* out, long long nbytes, long long block,
             int itemsize, cudaStream_t s) {
  switch (itemsize) {
    case 2: return launch<2, kInverse>(in, out, nbytes, block, itemsize, s);
    case 4: return launch<4, kInverse>(in, out, nbytes, block, itemsize, s);
    case 8: return launch<8, kInverse>(in, out, nbytes, block, itemsize, s);
    default: return launch<0, kInverse>(in, out, nbytes, block, itemsize, s);
  }
}

}  // namespace

// in, out: uint8[nbytes], distinct buffers. Every `block` bytes (the last
// run may be shorter) are shuffled on their own ([n, itemsize] ->
// [itemsize, n]), or unshuffled when `inverse` is set; a run whose length
// is not a multiple of `itemsize` is copied. Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a block or an
// item size out of range.
extern "C" int jbp_byte_shuffle(const void* in, void* out, long long nbytes,
                                long long block, int itemsize, int inverse,
                                void* stream) {
  if (block <= 0 || itemsize < 1 || itemsize > kMaxItem)
    return (int)cudaErrorInvalidValue;
  if (nbytes <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return inverse ? dispatch<true>(in, out, nbytes, block, itemsize, s)
                 : dispatch<false>(in, out, nbytes, block, itemsize, s);
}
