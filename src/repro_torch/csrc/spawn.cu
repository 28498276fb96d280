// Particle spawn as an order-preserving stream compaction, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference's spawn is plain jnp, which XLA
// fuses (src/repro/pic/particles.py::spawn: a stable argsort of the alive
// flags, a cumsum of the events, four concatenations and a scatter of every
// candidate, each rejected one into a trash slot). In PyTorch on the card
// that chain was a radix sort, four copies and four index_put of all M
// candidates (2^25 writes a field on one trash address at paper scale),
// two thirds of a PIC step's device time, and one host sync a call. This
// kernel does the work that is needed instead.
//
// It computes, for a species of C slots and M candidates with event mask
// m: the k-th event (k counted in candidate order) goes to the k-th dead
// slot (alive <= 0) in slot order, for k < n_dead; the other events are
// dropped and counted. For alive flags of 0 and 1 these are the slots that
// argsort(alive, stable=True) lists first, so the result is bit-identical to
// the plain version (kernels/spawn/ref.py). The result is out of place:
// x, v, w and alive are written anew, a placed event's slot with its
// candidate's x, v, w and alive = 1.
//
// Bound on an H100 SXM (3.35 TB/s): every slot's x, v, w and alive is read
// and written once (48 B a slot), the mask read once (1 B a candidate) and
// each placed event's x, v and w read (20 B): 1.64 GB, 0.49 ms, at
// C = M = 2^25 with few events. A slot takes a handful of integer
// operations, far below any compute limit.
//
// Design: four launches over tiles of kTile = 4096 slots or candidates,
// kThreads = 256 threads a block, all on the caller's stream; no count is
// read back to the host, so the call never synchronises.
//  1. count: the dead slots of each slot tile, the events of each
//     candidate tile;
//  2. scan: one block turns the counts into each tile's exclusive offset,
//     with the totals n_dead and n_events, and writes
//     dropped = max(n_events - n_dead, 0);
//  3. compact: each event's rank k (its tile's offset, then warp shuffles
//     and a block scan inside the tile); an event with k < n_fill =
//     min(n_events, n_dead) writes its index to idx[k];
//  4. fill: each dead slot's rank r the same way; a slot with r < n_fill
//     takes candidate idx[r]. Every slot of x, v, w and alive is written
//     exactly once, from the species or from its candidate, so no write
//     has to be ordered after another.
// Slot tiles are read with 16-byte loads and written with 16-byte stores,
// a thread's four consecutive slots a load, neighbouring threads on
// neighbouring addresses (scalar accesses for a ragged tail, or throughout
// when a pointer is not 16-byte aligned). The mask is read 16 bytes a
// thread. The count pass and the fill pass both read alive (4 B a slot
// more than the bound) and the mask is read twice (1 B a candidate more).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                  // slots or candidates a block
constexpr int kQuads = kTile / 4 / kThreads; // 4-slot groups a thread: 4
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kQuads * kWarps == 32, "the fill's per-warp totals are a warp");

__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive prefix of v over the block's threads in thread order; `sums`
// holds blockDim.x / 32 ints of shared memory, and *total gets the block's
// sum. Ends with a barrier, so `sums` may be reused after it.
__device__ __forceinline__ int block_exclusive(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int incl = warp_inclusive(v);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < warps ? sums[lane] : 0;
    const int si = warp_inclusive(s);
    if (lane < warps) sums[lane] = si - s;
    if (lane == 31) sums[warps] = si;
  }
  __syncthreads();
  const int out = sums[warp] + incl - v;
  *total = sums[warps];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long i, long long n, bool vec,
                                        float fill) {
  if (vec && i + 4 <= n) return __ldg(reinterpret_cast<const float4*>(p + i));
  float4 r;
  r.x = i < n ? __ldg(p + i) : fill;
  r.y = i + 1 < n ? __ldg(p + i + 1) : fill;
  r.z = i + 2 < n ? __ldg(p + i + 2) : fill;
  r.w = i + 3 < n ? __ldg(p + i + 3) : fill;
  return r;
}

__device__ __forceinline__ void store4(float* __restrict__ p, long long i,
                                       long long n, bool vec, float4 r) {
  if (vec && i + 4 <= n) {
    *reinterpret_cast<float4*>(p + i) = r;
    return;
  }
  if (i < n) p[i] = r.x;
  if (i + 1 < n) p[i + 1] = r.y;
  if (i + 2 < n) p[i + 2] = r.z;
  if (i + 3 < n) p[i + 3] = r.w;
}

// the mask's 16 bytes from candidate i on, 0 past n
__device__ __forceinline__ uint4 load16(const unsigned char* __restrict__ m,
                                        long long i, long long n, bool vec) {
  if (vec && i + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(m + i));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 16 && i + j < n; ++j)
    w[j >> 2] |= (unsigned)(__ldg(m + i + j) != 0) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// events among 16 mask bytes, and their bits in candidate order
__device__ __forceinline__ unsigned event_bits(uint4 q) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    bits |= (unsigned)(((w[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0) << j;
  return bits;
}

__device__ __forceinline__ unsigned dead_bits(float4 a) {
  return (unsigned)(a.x <= 0.0f) | (unsigned)(a.y <= 0.0f) << 1 |
         (unsigned)(a.z <= 0.0f) << 2 | (unsigned)(a.w <= 0.0f) << 3;
}

// counts[b]: dead slots of slot tile b < slot_tiles, then events of
// candidate tile b - slot_tiles
__global__ void __launch_bounds__(kThreads)
spawn_count_kernel(const float* __restrict__ alive,
                   const unsigned char* __restrict__ mask, long long C,
                   long long M, int slot_tiles, bool vec,
                   int* __restrict__ counts) {
  __shared__ int sums[kWarps + 1];
  int c = 0;
  if ((int)blockIdx.x < slot_tiles) {
    const long long s0 = (long long)blockIdx.x * kTile;
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const long long s = s0 + 4LL * (i * kThreads + threadIdx.x);
      c += __popc(dead_bits(load4(alive, s, C, vec, 1.0f)));
    }
  } else {
    const long long e = (long long)(blockIdx.x - slot_tiles) * kTile +
                        16LL * threadIdx.x;
    c = __popc(event_bits(load16(mask, e, M, vec)));
  }
  int total;
  block_exclusive(c, sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// exclusive scan of n counts in place by one block; returns the total
__device__ int scan_counts(int* __restrict__ counts, int n, int* sums) {
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  int total;
  int run = block_exclusive(s, sums, &total);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  return total;
}

// one block of kScanThreads: the tiles' offsets, info = {n_dead, n_events}
// and the dropped count
__global__ void __launch_bounds__(kScanThreads)
spawn_scan_kernel(int* __restrict__ counts, int slot_tiles, int event_tiles,
                  int* __restrict__ info, long long* __restrict__ dropped) {
  __shared__ int sums[kScanThreads / 32 + 1];
  const int n_dead = scan_counts(counts, slot_tiles, sums);
  const int n_events = scan_counts(counts + slot_tiles, event_tiles, sums);
  if (threadIdx.x == 0) {
    info[0] = n_dead;
    info[1] = n_events;
    *dropped = n_events > n_dead ? (long long)(n_events - n_dead) : 0LL;
  }
}

// idx[k] = the candidate index of the k-th event, for k < n_fill
__global__ void __launch_bounds__(kThreads)
spawn_compact_kernel(const unsigned char* __restrict__ mask, long long M,
                     const int* __restrict__ event_offsets,
                     const int* __restrict__ info, bool vec,
                     int* __restrict__ idx) {
  __shared__ int sums[kWarps + 1];
  const int n_fill = min(info[0], info[1]);
  const int base = event_offsets[blockIdx.x];
  if (base >= n_fill) return;  // the whole tile is dropped (uniform)
  const long long e = (long long)blockIdx.x * kTile + 16LL * threadIdx.x;
  unsigned bits = event_bits(load16(mask, e, M, vec));
  int total;
  int k = base + block_exclusive(__popc(bits), sums, &total);
  for (; bits && k < n_fill; bits &= bits - 1, ++k)
    idx[k] = (int)(e + __ffs(bits) - 1);
}

// every slot of the out-of-place species: copied, or the candidate idx[r]
// for the dead slot of rank r < n_fill
__global__ void __launch_bounds__(kThreads)
spawn_fill_kernel(const float* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ alive,
                  const float* __restrict__ new_x,
                  const float* __restrict__ new_v,
                  const float* __restrict__ new_w, long long C,
                  const int* __restrict__ slot_offsets,
                  const int* __restrict__ info, const int* __restrict__ idx,
                  bool vec, float* __restrict__ out_x,
                  float* __restrict__ out_v, float* __restrict__ out_w,
                  float* __restrict__ out_alive) {
  __shared__ int totals[32];       // dead slots a (quad round, warp)
  __shared__ int4 src_s[kTile / 4];  // a slot's candidate, or -1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long s0 = (long long)blockIdx.x * kTile;
  const int n_fill = min(info[0], info[1]);

  // ranks: slot s0 + 4 * (i * kThreads + t) + j is ordered by (i, warp,
  // lane, j); each (i, warp) total goes to `totals`, scanned by one warp
  float4 a[kQuads];
  unsigned dead[kQuads];
  int before[kQuads];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    a[i] = load4(alive, s0 + 4LL * (i * kThreads + threadIdx.x), C, vec,
                 1.0f);
    dead[i] = dead_bits(a[i]);
    const int c = __popc(dead[i]);
    const int incl = warp_inclusive(c);
    before[i] = incl - c;
    if (lane == 31) totals[i * kWarps + warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    const int t = totals[lane];
    totals[lane] = warp_inclusive(t) - t;
  }
  __syncthreads();
  const int tile_base = slot_offsets[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int q = i * kThreads + threadIdx.x;
    int r = tile_base + totals[i * kWarps + warp] + before[i];
    int src[4];
    float* af = reinterpret_cast<float*>(&a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      src[j] = -1;
      if (dead[i] >> j & 1u) {
        if (r < n_fill) {
          src[j] = idx[r];
          af[j] = 1.0f;
        }
        ++r;
      }
    }
    src_s[q] = make_int4(src[0], src[1], src[2], src[3]);
    store4(out_alive, s0 + 4LL * q, C, vec, a[i]);
  }
  __syncthreads();

  // x and w: one 4-slot group a round
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int q = i * kThreads + threadIdx.x;
    const long long s = s0 + 4LL * q;
    const int4 sq = src_s[q];
    const int src[4] = {sq.x, sq.y, sq.z, sq.w};
    float4 xv = load4(x, s, C, vec, 0.0f);
    float4 wv = load4(w, s, C, vec, 0.0f);
    float* xf = reinterpret_cast<float*>(&xv);
    float* wf = reinterpret_cast<float*>(&wv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (src[j] >= 0) {
        xf[j] = __ldg(new_x + src[j]);
        wf[j] = __ldg(new_w + src[j]);
      }
    }
    store4(out_x, s, C, vec, xv);
    store4(out_w, s, C, vec, wv);
  }

  // v, [C, 3] flat: the tile's 3 * kTile floats, four a round
  const int* src_flat = reinterpret_cast<const int*>(src_s);
  const long long nv = 3 * C;
#pragma unroll 4
  for (int i = 0; i < 3 * kQuads; ++i) {
    const int lf = 4 * (i * kThreads + threadIdx.x);  // float in the tile
    const long long f = 3 * s0 + lf;
    float4 vv = load4(v, f, nv, vec, 0.0f);
    float* vf = reinterpret_cast<float*>(&vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ls = (lf + j) / 3;
      const int src = src_flat[ls];
      if (src >= 0) vf[j] = __ldg(new_v + 3LL * src + (lf + j - 3 * ls));
    }
    store4(out_v, f, nv, vec, vv);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

long long tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Slots or candidates a tile; the scratch's length depends on it.
extern "C" int jbp_spawn_tile(void) { return kTile; }

// x, w, alive: float32[C]; v: float32[C, 3]; new_x, new_w: float32[M];
// new_v: float32[M, 3]; mask: bool[M]; out_*: like x, v, w, alive;
// dropped: int64[]; scratch: int32[scratch_ints] with scratch_ints at
// least tiles(C) + tiles(M) + 2 + min(C, M). C, M < 2^31. Launches up to
// four kernels on `stream`, writes how many to *launches and returns the
// CUDA error.
extern "C" int jbp_spawn(const void* x, const void* v, const void* w,
                         const void* alive, const void* new_x,
                         const void* new_v, const void* new_w,
                         const void* mask, void* out_x, void* out_v,
                         void* out_w, void* out_alive, void* dropped,
                         void* scratch, long long scratch_ints, long long C,
                         long long M, int* launches, void* stream) {
  *launches = 0;
  const long long slot_tiles = tiles(C), event_tiles = tiles(M);
  if (C < 0 || M < 0 || C >= (1LL << 31) || M >= (1LL << 31) ||
      scratch_ints < slot_tiles + event_tiles + 2 + (C < M ? C : M))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(x) && aligned16(v) && aligned16(w) &&
                   aligned16(alive) && aligned16(mask) && aligned16(out_x) &&
                   aligned16(out_v) && aligned16(out_w) &&
                   aligned16(out_alive);
  cudaStream_t st = (cudaStream_t)stream;
  int* counts = (int*)scratch;
  int* info = counts + slot_tiles + event_tiles;
  int* idx = info + 2;
  const float* alive_f = (const float*)alive;
  const unsigned char* mask_b = (const unsigned char*)mask;
  cudaError_t err;
  if (slot_tiles + event_tiles > 0) {
    spawn_count_kernel<<<(unsigned)(slot_tiles + event_tiles), kThreads, 0,
                         st>>>(alive_f, mask_b, C, M, (int)slot_tiles, vec,
                               counts);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  spawn_scan_kernel<<<1, kScanThreads, 0, st>>>(
      counts, (int)slot_tiles, (int)event_tiles, info, (long long*)dropped);
  ++*launches;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (event_tiles > 0) {
    spawn_compact_kernel<<<(unsigned)event_tiles, kThreads, 0, st>>>(
        mask_b, M, counts + slot_tiles, info, vec, idx);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (slot_tiles > 0) {
    spawn_fill_kernel<<<(unsigned)slot_tiles, kThreads, 0, st>>>(
        (const float*)x, (const float*)v, (const float*)w, alive_f,
        (const float*)new_x, (const float*)new_v, (const float*)new_w, C,
        counts, info, idx, vec, (float*)out_x, (float*)out_v, (float*)out_w,
        (float*)out_alive);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
