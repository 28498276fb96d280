// Flash attention forward (online softmax) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_tpu` / `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention/kernel.py. It computes the same
// function, not the same blocks. For each batch b, head h and query row i:
//   s_j  = (q_i . k_j) * scale, scale = 1/sqrt(D), fp32 products of the
//          bf16 values;
//   s_j  = -1e30 where j >= Skv, or, when causal, where j > i;
//   online softmax over key tiles in order: m starts at -1e30,
//     m' = max(m, max_j s_j), p_j = exp(s_j - m'), corr = exp(m - m'),
//     l = l * corr + sum_j p_j,
//     acc = acc * corr + sum_j bf16(p_j) * v_j  (p rounded to bf16 first);
//   out_i = bf16(acc / max(l, 1e-30)).
// Key tiles wholly above the causal diagonal are skipped: every p of such
// a tile is exactly 0 and its corr exactly 1, so the result is the same.
// exp is taken as 2^(s c - m log2 e), c = scale log2 e (one FMA and one
// ex2 an element); masked scores enter as -inf, which gives the same p = 0
// because tile 0 holds key 0, which no row masks, so m is finite from the
// first tile on.
//
// Layout: q [B,Sq,H,D], k/v [B,Skv,H,D], bf16, read in place through their
// strides (unit stride on D), so the model's layout needs no transpose.
// The output is a fresh contiguous [B,Sq,H,D] bf16 tensor. Ragged Sq/Skv
// are masked here; nothing is padded.
//
// Bound on an H100 SXM at the serving shape (B=4, S=512, H=32, D=80,
// causal): q, k, v and out are 41.9 MB of bf16, 12.5 us at 3.35 TB/s; the
// 5.4 GFLOP of the two products take 5.4 us on bf16 tensor cores. So the
// bound is set by bytes.
//
// Design (FlashAttention-2 in shape, on mma.sync m16n8k16 bf16 -> fp32):
// - A block of 8 warps owns 128 query rows, 16 a warp, so each K/V tile
//   read from L2 serves 128 rows (64-row blocks read K/V twice as often,
//   and measured slower). Two blocks fit an SM, which caps a thread at 128
//   registers: the Q tile stays in shared memory and each warp re-reads
//   its A fragments by ldmatrix at every k-step instead of holding them.
// - K and V tiles of 64 keys are staged as bf16 by 16-byte cp.async copies
//   into two stages: tile j+1 is in flight while tile j computes, with one
//   barrier a tile. Rows are padded by 16 bytes: 8 consecutive rows then
//   start in 8 distinct groups of 4 banks for every D here, so ldmatrix
//   (K, the B operand of Q.K^T) and ldmatrix.trans (V, the B operand of
//   P.V) hit no conflicts.
// - S = Q.K^T is 16 x 64 fp32 a warp; the online softmax stays in
//   registers, its row max and sum reduced over the 4 threads of a quad.
// - P is packed to bf16 and used as the A operand of P.V straight from
//   the registers: the accumulator layout of m16n8k16 is its A layout.
// - Causal: key tiles above the diagonal are skipped, only the diagonal
//   tiles (and a ragged last tile) are masked, and a warp whose 16 rows
//   all lie above a tile skips it. The grid is one dimension, query tiles
//   in falling order (heaviest first), so a causal launch ends on its
//   lightest blocks.
// - O is normalised, staged as bf16 in the warp's own rows of the Q tile
//   and written with 16-byte stores.
// wgmma (A and B from shared memory for Q.K^T, P from registers for P.V)
// was measured slower at this shape: without warpgroup ping-pong the two
// products and the softmax run in series. D=80 gives 160-byte rows, which
// match no TMA swizzle span. D must be a multiple of 16: D in {32, 64, 80,
// 96, 128} is instantiated (96: phi3-mini's 3072 / 32 heads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // query rows a block, 16 a warp
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 8 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kStride = D + 8;  // bf16 a row (padded)
  static constexpr int kQBytes = kBQ * kStride * 2;
  static constexpr int kTileBytes = kBK * kStride * 2;
  // Q, then K in two stages, then V in two stages
  static constexpr int kBytes = kQBytes + 4 * kTileBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on the tensor cores, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows row0.. of `base` (row stride `rstride` elements) -> the padded tile
// at `dst`, by cp.async; rows at or past `nrows` are zero-filled
template <int D, int kRows>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long rstride, int row0,
                                          int nrows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kTotal = kRows * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    if (kTotal % kThreads != 0 && idx >= kTotal) break;
    const int i = idx / kChunks, c = idx % kChunks, r = row0 + i;
    const bool valid = r < nrows;
    const __nv_bfloat16* src = base + (long long)(valid ? r : 0) * rstride +
                               c * 8;
    cp_async16(dst + (i * Smem<D>::kStride + c * 8) * 2, src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, long long qsb, long long qss,
              long long qsh, long long ksb, long long kss, long long ksh,
              long long vsb, long long vss, long long vsh, int H, int Sq,
              int Skv, int causal, float scale, int n_qt, int BH) {
  constexpr int kS = Smem<D>::kStride;
  constexpr int kTB = Smem<D>::kTileBytes;
  constexpr int kKSteps = D / 16;  // k-steps of Q.K^T, d-pairs of P.V
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + Smem<D>::kQBytes;
  const uint32_t sV = sK + 2 * kTB;

  // heaviest first: the query tile falls as the block index grows
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int w0 = warp * 16;  // the warp's first row in the tile
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  // keys past the tile's last row are masked for every row of the tile
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int n_kt = (kv_end + kBK - 1) / kBK;

  load_tile<D, kBQ>(sQ, q + b * qsb + h * qsh, qss, q0, Sq);
  load_tile<D, kBK>(sK, kb, kss, 0, Skv);
  load_tile<D, kBK>(sV, vb, vss, 0, Skv);
  cp_async_commit();

  // this thread's rows: row_a (elements 0, 1 of an accumulator block) and
  // row_a + 8 (elements 2, 3)
  float acc[2 * kKSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kKSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row_a = q0 + w0 + g;
  const float c = scale * kLog2e;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kBK;
    cp_async_wait<0>();  // this thread's copies of tile t have landed
    // every thread's copies of tile t are visible, and every warp is done
    // with tile t-1, whose stage the next load takes
    __syncthreads();
    if (t + 1 < n_kt) {
      const int off = ((t + 1) & 1) * kTB;
      load_tile<D, kBK>(sK + off, kb, kss, k0 + kBK, Skv);
      load_tile<D, kBK>(sV + off, vb, vss, k0 + kBK, Skv);
      cp_async_commit();
    }
    // a warp whose rows all lie above the tile's first key skips it: its
    // p are all 0 and its corr 1
    if (causal && k0 > q0 + w0 + 15) continue;

    // S = Q.K^T: 8 column blocks of 8 keys
    const uint32_t kst = sK + (t & 1) * kTB;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(sQ + ((w0 + (lane & 15)) * kS + kk * 16 + (lane >> 4) * 8) *
                           2,
                  qa);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {  // 16 keys an ldmatrix.x4
        uint32_t bf[4];
        const int key = nb * 16 + ((lane >> 4) << 3) + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kst + (key * kS + col) * 2, bf);
        mma_bf16(s[2 * nb], qa, bf[0], bf[1]);
        mma_bf16(s[2 * nb + 1], qa, bf[2], bf[3]);
      }
    }

    // online softmax; element e of block n is row row_a + 8*(e>>1), key
    // k0 + 8n + 2tq + (e&1)
    if (k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          if (col >= Skv || (causal && col > row_a + 8 * (e >> 1)))
            s[n][e] = __int_as_float(0xff800000);  // -inf
        }
    }
    float corr[2], ml[2], ps[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mx[j] = fmaxf(fmaxf(s[j][2 * i], s[j][2 * i + 1]),
                      fmaxf(s[j + 4][2 * i], s[j + 4][2 * i + 1]));
      // max(s) * scale == max(s * scale): the scale is positive
      const float m_new = fmaxf(
          m[i], quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))) *
                    scale);
      corr[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      ml[i] = m_new * kLog2e;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[i][j] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[n][e], c, -ml[e >> 1]));
        s[n][e] = p;
        ps[e >> 1][n & 3] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = l[i] * corr[i] +
             quad_sum((ps[i][0] + ps[i][1]) + (ps[i][2] + ps[i][3]));
#pragma unroll
    for (int n = 0; n < 2 * kKSteps; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += bf16(P).V: P's accumulator blocks 2kk, 2kk+1 are the A
    // fragment of key step kk
    const uint32_t vst = sV + (t & 1) * kTB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < kKSteps; ++nd) {  // 16 columns of D a step
        uint32_t bf[4];
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = nd * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vst + (key * kS + col) * 2, bf);
        mma_bf16(acc[2 * nd], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nd + 1], a, bf[2], bf[3]);
      }
    }
  }

  // normalise and stage in this warp's own 16 rows of the Q tile: no other
  // warp reads them, and no copy is in flight to them
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  __nv_bfloat16* Ow = Qs + w0 * kS;
#pragma unroll
  for (int n = 0; n < 2 * kKSteps; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(Ow + g * kS + col) =
        pack_bf16(acc[n][0] / den[0], acc[n][1] / den[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * kS + col) =
        pack_bf16(acc[n][2] / den[1], acc[n][3] / den[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int idx = it * 32 + lane;
    const int i = idx / kChunks, cc = idx % kChunks;
    const int row = q0 + w0 + i;
    if (row < Sq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Sq + row) * H + h) * D +
                                cc * 8) =
          *reinterpret_cast<const uint4*>(Ow + i * kS + cc * 8);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int Sq, int Skv, int causal,
           float scale, cudaStream_t stream) {
  // the opt-in above 48 KB of dynamic shared memory, once per device;
  // without it the launch is refused
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted_in.load() & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_mma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<D>::kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit);
  }
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_mma<D><<<(unsigned)blocks, kThreads, Smem<D>::kBytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], H, Sq, Skv, causal, scale, n_qt,
      B * H);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Sq,H,D], k/v [B,Skv,H,D] bf16 with element strides (batch, seq, head)
// given and a unit stride on D; o contiguous [B,Sq,H,D] bf16. Launches on
// `stream` and returns the CUDA error (cudaErrorInvalidValue for an
// unsupported D or an empty shape).
extern "C" int jbp_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int B, int H, int Sq, int Skv,
    int D, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (long long)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    case 64: return launch<64>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    case 80: return launch<80>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    case 96: return launch<96>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    case 128: return launch<128>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
