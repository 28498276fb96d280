// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_tpu` / `_ssd_kernel` of
// src/repro/kernels/ssd_scan/kernel.py, and also writes the final state,
// which the TPU kernel drops but the prefill needs for the decode cache.
// For each batch b and head h, over chunks of Q steps in order, in fp32:
//   cs_t   = cumsum_t(dt_t * A)                        (inclusive, in chunk)
//   M[l,s] = (C_l . B_s) * exp(cs_l - cs_s) for s <= l, else 0
//   y_l    = sum_s M[l,s] * x_s dt_s + exp(cs_l) * (C_l . state) + D x_l
//   state  = state * exp(cs_last) + sum_s exp(cs_last - cs_s) x_s dt_s B_s^T
// y is written in bf16 and the final state [P,N] in fp32. The decay is
// always the exponential of a difference of cumulative sums, never a
// quotient of exponentials: at zamba2's A (down to -16) cs reaches about
// -200 within a chunk and exp(cs) underflows to 0.
//
// Layout: x [b,s,h,p] bf16, dt [b,s,h] fp32, A and D [h] fp32, B and C
// [b,s,n] bf16 (one group), all contiguous and read in place; init and the
// final state [b,h,p,n] fp32; y [b,s,h,p] bf16. s is a multiple of Q: the
// wrapper pads with zeros, and a zero dt neither decays nor updates the
// state. A chunk that is not a multiple of 16 is zero-padded in shared
// memory to the next one.
//
// Bound on an H100 SXM at zamba2-2.7b's prefill (b=4, s=512, h=80, p=64,
// n=64): x, y (bf16), dt, B, C and the fp32 final state are ~48 MB, 14 us
// at 3.35 TB/s. The products run on bf16 tensor cores (below), ~8 GFLOP
// with the split operands, 8 us at 989 TFLOP/s. So bytes bound it, as
// long as the products run on tensor cores, C.B^T is not redone for every
// head and enough small blocks fill the card: the design below.
//
// Design: two launches a call, on the caller's stream.
// 1. `ssd_cb_kernel` computes G = C.B^T once per (batch, chunk), the
//    lower-triangular 16x16 tiles only, on mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate: B and C are bf16, so every product is exact and only
//    the order of the sums differs from fp32 FMAs), into an fp32 scratch
//    [b, s/Q, 128, 128] that stays in L2 (1 MB at the prefill shape).
// 2. `ssd_chunk_scan_kernel` splits each (b, h) over slices of 32 columns
//    of p (y[:, p] and state[p, :] depend only on column p of x dt): a
//    block of 8 warps per (p slice, h, b), 640 blocks at the prefill
//    shape, ~113 KB of shared memory at n=64, so two blocks share an SM.
//    The block walks its chunks in order; the next chunk's B, C, x and dt
//    tiles are in flight by cp.async (two stages) while one computes. The
//    block's fp32 state slice [32, n] stays in shared memory, twice: warps
//    0-3 compute y from the old state while warps 4-7 write the new one.
//    Per chunk, output warp w takes the rows of two 16-row tiles (l
//    tiles w and 7-w, so the causal work is even across warps):
//      y  = exp(cs_l) * C.(S_hi + S_lo)^T  +  sum_s M'_hi|lo . x  +  D x
//    with M' = G * exp(cs_l - cs_s) * dt_s built in registers from the G
//    tile (the m16n8 accumulator layout is the A layout of the next
//    product) and the tiles above the diagonal skipped. Then the state
//      S = S exp(cs_last) + (x * dt exp(cs_last - cs))_hi|lo^T . B.
//    Every product with an fp32 operand (M', the state, x dt decay) runs
//    on bf16 tensor cores with that operand split in two: hi = bf16(v),
//    lo = bf16(v - hi), so hi + lo keeps ~16 bits of v and the product
//    keeps a relative error near 2^-17, against the 1e-4 state check; the
//    other operand (x, B or C) is bf16 already and needs no split.
//    `ref.ssd_chunked_split` repeats these roundings on the CPU.
// n in {16, 32, 64, 128}, p a multiple of 32, chunk <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQ = 128;        // largest chunk; the G scratch's row stride
constexpr int kPS = 32;        // columns of p a block
constexpr int kThreads = 256;  // 8 warps: 4 for y, 4 for the state
constexpr int kXS = kPS + 8;   // padded bf16 row of the x tile

template <int N>
struct Layout {
  static constexpr int kRow = N + 8;           // padded bf16 row of B, C
  static constexpr int kBC = kQ * kRow * 2;    // bytes of the B or C tile
  static constexpr int kX = kQ * kXS * 2;      // bytes of the x tile
  static constexpr int kDt = kQ * 4;           // bytes of dt
  static constexpr int kStage = 2 * kBC + kX + kDt;
  static constexpr int kSRow = N + 8;          // padded fp32 state row
  static constexpr int kState = kPS * kSRow * 4;
  // two stages, the state slice twice (old and new), and cs, exp(cs),
  // dt exp(cs_last - cs)
  static constexpr int kBytes = 2 * kStage + 2 * kState + 3 * kQ * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared; zero-filled when `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t addr,
                                                  uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// (a, b) -> bf16x2 hi = bf16(v) and lo = bf16(v - hi), `a` in the low half
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// two bf16 of row `row` (< rows, else 0) at column k of a [.., N] matrix
template <int N>
__device__ __forceinline__ uint32_t ld_pair(const bf16* m, long long row0,
                                            int row, int rows, int k) {
  return row < rows ? __ldg(reinterpret_cast<const unsigned int*>(
                          m + (row0 + row) * N + k))
                    : 0u;
}

// G[l, s] = C_l . B_s for one 16-row tile of one (batch, chunk), the
// columns up to its diagonal; one warp a block.
template <int N>
__global__ void __launch_bounds__(32)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              float* __restrict__ G, int S, int Q) {
  const int mt = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x, g = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)b * S + (long long)c * Q;
  const int ra = mt * 16 + g, rb = ra + 8;
  const int jmax = 2 * mt + 1;  // the last 8-column tile at the diagonal
  float acc[16][4] = {};
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int k0 = kk * 16 + 2 * tq;
    const uint32_t a[4] = {ld_pair<N>(Cm, row0, ra, Q, k0),
                           ld_pair<N>(Cm, row0, rb, Q, k0),
                           ld_pair<N>(Cm, row0, ra, Q, k0 + 8),
                           ld_pair<N>(Cm, row0, rb, Q, k0 + 8)};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j <= jmax) {
        const int sr = j * 8 + g;
        mma_bf16(acc[j], a, ld_pair<N>(Bm, row0, sr, Q, k0),
                 ld_pair<N>(Bm, row0, sr, Q, k0 + 8));
      }
    }
  }
  float* Gc = G + ((long long)b * (S / Q) + c) * kQ * kQ;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j <= jmax) {
      const int col = j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(Gc + ra * kQ + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(Gc + rb * kQ + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// the B, C, x and dt tiles of one chunk -> a stage, by cp.async; rows at
// or past Q (up to QT, a multiple of 16) are zero-filled
template <int N>
__device__ __forceinline__ void load_chunk(unsigned char* stage,
                                           const bf16* x, const float* dt,
                                           const bf16* Bm, const bf16* Cm,
                                           long long row0, int Q, int QT,
                                           int H, int P, int h, int p0) {
  using L = Layout<N>;
  const uint32_t sB = smem_u32(stage), sC = sB + L::kBC, sX = sC + L::kBC,
                 sD = sX + L::kX;
  constexpr int kPieces = N / 8;  // 16-byte pieces of a row of B or C
  for (int i = threadIdx.x; i < QT * kPieces; i += kThreads) {
    const int t = i / kPieces, k = i % kPieces;
    const bool ok = t < Q;
    const long long src = (row0 + (ok ? t : 0)) * N + k * 8;
    const uint32_t off = (t * L::kRow + k * 8) * 2;
    cp_async16(sB + off, Bm + src, ok);
    cp_async16(sC + off, Cm + src, ok);
  }
  for (int i = threadIdx.x; i < QT * (kPS / 8); i += kThreads) {
    const int t = i / (kPS / 8), k = i % (kPS / 8);
    const bool ok = t < Q;
    const long long src = ((row0 + (ok ? t : 0)) * H + h) * P + p0 + k * 8;
    cp_async16(sX + (t * kXS + k * 8) * 2, x + src, ok);
  }
  for (int t = threadIdx.x; t < QT; t += kThreads) {
    const bool ok = t < Q;
    cp_async4(sD + t * 4, dt + (row0 + (ok ? t : 0)) * H + h, ok);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                      const float* __restrict__ Dv,
                      const float* __restrict__ init,
                      const float* __restrict__ G, bf16* __restrict__ y,
                      float* __restrict__ final_state, int S, int H, int P,
                      int Q) {
  using L = Layout<N>;
  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int QT = (Q + 15) & ~15, MT = QT / 16, nc = S / Q;
  extern __shared__ __align__(16) unsigned char smem[];
  // the state slice [kPS][kSRow], twice: chunk c reads St_(c&1) and
  // writes St_((c+1)&1)
  float* St = reinterpret_cast<float*>(smem + 2 * L::kStage);
  float* cs = St + 2 * kPS * L::kSRow;  // [kQ] cumulative dt*A
  float* eo = cs + kQ;              // [kQ] exp(cs_l)
  float* fs = eo + kQ;              // [kQ] dt_s exp(cs_last - cs_s)

  const float a = A[h], dskip = Dv[h];
  const long long head_state = ((long long)b * H + h) * P * N;
  for (int i = threadIdx.x; i < kPS * N; i += kThreads) {
    const int p = i / N, n = i % N;
    St[p * L::kSRow + n] =
        init ? init[head_state + (long long)(p0 + p) * N + n] : 0.f;
  }
  load_chunk<N>(smem, x, dt, Bm, Cm, (long long)b * S, Q, QT, H, P, h, p0);
  cp_async_commit();

  for (int c = 0; c < nc; ++c) {
    const long long row0 = (long long)b * S + (long long)c * Q;
    if (c + 1 < nc)  // the next chunk, into the stage chunk c-1 used
      load_chunk<N>(smem + ((c + 1) & 1) * L::kStage, x, dt, Bm, Cm,
                    row0 + Q, Q, QT, H, P, h, p0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* stage = smem + (c & 1) * L::kStage;
    const bf16* Bs = reinterpret_cast<const bf16*>(stage);
    const bf16* Cs = Bs + kQ * L::kRow;
    const bf16* Xs = Cs + kQ * L::kRow;
    const float* dts = reinterpret_cast<const float*>(Xs + kQ * kXS);

    if (warp == 0) {  // inclusive scan of dt*A, 4 steps a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        run += t < QT ? dts[t] * a : 0.f;
        v[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float before = tot - run;
      const float total = __shfl_sync(0xffffffffu, tot, 31);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        if (t < QT) {
          const float ct = before + v[e];
          cs[t] = ct;
          eo[t] = expf(ct);
          fs[t] = dts[t] * expf(total - ct);
        }
      }
    }
    __syncthreads();
    const float total = cs[QT - 1];
    const float* Sc = St + (c & 1) * kPS * L::kSRow;
    float* Sn = St + ((c + 1) & 1) * kPS * L::kSRow;

    if (warp < 4) {
      // ---- outputs: warp w < 4 takes the rows of l tiles w and 7 - w
      const float* Gc = G + ((long long)b * nc + c) * kQ * kQ;
#pragma unroll 1
      for (int k = 0; k < 2; ++k) {
        const int mt = k ? 7 - warp : warp;
        if (mt >= MT) continue;
        const int ra = mt * 16 + g, rb = ra + 8;
        float acc[4][4] = {};
        // carried state: C_l . (S_hi + S_lo)^T
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(smem_u32(Cs + (mt * 16 + (lane & 15)) * L::kRow +
                               kk * 16 + (lane >> 4) * 8),
                      af);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float* sr = Sc + (nt * 8 + g) * L::kSRow + kk * 16 + 2 * tq;
            const float2 s0 = *reinterpret_cast<const float2*>(sr);
            const float2 s1 = *reinterpret_cast<const float2*>(sr + 8);
            uint32_t h0, l0, h1, l1;
            split2(s0.x, s0.y, h0, l0);
            split2(s1.x, s1.y, h1, l1);
            mma_bf16(acc[nt], af, h0, h1);
            mma_bf16(acc[nt], af, l0, l1);
          }
        }
        const float ea = eo[ra], eb = eo[rb], csa = cs[ra], csb = cs[rb];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
        // intra-chunk: M' = G * exp(cs_l - cs_s) * dt_s, s tiles up to the
        // diagonal; the next G tile is loaded while this one computes
        float2 gn[4];
        auto load_g = [&](int st) {
          const int col = st * 16 + 2 * tq;
          gn[0] = __ldg(reinterpret_cast<const float2*>(Gc + ra * kQ + col));
          gn[1] = __ldg(reinterpret_cast<const float2*>(Gc + rb * kQ + col));
          gn[2] =
              __ldg(reinterpret_cast<const float2*>(Gc + ra * kQ + col + 8));
          gn[3] =
              __ldg(reinterpret_cast<const float2*>(Gc + rb * kQ + col + 8));
        };
        load_g(0);
#pragma unroll 1
        for (int st = 0; st <= mt; ++st) {
          const float2 gv[4] = {gn[0], gn[1], gn[2], gn[3]};
          if (st < mt) load_g(st + 1);
          const int sc = st * 16 + 2 * tq;  // columns sc, sc+1, sc+8, sc+9
          const int cols[4] = {sc, sc + 1, sc + 8, sc + 9};
          float cc[4], dd[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cc[j] = cs[cols[j]];
            dd[j] = dts[cols[j]];
          }
          // element e of register r: row (r & 1 ? rb : ra), column
          // cols[2 * (r >> 1) + e]
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = r & 1 ? rb : ra;
            const float cr = r & 1 ? csb : csa;
            const int j0 = 2 * (r >> 1);
            const float m0 = cols[j0] <= row
                                 ? gv[r].x * expf(cr - cc[j0]) * dd[j0]
                                 : 0.f;
            const float m1 = cols[j0 + 1] <= row
                                 ? gv[r].y * expf(cr - cc[j0 + 1]) * dd[j0 + 1]
                                 : 0.f;
            split2(m0, m1, ahi[r], alo[r]);
          }
#pragma unroll
          for (int pair = 0; pair < 2; ++pair) {
            uint32_t bf[4];
            const int key = st * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            ldmatrix_x4_trans(
                smem_u32(Xs + key * kXS + pair * 16 + (lane >> 4) * 8), bf);
            mma_bf16(acc[2 * pair], ahi, bf[0], bf[1]);
            mma_bf16(acc[2 * pair], alo, bf[0], bf[1]);
            mma_bf16(acc[2 * pair + 1], ahi, bf[2], bf[3]);
            mma_bf16(acc[2 * pair + 1], alo, bf[2], bf[3]);
          }
        }
        // skip term and the bf16 store of rows inside the chunk
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = nt * 8 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = half ? rb : ra;
            if (row < Q) {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(Xs + row * kXS +
                                                           col));
              *reinterpret_cast<__nv_bfloat162*>(
                  y + ((row0 + row) * H + h) * P + p0 + col) =
                  __floats2bfloat162_rn(acc[nt][2 * half] + dskip * xv.x,
                                        acc[nt][2 * half + 1] + dskip * xv.y);
            }
          }
        }
      }
    } else {
      // ---- state, beside the outputs: S_new = S exp(cs_last)
      // + (x dt exp(cs_last - cs))^T . B; warp 4 + w: p rows (w & 1) * 16..,
      // state columns (w >> 1) * N/2..
      constexpr int kNT = N / 16;  // 8-column tiles a warp
      const int wl = warp - 4;
      const int pa = (wl & 1) * 16 + g, n0 = (wl >> 1) * (N / 2);
      const float dec = expf(total);
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + j * 8 + 2 * tq;
        const float2 v0 =
            *reinterpret_cast<const float2*>(Sc + pa * L::kSRow + col);
        const float2 v1 =
            *reinterpret_cast<const float2*>(Sc + (pa + 8) * L::kSRow + col);
        acc[j][0] = v0.x * dec;
        acc[j][1] = v0.y * dec;
        acc[j][2] = v1.x * dec;
        acc[j][3] = v1.y * dec;
      }
#pragma unroll 1
      for (int ks = 0; ks < MT; ++ks) {
        // A = x^T [p, s] by ldmatrix.trans of the [s, p] tile; registers
        // 0, 1 hold s = ks*16 + 2tq + {0, 1}, registers 2, 3 those + 8
        uint32_t xf[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(
            smem_u32(Xs + (ks * 16 + (mi >> 1) * 8 + (lane & 7)) * kXS +
                     (wl & 1) * 16 + (mi & 1) * 8),
            xf);
        const int s0 = ks * 16 + 2 * tq;
        const float f[4] = {fs[s0], fs[s0 + 1], fs[s0 + 8], fs[s0 + 9]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack_bf16(xf[r]);
          const int j0 = 2 * (r >> 1);
          split2(v.x * f[j0], v.y * f[j0 + 1], ahi[r], alo[r]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t bf[2];
          ldmatrix_x2_trans(smem_u32(Bs + (ks * 16 + (lane & 15)) * L::kRow +
                                     n0 + j * 8),
                            bf);
          mma_bf16(acc[j], ahi, bf[0], bf[1]);
          mma_bf16(acc[j], alo, bf[0], bf[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(Sn + pa * L::kSRow + col) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(Sn + (pa + 8) * L::kSRow + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();  // the new state is whole; this stage may be refilled
  }
  cp_async_wait<0>();
  for (int i = threadIdx.x; i < kPS * N; i += kThreads) {
    const int p = i / N, n = i % N;
    final_state[head_state + (long long)(p0 + p) * N + n] =
        St[(nc & 1) * kPS * L::kSRow + p * L::kSRow + n];
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* init, void* G, void* y,
           void* final_state, int b, int s, int h, int p, int chunk,
           cudaStream_t stream) {
  const int qt = (chunk + 15) / 16 * 16;
  ssd_cb_kernel<N><<<dim3(qt / 16, s / chunk, b), 32, 0, stream>>>(
      (const bf16*)B, (const bf16*)C, (float*)G, s, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the opt-in above 48 KB of dynamic shared memory, on the current device
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<N>::kBytes);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory, so two blocks fit at n = 64
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<N>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<N>
      <<<dim3(p / kPS, h, b), kThreads, Layout<N>::kBytes, stream>>>(
          (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
          (const bf16*)C, (const float*)D, (const float*)init,
          (const float*)G, (bf16*)y, (float*)final_state, s, h, p, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the two kernels on `stream` and returns the CUDA error;
// cudaErrorInvalidValue for a shape the kernels do not take. G is fp32
// scratch of b * (s / chunk) * 128 * 128 elements, allocated by the
// caller; x, B and C must be 16-byte aligned.
extern "C" int jbp_ssd_scan(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* D,
                            const void* init, void* G, void* y,
                            void* final_state, int b, int s, int h, int p,
                            int n, int chunk, void* stream) {
  if (b <= 0 || h <= 0 || p <= 0 || p % kPS || chunk <= 0 || chunk > kQ ||
      s <= 0 || s % chunk || b > 65535 || h > 65535 || s / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 16:
      return launch<16>(x, dt, A, B, C, D, init, G, y, final_state, b, s, h,
                        p, chunk, st);
    case 32:
      return launch<32>(x, dt, A, B, C, D, init, G, y, final_state, b, s, h,
                        p, chunk, st);
    case 64:
      return launch<64>(x, dt, A, B, C, D, init, G, y, final_state, b, s, h,
                        p, chunk, st);
    case 128:
      return launch<128>(x, dt, A, B, C, D, init, G, y, final_state, b, s,
                         h, p, chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
