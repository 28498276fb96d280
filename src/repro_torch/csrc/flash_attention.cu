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
//
// Layout: q [B,Sq,H,D], k/v [B,Skv,H,D], bf16, read in place through their
// strides (unit stride on D), so the model's layout needs no transpose.
// The output is a fresh contiguous [B,Sq,H,D] bf16 tensor. Ragged Sq/Skv
// are masked here; nothing is padded.
//
// Bound on an H100 SXM at the serving shape (B=4, S=512, H=32, D=80,
// causal): q, k, v and out are 21 MB of bf16, 6.3 us at 3.35 TB/s; the
// ~5.4 GFLOP of the two products take 5.4 us on bf16 tensor cores. So the
// bound is set by bytes.
//
// Design (simple first): one block of 256 threads per (query tile of 64
// rows, h, b). The query tile and each 64-key tile of K are staged in
// shared memory as fp32 and transposed ([D][64]), V as [64][D]; each thread
// owns a 4x4 block of scores (float4 reads from the transposed tiles), its
// 4 rows' m and l (reduced across the 16 threads of a row group with warp
// shuffles), and 4 rows x D/16 columns of the fp32 accumulator. The
// products run on the fp32 FMA units, not the tensor cores; wgmma and TMA
// are for a later change. Loads are 16 bytes a thread (8 bf16), so D must
// be a multiple of 8: D in {32, 64, 80, 128} is instantiated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kTS = kBQ + 4;   // row stride of the transposed tiles (floats)
constexpr int kPS = kBK + 1;   // row stride of the probability tile
constexpr float kNegInf = -1e30f;

// dst[d * kTS + i] = row (row0 + i) of `base`, as fp32; zero past `nrows`.
template <int D>
__device__ void load_transposed(const __nv_bfloat16* base, long long rstride,
                                int row0, int nrows, float* dst) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < kBQ * kVec; idx += kThreads) {
    const int i = idx / kVec, c = idx % kVec, r = row0 + i;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      raw = *reinterpret_cast<const uint4*>(base + (long long)r * rstride +
                                            c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * kTS + i] = __bfloat162float(e[j]);
  }
}

// dst[i * D + d] = row (row0 + i) of `base`, as fp32; zero past `nrows`.
template <int D>
__device__ void load_rows(const __nv_bfloat16* base, long long rstride,
                          int row0, int nrows, float* dst) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < kBK * kVec; idx += kThreads) {
    const int i = idx / kVec, c = idx % kVec, r = row0 + i;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      raw = *reinterpret_cast<const uint4*>(base + (long long)r * rstride +
                                            c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[i * D + c * 8 + j] = __bfloat162float(e[j]);
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr int smem_bytes() {
  return (2 * D * kTS + kBK * D + kBQ * kPS) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, int H, int Sq,
                 int Skv, int causal, float scale) {
  constexpr int kDPT = D / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][kTS]
  float* Kt = Qt + D * kTS;      // [D][kTS]
  float* Vs = Kt + D * kTS;      // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][kPS]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  load_transposed<D>(q + b * qsb + h * qsh, qss, q0, Sq, Qt);

  float m[4], l[4], acc[4][kDPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) acc[ii][c] = 0.f;
  }

  // keys past the tile's last row are masked for every row of the tile
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_transposed<D>(kb, kss, k0, Skv, Kt);
    load_rows<D>(vb, vss, k0, Skv, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kTS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kTS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(av[ii], cv[jj], s[ii][jj]);
    }

    float corr[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = q0 + ty * 4 + ii;
      float rmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx * 4 + jj;
        float val = s[ii][jj] * scale;
        if (col >= Skv || (causal && col > row)) val = kNegInf;
        s[ii][jj] = val;
        rmax = fmaxf(rmax, val);
      }
      const float m_new = fmaxf(m[ii], row_max16(rmax));
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[ii][jj] - m_new);
        psum += p;
        Ps[(ty * 4 + ii) * kPS + tx * 4 + jj] =
            __bfloat162float(__float2bfloat16(p));
      }
      corr[ii] = expf(m[ii] - m_new);
      l[ii] = l[ii] * corr[ii] + row_sum16(psum);
      m[ii] = m_new;
    }
    __syncthreads();

    float t[4][kDPT];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int c = 0; c < kDPT; ++c) t[ii][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pv[ii] = Ps[(ty * 4 + ii) * kPS + j];
#pragma unroll
      for (int c = 0; c < kDPT; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) t[ii][c] = fmaf(pv[ii], vv, t[ii][c]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int c = 0; c < kDPT; ++c) acc[ii][c] = acc[ii][c] * corr[ii] + t[ii][c];
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = q0 + ty * 4 + ii;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[ii], 1e-30f);
    __nv_bfloat16* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kDPT; ++c)
      orow[tx + 16 * c] = __float2bfloat16(acc[ii][c] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int Sq, int Skv, int causal,
           float scale, cudaStream_t stream) {
  // the opt-in above 48 KB of dynamic shared memory, on the current device;
  // without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], H, Sq, Skv, causal, scale);
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
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    case 64: return launch<64>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    case 80: return launch<80>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    case 128: return launch<128>(q, k, v, o, st, B, H, Sq, Skv, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
