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
// state.
//
// Bound on an H100 SXM at zamba2-2.7b's prefill (b=4, s=512, h=80, p=64,
// n=64): x, y (bf16), dt, B, C and the fp32 final state are ~48 MB, 14 us at
// 3.35 TB/s; the ~4 GFLOP the data needs (C.B once per batch and chunk,
// the decay-masked product and the two state terms per head) take ~60 us at
// the 67 TFLOP/s of fp32. So the bound is set by operations.
//
// Design (simple first): one block of 256 threads per (h, b) walks the
// chunks in order, which takes the place of the TPU's sequential grid
// axis; the state lives in shared memory in fp32 ([N][P], transposed so a
// warp reads consecutive p) for the whole sequence. Per chunk the block
// stages B and C as bf16 rows padded to n+2 (bf16 is exact for them, and
// the padding puts 32 consecutive rows in 32 banks), x*dt [Q][P] in fp32
// and the decay-masked scores M [Q][Q+1] in fp32. At Q=128, p=64 that is
// 151 KB for n=64 and 200 KB for n=128, above the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute. All products are fp32 FMAs;
// C.B is recomputed for every head (the heads share B and C), which a
// later change can hoist.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ A,
                const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm,
                const float* __restrict__ Dv, const float* __restrict__ init,
                __nv_bfloat16* __restrict__ y, float* __restrict__ final_state,
                int S, int H, int P, int N, int Q) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int NB = N + 2;  // padded bf16 row of B and C
  extern __shared__ __align__(16) float smem[];
  float* St = smem;              // state, [N][P]
  float* xdt = St + N * P;       // [Q][P]
  float* M = xdt + Q * P;        // [Q][Q+1]
  float* cs = M + Q * (Q + 1);   // [Q] cumulative dt*A
  float* od = cs + Q;            // [Q] exp(cs_l)
  float* ds = od + Q;            // [Q] exp(cs_last - cs_s)
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(ds + Q);  // [Q][NB]
  __nv_bfloat16* Cs = Bs + Q * NB;                                // [Q][NB]

  const float a = A[h], dskip = Dv[h];
  const long long head_state = ((long long)b * H + h) * P * N;
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) {
    const int n = idx / P, p = idx % P;
    St[idx] = init ? init[head_state + (long long)p * N + n] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk is consumed
    const long long row0 = (long long)b * S + c0;  // first (b, t) row
    for (int idx = threadIdx.x; idx < Q * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      Bs[t * NB + n] = Bm[(row0 + t) * N + n];
      Cs[t * NB + n] = Cm[(row0 + t) * N + n];
    }
    for (int idx = threadIdx.x; idx < Q * P; idx += kThreads) {
      const int t = idx / P, p = idx % P;
      xdt[idx] = __bfloat162float(x[((row0 + t) * H + h) * P + p]) *
                 dt[(row0 + t) * H + h];
    }
    if (threadIdx.x < 32) {  // inclusive scan of dt*A, 4 steps a lane
      const int lane = threadIdx.x;
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        run += t < Q ? dt[(row0 + t) * H + h] * a : 0.f;
        v[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float before = tot - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        if (t < Q) cs[t] = before + v[e];
      }
    }
    __syncthreads();

    const float total = cs[Q - 1];
    for (int t = threadIdx.x; t < Q; t += kThreads) {
      od[t] = expf(cs[t]);
      ds[t] = expf(total - cs[t]);
    }
    // decay-masked scores
    for (int idx = threadIdx.x; idx < Q * Q; idx += kThreads) {
      const int l = idx / Q, s = idx % Q;
      float val = 0.f;
      if (s <= l) {
        const __nv_bfloat162* cr =
            reinterpret_cast<const __nv_bfloat162*>(Cs + l * NB);
        const __nv_bfloat162* br =
            reinterpret_cast<const __nv_bfloat162*>(Bs + s * NB);
        float dot = 0.f;
        for (int n2 = 0; n2 < N / 2; ++n2) {
          const float2 cf = __bfloat1622float2(cr[n2]);
          const float2 bf = __bfloat1622float2(br[n2]);
          dot = fmaf(cf.x, bf.x, dot);
          dot = fmaf(cf.y, bf.y, dot);
        }
        val = dot * expf(cs[l] - cs[s]);
      }
      M[l * (Q + 1) + s] = val;
    }
    __syncthreads();

    // outputs: intra-chunk term, carried-state term, skip
    for (int idx = threadIdx.x; idx < Q * P; idx += kThreads) {
      const int l = idx / P, p = idx % P;
      float intra = 0.f;
      for (int s = 0; s <= l; ++s)
        intra = fmaf(M[l * (Q + 1) + s], xdt[s * P + p], intra);
      const __nv_bfloat162* cr =
          reinterpret_cast<const __nv_bfloat162*>(Cs + l * NB);
      float carried = 0.f;
      for (int n2 = 0; n2 < N / 2; ++n2) {
        const float2 cf = __bfloat1622float2(cr[n2]);
        carried = fmaf(cf.x, St[(2 * n2) * P + p], carried);
        carried = fmaf(cf.y, St[(2 * n2 + 1) * P + p], carried);
      }
      const long long xi = ((row0 + l) * H + h) * P + p;
      const float out = intra + carried * od[l] +
                        dskip * __bfloat162float(x[xi]);
      y[xi] = __float2bfloat16(out);
    }
    __syncthreads();  // every read of the old state is done

    const float decay_all = expf(total);
    for (int idx = threadIdx.x; idx < N * P; idx += kThreads) {
      const int n = idx / P, p = idx % P;
      float upd = 0.f;
      for (int s = 0; s < Q; ++s)
        upd = fmaf(xdt[s * P + p] * ds[s], __bfloat162float(Bs[s * NB + n]),
                   upd);
      St[idx] = St[idx] * decay_all + upd;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    final_state[head_state + idx] = St[n * P + p];
  }
}

}  // namespace

// Launches one block per (h, b) on `stream` with `smem` bytes of dynamic
// shared memory (the wrapper computes it) and returns the CUDA error;
// cudaErrorInvalidValue for a shape the kernel does not take (s not a
// multiple of chunk, chunk > 128, odd n).
extern "C" int jbp_ssd_scan(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* D,
                            const void* init, void* y, void* final_state,
                            int b, int s, int h, int p, int n, int chunk,
                            int smem, void* stream) {
  if (b <= 0 || h <= 0 || p <= 0 || n <= 0 || n % 2 || chunk <= 0 ||
      chunk > 128 || s <= 0 || s % chunk || b > 65535)
    return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB of dynamic shared memory, on the current device;
  // without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<dim3(h, b), kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)dt, (const float*)A,
      (const __nv_bfloat16*)B, (const __nv_bfloat16*)C, (const float*)D,
      (const float*)init, (__nv_bfloat16*)y, (float*)final_state, s, h, p, n,
      chunk);
  return (int)cudaGetLastError();
}
