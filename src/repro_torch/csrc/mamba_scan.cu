// Hopper kernel for the Mamba-1 selective scan with fused discretisation
// and C-contraction.
//
// K5  mamba_scan  delta (B, S, inner) f32; xc (B, S, inner), bmat, cmat
//                 (B, S, n) f32 or bf16; a (inner, n) f32;
//                 h0 (B, inner, n) f32 or none
//                 -> y (B, S, inner) f32, hT (B, inner, n) f32
//     per step t, for each channel i and state k:
//       h[i,k] = exp(delta[t,i]·a[i,k]) · h[i,k] + (delta[t,i]·xc[t,i]) · bmat[t,k]
//       y[t,i] = Σ_k h[i,k] · cmat[t,k]
//     Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py::
//     mamba_scan (_mamba_kernel).  That kernel takes da = exp(delta·a) and
//     dbx = delta·xc·b already formed, (B, S, inner, n) f32 each; this one
//     forms them in registers from the (B, S, inner) and (B, S, n) inputs,
//     as the step scan of src/repro/models/recurrent.py::mamba_mix does, so
//     nothing of shape (B, S, inner, n) reaches device memory.  With h0
//     absent (zeros) it computes the TPU kernel's function.  Called by
//     repro_torch/models/recurrent.py::MambaMixer once per layer, for the
//     prefill (S = prompt length, h0 absent) and for each decode step (S = 1,
//     h0 = the cached state).
//
// Bound on an H100 at Falcon-Mamba-7B's prefill shape (B 4, S 2048,
// inner 8192, n 16, delta f32 and xc bf16), as chip_smoke.py reckons it
// from the data sheet's rates: 0.674 GB moved (delta, xc and y once each)
// is 0.201 ms at 3.35 TB/s; 6.51 GFLOP of fp32 is 0.097 ms at 67 TFLOP/s;
// the 1.07e9 exp() on the special-function units (16 per SM per clock,
// 132 SMs) take 0.257 ms at the card's 1980 MHz maximum SM clock.  So the
// exps bound it, then the bytes.  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W: 1.08 and 1.12 ms in two runs, about 4.3x that
// bound (PERF.md): with one thread per channel, batch 4 puts only 8 warps
// on an SM.
//
// Design: one thread per (batch row, channel), its n states and n values
// of a in registers, a loop over S inside the thread (Hopper's blocks run
// in no order, so the sequential grid axis of the TPU kernel becomes this
// loop).  A block holds 128 neighbouring channels of one batch row.  The
// sequence is walked in chunks of kChunk steps: each thread loads its
// channel's delta and xc for the whole chunk first (coalesced across the
// block, kChunk loads in flight per thread), the block stages the chunk's
// bmat and cmat rows in shared memory (read by all 128 channels), then the
// steps run from registers.  y is written per step, coalesced.
//
// Arithmetic order follows the reference step body: delta·a and the exp
// in f32; delta·xc in f32 (delta is f32 on the model's path, so the
// product promotes), then ·b; h = da·h + dbx with the product and the sum
// rounded separately; y summed over k in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ delta, const TX* __restrict__ xc,
            const TX* __restrict__ bm, const TX* __restrict__ cm,
            const float* __restrict__ a, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hT, int S, int inner) {
  __shared__ float b_s[kChunk][N];
  __shared__ float c_s[kChunk][N];
  const int row = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < inner;
  const long long state0 = ((long long)row * inner + ch) * N;

  float h[N], av[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    av[k] = live ? a[(long long)ch * N + k] : 0.f;
    h[k] = (live && h0 != nullptr) ? h0[state0 + k] : 0.f;
  }

  const long long t_row = (long long)row * S;  // flat (row, t = 0)
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's readers are done with b_s, c_s
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      const long long off = (t_row + t0) * N + i;
      b_s[i / N][i % N] = to_f32(bm[off]);
      c_s[i / N][i % N] = to_f32(cm[off]);
    }
    float dv[kChunk], xv[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      dv[tt] = 0.f;
      xv[tt] = 0.f;
      if (live && tt < steps) {
        const long long off = (t_row + t0 + tt) * inner + ch;
        dv[tt] = delta[off];
        xv[tt] = to_f32(xc[off]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < steps) {  // the same for every thread of the block
        const float d = dv[tt];
        const float dx = d * xv[tt];
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float da = expf(d * av[k]);
          const float dbx = dx * b_s[tt][k];
          h[k] = __fadd_rn(__fmul_rn(da, h[k]), dbx);
          acc = fmaf(h[k], c_s[tt][k], acc);
        }
        if (live) y[(t_row + t0 + tt) * inner + ch] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < N; ++k) hT[state0 + k] = h[k];
  }
}

template <typename TX, int N>
void launch(const void* delta, const void* xc, const void* bm, const void* cm,
            const void* a, const void* h0, void* y, void* hT, int B, int S,
            int inner, cudaStream_t stream) {
  const dim3 grid((inner + kThreads - 1) / kThreads, B);
  scan_kernel<TX, N><<<grid, kThreads, 0, stream>>>(
      (const float*)delta, (const TX*)xc, (const TX*)bm, (const TX*)cm,
      (const float*)a, (const float*)h0, (float*)y, (float*)hT, S, inner);
}

template <int N>
void launch_typed(int x_bf16, const void* delta, const void* xc,
                  const void* bm, const void* cm, const void* a,
                  const void* h0, void* y, void* hT, int B, int S, int inner,
                  cudaStream_t stream) {
  if (x_bf16)
    launch<__nv_bfloat16, N>(delta, xc, bm, cm, a, h0, y, hT, B, S, inner,
                             stream);
  else
    launch<float, N>(delta, xc, bm, cm, a, h0, y, hT, B, S, inner, stream);
}

}  // namespace

// x_bf16: 1 when xc, bmat and cmat are bf16, 0 for f32; delta is f32.
// h0 may be null (a zero initial state).  Returns cudaGetLastError().
extern "C" int mamba_scan(const void* delta, const void* xc, const void* bm,
                          const void* cm, const void* a, const void* h0,
                          void* y, void* hT, int B, int S, int inner, int n,
                          int x_bf16, void* stream) {
  if (B <= 0 || inner <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 8:
      launch_typed<8>(x_bf16, delta, xc, bm, cm, a, h0, y, hT, B, S, inner,
                      st);
      break;
    case 16:
      launch_typed<16>(x_bf16, delta, xc, bm, cm, a, h0, y, hT, B, S, inner,
                       st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
