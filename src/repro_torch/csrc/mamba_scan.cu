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
// from the data sheet's rates: the 1.07e9 exps on the special-function
// units (16 per SM per clock, 132 SMs) take 0.257 ms at the card's 1980
// MHz maximum SM clock; 0.674 GB moved (delta, xc and y once each) is
// 0.201 ms at 3.35 TB/s; 6.51 GFLOP of fp32 is 0.097 ms at 67 TFLOP/s.
// So the exps bound it, then the bytes.  Each (step, state) also costs
// four fp32 instructions (d·a, dx·b, the state's fma, y's fma), and an
// SM issues 4 warp instructions a clock: 5 issue slots an element against
// the SFUs' 8, so what a step adds on top (loads, shuffles, stores, the
// chunk's fetch) comes close to the exps' time.  Decode shape (4, 1,
// 8192, 16) from a state: 5.05 MB (h0 read, h_T written) is 0.0015 ms.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, this kernel beside the
// one before it and beside variants of it, in turns in one process
// (scripts/scan_variants.py; PERF.md): at the prefill shape
// 0.3819 ms, 1.49x the SFUs' bound, against 1.0988 ms for the kernel
// before (one thread a channel, its 16 states in registers, accurate
// expf, mul and add rounded apart, each chunk loaded before it computed);
// at the decode shape 0.0051 ms of card time against 0.0110 ms.  126-128
// registers, no spill; 4096 SASS instructions before, 1576 now.  Variants
// at the prefill shape: 4 lanes a channel (32 warps an SM, 64 registers
// and a spill) 0.5549 ms, one
// lane 0.3643 ms (but 0.0105 ms at the decode shape), accurate expf
// 0.6526 ms, the fetch after the compute 0.4065 ms, chunks of 8 steps
// 0.4464 ms, 128-thread blocks 0.4029 ms; with the exps taken out (a
// timing probe, wrong results) 0.3283 ms.  So the kernel before lost its
// time to expf and its instruction count more than to its 8 warps an SM.
//
// Design:
//   * kLanes (2) lanes a channel, each holding n / kLanes of its states
//     (8 at n 16) and those states' a in registers; the lanes' partial
//     sums of y meet by __shfl_xor_sync in butterfly order and the
//     group's first lane writes y.  A block of 64 threads holds 32
//     neighbouring channels of one batch row, and the registers are
//     capped at 128 so that every block of the prefill shape is resident
//     at once (kMinBlocks an SM): 4 x 8192 x 2 lanes is 1024 blocks, 8 an
//     SM on 132 SMs, one wave, 16 warps an SM.
//   * a is pre-scaled by log2(e) once, in registers, and the decay is one
//     FMUL and one ex2.approx.ftz (MUFU.EX2) instead of expf's range
//     reduction; the state takes one fmaf(da, h, dx·b).
//   * The sequence is walked in chunks of kChunk (16) steps through a
//     2-stage ring in shared memory.  Each thread fetches its share of
//     chunk j+1 (delta, xc, b and c rows, coalesced across the block, the
//     same slots of every chunk from pointers that walk the chunks) into
//     registers before chunk j computes, and converts and stores it
//     after: f32 {delta, delta·xc} per (step, channel), f32 b and c rows,
//     so a lane's step reads one float2 and four float4 and converts
//     nothing.  One __syncthreads a chunk.
//   * S = 1 from h0 (a decode step), S = 0, ragged S and ragged widths run
//     the same code: past the width or past S the fetch gives zeros and
//     nothing is written.
//
// Arithmetic order (tests/test_torch_kernels.py emulates it on the CPU):
// a2 = a·log2(e) and d·a2 in f32, then 2^x (ex2.approx: about 2 ulp, not
// emulated); dx = delta·xc in f32 (delta is f32 on the model's path, so
// the product promotes), then dx·b; h = fmaf(da, h, dbx), rounded once;
// each lane sums h·c over its states in order (a product, then fmas), and
// the kLanes partial sums are added in butterfly order.  Against the plain
// version on the card: at most 1.5e-6 of the largest value (the hold is
// 1e-5), against 1.3e-7 for the kernel before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 2;      // lanes a channel, its states split across them
constexpr int kThreads = 64;   // a block
constexpr int kChannels = kThreads / kLanes;  // a block
constexpr int kChunk = 16;     // steps a chunk
constexpr int kMinBlocks = 8;  // blocks an SM the registers allow
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// 2^x on the special-function unit: one MUFU.EX2, subnormal results
// flushed to zero
__device__ __forceinline__ float exp2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// K consecutive floats of shared memory, 16-byte aligned, as float4s
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&v)[K]) {
  static_assert(K % 4 == 0, "a lane's states come in float4s");
#pragma unroll
  for (int i = 0; i < K; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const float* __restrict__ delta, const TX* __restrict__ xc,
            const TX* __restrict__ bm, const TX* __restrict__ cm,
            const float* __restrict__ a, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hT, int S, int inner) {
  constexpr int SL = N / kLanes;                  // states a lane
  constexpr int kPairs = kChunk * kChannels / kThreads;  // (step, channel)
  constexpr int kRows = (kChunk * N + kThreads - 1) / kThreads;  // b, c
  static_assert(N % kLanes == 0 && 32 % kLanes == 0, "lanes split n");
  static_assert(kChunk * kChannels % kThreads == 0, "whole fetches");
  __shared__ __align__(16) float2 dx_s[2][kChunk][kChannels];  // d, d·x
  __shared__ __align__(16) float b_s[2][kChunk * N];
  __shared__ __align__(16) float c_s[2][kChunk * N];

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int cc = tid / kLanes, sub = tid % kLanes;
  const int ch = c0 + cc;
  const bool live = ch < inner;
  const long long state0 = ((long long)row * inner + ch) * N + sub * SL;

  float h[SL], a2[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    a2[j] = live ? a[(long long)ch * N + sub * SL + j] * kLog2e : 0.f;
    h[j] = (live && h0 != nullptr) ? h0[state0 + j] : 0.f;
  }

  const long long t_row = (long long)row * S;  // flat (row, t = 0)
  // A thread fetches the same (step, channel) slots of every chunk: steps
  // f_t, f_t + kEvery, ... of channel c0 + f_ch, and b and c entries tid,
  // tid + kThreads, ... of the chunk's rows; the pointers walk the chunks.
  constexpr int kEvery = kThreads / kChannels;
  const int f_t = tid / kChannels, f_ch = tid % kChannels;
  const bool f_live = c0 + f_ch < inner;
  const long long f_stride = (long long)kEvery * inner;
  const float* dp = delta + (t_row + f_t) * inner + c0 + f_ch;
  const TX* xp = xc + (t_row + f_t) * inner + c0 + f_ch;
  const TX* bp = bm + t_row * N + tid;
  const TX* cp = cm + t_row * N + tid;
  float f_d[kPairs];
  TX f_x[kPairs], f_b[kRows], f_c[kRows];
  auto fetch = [&](int t0) {  // chunk t0's share of this thread, raw
    const int left = S - t0 - f_t;  // steps of the chunk at or after f_t
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const bool ok = f_live && i * kEvery < left;
      f_d[i] = ok ? dp[i * f_stride] : 0.f;
      f_x[i] = ok ? xp[i * f_stride] : zero<TX>();
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int it = tid + i * kThreads;
      const bool ok = it < kChunk * N && it / N < S - t0;
      f_b[i] = ok ? bp[i * kThreads] : zero<TX>();
      f_c[i] = ok ? cp[i * kThreads] : zero<TX>();
    }
    dp += kChunk * (long long)inner;
    xp += kChunk * (long long)inner;
    bp += kChunk * N;
    cp += kChunk * N;
  };
  auto stash = [&](int st) {  // ... converted into stage st
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int it = tid + i * kThreads;
      dx_s[st][it / kChannels][it % kChannels] =
          make_float2(f_d[i], f_d[i] * to_f32(f_x[i]));
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int it = tid + i * kThreads;
      if (it < kChunk * N) {
        b_s[st][it] = to_f32(f_b[i]);
        c_s[st][it] = to_f32(f_c[i]);
      }
    }
  };
  auto step = [&](int st, int tt, float*& yq) {
    const float2 v = dx_s[st][tt][cc];
    float bv[SL], cv[SL];
    load_row(&b_s[st][tt * N + sub * SL], bv);
    load_row(&c_s[st][tt * N + sub * SL], cv);
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      h[j] = fmaf(exp2_sfu(v.x * a2[j]), h[j], v.y * bv[j]);
      p = j == 0 ? h[j] * cv[j] : fmaf(h[j], cv[j], p);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (sub == 0 && live) *yq = p;
    yq += inner;
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  float* yq = y + t_row * inner + ch;
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j & 1;
    const bool more = j + 1 < n_chunks;
    if (more) fetch((j + 1) * kChunk);  // in flight while chunk j computes
    const int steps = min(kChunk, S - j * kChunk);
    if (steps == kChunk) {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) step(st, tt, yq);
    } else {
      for (int tt = 0; tt < steps; ++tt) step(st, tt, yq);
    }
    if (more) stash(st ^ 1);  // stage st ^ 1 was last read in chunk j - 1
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SL; ++j) hT[state0 + j] = h[j];
  }
}

template <typename TX, int N>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&scan_kernel<TX, N>);
}

template <typename TX, int N>
void launch(const void* delta, const void* xc, const void* bm, const void* cm,
            const void* a, const void* h0, void* y, void* hT, int B, int S,
            int inner, cudaStream_t stream) {
  const dim3 grid((inner + kChannels - 1) / kChannels, B);
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

// The launch geometry of the build for state size n and x_bf16, into
// out[0..6]: lanes a channel, threads a block, channels a block, steps a
// chunk, blocks an SM at most (the occupancy calculator's), registers a
// thread and local memory bytes a thread (spills) of the kernel as loaded.
// Returns a cudaError.
extern "C" int mamba_scan_geometry(int n, int x_bf16, int* out) {
  const void* fn = nullptr;
  if (n == 8) fn = x_bf16 ? kernel_of<__nv_bfloat16, 8>()
                          : kernel_of<float, 8>();
  if (n == 16) fn = x_bf16 ? kernel_of<__nv_bfloat16, 16>()
                           : kernel_of<float, 16>();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t rc =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (rc != cudaSuccess) return (int)rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = kLanes;
  out[1] = kThreads;
  out[2] = kChannels;
  out[3] = kChunk;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  return 0;
}
