// Hopper kernel for the RG-LRU gated linear recurrence.
//
// K6  rglru_scan  a, b (B, S, W) f32; h0 (B, W) f32 or none
//                 -> h (B, S, W) f32
//     h[t] = a[t] · h[t-1] + b[t] elementwise over the width, h[-1] = h0
//     (zeros when absent).
//     Replaces the TPU kernel src/repro/kernels/rglru/rglru.py::rglru_scan
//     (_rglru_kernel), which starts from zeros; with h0 absent this is its
//     function.  Called by repro_torch/models/recurrent.py::RGLRUMixer once
//     per RG-LRU layer: for the prefill (S = prompt length, h0 absent) and for
//     each decode step (S = 1, h0 = the cached state).  h[:, S-1] is the new
//     state.
//
//     Each step is one fused multiply-add, fmaf(a, h, b), rounded once.  The
//     reference's step form (the lax.scan of src/repro/models/recurrent.py::
//     rglru_mix from a state) rounds the same way on XLA:CPU, where LLVM
//     contracts a·h + b into one FMA (tests/test_torch_hybrid.py::
//     test_plain_step_rounds_as_the_references prints how many steps equal
//     an FMA and how many a separately rounded product and sum; LLVM's
//     contraction may depend on the host).  Its fresh form is the
//     associative linear_scan, which sums in another order, so a prefill
//     matches the reference to f32 rounding, not bit for bit.
//
// Bound on an H100 at RecurrentGemma-9B's prefill shape (B 2, S 4096,
// W 4096), as chip_smoke.py reckons it from the data sheet's rate: a, b and
// h pass once each, 3 x 134 MB = 403 MB, 0.120 ms at 3.35 TB/s; the 3.4e7
// FMAs are nothing beside that.  So the bytes bound it.
//
// Design (a simple first kernel): one thread per (batch row, width column),
// the recurrence as a loop over S inside the thread (the TPU kernel's
// sequential grid axis; Hopper's blocks run in no order).  A block holds
// kThreads neighbouring columns of one batch row, so every load and store of
// a warp is 128 contiguous bytes.  The sequence is walked in chunks of
// kChunk steps: a thread first loads its column's a and b for the whole
// chunk (2 x kChunk loads in flight, independent of h), then runs the chunk's
// steps from registers and stores each h.  Small blocks spread B·W / kThreads
// blocks over the SMs: at B 2, W 4096 that is 128 blocks for 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ h, int S,
             int W) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= W) return;  // no barrier below: a thread past W may leave
  float state = h0 != nullptr ? h0[(long long)row * W + col] : 0.f;
  const long long base = (long long)row * S * W + col;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    float av[kChunk], bv[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      av[t] = 0.f;
      bv[t] = 0.f;
      if (t < steps) {
        const long long off = base + (long long)(t0 + t) * W;
        av[t] = a[off];
        bv[t] = b[off];
      }
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < steps) {
        state = fmaf(av[t], state, bv[t]);
        h[base + (long long)(t0 + t) * W] = state;
      }
    }
  }
}

}  // namespace

// h0 may be null (a zero initial state).  Returns cudaGetLastError().
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* h, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h, S, W);
  return (int)cudaGetLastError();
}
