// Hopper kernel for antialiased bilinear resize.
//
// K2  resize_bilinear  (n, h1, w1) f32 -> (n, h2, w2) f32
//     out[f] = R_y · X[f] · R_xᵀ with the triangle-filter weights of
//     jax.image.resize(..., "bilinear") (support widened by the downscale
//     factor, rows normalised).
//     Replaces the TPU kernel src/repro/kernels/resize/resize.py::
//     resize_bilinear (_resize_kernel), which multiplied dense R matrices
//     on the MXU.  Called by spatial_convert, NN's scale pyramid and OCR's
//     plate patch (repro_torch/codec/transform.py::resize).
//
// R_y and R_x are banded: output row i reads input rows y0[i] ..
// y0[i]+ty-1 only, with ty <= 2·ceil(support)+1 taps.  The wrapper passes
// that band (start index and ty weights per output row, zero-padded where
// a row has fewer taps; likewise x0/wx per output column).
//
// Bound on an H100: memory.  Per output pixel the kernel needs 4·(h1·w1)/
// (h2·w2) bytes in and 4 out against 2·(ty·w1/w2 + tx) FLOPs of the
// separable product: at 720p -> 480p, 10 B against ~14 FLOP, 3.0 ps of
// bandwidth to 0.2 ps of fp32 compute.
//
// Design: one thread per output pixel, column fastest, so a warp's loads
// of one input row fall on neighbouring addresses and its stores are
// contiguous.  Each thread sums ty vertical taps for each of its tx
// columns, then the tx column sums: R_y first, as the reference does.  The
// ty·tx input reads of neighbouring threads overlap and are served by
// L1/L2, so device memory sees each input byte about once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resize_kernel(const float* __restrict__ x, float* __restrict__ out,
              long long total, int h1, int w1, int h2, int w2,
              const int* __restrict__ y0, const float* __restrict__ wy, int ty,
              const int* __restrict__ x0, const float* __restrict__ wx,
              int tx) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const int j = (int)(g % w2);
  const long long r = g / w2;
  const int i = (int)(r % h2);
  const long long f = r / h2;
  const float* src = x + f * h1 * (long long)w1 + (long long)y0[i] * w1 + x0[j];
  const float* wyi = wy + (long long)i * ty;
  const float* wxj = wx + (long long)j * tx;
  float acc = 0.f;
  for (int b = 0; b < tx; ++b) {
    float v = 0.f;
    for (int a = 0; a < ty; ++a) v = fmaf(wyi[a], src[(long long)a * w1 + b], v);
    acc = fmaf(wxj[b], v, acc);
  }
  out[g] = acc;
}

}  // namespace

extern "C" int resize_bilinear(const void* x, void* out, long long n, int h1,
                               int w1, int h2, int w2, const void* y0,
                               const void* wy, int ty, const void* x0,
                               const void* wx, int tx, void* stream) {
  const long long total = n * h2 * (long long)w2;
  if (total > 0) {
    const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
    resize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, total, h1, w1, h2, w2, (const int*)y0,
        (const float*)wy, ty, (const int*)x0, (const float*)wx, tx);
  }
  return (int)cudaGetLastError();
}
