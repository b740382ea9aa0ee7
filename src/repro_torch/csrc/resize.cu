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
// separable product: at 720p -> 544p, 10 B against ~14 FLOP, 3.0 ps of
// bandwidth to 0.2 ps of fp32 compute.
//
// Arithmetic: each output is the chain
//   v_c = fmaf(wy[ty-1], x[y0+ty-1][c], ... fmaf(wy[0], x[y0][c], 0))
//   out = fmaf(wx[tx-1], v_{x0+tx-1}, ... fmaf(wx[0], v_{x0}, 0))
// in this order: R_y first, one sequential fused multiply-add chain per
// sum, as XLA:CPU's dot computes jax.image.resize (ROADMAP §3.4).  The
// one-thread-an-output form this kernel replaced computed the same chains,
// so the two agree bit for bit (scripts/resize_variants.py counts it).
//
// Design: one block per tile of kTH output rows x TW output columns of one
// frame, in two passes.  The vertical pass computes v for each (output
// row, input column) of the tile's column band once, into shared memory:
// a warp takes a row, its lanes kVec columns 32 apart, so a warp's loads
// of an input row are contiguous, and kGroup taps' loads go out together
// before their chains.  The tile's input rows (about kTH·h1/h2 + ty) come
// from device memory about once, the ty-1 rows shared with the next row
// tile again from L2.  The horizontal pass reads each output's tx sums from
// shared memory, a thread one column and kTH·TW/kThreads rows, so its tx
// weights are loaded once and its stores are contiguous along the row.
// Index arithmetic is 32-bit and done once a block; the grid is 1-D.
// The host plans the tile (resize_plan): TW narrows from kTW while the
// column band of a wide downscale overflows the default 48 KB of shared
// memory; kernels/resize/resize.py::tile_plan is its twin.
// What holds it (H100, scripts/resize_variants.py): the vertical pass, a
// round trip to memory a row of loads in flight; 64 registers keep 4
// blocks an SM.

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 16;         // output rows of a tile
constexpr int kTW = 128;        // output columns of a tile, before narrowing
constexpr int kThreads = 256;
constexpr int kVec = 8;         // columns a lane of the vertical pass holds
constexpr int kGroup = 4;       // taps whose loads go out together
constexpr int kMinTW = kThreads / kTH;
constexpr int kSmemDefault = 48 * 1024;  // without opting in
constexpr int kSmemMax = 232448;         // a block's most, opted in

// The widest column band [x0[j0], x0[j_last] + taps) of a tile of tw output
// columns: x0 rises by at most ceil(d·n_in/n_out) over d columns, plus one
// for its float32 rounding.
int column_span(int n_in, int n_out, int taps, int tw) {
  const long long d = (tw < n_out ? tw : n_out) - 1;
  const long long span = (d * n_in + n_out - 1) / n_out + taps + 1;
  return (int)(span < n_in ? span : n_in);
}

struct Plan {
  int tw;           // output columns of a tile
  int span;         // input columns of the widest band: the sums' row
  long long bytes;  // dynamic shared memory a block: kTH rows of span sums
};

Plan plan_tiles(int w1, int w2, int tx) {
  Plan p{kTW, 0, 0};
  for (;; p.tw /= 2) {
    p.span = column_span(w1, w2, tx, p.tw);
    p.bytes = (long long)kTH * p.span * (long long)sizeof(float);
    if (p.bytes <= kSmemDefault || p.tw == kMinTW) return p;
  }
}

template <int TW>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const float* __restrict__ x, float* __restrict__ out, int h1,
              int w1, int h2, int w2, const int* __restrict__ y0,
              const float* __restrict__ wy, int ty,
              const int* __restrict__ x0, const float* __restrict__ wx,
              int tx, int col_tiles, int row_tiles, int ld) {
  static_assert(kThreads % TW == 0 && kTH % (kThreads / TW) == 0,
                "a thread's rows of the horizontal pass");
  extern __shared__ float vsum[];  // [kTH][ld]: the tile's vertical sums
  const int ct = blockIdx.x % col_tiles;
  const int rest = blockIdx.x / col_tiles;
  const int i0 = rest % row_tiles * kTH;
  const int f = rest / row_tiles;
  const int j0 = ct * TW;
  const int rows = min(kTH, h2 - i0);
  const int cols = min(TW, w2 - j0);
  const int base = __ldg(x0 + j0);
  const int span = __ldg(x0 + j0 + cols - 1) + tx - base;
  if (span > ld) __trap();  // resize_plan bounds every tile's band
  const float* src = x + (size_t)f * h1 * w1 + base;

  // vertical pass: a warp a row, kVec columns 32 apart a lane; kGroup taps'
  // loads go out together before their chains
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int i = i0 + r;
    const float* xi = src + __ldg(y0 + i) * w1 + lane;
    const float* wi = wy + i * ty;
    float* vr = vsum + r * ld + lane;
    for (int c0 = 0; c0 < span; c0 += 32 * kVec) {
      bool in[kVec];
      float v[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        in[u] = c0 + 32 * u + lane < span;
        v[u] = 0.f;
      }
      for (int a0 = 0; a0 < ty; a0 += kGroup) {
        float w[kGroup], t[kGroup][kVec];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const bool tap = a0 + q < ty;
          w[q] = tap ? __ldg(wi + a0 + q) : 0.f;
          const float* xa = xi + (a0 + q) * w1 + c0;
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            t[q][u] = tap && in[u] ? __ldg(xa + 32 * u) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (a0 + q < ty) {
#pragma unroll
            for (int u = 0; u < kVec; ++u) v[u] = fmaf(w[q], t[q][u], v[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        if (in[u]) vr[c0 + 32 * u] = v[u];
      }
    }
  }
  __syncthreads();

  // horizontal pass: a thread a column, kRows rows kRowStep apart
  constexpr int kRowStep = kThreads / TW;
  constexpr int kRows = kTH / kRowStep;
  const int jj = threadIdx.x % TW;
  if (jj >= cols) return;
  const int r0 = threadIdx.x / TW;
  const int j = j0 + jj;
  const float* vj = vsum + r0 * ld + (__ldg(x0 + j) - base);
  const float* wj = wx + j * tx;
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
  for (int b0 = 0; b0 < tx; b0 += kGroup) {
    float w[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      w[q] = b0 + q < tx ? __ldg(wj + b0 + q) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (b0 + q < tx) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (r0 + k * kRowStep < rows) {
            acc[k] = fmaf(w[q], vj[k * kRowStep * ld + b0 + q], acc[k]);
          }
        }
      }
    }
  }
  float* o = out + (size_t)f * h2 * w2 + (i0 + r0) * w2 + j;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (r0 + k * kRowStep < rows) o[k * kRowStep * w2] = acc[k];
  }
}

// Launches the build of resize_kernel for the plan's tile width.
template <int TW>
int launch(const Plan& p, unsigned blocks, cudaStream_t stream,
           const float* x, float* out, int h1, int w1, int h2, int w2,
           const int* y0, const float* wy, int ty, const int* x0,
           const float* wx, int tx, int col_tiles, int row_tiles) {
  if constexpr (TW > kMinTW) {
    if (p.tw < TW) {
      return launch<TW / 2>(p, blocks, stream, x, out, h1, w1, h2, w2, y0,
                            wy, ty, x0, wx, tx, col_tiles, row_tiles);
    }
  }
  if (p.bytes > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        resize_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  resize_kernel<TW><<<blocks, kThreads, (size_t)p.bytes, stream>>>(
      x, out, h1, w1, h2, w2, y0, wy, ty, x0, wx, tx, col_tiles, row_tiles,
      p.span);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile resize_bilinear launches for an output w2 columns wide from w1
// with tx taps: plan[0] output columns a tile, plan[1] input columns of
// its widest band, plan[2] bytes of dynamic shared memory a block.
extern "C" int resize_plan(int w1, int w2, int tx, long long* plan) {
  const Plan p = plan_tiles(w1, w2, tx);
  plan[0] = p.tw;
  plan[1] = p.span;
  plan[2] = p.bytes;
  return 0;
}

extern "C" int resize_bilinear(const void* x, void* out, long long n, int h1,
                               int w1, int h2, int w2, const void* y0,
                               const void* wy, int ty, const void* x0,
                               const void* wx, int tx, void* stream) {
  if (n <= 0 || h2 <= 0 || w2 <= 0) return (int)cudaGetLastError();
  const Plan p = plan_tiles(w1, w2, tx);
  const long long col_tiles = (w2 + p.tw - 1) / p.tw;
  const long long row_tiles = (h2 + kTH - 1) / kTH;
  const long long blocks = n * row_tiles * col_tiles;
  // 32-bit offsets within a frame, a 1-D grid, a block's shared memory
  if ((long long)h1 * w1 > 0x7fffffffLL || (long long)h2 * w2 > 0x7fffffffLL
      || blocks > 0x7fffffffLL || p.bytes > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<kTW>(p, (unsigned)blocks, (cudaStream_t)stream,
                     (const float*)x, (float*)out, h1, w1, h2, w2,
                     (const int*)y0, (const float*)wy, ty, (const int*)x0,
                     (const float*)wx, tx, (int)col_tiles, (int)row_tiles);
}
