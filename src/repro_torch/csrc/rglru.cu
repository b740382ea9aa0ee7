// Hopper kernels for the RG-LRU gated linear recurrence.
//
// K6  rglru_scan        a, b (B, S, W) f32; h0 (B, W) f32 or none
//                       -> h (B, S, W) f32
//     h[t] = a[t] · h[t-1] + b[t] elementwise over the width, h[-1] = h0
//     (zeros when absent).
//     Replaces the TPU kernel src/repro/kernels/rglru/rglru.py::rglru_scan
//     (_rglru_kernel), which starts from zeros; with h0 absent this is its
//     function.
//
// K6's gated form  rglru_gated_scan
//                       r, i, xc (B, S, W) bf16 or f32 (the activation
//                       dtype); a_param (W,) f32; h0 (B, W) f32 or none
//                       -> h (B, S, W) f32
//     The same recurrence, with each a and b formed in registers from the
//     gates, as repro_torch/models/recurrent.py::RGLRUMixer formed them
//     before it called K6 (kernels/rglru/ref.py::gated_ab), step for step
//     and rounding for rounding:
//       a = expf(fl32(-8·r) · softplus(a_param))      (-8·r is exact)
//       b = sqrtf(max(1 - a·a, 1e-12)) · fl32(fl_dtype(i · xc))
//     each product, difference and root rounded on its own (__fmul_rn,
//     __fsub_rn: nvcc's -fmad=true would otherwise fuse 1 - a·a), softplus
//     as F.softplus takes it (log1pf(expf(x)), x itself above 20), i · xc
//     rounded to the activation dtype.  So a and b never reach device
//     memory.  Called by RGLRUMixer once per RG-LRU layer: for the prefill
//     (S = prompt length, h0 absent) and for each decode step (S = 1, h0
//     = the cached state).  h[:, S-1] is the new state.
//
//     Each step of both forms is one fused multiply-add, fmaf(a, h, b),
//     rounded once, in sequence order: the chain of the kernel before
//     this design, so the standalone form's output is that kernel's.  The
//     reference's step form (the lax.scan of src/repro/models/recurrent.py::
//     rglru_mix from a state) rounds the same way on XLA:CPU, where LLVM
//     contracts a·h + b into one FMA (tests/test_torch_hybrid.py::
//     test_plain_step_rounds_as_the_references prints how many steps equal
//     an FMA and how many a separately rounded product and sum; LLVM's
//     contraction may depend on the host).  Its fresh form is the
//     associative linear_scan, which sums in another order, so a prefill
//     matches the reference to f32 rounding, not bit for bit.
//
// Bounds on an H100 at RecurrentGemma-9B's prefill shape (B 2, S 4096,
// W 4096), as chip_smoke.py reckons them from the data sheet's rate: the
// standalone form moves a, b and h once each, 3 x 134 MB = 403 MB, 0.120
// ms at 3.35 TB/s; the gated form moves r, i and xc in bf16 and h in f32,
// 3 x 67 MB + 134 MB = 336 MB, 0.100 ms.  The ~30 fp32 instructions an
// element of the gated form (expf, the IEEE root, the roundings) are
// 1.0e9, 0.015 ms at 67 TFLOP/s.  So the bytes bound both.
//
// Measured times, the variants tried against this design and their
// registers are in PERF.md §6 (scripts/rglru_variants.py times them).
//
// Design.  There are only B·W independent chains (8,192 at the prefill
// shape), so the depth of the pipeline, not parallelism, has to keep the
// bytes in flight that the card's memory wants (Little's law: ~18 KB an
// SM at ~700 ns).  A block takes a band of kCols neighbouring columns of
// one batch row and walks the sequence in chunks of kSteps steps, with
// two kinds of warps:
//   * producers, one thread a (step of the chunk, kGroup columns): each
//     keeps its own 16-byte pieces of the inputs in a ring of kStages
//     chunks in shared memory, filled by cp.async kStages - 1 chunks
//     ahead.  A step's band is 64 contiguous bytes of each bf16 gate, 128
//     of an f32 input; each copy instruction of a step's producers takes
//     64 contiguous bytes of it (piece_col).  A thread reads back only
//     what it copied, so cp.async.wait_group alone makes a chunk visible
//     to it.  It forms
//     a and b of its step and columns (the gated form's arithmetic above,
//     or a copy for the standalone form) into a double buffer of the
//     chunk's a and b in shared memory;
//   * consumers, one thread a column: the fmaf chain over the chunk the
//     producers formed one iteration earlier, storing h (128 contiguous
//     bytes a warp a step).
// One barrier an iteration hands a chunk from producers to consumers.
// Widths that are not a multiple of kGroup, or tensors not 16-byte
// aligned, take scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCols = 32;    // columns a block: one consumer thread each
constexpr int kSteps = 32;   // steps a chunk
constexpr int kStages = 4;   // chunks in a producer's ring: 3 in flight
constexpr int kGroup = 8;    // columns a producer forms
constexpr int kGroups = kCols / kGroup;
constexpr int kProducers = kSteps * kGroups;
constexpr int kThreads = kCols + kProducers;
constexpr float kC = 8.f;    // the RG-LRU's c: kernels/rglru/ref.py::C_RGLRU

static_assert(kCols % 32 == 0 && kProducers % 32 == 0, "whole warps");
static_assert(kCols % kGroup == 0 && kStages >= 2, "ring of 2 or more");

// the standalone K6: a and b in
struct Stepped {
  using T = float;
  static constexpr int kInputs = 2;
};
// the gated form: r, i and xc in the activation dtype E
template <class E>
struct Gated {
  using T = E;
  static constexpr int kInputs = 3;
};

// 16-byte pieces of one input a producer copies for its kGroup columns
template <class F>
constexpr int kCopies = kGroup * (int)sizeof(typename F::T) / 16;

// a producer's inputs for one step of a chunk
template <class F>
struct Pieces {
  uint4 v[F::kInputs][kCopies<F>];
};

// The first column (in the band) of copy c of producer group g.  A
// group's copies lie kGroups copies apart, so that each copy of a step's
// kGroups producers is one contiguous run of 64 bytes (bf16: one copy, a
// group's 8 columns side by side; f32: columns 4g..4g+3 and 16+4g..).
template <class F>
__device__ __forceinline__ int piece_col(int g, int c) {
  return (c * kGroups + g) * (16 / (int)sizeof(typename F::T));
}

constexpr int kAbFloats = kSteps * kCols;  // a (or b) of one chunk
constexpr int kAbBytes = 2 * 2 * kAbFloats * 4;  // a and b, two chunks
template <class F>
constexpr int kSlotPieces = F::kInputs * kCopies<F> * kProducers;
template <class F>
constexpr int kSmemBytes = kAbBytes + kStages * kSlotPieces<F> * 16;

struct Args {
  const void* in[3];      // a, b  |  r, i, xc
  const float* a_param;   // the gated form's, (W,)
  const float* h0;        // (B, W) or null
  float* h;               // (B, S, W)
  int S, W;
  int vec;                // every piece one aligned 16-byte copy
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first n elements of a 16-byte piece at src, zeros after: the scalar
// path of a width that is not a multiple of kGroup or an unaligned tensor.
template <class T>
__device__ uint4 load_scalar(const T* src, int n) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n) w[q] = s[q];
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < n) w[q / 2] |= (unsigned)s[q] << (16 * (q % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The producer's inputs of step t (group g's columns of the band) into
// its ring slot by cp.async (or by scalar loads).  Nothing where the step
// or the columns lie outside the tensor: what a producer forms there is
// never read.
template <class F>
__device__ __forceinline__ void fetch(const Args& p, long long row_base,
                                      int t, int band, int g, uint4* slot,
                                      int prod) {
  using T = typename F::T;
  if (t >= p.S) return;
  const long long off = row_base + (long long)t * p.W + band;
#pragma unroll
  for (int k = 0; k < F::kInputs; ++k) {
    const T* src = static_cast<const T*>(p.in[k]) + off;
#pragma unroll
    for (int c = 0; c < kCopies<F>; ++c) {
      const int col = piece_col<F>(g, c);
      if (band + col >= p.W) continue;
      uint4* dst = slot + (k * kCopies<F> + c) * kProducers + prod;
      if (p.vec) {
        cp_async16(dst, src + col);
      } else {
        *dst = load_scalar(src + col, p.W - band - col);
      }
    }
  }
}

// the kGroup values of one input's pieces, widened to f32
template <class T, int N>
__device__ __forceinline__ void widen(const uint4 (&v)[N],
                                      float (&out)[kGroup]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const unsigned w[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if constexpr (sizeof(T) == 4) {
        out[c * 4 + m] = __uint_as_float(w[m]);
      } else {  // bf16: the low half first
        out[c * 8 + 2 * m] = __uint_as_float(w[m] << 16);
        out[c * 8 + 2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
      }
    }
  }
}

// x rounded to the activation dtype T, widened back
template <class T>
__device__ __forceinline__ float in_dtype(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// F.softplus(x) as PyTorch takes it on the card (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// a and b of one element from its gates, in the stepped route's roundings
template <class T>
__device__ __forceinline__ void gate(float r, float i, float xc, float sp,
                                     float& a, float& b) {
  a = expf(__fmul_rn(-kC * r, sp));
  const float keep = __fsub_rn(1.f, __fmul_rn(a, a));
  b = __fmul_rn(__fsqrt_rn(keep < 1e-12f ? 1e-12f : keep),  // NaN stays
                in_dtype<T>(__fmul_rn(i, xc)));
}

// a and b of the producer's step and columns (group g) into the chunk's
// buffers, a_out and b_out pointing at the step's row
template <class F>
__device__ __forceinline__ void form(const Pieces<F>& x,
                                     const float (&sp)[kGroup], int g,
                                     float* a_out, float* b_out) {
  using T = typename F::T;
  float a[kGroup], b[kGroup];
  if constexpr (F::kInputs == 2) {
    widen<T>(x.v[0], a);
    widen<T>(x.v[1], b);
  } else {
    float r[kGroup], i[kGroup], xc[kGroup];
    widen<T>(x.v[0], r);
    widen<T>(x.v[1], i);
    widen<T>(x.v[2], xc);
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      gate<T>(r[q], i[q], xc[q], sp[q], a[q], b[q]);
  }
  constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
  for (int q = 0; q < kGroup; q += 4) {
    const int col = piece_col<F>(g, q / kPer) + q % kPer;
    *reinterpret_cast<float4*>(a_out + col) =
        make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]);
    *reinterpret_cast<float4*>(b_out + col) =
        make_float4(b[q], b[q + 1], b[q + 2], b[q + 3]);
  }
}

template <class F>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ab = reinterpret_cast<float*>(smem);  // [chunk & 1][a, b][step][col]
  uint4* ring = reinterpret_cast<uint4*>(smem + kAbBytes);
  const int row = blockIdx.y;
  const int band = blockIdx.x * kCols;
  const long long row_base = (long long)row * p.S * p.W;
  const int chunks = (p.S + kSteps - 1) / kSteps;
  const bool consumer = threadIdx.x < kCols;

  // consumer: its column and state
  const int col = band + (int)threadIdx.x;
  const bool col_in = consumer && col < p.W;
  float state = 0.f;
  if (col_in && p.h0 != nullptr) state = p.h0[(long long)row * p.W + col];
  // producer: its step of a chunk, its columns, their softplus(a_param)
  const int prod = consumer ? 0 : (int)threadIdx.x - kCols;
  const int st = prod / kGroups;
  const int g = prod % kGroups;
  constexpr int kPer = 16 / (int)sizeof(typename F::T);
  float sp[kGroup];
  if (!consumer) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {  // the ring's first chunks
      fetch<F>(p, row_base, s * kSteps + st, band, g,
               ring + s * kSlotPieces<F>, prod);
      cp_async_commit();
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      sp[q] = 0.f;
      if constexpr (F::kInputs == 3) {
        const int col = band + piece_col<F>(g, q / kPer) + q % kPer;
        if (col < p.W) sp[q] = softplus(p.a_param[col]);
      }
    }
  }

  for (int j = 0; j <= chunks; ++j) {
    if (consumer) {
      if (j > 0 && col_in) {  // the chain over chunk j - 1
        const float* a = ab + ((j - 1) & 1) * 2 * kAbFloats + threadIdx.x;
        const float* b = a + kAbFloats;
        const int t0 = (j - 1) * kSteps;
        float* out = p.h + row_base + (long long)t0 * p.W + col;
        const int steps = min(kSteps, p.S - t0);
        if (steps == kSteps) {
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            state = fmaf(a[s * kCols], state, b[s * kCols]);
            out[(long long)s * p.W] = state;
          }
        } else {
          for (int s = 0; s < steps; ++s) {
            state = fmaf(a[s * kCols], state, b[s * kCols]);
            out[(long long)s * p.W] = state;
          }
        }
      }
    } else if (j < chunks) {  // chunk j formed, chunk j + kStages - 1 asked
      const int t = j * kSteps + st;
      fetch<F>(p, row_base, t + (kStages - 1) * kSteps, band, g,
               ring + ((j + kStages - 1) % kStages) * kSlotPieces<F>, prod);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // this thread's copies of chunk j
      Pieces<F> x;
      const uint4* slot = ring + (j % kStages) * kSlotPieces<F>;
#pragma unroll
      for (int k = 0; k < F::kInputs; ++k) {
#pragma unroll
        for (int c = 0; c < kCopies<F>; ++c) {
          x.v[k][c] = slot[(k * kCopies<F> + c) * kProducers + prod];
        }
      }
      if (t < p.S && band + piece_col<F>(g, 0) < p.W) {
        float* a = ab + (j & 1) * 2 * kAbFloats + st * kCols;
        form<F>(x, sp, g, a, a + kAbFloats);
      }
    }
    __syncthreads();
  }
}

template <class F>
int launch(const void* const* in, const float* a_param, const float* h0,
           float* h, int B, int S, int W, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = kSmemBytes<F>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  Args p{};
  p.vec = W % kGroup == 0;
  for (int k = 0; k < F::kInputs; ++k) {
    p.in[k] = in[k];
    p.vec = p.vec && reinterpret_cast<std::uintptr_t>(in[k]) % 16 == 0;
  }
  p.a_param = a_param;
  p.h0 = h0;
  p.h = h;
  p.S = S;
  p.W = W;
  const dim3 grid((W + kCols - 1) / kCols, B);
  scan_kernel<F><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// h0 may be null (a zero initial state).  Returns a cudaError_t.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* h, int B, int S, int W, void* stream) {
  const void* in[2] = {a, b};
  return launch<Stepped>(in, nullptr, (const float*)h0, (float*)h, B, S, W,
                         (cudaStream_t)stream);
}

// The gated form; gate_bf16 is 1 where r, i and xc are bfloat16, 0 where
// they are float32.  h0 may be null.  Returns a cudaError_t.
extern "C" int rglru_gated_scan(const void* r, const void* i, const void* xc,
                                const void* a_param, const void* h0, void* h,
                                int B, int S, int W, int gate_bf16,
                                void* stream) {
  const void* in[3] = {r, i, xc};
  const cudaStream_t st = (cudaStream_t)stream;
  if (gate_bf16 == 1)
    return launch<Gated<__nv_bfloat16>>(in, (const float*)a_param,
                                        (const float*)h0, (float*)h, B, S, W,
                                        st);
  if (gate_bf16 == 0)
    return launch<Gated<float>>(in, (const float*)a_param, (const float*)h0,
                                (float*)h, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}
