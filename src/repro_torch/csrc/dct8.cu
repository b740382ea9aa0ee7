// Hopper kernels for the codec's 8x8 block transforms.
//
// K3  dct8_quantize    (n, h, w) f32 -> (n, h/8, w/8, 8, 8) int16
//     sym = rint(D·X·Dᵀ / (qt·qs)) per 8x8 block.
//     Replaces the TPU kernel src/repro/kernels/dct8/dct8.py::dct8_quantize
//     (_dct_kernel).  Called by the encoder's DPCM loop
//     (repro_torch/codec/segment.py::_encode_chunks).
// K1  dct8_dequantize  (n, hb, wb, 8, 8) int16 -> (n, 8·hb, 8·wb) f32
//     out = Dᵀ·(sym·qt·qs)·D per block, written straight into the frame
//     layout (de-blocking fused).
//     Replaces src/repro/kernels/dct8/dct8.py::dct8_dequantize
//     (_idct_kernel).  Called by the decoder (_chunk_residuals) and by the
//     encoder's reconstruction step.
//
// Bound on an H100: memory.  Per pixel K1 moves 6 bytes (2 in, 4 out) and
// K3 6 bytes (4 in, 2 out) for about 32 FLOPs of transform: 6 B / 3.35 TB/s
// = 1.8 ps against 32 FLOP / 67 TFLOP/s (fp32, no tensor cores) = 0.48 ps.
//
// Design: one thread per (block, row i of the 8x8 output).  The 8 threads of
// a block sit next to each other in a warp, so a warp covers 4 neighbouring
// blocks: K1's loads of the 128-byte symbol block are one broadcast per
// 8 threads and its 32-byte row stores land in 8 frame rows of 128 bytes;
// K3 reads 8 frame rows of 128 contiguous bytes and stores 512 contiguous
// bytes of symbols.  D and the quantization table sit in shared memory.
// Each thread does the 2 x 64 multiply-adds of its output row, the least
// work of the separable transform.
//
// Every 8-term dot is summed in the order of the reference's XLA:CPU GEMM
// and of the plain version (codec/transform.py::_dot8): four fused
// multiply-add chains over the term pairs (j, j+4), added pairwise.  The
// explicit _rn intrinsics keep the compiler from contracting or reordering
// them.  So the kernels' symbols equal the reference encoder's; a plain
// GEMM order would flip the symbols that land on a rounding tie.  Rounding
// is rintf (half to even, as jnp.round) after an IEEE division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// sum_t a[t] * m[t * stride] in the reference's order:
// (c0 + c1) + (c2 + c3) with c_j = fma(a[j+4], m[j+4], a[j] * m[j]).
__device__ __forceinline__ float dot8(const float* a, const float* m,
                                      int stride) {
  float c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = __fmaf_rn(a[j + 4], m[(j + 4) * stride],
                     __fmul_rn(a[j], m[j * stride]));
  }
  return __fadd_rn(__fadd_rn(c[0], c[1]), __fadd_rn(c[2], c[3]));
}

__device__ __forceinline__ void load_consts(const float* __restrict__ dmat,
                                            const float* __restrict__ qt,
                                            float qs, float* D, float* Q) {
  const int t = threadIdx.x;
  if (t < 64) {
    D[t] = dmat[t];
  } else if (t < 128) {
    Q[t - 64] = __fmul_rn(qt[t - 64], qs);
  }
  __syncthreads();
}

// One thread: row i of block blk.  sym[blk] is 64 int16 (128 B, 16 B aligned).
__global__ void __launch_bounds__(kThreads)
idct8_kernel(const int16_t* __restrict__ sym, float* __restrict__ out,
             const float* __restrict__ dmat, const float* __restrict__ qt,
             float qs, long long rows, int hb, int wb) {
  __shared__ float D[64];
  __shared__ float Q[64];
  load_consts(dmat, qt, qs, D, Q);
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= rows) return;
  const int i = (int)(g & 7);
  const long long blk = g >> 3;
  const int bx = (int)(blk % wb);
  const long long fy = blk / wb;  // frame * hb + block row

  // coefficients C[j][k] = sym[j][k] * Q[j][k], held column-major:
  // ct[k][j] = C[j][k]
  const int4* s4 = reinterpret_cast<const int4*>(sym + blk * 64);
  float ct[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 v = s4[j];
    const int16_t* r = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) ct[k][j] = __fmul_rn((float)r[k], Q[j * 8 + k]);
  }
  float tmp[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) tmp[k] = dot8(ct[k], D + i, 8);  // sum_j C[j][k] D[j][i]
  float o[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) o[l] = dot8(tmp, D + l, 8);  // sum_k tmp[k] D[k][l]
  const long long w = (long long)wb * 8;
  float4* dst = reinterpret_cast<float4*>(out + (fy * 8 + i) * w + bx * 8);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__global__ void __launch_bounds__(kThreads)
dct8_kernel(const float* __restrict__ x, int16_t* __restrict__ sym,
            const float* __restrict__ dmat, const float* __restrict__ qt,
            float qs, long long rows, int hb, int wb) {
  __shared__ float D[64];
  __shared__ float Q[64];
  load_consts(dmat, qt, qs, D, Q);
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= rows) return;
  const int i = (int)(g & 7);
  const long long blk = g >> 3;
  const int bx = (int)(blk % wb);
  const long long fy = blk / wb;
  const long long w = (long long)wb * 8;

  // the block held column-major: xt[k][j] = X[j][k]
  float xt[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4* src =
        reinterpret_cast<const float4*>(x + (fy * 8 + j) * w + bx * 8);
    const float4 a = src[0], b = src[1];
    xt[0][j] = a.x; xt[1][j] = a.y; xt[2][j] = a.z; xt[3][j] = a.w;
    xt[4][j] = b.x; xt[5][j] = b.y; xt[6][j] = b.z; xt[7][j] = b.w;
  }
  float tmp[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) tmp[k] = dot8(xt[k], D + i * 8, 1);  // sum_j X[j][k] D[i][j]
  int16_t q[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    // coef[i][l] = sum_k tmp[k] D[l][k]; quantize as the reference does
    const float coef = dot8(tmp, D + l * 8, 1);
    q[l] = (int16_t)rintf(__fdiv_rn(coef, Q[i * 8 + l]));
  }
  int4 packed;
  int16_t* p = reinterpret_cast<int16_t*>(&packed);
#pragma unroll
  for (int l = 0; l < 8; ++l) p[l] = q[l];
  reinterpret_cast<int4*>(sym + blk * 64)[i] = packed;
}

inline unsigned grid_for(long long rows) {
  return (unsigned)((rows + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int dct8_dequantize(const void* sym, void* out, const void* dmat,
                               const void* qt, float qs, long long n, int hb,
                               int wb, void* stream) {
  const long long rows = n * hb * wb * 8;
  if (rows > 0) {
    idct8_kernel<<<grid_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)sym, (float*)out, (const float*)dmat,
        (const float*)qt, qs, rows, hb, wb);
  }
  return (int)cudaGetLastError();
}

extern "C" int dct8_quantize(const void* x, void* sym, const void* dmat,
                             const void* qt, float qs, long long n, int hb,
                             int wb, void* stream) {
  const long long rows = n * hb * wb * 8;
  if (rows > 0) {
    dct8_kernel<<<grid_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int16_t*)sym, (const float*)dmat, (const float*)qt,
        qs, rows, hb, wb);
  }
  return (int)cudaGetLastError();
}
