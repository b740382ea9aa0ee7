// Hopper kernels for the codec's 8x8 block transforms.
//
// K3  dct8_quantize    (n, h, w) f32 -> (n, h/8, w/8, 8, 8) int16
//     sym = rint(D·X·Dᵀ / (qt·qs)) per 8x8 block.
//     Replaces the TPU kernel src/repro/kernels/dct8/dct8.py::dct8_quantize
//     (_dct_kernel).  K3's one-to-one counterpart; the encoder runs its
//     chunk form below.
// K3, encoder form: dct8_encode_chunks
//     (n, h, w) u8 -> (C, ke, h/8, w/8, 8, 8) int16, C = ceil(n/k),
//     ke = min(k, n): every chunk of k frames DPCM-coded in one launch.
//     Replaces the reference's encoder scan over K3 and K1
//     (src/repro/codec/segment.py::_encode_chunk, a lax.scan of
//     dct8_quantize and dct8_dequantize).  Called by
//     repro_torch/codec/segment.py::_encode_chunks.
// K1  dct8_dequantize  (n, hb, wb, 8, 8) int16 -> (n, 8·hb, 8·wb) f32
//     out = Dᵀ·(sym·qt·qs)·D per block, written straight into the frame
//     layout (de-blocking fused).
//     Replaces src/repro/kernels/dct8/dct8.py::dct8_dequantize
//     (_idct_kernel).  Called by the decoder (_chunk_residuals).
//
// Bound on an H100: K1 and K3 alone move 6 bytes a pixel (f32 one way,
// int16 the other) for about 33 FLOPs of transform: memory.  The encoder
// form moves 3 (u8 in, int16 out) for about 66 (K3 + K1): 3 B / 3.35 TB/s
// = 0.9 ps against 66 FLOP / 67 TFLOP/s = 1.0 ps, so operations, and in
// practice instruction issue: a thread's step codes 8 pixels with ~430
// floating-point instructions (two 8x8 transforms, 8 IEEE divisions),
// ~50 shared-memory accesses and the loop's integer work.
//
// Design of K1 and K3: one thread per (block, row i of the 8x8 output).
// The 8 threads of a block sit next to each other in a warp, so a warp
// covers 4 neighbouring blocks: K1's loads of the 128-byte symbol block
// are one broadcast per 8 threads and its 32-byte row stores land in 8
// frame rows of 128 bytes; K3 reads 8 frame rows of 128 contiguous bytes
// and stores 512 contiguous bytes of symbols.  D and the quantization
// table sit in shared memory.  Each thread does the 2 x 64 multiply-adds
// of its output row (dct8_row, idct8_row), the least work of the
// separable transform.
//
// Design of the encoder form: an 8x8 block's DPCM recurrence reads only the
// same block of the previous reconstructed frame, so a chunk's whole scan
// runs in the block's own 8 threads, one a row, with the prediction in
// registers for the whole chunk: per step a thread loads its u8 row (8
// bytes), subtracts the prediction, exchanges the residual rows through the
// warp's shared memory (transposed, so that a column is read where the row
// body uses it, and the registers stay under the 72 that 28 warps an SM
// allow), codes its coefficient row with dct8_row, stores it, exchanges the
// dequantized rows, runs idct8_row and adds and clamps.  Frame t+1 is
// loaded into registers while step t computes (with 28 warps an SM, deeper
// rings, and 4 threads a block of 2 rows each, gained nothing and cost
// registers: scripts/encode_variants.py).  Each 8-byte row load of 8
// threads a block, 4 blocks a warp, fills 8 whole 32-byte sectors; the
// symbol stores are 512 contiguous bytes a warp.  Blocks of 64 threads
// keep the golden segment (14,400 8x8 blocks, 3,600 warps) in one wave at
// 28 warps an SM.
//
// Every 8-term dot is summed in the order of the reference's XLA:CPU GEMM
// and of the plain version (codec/transform.py::_dot8): four fused
// multiply-add chains over the term pairs (j, j+4), added pairwise.  The
// explicit _rn intrinsics keep the compiler from contracting or reordering
// them.  So the kernels' symbols equal the reference encoder's; a plain
// GEMM order would flip the symbols that land on a rounding tie.  Rounding
// is rintf (half to even, as jnp.round) after an IEEE division.  For the
// same reason no form uses the tensor cores: an MMA sums in its own order,
// and the work is bound by issue and bytes, not by multiply-add rate.  The
// encoder form runs the same row bodies as K3 and K1, so its symbols equal
// the stepped K3 + K1 route's symbol for symbol.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// the encoder form: threads a block (8 an 8x8 block), and the blocks an SM
// the register budget is sized for
constexpr int kEncThreads = 64;
constexpr int kEncMinBlocks = 14;
// floats between two 8x8 blocks in the exchange: 8 banks apart, so the
// 4 blocks of a warp store their columns without a bank conflict
constexpr int kLd = 72;

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
  for (int t = threadIdx.x; t < 64; t += blockDim.x) {
    D[t] = dmat[t];
    Q[t] = __fmul_rn(qt[t], qs);
  }
  __syncthreads();
}

// The 8x8 f32 block at x, rows ld floats apart (16-byte aligned), held
// column-major: xt[k][j] = X[j][k].
__device__ __forceinline__ void load_block_t(const float* x, long long ld,
                                             float (&xt)[8][8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4* src = reinterpret_cast<const float4*>(x + j * ld);
    const float4 a = src[0], b = src[1];
    xt[0][j] = a.x; xt[1][j] = a.y; xt[2][j] = a.z; xt[3][j] = a.w;
    xt[4][j] = b.x; xt[5][j] = b.y; xt[6][j] = b.z; xt[7][j] = b.w;
  }
}

// K3's row i: the 8 symbols rint(coef[i][l] / Q[i][l]) of coef = D·X·Dᵀ,
// from the block held column-major, packed as 8 int16.
__device__ __forceinline__ int4 dct8_row(const float (&xt)[8][8],
                                         const float* D, const float* Q,
                                         int i) {
  float tmp[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) tmp[k] = dot8(xt[k], D + i * 8, 1);  // sum_j X[j][k] D[i][j]
  int4 packed;
  int16_t* p = reinterpret_cast<int16_t*>(&packed);
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    // coef[i][l] = sum_k tmp[k] D[l][k]; quantize as the reference does
    const float coef = dot8(tmp, D + l * 8, 1);
    p[l] = (int16_t)rintf(__fdiv_rn(coef, Q[i * 8 + l]));
  }
  return packed;
}

// K1's dequantization of one symbol.
__device__ __forceinline__ float dequant(int16_t s, float q) {
  return __fmul_rn((float)s, q);
}

// K1's row i: row i of Dᵀ·C·D, from the dequantized coefficients held
// column-major (ct[k][j] = C[j][k]).
__device__ __forceinline__ void idct8_row(const float (&ct)[8][8],
                                          const float* D, int i,
                                          float (&o)[8]) {
  float tmp[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) tmp[k] = dot8(ct[k], D + i, 8);  // sum_j C[j][k] D[j][i]
#pragma unroll
  for (int l = 0; l < 8; ++l) o[l] = dot8(tmp, D + l, 8);  // sum_k tmp[k] D[k][l]
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

  const int4* s4 = reinterpret_cast<const int4*>(sym + blk * 64);
  float ct[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 v = s4[j];
    const int16_t* r = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) ct[k][j] = dequant(r[k], Q[j * 8 + k]);
  }
  float o[8];
  idct8_row(ct, D, i, o);
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

  float xt[8][8];
  load_block_t(x + fy * 8 * w + bx * 8, w, xt);
  reinterpret_cast<int4*>(sym + blk * 64)[i] = dct8_row(xt, D, Q, i);
}

// The 8x8 f32 block held transposed at xc (column k at xc[8k .. 8k+7],
// 16-byte aligned), column-major as load_block_t gives it: xt[k][j] =
// X[j][k].  Each column is two 16-byte loads, read where it is used.
__device__ __forceinline__ void load_block_cols(const float* xc,
                                                float (&xt)[8][8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4* src = reinterpret_cast<const float4*>(xc + k * 8);
    const float4 a = src[0], b = src[1];
    xt[k][0] = a.x; xt[k][1] = a.y; xt[k][2] = a.z; xt[k][3] = a.w;
    xt[k][4] = b.x; xt[k][5] = b.y; xt[k][6] = b.z; xt[k][7] = b.w;
  }
}

// One group of 8 threads: one 8x8 block (by, bx) of chunk c through the
// chunk's ke frames, thread i coding row i.  The rows are exchanged
// transposed (a thread stores its row as 8 scalars down a column), so that
// the row bodies read each column as two 16-byte loads where they use it:
// fewer registers live than a whole block held at once.
__global__ void __launch_bounds__(kEncThreads, kEncMinBlocks)
encode_chunks_kernel(const uint8_t* __restrict__ frames,
                     int16_t* __restrict__ sym,
                     const float* __restrict__ dmat,
                     const float* __restrict__ qt, float qs, long long n,
                     int h, int w, int k, int ke, long long groups) {
  __shared__ float D[64];
  __shared__ float Q[64];
  // [residual, dequantized][8x8 block of this CUDA block][kLd], each
  // block transposed
  __shared__ __align__(16) float ex[2][kEncThreads / 8][kLd];
  load_consts(dmat, qt, qs, D, Q);
  const long long g = (long long)blockIdx.x * kEncThreads + threadIdx.x;
  const long long blk = g / 8;
  if (blk >= groups) return;  // whole groups: the sync masks stay whole
  const int i = (int)(g % 8);
  float* xs = ex[0][threadIdx.x / 8];
  float* cs = ex[1][threadIdx.x / 8];
  const unsigned mask = 0xffu << (threadIdx.x & 24u);
  const int hb = h / 8, wb = w / 8;
  const int bx = (int)(blk % wb);
  const long long cy = blk / wb;
  const int by = (int)(cy % hb);
  const long long c = cy / hb;
  const long long first = c * k;
  // frames of the chunk: first .. first + tlast (a short tail chunk
  // repeats its last frame)
  const int tlast = (int)((first + k < n ? first + k : n) - 1 - first);
  const long long frame = (long long)h * w;
  const uint8_t* src =
      frames + first * frame + (long long)(by * 8 + i) * w + bx * 8;
  int16_t* dst = sym + ((c * ke * hb + by) * wb + bx) * 64;
  const long long step = (long long)hb * wb * 64;

  auto load = [&](int t) {
    return __ldg(reinterpret_cast<const uint2*>(
        src + (long long)(t < tlast ? t : tlast) * frame));
  };
  uint2 next = load(0);
  float pred[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) pred[l] = 128.0f;

#pragma unroll 1
  for (int t = 0; t < ke; ++t, dst += step) {
    const uint2 px = next;
    next = load(t + 1);

    // the residual row into the exchange
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const unsigned word = l < 4 ? px.x : px.y;
      const float p = (float)((word >> (8 * (l & 3))) & 0xffu);
      xs[l * 8 + i] = __fsub_rn(p, pred[l]);
    }
    __syncwarp(mask);

    // K3: the coefficient row, stored, and dequantized into the exchange
    float xt[8][8];
    load_block_cols(xs, xt);
    const int4 q = dct8_row(xt, D, Q, i);
    reinterpret_cast<int4*>(dst)[i] = q;
    const int16_t* s = reinterpret_cast<const int16_t*>(&q);
#pragma unroll
    for (int l = 0; l < 8; ++l) cs[l * 8 + i] = dequant(s[l], Q[i * 8 + l]);
    __syncwarp(mask);

    // K1: the reconstructed row, added to the prediction and clamped
    load_block_cols(cs, xt);
    float o[8];
    idct8_row(xt, D, i, o);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      pred[l] = fminf(fmaxf(__fadd_rn(pred[l], o[l]), 0.0f), 255.0f);
    }
  }
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

// frames_u8 (n, h, w) uint8, contiguous, h and w multiples of 8; sym
// (ceil(n/k), min(k, n), h/8, w/8, 8, 8) int16.  Returns cudaGetLastError().
extern "C" int dct8_encode_chunks(const void* frames_u8, void* sym,
                                  const void* dmat, const void* qt, float qs,
                                  long long n, int h, int w, int k,
                                  void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || k <= 0 || h % 8 || w % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const long long chunks = (n + k - 1) / k;
  const int ke = (int)(k < n ? k : n);
  const long long groups = chunks * (h / 8) * (w / 8);
  const long long threads = groups * 8;
  encode_chunks_kernel<<<(unsigned)((threads + kEncThreads - 1) /
                                    kEncThreads),
                         kEncThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames_u8, (int16_t*)sym, (const float*)dmat,
      (const float*)qt, qs, n, h, w, k, ke, groups);
  return (int)cudaGetLastError();
}
