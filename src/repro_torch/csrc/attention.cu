// Hopper kernel for grouped-query flash attention: causal over a prompt
// (with an optional sliding window) and over a KV cache (with an optional
// window over a linear cache), or non-causal over a whole sequence (an
// encoder), each with an optional logit soft-cap.
//
// K4  flash_attention  q (B, Sq, H, hd); k, v (B, Sk, KV, hd); f32 or bf16,
//                      k and v of one dtype, q of the same dtype (or, in the
//                      decode form, f32 q over bf16 k/v); hd 32, 64, 80
//                      (prefill form only), 128 or 256; scalars q_offset,
//                      k_len, window, causal, logit_cap ->
//                      o (B, Sq, H, hd) in q's dtype
//     o[b, i, h] = Σ_j softmax_j(s_ij) · v[b, j, h / (H/KV)]
//     s_ij = c((q[b, i, h] · hd^-0.5) · k[b, j, h / (H/KV)]) with
//     c(s) = cap·tanh(s/cap) when logit_cap > 0 (else c(s) = s), kept where
//     j < k_len and, when causal, j <= q_offset + i and (window = 0 or
//     q_offset + i - j < window), else -1e30 (q_offset 0 and k_len Sk when
//     Sq > 1; q_offset k_len - 1 when Sq = 1 with a window; non-causal:
//     Sq > 1, q_offset 0, k_len Sk and window 0, so j < Sk is the only
//     mask).
//     Replaces the TPU kernel src/repro/kernels/attention/attention.py::
//     flash_attention (_attn_kernel), which takes (B, H, S, hd) with the KV
//     heads repeated by its wrapper, casts each input to f32 on its own,
//     soft-caps the f32 scores before the mask and counts query positions
//     from 0.  This one reads the model's layouts, indexes the KV head as
//     h / (H/KV) without repeating it, and has two forms.  The prefill form
//     (Sq > 1) takes q_offset 0, k_len Sk and one dtype only: the TPU
//     kernel's causal function, with its sliding window when window > 0 (the
//     mask of src/repro/models/attention.py::_block_mask), or its non-causal
//     function (causal 0: the audio family's encoder, HuBERT).
//     The decode form (Sq 1) takes the absolute position of its query
//     (q_offset len-1) and the valid key count (k_len len) over a cache: the
//     reference's decode_attention (src/repro/models/attention.py), with its
//     window over a linear cache (keys len - window .. len - 1: gemma2's
//     local layers) and f32 q over a bf16 cache (f32 weights over the
//     reference's default cache), which the TPU kernel takes by casting each
//     input.  A prompt chunk over a cache (a prefill form with q_offset > 0)
//     is no served path's and is refused, and so are a bf16 q over an f32
//     cache and mixed dtypes in the prefill form.  The non-causal form takes
//     neither a window, an offset nor Sq 1, and hd 80 has no decode form: no
//     path uses them.
//     Called by repro_torch/models/attention.py once per layer: in prefill
//     over the prompt (with RecurrentGemma's window on its local-attention
//     layers, gemma2's window and soft-cap), in every decode step over the
//     cache or the ring, and in the encoder's forward over the frames
//     (non-causal).
//
//     As in the TPU kernel: q is scaled in f32 before the product, scores,
//     the running max and sum and the accumulator are f32, the soft-cap is
//     cap·tanhf(s/cap) on the f32 score before the mask, masked scores are
//     -1e30, and o = acc / max(l, 1e-30) is rounded to q's dtype once.
//
// Bound on an H100 at StarCoder2-3B's prefill shape (B 4, S 2048, H 24 over
// KV 2, hd 128, bf16), as chip_smoke.py reckons it from the data sheet's
// rates: B·H·S(S+1)/2 = 2.01e8 kept (q, k) pairs at 4·hd FLOP each are
// 103 GFLOP, 0.104 ms on the tensor cores at 989 TFLOP/s (1.54 ms on the
// f32 cores at 67 TFLOP/s); q, k, v and o once each are 109 MB, 0.033 ms at
// 3.35 TB/s; the 2.0e8 exps take 0.048 ms on the special-function units.
// So the operations bound it.  A decode launch reads about 8.5 MB of cache,
// 2.5 us.  At RecurrentGemma-9B's prefill shape (B 2, S 4096, H 16 over KV 1,
// hd 256, window 2048, bf16): each (b, h) keeps 2048·2049/2 + 2048·2048 =
// 6.29e6 pairs, 2.01e8 in all, 206 GFLOP at 4·256 a pair, 0.208 ms at
// 989 TFLOP/s; about 142 MB, 0.042 ms; the exps 0.048 ms.  The operations
// bound it.  Its decode form over a full ring (B 2, 2048 keys) reads about
// 4.2 MB, 1.3 us.  At HuBERT-XLarge's encoder shape (B 8, S 1499, H 16 over
// KV 16, hd 80, bf16, non-causal): 8·16·1499² = 2.876e8 pairs, 92.0 GFLOP at
// 4·80 a pair, 0.093 ms at 989 TFLOP/s (1.37 ms on the f32 cores); q, k, v
// and o 122.8 MB, 0.037 ms; the exps 0.069 ms.  The operations bound it.
// At Gemma2-2B's prefill shape (B 2, S 8160, H 8 over KV 4, hd 256, bf16,
// cap 50): a global layer keeps 2·8·8160·8161/2 = 5.327e8 pairs, 545.5
// GFLOP, 0.552 ms at 989 TFLOP/s; a local layer (window 4096) 4.006e8
// pairs, 410.2 GFLOP, 0.415 ms; each pair takes an exp and a tanh, 0.255
// and 0.192 ms on the special-function units; q, k, v and o 201 MB,
// 0.060 ms.  The tensor-core operations bound both.  Its decode form over
// 8,161 keys (B 2) reads 66.8 MB of cache, 20 us (33.5 MB, 10 us, over a
// local layer's 4,096).
//
// Design (a simple first kernel: f32 arithmetic on the CUDA cores, no
// tensor cores, no asynchronous copies).
//  * Prefill form (Sq > 1): one block of 256 threads per (tile of 64 query
//    rows, query head, batch row).  The q tile is staged once in shared
//    memory, scaled, in f32; key tiles of 64 rows of k and v are staged in
//    f32, tiles wholly above the causal diagonal, wholly left of every
//    row's window or past Sk are never read (non-causal: every tile below
//    Sk; rows of the last tile past Sk are zeros and masked by key < Sk).
//    Thread (ty, tx) of a 16x16 grid owns query rows 4ty..4ty+3 and,
//    in q·kᵀ, keys tx + 16j; its running max, sum and its 4 x hd/16 slice
//    of the accumulator stay in registers.  In p·v it owns the float4
//    columns 4tx + 64c (c < hd/64) and, where hd is not a multiple of 64
//    (32, 80), the single columns 64·(hd/64) + 16e + tx (e < (hd % 64)/16),
//    so every column is accumulated and written and every lane does the
//    same work (hd 32: no float4 column, two single ones).  A row's max and
//    sum are reduced over its 16 threads with shuffles; p goes through
//    shared memory (key major) to the p·v product.
//    Shared rows of q and k are padded to hd + 4 floats, so that the float4
//    reads of a quarter warp (8 rows tx apart) fall in distinct banks: the
//    row stride is 4 banks mod 32 at hd 32, 64, 128 and 256 and 20 at hd 80,
//    and 20·tx mod 32 (tx < 8) covers 8 distinct groups of 4 banks.
//  * Decode form (Sq = 1): one block per (KV head, batch row) serves the
//    head's whole query group (up to 16 query heads), so each key and value
//    row is read from memory once for the group.  Keys go in chunks of 256
//    from the window's first key, one per thread for q·kᵀ; warp w runs the
//    online softmax of query heads w and w+8 over the chunk in shared
//    memory; then each thread accumulates p·v for one head-dim column of
//    its heads, reading v rows coalesced (hd must divide 256, so not 80).
//    q and the cache are read in their own dtypes and converted to f32 in
//    registers.  At hd 256 the prefill's shared memory is 216,064 bytes,
//    one block an SM (232,448 at most), and a thread holds 4 x 16
//    accumulators; the decode form gives each thread one head-dim column of
//    all 16 heads.  At hd 80 the prefill takes 80,896 bytes, two blocks an
//    SM, and 4 x 5 accumulators a thread; at hd 32 44,032 bytes and 4 x 2.
//    The decode form runs B·KV blocks only (8 at Gemma2-2B's batch 2), each
//    over its whole window of keys: slow over a long cache, left for a
//    split-KV redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows per block (prefill form)
constexpr int kBK = 64;            // keys per tile (prefill form)
constexpr int kChunk = kThreads;   // keys per chunk (decode form)
constexpr int kMaxGroups = 16;     // query heads per KV head (decode form)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the TPU kernel's logit soft-cap, cap·tanh(s/cap), or s when cap is 0
__device__ __forceinline__ float soft_cap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// max / sum over the 16 lanes that share a query row (lanes 0-15 or 16-31)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float max32(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum32(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr int prefill_smem_bytes() {
  return (kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBK * (kBQ + 4)) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
               int H, int KV, int window, int causal, float scale,
               float cap) {
  constexpr int LD = HD + 4;    // padded row of q_s and k_s, in floats
  constexpr int LDP = kBQ + 4;  // padded row of p_s
  constexpr int V4 = HD / 4;    // float4 columns of a row
  constexpr int DC = HD / 64;   // float4 columns a thread owns in p·v
  constexpr int DR = HD % 64 / 16;  // and single columns past 64·DC
  constexpr int NA = 4 * DC + DR;   // accumulators a row
  static_assert(HD % 16 == 0 && HD >= 32, "head_dim: a multiple of 16, >= 32");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][LD], scaled q
  float* k_s = q_s + kBQ * LD;                   // [kBK][LD]
  float* v_s = k_s + kBK * LD;                   // [kBK][HD]
  float* p_s = v_s + kBK * HD;                   // [kBK][LDP], p key-major

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * HD;   // between positions of q, o
  const long long kv_row = (long long)KV * HD;  // between positions of k, v
  const T* qb = q + (long long)b * Sq * q_row + (long long)h * HD;
  const T* kb = k + (long long)b * Sk * kv_row + (long long)kvh * HD;
  const T* vb = v + (long long)b * Sk * kv_row + (long long)kvh * HD;
  T* ob = o + (long long)b * Sq * q_row + (long long)h * HD;

  for (int i = tid; i < kBQ * V4; i += kThreads) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = load4(qb + (q0 + r) * q_row + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    store4(q_s + r * LD + c, x);
  }

  float m[4], l[4], acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < NA; ++d) acc[i][d] = 0.f;
  }

  // keys any row of this tile may see: below Sk and, when causal, up to its
  // last row and, with a window, from its first row's first key on (whole
  // tiles only)
  const int n_keys = causal ? min(Sk, min(q0 + kBQ, Sq)) : Sk;
  const int k_first = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  for (int k0 = k_first; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // q_s is staged; the last tile's readers are done
    for (int i = tid; i < kBK * V4; i += kThreads) {
      const int r = i / V4, c = (i % V4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < n_keys) {  // rows past n_keys stay zero, never garbage
        kx = load4(kb + (k0 + r) * kv_row + c);
        vx = load4(vb + (k0 + r) * kv_row + c);
      }
      store4(k_s + r * LD + c, kx);
      store4(v_s + r * HD + c, vx);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(q_s + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = load4(k_s + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // soft-cap, mask, then the online softmax of each of this thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = soft_cap(s[i][j], cap);
        if (!(key < Sk && (!causal || (key <= pos &&
                                       (window == 0 || pos - key < window)))))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < NA; ++d) acc[i][d] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(p_s + (tx + 16 * j) * LDP + ty * 4,
             make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
    __syncthreads();

    const int kn = min(kBK, n_keys - k0);  // p is 0 past it
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      const float4 pa = load4(p_s + c * LDP + ty * 4);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float4 va = load4(v_s + c * HD + dc * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][dc * 4 + 0] = fmaf(pr[i], va.x, acc[i][dc * 4 + 0]);
          acc[i][dc * 4 + 1] = fmaf(pr[i], va.y, acc[i][dc * 4 + 1]);
          acc[i][dc * 4 + 2] = fmaf(pr[i], va.z, acc[i][dc * 4 + 2]);
          acc[i][dc * 4 + 3] = fmaf(pr[i], va.w, acc[i][dc * 4 + 3]);
        }
      }
#pragma unroll
      for (int e = 0; e < DR; ++e) {
        const float vx = v_s[c * HD + DC * 64 + e * 16 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][4 * DC + e] = fmaf(pr[i], vx, acc[i][4 * DC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      store4(ob + r * q_row + dc * 64 + tx * 4,
             make_float4(acc[i][dc * 4 + 0] / den, acc[i][dc * 4 + 1] / den,
                         acc[i][dc * 4 + 2] / den, acc[i][dc * 4 + 3] / den));
#pragma unroll
    for (int e = 0; e < DR; ++e)
      store1(ob + r * q_row + DC * 64 + e * 16 + tx, acc[i][4 * DC + e] / den);
  }
}

// TQ: the query's (and the output's) type, TKV the cache's
template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, TQ* __restrict__ o, int Sk, int H,
              int KV, int k_first, int n_keys, float scale, float cap) {
  constexpr int GS = kThreads / HD;           // head stride in p·v: 8 .. 1
  constexpr int NG = kMaxGroups / GS;         // heads a thread may own in p·v
  __shared__ __align__(16) float q_s[kMaxGroups][HD];
  __shared__ float s_s[kMaxGroups][kChunk];   // scores, then p
  __shared__ float alpha_s[kMaxGroups], l_s[kMaxGroups];

  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const long long kv_row = (long long)KV * HD;
  const long long q_off = ((long long)b * H + (long long)kvh * G) * HD;
  const TKV* kb = k + (long long)b * Sk * kv_row + (long long)kvh * HD;
  const TKV* vb = v + (long long)b * Sk * kv_row + (long long)kvh * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i / HD][i % HD] = to_f32(q[q_off + i]) * scale;

  const int d = tid % HD, g0 = tid / HD;  // this thread's column in p·v
  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) acc[i] = 0.f;
  float m_w[2] = {kNegInf, kNegInf}, l_w[2] = {0.f, 0.f};  // heads w, w+8

  for (int c0 = k_first; c0 < n_keys; c0 += kChunk) {
    __syncthreads();  // q_s is staged; the last chunk's readers are done
    const int key = c0 + tid;
    float sc[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) sc[g] = 0.f;
    if (key < n_keys) {
      const TKV* kr = kb + key * kv_row;
#pragma unroll 2
      for (int c = 0; c < HD; c += 4) {
        const float4 kx = load4(kr + c);
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) {
          if (g < G) {
            const float4 qa = load4(&q_s[g][c]);
            sc[g] = fmaf(qa.x, kx.x, sc[g]);
            sc[g] = fmaf(qa.y, kx.y, sc[g]);
            sc[g] = fmaf(qa.z, kx.z, sc[g]);
            sc[g] = fmaf(qa.w, kx.w, sc[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (g < G) s_s[g][tid] = key < n_keys ? soft_cap(sc[g], cap) : kNegInf;
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + 8 * r;
      if (g >= G) continue;  // the same for the whole warp
      float mx = kNegInf;
      for (int i = lane; i < kChunk; i += 32) mx = fmaxf(mx, s_s[g][i]);
      const float m_new = fmaxf(m_w[r], max32(mx));
      float sum = 0.f;
      for (int i = lane; i < kChunk; i += 32) {
        const float p = expf(s_s[g][i] - m_new);
        s_s[g][i] = p;
        sum += p;
      }
      const float alpha = expf(m_w[r] - m_new);
      l_w[r] = l_w[r] * alpha + sum32(sum);
      m_w[r] = m_new;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (g0 + GS * i < G) acc[i] *= alpha_s[g0 + GS * i];
    const int kn = min(kChunk, n_keys - c0);
    const TKV* vr = vb + (long long)c0 * kv_row + d;
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      const float vx = to_f32(vr[c * kv_row]);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (g0 + GS * i < G)
          acc[i] = fmaf(s_s[g0 + GS * i][c], vx, acc[i]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (warp + 8 * r < G) l_s[warp + 8 * r] = l_w[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = g0 + GS * i;
    if (g < G) store1(o + q_off + (long long)g * HD + d,
                      acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int q_offset, int k_len,
           int window, int causal, float scale, float cap,
           cudaStream_t stream) {
  if (Sq == 1) {
    // the decode form gives each thread one of hd columns: hd divides 256
    if constexpr (kThreads % HD != 0) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (H / KV > kMaxGroups || !causal) return (int)cudaErrorInvalidValue;
      const int n_keys = min(k_len, q_offset + 1);
      const int k_first = window > 0 ? max(0, q_offset + 1 - window) : 0;
      decode_kernel<TQ, TKV, HD><<<dim3(KV, B), kThreads, 0, stream>>>(
          (const TQ*)q, (const TKV*)k, (const TKV*)v, (TQ*)o, Sk, H, KV,
          k_first, n_keys, scale, cap);
    }
  } else {
    // the prefill form takes one dtype: no served path mixes them there
    if constexpr (!std::is_same<TQ, TKV>::value) {
      return (int)cudaErrorInvalidValue;
    } else {
      constexpr int smem = prefill_smem_bytes<HD>();
      static const cudaError_t attr = cudaFuncSetAttribute(
          prefill_kernel<TQ, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (attr != cudaSuccess) return (int)attr;
      const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
      prefill_kernel<TQ, HD><<<grid, kThreads, smem, stream>>>(
          (const TQ*)q, (const TQ*)k, (const TQ*)v, (TQ*)o, Sq, Sk, H, KV,
          window, causal, scale, cap);
    }
  }
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Sk, int H, int KV, int q_offset, int k_len,
              int window, int causal, float scale, float cap,
              cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, cap, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, cap, stream);
    case 80:
      return launch<TQ, TKV, 80>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, cap, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                  k_len, window, causal, scale, cap, stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                  k_len, window, causal, scale, cap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_bf16 / kv_bf16: 1 when q (and o) / k and v are bf16, 0 for f32; they
// differ only in the decode form, and then as an f32 q over a bf16 cache.
// logit_cap: the soft-cap, 0 for none.  Sq 1 runs the decode form, which
// takes causal only, no hd 80 and, with a window, the query at the cache's
// last valid position (q_offset k_len - 1); longer queries the prefill form,
// which takes q_offset 0 and k_len Sk only (window 0: no window).  causal 0
// (the prefill form's non-causal function) takes no window and neither
// Sq 1 nor (q_offset, k_len) other than (0, Sk).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it refuses.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KV,
                               int hd, int q_offset, int k_len, int window,
                               int causal, float scale, float logit_cap,
                               int q_bf16, int kv_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || k_len < 1 ||
      k_len > Sk || q_offset < 0 || window < 0 || !(logit_cap >= 0.f) ||
      (Sq > 1 && (q_offset != 0 || k_len != Sk || q_bf16 != kv_bf16)) ||
      (Sq == 1 && window != 0 && q_offset != k_len - 1) ||
      (q_bf16 && !kv_bf16) ||
      (!causal && (Sq == 1 || window != 0 || q_offset != 0 || k_len != Sk)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (q_bf16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, q, k, v, o, B, Sq, Sk, H, KV, q_offset, k_len, window, causal,
        scale, logit_cap, st);
  if (kv_bf16)
    return launch_hd<float, __nv_bfloat16>(
        hd, q, k, v, o, B, Sq, Sk, H, KV, q_offset, k_len, window, causal,
        scale, logit_cap, st);
  return launch_hd<float, float>(hd, q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, logit_cap, st);
}
