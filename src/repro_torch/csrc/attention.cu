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
// So the operations bound it.  At RecurrentGemma-9B's prefill shape (B 2,
// S 4096, H 16 over KV 1, hd 256, window 2048, bf16): each (b, h) keeps
// 2048·2049/2 + 2048·2048 = 6.29e6 pairs, 2.01e8 in all, 206 GFLOP at 4·256
// a pair, 0.208 ms at 989 TFLOP/s; about 142 MB, 0.042 ms; the exps
// 0.048 ms.  The operations bound it.  At HuBERT-XLarge's encoder shape
// (B 8, S 1499, H 16 over KV 16, hd 80, bf16, non-causal): 8·16·1499² =
// 2.876e8 pairs, 92.0 GFLOP at 4·80 a pair, 0.093 ms at 989 TFLOP/s (1.37
// ms on the f32 cores); q, k, v and o 122.8 MB, 0.037 ms; the exps
// 0.069 ms.  The operations bound it.
// At Gemma2-2B's prefill shape (B 2, S 8160, H 8 over KV 4, hd 256, bf16,
// cap 50): a global layer keeps 2·8·8160·8161/2 = 5.327e8 pairs, 545.5
// GFLOP, 0.552 ms at 989 TFLOP/s; a local layer (window 4096) 4.006e8
// pairs, 410.2 GFLOP, 0.415 ms; each pair takes an exp and a tanh, 0.255
// and 0.192 ms on the special-function units; q, k, v and o 201 MB,
// 0.060 ms.  The tensor-core operations bound both.
// The decode form (Sq 1) is bound by the bytes of cache it reads, each key
// and value row once: 4·hd bytes a key and KV head in bf16 (8·hd in f32)
// against 4·hd FLOP a key and query head, so G FLOP a byte in bf16 (2 at
// Gemma2-2B, 12 at StarCoder2-3B, 16 at RecurrentGemma-9B), under the 20
// a byte at which the f32 CUDA cores (67 TFLOP/s) would bind instead.
// StarCoder2-3B (B 4, KV 2, hd 128) at 2,049 keys reads 8.4 MB, 2.5 us;
// RecurrentGemma-9B's full ring (B 2, KV 1, hd 256, 2,048 keys) 4.2 MB,
// 1.3 us; Gemma2-2B (B 2, KV 4, hd 256) over 8,161 keys 66.8 MB, 20 us, and
// over a local layer's 4,096 33.5 MB, 10 us.
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
//    and 20·tx mod 32 (tx < 8) covers 8 distinct groups of 4 banks.  At hd
//    256 its shared memory is 216,064 bytes, one block an SM (232,448 at
//    most), and a thread holds 4 x 16 accumulators; at hd 80 80,896 bytes,
//    two blocks an SM, and 4 x 5; at hd 32 44,032 bytes and 4 x 2.
//  * Decode form (Sq = 1): split-KV ("flash-decoding"), so that a short
//    batch fills the card.  The wrapper (kernels/attention/attention.py::
//    decode_splits) cuts the keys a query may see -- the cache's Sk, or
//    the window where it is shorter -- into n_split splits of split_len
//    from the cache's shape, the window and the SM count alone: two blocks
//    an SM (the most that fit at once) where splits of 64 keys or more
//    allow it, so the launch is the same at every decode step over one
//    cache.  Split j takes keys k_first + j·split_len onwards, so that a
//    window's splits are all live (with splits fixed at 0, j·split_len,
//    half of a 4,096-key window's blocks over an 8,192-position cache
//    would find no key).  decode_split_kernel runs one block of 8 warps
//    per (split, KV head, batch row); it serves the head's whole query
//    group (up to 16 heads), so each key and value row is read from
//    memory once for the group.  q, scaled, waits in shared memory in f32.
//    The warps split the group into head groups of at most 4 heads at hd
//    256, 8 at hd 64 and 128, 16 at hd 32 (32 or 16 accumulators a lane)
//    and take the split's keys in batches of U (8, 4 or 2: the most whose
//    k and v slices fit a lane's register budget, decode_batch), the head
//    group's warps in turn.  The 32 lanes split hd, so a warp reads each k and v row in one
//    coalesced sweep (hd 256 bf16: 16 bytes a lane) and keeps a batch's
//    rows in flight at once; the
//    partial dot products meet by __shfl_xor_sync (a reduce-scatter of
//    the batch's U sums: U + 4 - log2 U shuffles, then U to share the
//    scores, not 5·U), and each warp keeps the
//    online softmax (max, sum, hd/32 accumulators a lane) of its heads in
//    registers.  Then the warps' partials meet in shared memory (reusing
//    q's) and the block writes its split's max m, sum l and unnormalised
//    acc[G][hd] in f32 to the workspace the wrapper passes; with
//    n_split 1 it writes o itself.  A split past n_keys (a step before
//    the cache holds a full window or Sk keys) writes l = 0, m = -inf and
//    returns.  decode_combine_kernel, one block
//    of hd threads per (query head, batch row), stages the splits' (m, l)
//    in shared memory, takes m* = max m_s over the splits with l_s > 0
//    and, its loads of acc_s in flight together, writes o = Σ e^(m_s - m*)·acc_s / max(Σ
//    e^(m_s - m*)·l_s, 1e-30), rounded to q's dtype once.  The sums are
//    f32 in another order than the plain version's (ref.HOLD's r term).
//    Two launches a call (one when n_split is 1), no atomics, no host
//    synchronisation: safe to capture in a CUDA graph.  hd must be a
//    multiple of 32 (not 80).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows per block (prefill form)
constexpr int kBK = 64;            // keys per tile (prefill form)
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

// Sums U partial values (one per key) over the warp's 32 lanes: halving
// exchanges leave lane t with key t >> (5 - log2 U), whose sum the last
// 5 - log2 U butterfly steps complete.  U - 1 + 5 - log2 U shuffles, not
// 5·U.  Returns this lane's key's sum; x is clobbered.
template <int U>
__device__ __forceinline__ float sum32_scatter(float (&x)[U], int lane) {
  static_assert(U == 2 || U == 4 || U == 8, "U: 2, 4 or 8");
  constexpr int L = U == 8 ? 3 : (U == 4 ? 2 : 1);
#pragma unroll
  for (int n = U, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? x[i] : x[i + n / 2];
      const float keep = up ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float r = x[0];
#pragma unroll
  for (int o = 16 >> L; o > 0; o >>= 1)
    r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
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

// A lane's slice of a k or v row: E consecutive values of T, kept in
// registers as loaded (bf16 pairs in 32-bit words) and widened to f32 at
// use.  at(i) takes a compile-time i once its loop is unrolled.
template <typename T, int E>
struct Slice;

template <int E>
struct Slice<float, E> {
  float x[E];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (E >= 4) {
#pragma unroll
      for (int i = 0; i < E; i += 4) {
        const float4 t = load4(p + i);
        x[i] = t.x; x[i + 1] = t.y; x[i + 2] = t.z; x[i + 3] = t.w;
      }
    } else if constexpr (E == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      x[0] = t.x; x[1] = t.y;
    } else {
      x[0] = *p;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = 0.f;
  }
  __device__ __forceinline__ float at(int i) const { return x[i]; }
};

template <int E>
struct Slice<__nv_bfloat16, E> {
  static constexpr int W = E >= 2 ? E / 2 : 1;  // 32-bit words
  unsigned w[W];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    if constexpr (E == 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
    } else if constexpr (E == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x; w[1] = t.y;
    } else if constexpr (E == 2) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
  }
  // value i of the slice: the low half of a word comes first in memory
  __device__ __forceinline__ float at(int i) const {
    const unsigned u = w[i >> 1];
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

constexpr int kWarps = kThreads / 32;

// query heads a warp of the decode form may own: its accumulators are
// heads x hd/32 floats a lane (32 at hd 128 and 256, 16 at hd 32 and 64)
template <int HD>
__host__ __device__ constexpr int decode_heads_per_warp() {
  return HD >= 128 ? 1024 / HD : (HD == 64 ? 8 : kMaxGroups);
}
// keys a warp of the decode form loads at once: the largest U of 8, 4 and
// 2 whose k and v slices (2·U of a lane's hd/32 values), the heads'
// accumulators, max and sum (GW·(hd/32 + 2)) and scores (U) take at most
// 84 registers a lane, so that a thread fits in 128 (two blocks of 256
// an SM) without spilling: 4 at hd 128 and 256 over bf16, 2 at hd 256
// over f32, 4 at hd 128 over f32, 8 at hd 32 and 64
template <typename TKV, int HD>
__host__ __device__ constexpr int decode_batch() {
  constexpr int E = HD / 32, GW = decode_heads_per_warp<HD>();
  constexpr int slice = (E * (int)sizeof(TKV) + 3) / 4;  // registers
  for (int u = 8; u > 2; u /= 2)
    if (2 * u * slice + GW * (E + 2) + u <= 84) return u;
  return 2;
}

// One block per (split, KV head, batch row) over split j's keys,
// [k_first + j·split_len, k_first + (j+1)·split_len) within n_keys.  TQ:
// the query's (and the output's) type, TKV the cache's.  With gridDim.x
// (n_split) 1 it writes o; else its partial (m, l, acc) to ws, laid out
// [B][KV][n_split][G][hd] (acc), then [B][KV][n_split][G][2] (m, l).
template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads, 2)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, TQ* __restrict__ o,
                    float* __restrict__ ws, int Sk, int H, int KV,
                    int k_first, int n_keys, int split_len, float scale,
                    float cap) {
  constexpr int E = HD / 32;                           // values a lane
  constexpr int GW = decode_heads_per_warp<HD>();
  constexpr int U = decode_batch<TKV, HD>();
  constexpr int LU = U == 8 ? 3 : (U == 4 ? 2 : 1);     // log2 U
  constexpr int kBuf = kWarps * GW * HD > kMaxGroups * HD
                           ? kWarps * GW * HD : kMaxGroups * HD;
  // q (scaled, [G][HD]) during the key loop, then the warps' partial
  // accumulators ([key slot][G][HD])
  __shared__ __align__(16) float buf[kBuf];
  __shared__ float m_s[kWarps][kMaxGroups], l_s[kWarps][kMaxGroups];

  const int G = H / KV;
  const int n_split = gridDim.x, split = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long s0 = k_first + (long long)split * split_len;
  const int lo = (int)min(s0, (long long)n_keys);
  const int hi = (int)min((long long)n_keys, s0 + split_len);
  const long long part = ((long long)b * KV + kvh) * n_split + split;
  float* ws_ml = ws + (long long)gridDim.z * KV * n_split * G * HD;
  if (lo >= hi) {  // an empty split (never with n_split 1)
    for (int g = tid; g < G; g += kThreads) {
      ws_ml[(part * G + g) * 2] = -INFINITY;
      ws_ml[(part * G + g) * 2 + 1] = 0.f;
    }
    return;
  }

  // warp = ks·n_hg + hg: head group hg (heads g0 .. g0 + gc - 1), key slot
  // ks of the group's KS; warps past n_hg·KS idle
  const int n_hg = (G + GW - 1) / GW;
  const int gpw = (G + n_hg - 1) / n_hg;
  const int KS = kWarps / n_hg;
  const int hg = warp % n_hg, ks = warp / n_hg;
  const int g0 = hg * gpw, gc = min(gpw, G - g0);
  const bool active = ks < KS && gc > 0;

  const long long q_off = ((long long)b * H + (long long)kvh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    buf[i] = to_f32(q[q_off + i]) * scale;
  __syncthreads();

  float m[GW], l[GW], acc[GW][E];
#pragma unroll
  for (int i = 0; i < GW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }
  if (active) {
    const long long kv_row = (long long)KV * HD;
    const long long base = (long long)b * Sk * kv_row +
                           (long long)kvh * HD + lane * E;
    const TKV* kb = k + base;
    const TKV* vb = v + base;
    for (int k0 = lo + ks * U; k0 < hi; k0 += KS * U) {
      // the batch's rows in flight together; zeros past hi, never junk
      Slice<TKV, E> kr[U], vr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u < hi) {
          kr[u].load(kb + (k0 + u) * kv_row);
          vr[u].load(vb + (k0 + u) * kv_row);
        } else {
          kr[u].zero();
          vr[u].zero();
        }
      }
      const int mine = k0 + (lane >> (5 - LU));  // this lane's key's score
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) {
        if (gi >= gc) break;  // the same for the whole warp
        Slice<float, E> qv;   // this lane's columns of the scaled query
        qv.load(buf + (g0 + gi) * HD + lane * E);
        float s[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u] = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e)
            s[u] = fmaf(qv.at(e), kr[u].at(e), s[u]);
        }
        float sc = sum32_scatter<U>(s, lane);
        sc = mine < hi ? soft_cap(sc, cap) : -INFINITY;
        float mx = m[gi];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u] = __shfl_sync(0xffffffffu, sc, u << (5 - LU));
          mx = fmaxf(mx, s[u]);
        }
        // mx is finite: key k0 < hi is in every batch
        const float alpha = expf(m[gi] - mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u] = expf(s[u] - mx);
          psum += s[u];
        }
        l[gi] = l[gi] * alpha + psum;
        m[gi] = mx;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[gi][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(s[u], vr[u].at(e), a);
          acc[gi][e] = a;
        }
      }
    }
  }

  __syncthreads();  // every warp is done with q in buf
  if (active) {
#pragma unroll
    for (int gi = 0; gi < GW; ++gi) {
      if (gi >= gc) break;
      const int g = g0 + gi;
      float* dst = buf + (ks * G + g) * HD + lane * E;
      if constexpr (E >= 4) {
#pragma unroll
        for (int e = 0; e < E; e += 4)
          store4(dst + e, make_float4(acc[gi][e], acc[gi][e + 1],
                                      acc[gi][e + 2], acc[gi][e + 3]));
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) dst[e] = acc[gi][e];
      }
      if (lane == 0) {
        m_s[ks][g] = m[gi];
        l_s[ks][g] = l[gi];
      }
    }
  }
  __syncthreads();

  // merge the key slots of each head: slot 0 saw key lo, so mx is finite,
  // and a slot that saw no key weighs e^-inf = 0
  const int n_slots = kWarps / ((G + GW - 1) / GW);
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float mx = -INFINITY;
    for (int j = 0; j < n_slots; ++j) mx = fmaxf(mx, m_s[j][g]);
    float num = 0.f, den = 0.f;
    for (int j = 0; j < n_slots; ++j) {
      const float w = expf(m_s[j][g] - mx);
      num = fmaf(w, buf[(j * G + g) * HD + i % HD], num);
      den = fmaf(w, l_s[j][g], den);
    }
    if (n_split == 1) {
      store1(o + q_off + i, num / fmaxf(den, 1e-30f));
    } else {
      ws[part * G * HD + i] = num;
      if (i % HD == 0) {
        ws_ml[(part * G + g) * 2] = mx;
        ws_ml[(part * G + g) * 2 + 1] = den;
      }
    }
  }
}

// One block of HD threads per (query head, batch row): merges the n_split
// partials of decode_split_kernel into o, skipping empty splits (l = 0,
// their acc never written).  The splits' (m, l) pairs come to shared
// memory in one sweep; the acc loads of the split loop do not depend on
// one another, so they are in flight together.
template <typename TQ, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ ws, TQ* __restrict__ o,
                      int H, int KV, int n_split) {
  extern __shared__ float ml_s[];  // [n_split][2]
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = H / KV, kvh = h / G, g = h % G;
  const long long first = ((long long)b * KV + kvh) * n_split * G + g;
  const float* acc = ws + first * HD + d;  // split j at + j·G·HD
  const float* ml = ws + (long long)gridDim.y * KV * n_split * G * HD +
                    first * 2;               // split j at + j·G·2
  for (int j = d; j < n_split; j += HD) {
    ml_s[2 * j] = ml[(long long)j * G * 2];
    ml_s[2 * j + 1] = ml[(long long)j * G * 2 + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int j = 0; j < n_split; ++j)
    if (ml_s[2 * j + 1] > 0.f) mx = fmaxf(mx, ml_s[2 * j]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int j = 0; j < n_split; ++j) {
    const float a = acc[(long long)j * G * HD];
    const float lj = ml_s[2 * j + 1];
    const float w = lj > 0.f ? expf(ml_s[2 * j] - mx) : 0.f;
    num += lj > 0.f ? w * a : 0.f;  // an empty split's acc is junk
    den += w * lj;
  }
  store1(o + ((long long)b * H + h) * HD + d, num / fmaxf(den, 1e-30f));
}

template <typename TQ, typename TKV, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int q_offset, int k_len,
           int window, int causal, float scale, float cap, void* ws,
           int n_split, int split_len, cudaStream_t stream) {
  if (Sq == 1) {
    // the decode form splits a row over a warp's 32 lanes: hd % 32 == 0
    if constexpr (HD % 32 != 0) {
      return (int)cudaErrorInvalidValue;
    } else {
      const int n_keys = min(k_len, q_offset + 1);
      const int k_first = window > 0 ? max(0, q_offset + 1 - window) : 0;
      if (H / KV > kMaxGroups || !causal || n_split < 1 || split_len < 1 ||
          (long long)n_split * split_len < n_keys - k_first ||
          (n_split > 1 && ws == nullptr))
        return (int)cudaErrorInvalidValue;
      decode_split_kernel<TQ, TKV, HD>
          <<<dim3(n_split, KV, B), kThreads, 0, stream>>>(
              (const TQ*)q, (const TKV*)k, (const TKV*)v, (TQ*)o,
              (float*)ws, Sk, H, KV, k_first, n_keys, split_len, scale, cap);
      if (n_split > 1) {
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        decode_combine_kernel<TQ, HD>
            <<<dim3(H, B), HD, 2 * n_split * sizeof(float), stream>>>(
                (const float*)ws, (TQ*)o, H, KV, n_split);
      }
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
              int window, int causal, float scale, float cap, void* ws,
              int n_split, int split_len, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, cap, ws,
                                 n_split, split_len, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, cap, ws,
                                 n_split, split_len, stream);
    case 80:
      return launch<TQ, TKV, 80>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, cap, ws,
                                 n_split, split_len, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                  k_len, window, causal, scale, cap, ws,
                                  n_split, split_len, stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                  k_len, window, causal, scale, cap, ws,
                                  n_split, split_len, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_bf16 / kv_bf16: 1 when q (and o) / k and v are bf16, 0 for f32; they
// differ only in the decode form, and then as an f32 q over a bf16 cache.
// logit_cap: the soft-cap, 0 for none.  Sq 1 runs the decode form, which
// takes causal only, no hd 80 and, with a window, the query at the cache's
// last valid position (q_offset k_len - 1); its keys go in n_split splits
// of split_len from the first key it sees (n_split·split_len must cover
// them), and with n_split > 1 ws is an f32 workspace of
// B·KV·n_split·(H/KV)·(hd + 2) floats.  Longer queries run the prefill form, which takes q_offset 0 and
// k_len Sk only (window 0: no window) and ignores ws, n_split and
// split_len.  causal 0 (the prefill form's non-causal function) takes no
// window and neither Sq 1 nor (q_offset, k_len) other than (0, Sk).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it refuses.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KV,
                               int hd, int q_offset, int k_len, int window,
                               int causal, float scale, float logit_cap,
                               int q_bf16, int kv_bf16, void* ws,
                               int n_split, int split_len, void* stream) {
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
        scale, logit_cap, ws, n_split, split_len, st);
  if (kv_bf16)
    return launch_hd<float, __nv_bfloat16>(
        hd, q, k, v, o, B, Sq, Sk, H, KV, q_offset, k_len, window, causal,
        scale, logit_cap, ws, n_split, split_len, st);
  return launch_hd<float, float>(hd, q, k, v, o, B, Sq, Sk, H, KV, q_offset,
                                 k_len, window, causal, scale, logit_cap, ws,
                                 n_split, split_len, st);
}
