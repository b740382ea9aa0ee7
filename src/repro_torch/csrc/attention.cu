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
//     As in the TPU kernel: scores, the running max and sum and the
//     accumulator are f32, the soft-cap is cap·tanhf(s/cap) on the f32
//     score before the mask, masked scores are -1e30, and o = acc / max(l,
//     1e-30) is rounded to q's dtype once.  The f32 prefill form and the
//     decode form scale q in f32 before the product, as the TPU kernel
//     does; the bf16 prefill form scales the f32 score after it (below).
//
//     The bf16 prefill form's rounding, on the tensor cores:
//      1. s = (q·kᵀ)·hd^-0.5: raw bf16 q times raw bf16 k with an f32
//         accumulator, the f32 score then scaled.  A q scaled and rounded
//         to bf16 first would move every score by up to 2^-9 of itself
//         wherever hd^-0.5 is no power of two (hd 32, 80, 128), which
//         breaks ref.HOLD in bf16 (tests/test_torch_kernels.py emulates
//         each scheme on the CPU).
//      2. The soft-cap (accurate tanhf: tanh.approx's ~2^-11 would move a
//         score near cap 50 by ~0.024), the mask and the online softmax
//         in f32, as above, with exp2f of log2e-scaled scores; the row
//         max and sum are of the f32 p.
//      3. p·v with p split in two bf16 parts, hi = bf16_rn(p) and lo =
//         bf16_rn(p - hi), two tensor-core products against the bf16 v
//         tile into one f32 accumulator: p keeps ~16 bits, where one bf16
//         p (as SDPA and flex_attention round it) keeps 8 and fails the
//         hold by 5-7x.  1.5x the nominal FLOPs of p·v; the bound counts
//         4·hd a kept pair all the same.
//      4. o = acc / max(l, 1e-30), rounded to bf16 once.
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
// Design.
//  * bf16 prefill form (Sq > 1, bf16): prefill_mma_kernel, on the tensor
//    cores with mma.sync.m16n8k16 (bf16 operands, f32 accumulators), as
//    the f32 CUDA-core kernel below took ~25 TFLOP/s of the card's 989.
//    One block of 4 warps per (query head, batch row, tile of 64 query
//    rows); each warp owns 16 rows.  The grid's slowest dimension is the
//    query tile, counted down, so the longest causal tiles of every head
//    start first and the grid's tail is short ones.  Key tiles of BK rows
//    (64; 32 at hd 256, whose 16 x 256 f32 accumulator alone is 128
//    registers a thread) of k and v come by cp.async (16 bytes a thread)
//    into a 2-stage ring in shared memory: tile t+1 is in flight while
//    tile t is computed, one __syncthreads a tile.  Rows past the keys the
//    tile may use (n_keys) and q rows past Sq are zero-filled by cp.async
//    with src-size 0, never read, so a masked p of 0 never meets junk.
//    Shared rows are padded to hd + 8 bf16 (16 bytes), so the 8 row
//    addresses of each ldmatrix fall in 8 distinct 16-byte bank groups
//    at every hd (the row stride is 16, 80, 48, 16 or 16 bytes mod 128 at
//    hd 64, 32, 80, 128, 256).  q·kᵀ: A from q (ldmatrix; held in
//    registers for the whole kernel at hd <= 128, re-read from shared
//    memory at hd 256), B from the k tile (ldmatrix: k is key-major, the
//    "col" operand as it lies).  The score fragment of two 8-key n-tiles
//    is the A fragment of a 16-key k-step of p·v as it lies in registers;
//    each k-step's hi and lo A fragments are made just before its
//    products, so p never goes through shared memory; B from the v tile
//    by ldmatrix.trans.  hd 80 is 5 k-steps of 16 and 10 n-tiles of 8: no
//    padding.  The row max is reduced over the 4 lanes of a row with two
//    shuffles a tile; the row sum stays a partial per lane until the end.
//    Tiles are skipped as below; the mask is evaluated only in tiles that
//    cross a warp's diagonal, its window's edge or Sk.  The soft-cap is a
//    template flag, so the uncapped kernels carry no tanhf.
//  * f32 prefill form (Sq > 1, f32; no timed path runs it): one block of
//    256 threads per (tile of 64 query rows, query head, batch row).
//    The q tile is staged once in shared
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
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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

// -- the bf16 prefill form on the tensor cores --------------------------
constexpr int kTcThreads = 128;  // 4 warps of 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

// keys per tile: 64, or 32 at hd 256 (its accumulator is 128 registers)
template <int HD>
__host__ __device__ constexpr int tc_keys() {
  return HD == 256 ? 32 : 64;
}
// shared memory: the q tile and a 2-stage ring of k and v tiles, rows
// padded to hd + 8 bf16
template <int HD>
constexpr int tc_smem_bytes() {
  return (kBQ + 4 * tc_keys<HD>()) * (HD + 8) * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, or 16 zero bytes when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a·b, a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}
// p0, p1 (p0 in the low half) as hi = bf16_rn(p) and lo = bf16_rn(p - hi)
__device__ __forceinline__ void split_bf16(float p0, float p1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// One block of 4 warps per (query head h, batch row b, query tile); the
// tile is gridDim.z - 1 - blockIdx.z, so the longest causal tiles start
// first.  Warp w owns query rows q0 + 16w .. q0 + 16w + 15; lane l holds,
// in each 8-column n-tile of a score or output fragment, rows l/4 and
// l/4 + 8 of them at columns 2(l%4) and 2(l%4) + 1.
template <int HD, bool CAP>
__global__ void __launch_bounds__(kTcThreads, 2)
prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                   int KV, int window, int causal, float scale, float cap) {
  constexpr int BK = tc_keys<HD>();
  constexpr int LD = HD + 8;         // padded shared row, in bf16
  constexpr int CH = HD / 8;         // 16-byte chunks a row
  constexpr int NT = BK / 8;         // 8-key n-tiles of a score tile
  constexpr int DT = HD / 8;         // 8-column n-tiles of the output
  constexpr int KS = HD / 16;        // 16-deep k-steps of q·kᵀ
  constexpr bool QREG = HD <= 128;   // q's A fragments kept in registers
  static_assert(HD % 16 == 0 && DT % 2 == 0, "head_dim: a multiple of 16");
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [kBQ][LD]
  __nv_bfloat16* kv_s = q_s + kBQ * LD;  // stage i: k [BK][LD], then v

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int w0 = q0 + warp * 16;  // this warp's first query row
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * HD;   // between positions of q, o
  const long long kv_row = (long long)KV * HD;  // between positions of k, v
  const __nv_bfloat16* qb = q + (long long)b * Sq * q_row + (long long)h * HD;
  const __nv_bfloat16* kb = k + (long long)b * Sk * kv_row + (long long)kvh * HD;
  const __nv_bfloat16* vb = v + (long long)b * Sk * kv_row + (long long)kvh * HD;
  __nv_bfloat16* ob = o + (long long)b * Sq * q_row + (long long)h * HD;

  // keys any row of this tile may see, as in prefill_kernel
  const int n_keys = causal ? min(Sk, min(q0 + kBQ, Sq)) : Sk;
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (n_keys - k_first + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const int k0 = k_first + t * BK;
    __nv_bfloat16* ks = kv_s + (t & 1) * 2 * BK * LD;
    __nv_bfloat16* vs = ks + BK * LD;
    // not unrolled: unrolled, ptxas keeps every chunk's addresses live
    // across the key loop, and hd 256 spilled (32 and 120 bytes)
#pragma unroll 1
    for (int i = tid; i < BK * CH; i += kTcThreads) {
      const int r = i / CH, c = i % CH * 8;
      const bool in = k0 + r < n_keys;  // else zeros, never junk
      const long long off = (long long)(in ? k0 + r : 0) * kv_row + c;
      cp_async16(ks + r * LD + c, kb + off, in);
      cp_async16(vs + r * LD + c, vb + off, in);
    }
  };
  for (int i = tid; i < kBQ * CH; i += kTcThreads) {
    const int r = i / CH, c = i % CH * 8;
    const bool in = q0 + r < Sq;
    cp_async16(q_s + r * LD + c, qb + (long long)(in ? q0 + r : 0) * q_row + c,
               in);
  }
  load_kv(0);
  cp_async_commit();

  // ldmatrix row addresses: q (A: rows l%16, columns 8(l/16)), k (B of two
  // n-tiles: keys l%8 + 8(l/16), columns 8((l/8)%2)), v (B of two n-tiles
  // by .trans: keys l%8 + 8((l/8)%2), columns 8(l/16))
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = (lane >> 3 & 1) * 8;
  const int v_row = (lane & 7) + (lane >> 3 & 1) * 8, v_col = (lane >> 4) * 8;
  const __nv_bfloat16* q_frag = q_s + (warp * 16 + a_row) * LD + a_col;

  unsigned qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], q_frag + ks * 16);
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // log2e-scaled max
  const float s_scale = CAP ? scale : scale * kLog2e;
  const int row = w0 + (lane >> 2);  // this lane's rows: row and row + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * BK;
    cp_async_wait_all();  // tile t is in (and q)
    __syncthreads();      // for every thread; tile t - 1's readers are done
    if (t + 1 < n_tiles) {
      load_kv(t + 1);     // into tile t - 1's stage, while t is computed
      cp_async_commit();
    }
    const __nv_bfloat16* ks = kv_s + (t & 1) * 2 * BK * LD;
    const __nv_bfloat16* vs = ks + BK * LD;

    // s = q·kᵀ on the tensor cores, f32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (j * 8 + k_row) * LD + kk * 16 + k_col);
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, soft-cap, mask (only where the tile crosses this warp's
    // diagonal, its window's edge or Sk), then the online softmax in the
    // log2 domain
    const bool edge = k0 + BK > Sk ||
                      (causal && (k0 + BK - 1 > w0 ||
                                  (window > 0 && w0 + 15 - k0 >= window)));
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * s_scale;
        if constexpr (CAP) x = cap * tanhf(x / cap) * kLog2e;
        if (edge) {
          const int pos = row + (e >> 1) * 8;
          const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
          if (!(key < Sk && (!causal || (key <= pos &&
                                         (window == 0 || pos - key < window)))))
            x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }

    // acc += p·v, p as hi + lo: a 16-key k-step's A fragment is the score
    // fragment of n-tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + v_row) * LD + d * 8 + v_col);
        mma_bf16(acc[d], hi, bv[0], bv[1]);
        mma_bf16(acc[d], lo, bv[0], bv[1]);
        mma_bf16(acc[d + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[d + 1], lo, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row + r * 8;
    if (pos >= Sq) continue;
    __nv_bfloat16* dst = ob + pos * q_row + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + d * 8) = __floats2bfloat162_rn(
          acc[d][2 * r] / l[r], acc[d][2 * r + 1] / l[r]);
  }
}

template <int HD, bool CAP>
cudaError_t launch_prefill_mma(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KV,
                               int window, int causal, float scale, float cap,
                               cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_mma_kernel<HD, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  prefill_mma_kernel<HD, CAP><<<grid, kTcThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Sq, Sk, H, KV, window,
      causal, scale, cap);
  return cudaSuccess;
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
    } else if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
      const cudaError_t err =
          cap > 0.f ? launch_prefill_mma<HD, true>(q, k, v, o, B, Sq, Sk, H,
                                                   KV, window, causal, scale,
                                                   cap, stream)
                    : launch_prefill_mma<HD, false>(q, k, v, o, B, Sq, Sk, H,
                                                    KV, window, causal, scale,
                                                    cap, stream);
      if (err != cudaSuccess) return (int)err;
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
// B·KV·n_split·(H/KV)·(hd + 2) floats.  Longer queries run the prefill form
// (bf16 on the tensor cores, f32 on the CUDA cores), which takes q_offset 0 and
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
