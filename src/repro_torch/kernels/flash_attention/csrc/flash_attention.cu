// Flash attention forward for Hopper (sm_90a) on the tensor cores, plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_pallas (body _fa_kernel): softmax(q k^T * scale + mask) v
// with an online softmax whose running max, sum and accumulator stay in f32,
// output in q's dtype, optional causal and sliding-window masks taken from
// absolute positions with q at the tail of k (q_offset = Sk - Sq), GQA
// (kv head = h / (H / KH)), ragged Sq and Sk, head dim 1 <= D <= 128, f32 and
// bf16 inputs; and, for bf16 serving with 16-byte rows and pointers, head
// dim 128 < D <= 160 (pixtral-12b's 160; see "Head dim 160" below) and a
// q/k head dim 128 < D <= 192 over a v head dim Dv <= 128 (deepseek-v2's
// MLA, 192 over 128; see "Split head dim" below), serving and training.
//
// Bound on an H100 SXM: 4 * B * H * (unmasked query-key pairs) * D
// operations against the bytes of q, k, v and o moved once.  In bf16 the
// tensor cores (989 TFLOP/s) make the bytes the bound (zamba2 prefill,
// B 4, S 512, H 32, D 80, causal: 41.9 MB, 0.0125 ms).  In f32 the products
// run as 3xTF32 (below), three TF32 products at 495 TFLOP/s, so 165 TFLOP/s
// of f32-accurate work: at the DiT-XL shape (B 8, S 256, H 16, D 72) 2.42
// GFLOP take 0.0146 ms against 0.0113 ms of bytes, so the operations bound.
//
// What the design does about it (FlashAttention-2 on mma.sync):
// - One block of 4 warps per (64-query tile, head, batch); each warp owns 16
//   query rows, and its Q fragments stay in registers for the whole walk.
//   K/V are walked in 64-key tiles through a 2-stage cp.async ring (16-byte
//   cp.async.cg copies with zero fill past Sk and past D), so the next tile's
//   copy overlaps this tile's products; one barrier a tile.  The output goes
//   out through shared memory in 16-byte rows.
// - bf16: S = Q K^T and O += P V through mma.sync m16n8k16 (bf16 in, f32
//   accumulate); K and V fragments come from ldmatrix (.trans for V).  The
//   softmax runs on the accumulator fragments (a row lives in a quad: two
//   shuffles for its max), P is rounded to bf16 in registers and fed back as
//   the A operand, since the m16n8k16 accumulator layout is its A layout.
//   The head dim is padded to a multiple of 16 with zero columns.
// - f32: the same walk through mma.sync m16n8k8 tf32.  Plain TF32 keeps 10
//   mantissa bits and misses the 1e-4 f32 tolerance, so every operand splits
//   into big = tf32(x) and small = tf32(x - big) and a product accumulates
//   small*big + big*small + big*big in f32 (3xTF32), P included; the split
//   is two integer operations a half.  The
//   m16n8k8 accumulator layout differs from its A layout; instead of a
//   shuffle the P V product permutes its reduction axis (k slot t <-> key 2t,
//   k slot t + 4 <-> key 2t + 1), which makes the accumulator fragment the A
//   fragment, and reads V's rows in the same order.  Head dim padded to 8.
// - Shared rows are padded (by 16 bytes in bf16, 4 floats in f32) so that
//   ldmatrix and the f32 fragment loads hit distinct banks.
// - exp2 on the special function unit (ex2.approx, log2(e) folded into the
//   scale); the row max and sum reduce as trees.
// - Masks cost only on tiles that straddle a mask edge or Sk, per warp;
//   causal tiles above a warp's rows are skipped (as are the block's, by
//   the tile range).  Keys excluded by the causal or window mask score
//   -1e30 as in the reference, so a row whose keys are all masked averages
//   all Sk keys; keys past Sk score -inf and weigh nothing.
// - Where D * element size is not a multiple of 16 bytes or a pointer is not
//   16-byte aligned, the same kernel stages element by element (template
//   flag kVec = false) at the widest padding, 128.
// - Head dim 160: one more instantiation, bf16 with 16-byte staging at
//   DP = kDWide, for 128 < D <= 160, so every instantiation up to kDMax
//   keeps its code: the serving one (kLse = false) from this file and the
//   training one (kLse = true, pixtral-12b's training forward) from
//   flash_attention_lse.cu.  Its ring is 2 stages x (K, V) x 64 x 168 x
//   2 B = 86 KB (the opt-in above 48 KB) and its O accumulator alone is 80
//   f32 a thread; the bound and the walk are the same as at D 128.  f32
//   stops at 128.
// - Split head dim: template parameter DV (default DP) sizes the V tiles,
//   the O accumulator and the epilogue, while Q K^T runs over DP / 16
//   k-steps.  Two instantiations use it, bf16 with 16-byte staging at
//   DP = kDSplit (192), DV = kDvSplit (128): serving, from this file's
//   flash_attention_fwd_split, and training (kLse), from
//   flash_attention_lse.cu's flash_attention_fwd_split_lse (deepseek-v2's
//   MLA under grad).  Both pass Dv (the kernel's last parameter, after lse,
//   so the other parameters keep their constant-bank offsets).  Every
//   DV == DP instantiation reads D where it reads Dv, through constant
//   conditions, so its code is what it was.
//   A stage of the ring holds K (64 x 200) and V (64 x 136): 86 KB for two
//   stages; Q (64 x 200) is staged in the last one.  Its O accumulator is
//   64 f32 a thread (80 at D 160) and its Q fragments 48 registers.
// - Training (template flag kLse): the epilogue also writes each row's
//   log-sum-exp (natural log, (B, H, Sq) f32) for the backward
//   (flash_attention_bwd.cu, and flash_attention_bwd_wide.cu above 128).
//   Those instantiations are built from flash_attention_lse.cu, which
//   includes this file with FLASH_ATTENTION_LSE defined and exports
//   flash_attention_fwd_lse and flash_attention_fwd_split_lse; this file's
//   own entry points, flash_attention_fwd and flash_attention_fwd_split,
//   build only the serving instantiations (kLse = false), whose code the
//   flag leaves as it was.
// Where the time goes (tools/flash_ablate.py) and what is left to gain are
// in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch_plan.cuh"
#include "tc_helpers.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;      // query rows per block, 16 per warp
constexpr int kBK = 64;               // keys per tile
constexpr int kStages = 2;            // K/V tiles in the cp.async ring
static_assert(kBQ <= 2 * kBK, "Q is staged in one stage of the ring");
constexpr int kDMax = 128;
constexpr int kDWide = 160;           // the bf16 serving instantiation above kDMax
constexpr int kDSplit = 192;          // the split instantiation's q/k head dim ...
constexpr int kDvSplit = 128;         // ... and its v head dim
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Head-dim padding (the mma's reduction depth) and shared row padding.
template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> { static constexpr int kPadTo = 16, kRowPad = 8; };
template <> struct Traits<float> { static constexpr int kPadTo = 8, kRowPad = 4; };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Copy rows row0 .. row0 + kRows - 1 (columns 0 .. DP - 1) of a (rows, stride)
// slice into a shared tile of row stride LD; rows >= n_rows and columns
// >= D become 0.  kVec: 16-byte cp.async (D * sizeof(T) is a multiple of 16
// and src is 16-byte aligned); otherwise element by element, synchronously.
template <typename T, int DP, int LD, bool kVec, int kRows = kBK>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long stride, int row0,
                                           int n_rows, int D) {
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = DP / kE;
    constexpr int kStep = kThreads / kChunks;   // rows per pass; a thread keeps its column
    const int r0 = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * kE;
    if (r0 >= kStep) return;
    const bool col_ok = c < D;
    const long long g_step = kStep * stride;
    const T* g = src + (row0 + r0) * stride + c;
    for (int r = r0; r < kRows; r += kStep, g += g_step) {
      const bool valid = col_ok && row0 + r < n_rows;
      cp_async16(dst + r * LD + c, valid ? g : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const int s = row0 + r;
      dst[r * LD + c] = (s < n_rows && c < D) ? src[s * stride + c] : T(0.f);
    }
  }
}

// An explicit minimum of one block an SM: ptxas then gives the bf16 kernel
// the registers it asks for (153 at D 80, against 130 without it), which
// measured 5-12 % faster (tools/flash_ablate.py, PERF.md).
// lse comes last, so that the other parameters keep the serving kernel's
// offsets in the constant bank: with it in front, the DiT bf16 shape ran
// 3.2 % slower on an H100 with identical instructions and registers
// (tools/flash_fwd_ab.py).
// Dv (the v and o head dim) is read only where DV != DP; elsewhere D.
template <typename T, int DP, bool kVec, bool kLse, int DV = DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Sk, int H, int KH, int D, int causal, int window,
          float scale_log2, int q_offset, float* __restrict__ lse, int Dv) {
  constexpr bool kBf16 = sizeof(T) == 2;
  static_assert(DV == DP || (kBf16 && kVec && DV < DP),
                "a split head dim is bf16 with 16-byte staging");
  constexpr int LD = DP + Traits<T>::kRowPad;   // shared row stride, elements
  constexpr int LDV = DV + Traits<T>::kRowPad;  // ... of the V tiles and O
  constexpr int kTile = kBK * LD;
  constexpr int kStage = kTile + kBK * LDV;      // K then V
  static_assert(kBQ * LD <= kStage, "Q is staged in one stage of the ring");
  constexpr int kNT = DV / 8;                    // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);      // [kStages][K, V][kBK][LD | LDV]
  T* sQ = ring + (kStages - 1) * kStage;         // Q, staged in the last stage

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;         // fragment row group, thread in quad
  const int DVr = DV == DP ? D : Dv;             // v and o head dim
  const long long q_stride = (long long)H * D;   // between sequence positions
  const long long k_stride = (long long)KH * D;
  const long long v_stride = DV == DP ? k_stride : (long long)KH * DVr;
  const long long o_stride = DV == DP ? q_stride : (long long)H * DVr;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * KH + kh) * D;
  const T* vb = v + ((long long)b * Sk * KH + kh) * DVr;

  int kt_lo = 0, kt_hi = (Sk + kBK - 1) / kBK;
  if (q_offset >= 0) {   // every row keeps its diagonal key
    const int q_first = q0 + q_offset;
    const int q_last = min(q0 + kBQ, Sq) - 1 + q_offset;
    if (causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (window > 0) kt_lo = max(0, (q_first - window + 1) / kBK);
  }

  // the ring: tile kt_lo + i goes to stage i % kStages, one commit group a
  // tile (empty past kt_hi); while a tile is in use the next kStages - 1 are
  // in flight
  auto stage_kv = [&](int kt) {
    if (kt < kt_hi) {
      T* dst = ring + ((kt - kt_lo) % kStages) * kStage;
      stage_tile<T, DP, LD, kVec>(dst, kb, k_stride, kt * kBK, Sk, D);
      stage_tile<T, DV, LDV, kVec>(dst + kTile, vb, v_stride, kt * kBK, Sk, DVr);
    }
    cp_async_commit();
  };
  stage_tile<T, DP, LD, kVec, kBQ>(sQ, qb, q_stride, q0, Sq, D);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage_kv(kt_lo + i);
  cp_async_wait<kStages - 1>();
  __syncthreads();

  // Q fragments, kept for the whole walk: rows w0 + g and w0 + g + 8.
  const int w0 = warp * 16;
  constexpr int kQK = kBf16 ? DP / 16 : DP / 8;  // reduction steps of Q K^T
  uint32_t qf[kBf16 ? kQK : 1][4];
  float qr[kBf16 ? 1 : kQK][4];
  if constexpr (kBf16) {
    const int r = (lane & 7) + 8 * ((lane >> 3) & 1), c = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < kQK; ++kk) ldsm_x4(qf[kk], sQ + (w0 + r) * LD + 16 * kk + c);
  } else {
#pragma unroll
    for (int kk = 0; kk < kQK; ++kk) {
      const float* p = reinterpret_cast<const float*>(sQ) + (w0 + g) * LD + 8 * kk + t;
      qr[kk][0] = p[0];
      qr[kk][1] = p[8 * LD];
      qr[kk][2] = p[4];
      qr[kk][3] = p[8 * LD + 4];
    }
  }
  __syncthreads();   // the last stage is free for the ring

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, log2 domain
  float l[2] = {0.f, 0.f};                       // this thread's part of the row sum
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int wq_first = q0 + w0;                  // the warp's first query row
  const int wq_last = min(q0 + w0 + 15, Sq - 1);
  const int qpos_g = q0 + w0 + g + q_offset;     // positions of rows g, g + 8

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    // one barrier a tile: it publishes tile kt, and every warp is past tile
    // kt - 1, whose stage the next copy reuses
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage_kv(kt + kStages - 1);

    const int k0 = kt * kBK;
    const T* tK = ring + ((kt - kt_lo) % kStages) * kStage;
    const T* tV = tK + kTile;
    // a tile masked for every row of the warp adds nothing once each row has
    // its own diagonal key (q_offset >= 0); rows past Sq are never stored
    bool live = wq_first < Sq;
    if (q_offset >= 0 && live) {
      if (causal && k0 > wq_last + q_offset) live = false;
      if (window > 0 && wq_first + q_offset - (k0 + kBK - 1) >= window) live = false;
    }
    if (live) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

      // S = Q K^T: 16 rows x 64 keys, 8 accumulator tiles of 8 keys
      if constexpr (kBf16) {
        // ldmatrix x4: keys 16 jp + (0..7 | 8..15) x columns 16 kk + (0..7 | 8..15)
        const int key = (lane & 7) + 8 * (lane >> 4), c = 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int kk = 0; kk < kQK; ++kk) {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t r[4];
            ldsm_x4(r, tK + (16 * jp + key) * LD + 16 * kk + c);
            mma_bf16(s[2 * jp], qf[kk], r[0], r[1]);
            mma_bf16(s[2 * jp + 1], qf[kk], r[2], r[3]);
          }
        }
      } else {
        const float* fK = reinterpret_cast<const float*>(tK);
#pragma unroll
        for (int kk = 0; kk < kQK; ++kk) {
          uint32_t ab[4], as[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split(qr[kk][i], ab[i], as[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float* p = fK + (8 * j + g) * LD + 8 * kk + t;
            uint32_t bb0, bs0, bb1, bs1;
            split(p[0], bb0, bs0);
            split(p[4], bb1, bs1);
            mma_3xtf32(s[j], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }

      // scale into the log2 domain; masks only where the tile straddles an edge
      const bool clear = k0 + kBK <= Sk &&
                         (!causal || k0 + kBK - 1 <= wq_first + q_offset) &&
                         (window <= 0 || wq_last + q_offset - k0 < window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (!clear) {   // selects, not branches
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = qpos_g + 8 * (e >> 1);
            const bool masked = (causal & (key > qpos)) | ((window > 0) & (qpos - key >= window));
            x = key >= Sk ? -CUDART_INF_F : masked ? kMasked : x;
          }
          s[j][e] = x;
        }
      }

      // online softmax on the fragments: row g holds e = 0, 1; row g + 8 e = 2, 3
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t8[8];   // pairwise: a tree, not a chain
#pragma unroll
        for (int j = 0; j < 8; ++j) t8[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) t8[j] = fmaxf(t8[j], t8[j + w]);
        const float mx = quad_max(fmaxf(m[r], t8[0]));
        const float m_use = mx == -CUDART_INF_F ? 0.f : mx;   // no -inf - -inf
        alpha[r] = ex2(m[r] - m_use);
        m[r] = mx;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][2 * r] = ex2(s[j][2 * r] - m_use);
          s[j][2 * r + 1] = ex2(s[j][2 * r + 1] - m_use);
          t8[j] = s[j][2 * r] + s[j][2 * r + 1];
        }
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) t8[j] += t8[j + w];
        l[r] = l[r] * alpha[r] + t8[0];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V
      if constexpr (kBf16) {
        // ldmatrix.trans x4: keys 16 kk + (0..7 | 8..15) x columns 16 np + (0..7 | 8..15)
        const int key = (lane & 7) + 8 * ((lane >> 3) & 1), c = 8 * (lane >> 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int np = 0; np < DV / 16; ++np) {
            uint32_t r[4];
            ldsm_x4_trans(r, tV + (16 * kk + key) * LDV + 16 * np + c);
            mma_bf16(acc[2 * np], a, r[0], r[1]);
            mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
          }
        }
      } else {
        // k slot t <-> key 2t, k slot t + 4 <-> key 2t + 1 of each 8-key step
        const float* fV = reinterpret_cast<const float*>(tV);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t ab[4], as[4];
          split(s[kk][0], ab[0], as[0]);
          split(s[kk][2], ab[1], as[1]);
          split(s[kk][1], ab[2], as[2]);
          split(s[kk][3], ab[3], as[3]);
          const float* p = fV + (8 * kk + 2 * t) * LD + g;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            uint32_t bb0, bs0, bb1, bs1;
            split(p[8 * n], bb0, bs0);
            split(p[LD + 8 * n], bb1, bs1);
            mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }
    }
  }

  // O = acc / l.  kVec: through shared memory (the first kBQ rows of the
  // ring), so that each thread writes 16 contiguous bytes of a row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    inv[r] = lr > 0.f ? 1.f / lr : 0.f;
    if constexpr (kLse) {
      // the row's log-sum-exp for the backward; a row whose keys are all
      // masked (max kMasked) gets the reference's -1e30
      const int s = q0 + w0 + g + 8 * r;
      if (t == 0 && s < Sq)
        lse[((long long)b * H + h) * Sq + s] =
            m[r] <= 0.5f * kMasked ? kMasked : (m[r] + __log2f(lr)) * kLn2;
    }
  }
  T* ob = o + ((long long)b * Sq * H + h) * DVr;
  if constexpr (kVec) {
    __syncthreads();   // every warp is done with the ring
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        store2(ring + (w0 + g + 8 * r) * LDV + 8 * n + 2 * t, acc[n][2 * r] * inv[r],
               acc[n][2 * r + 1] * inv[r]);
    __syncthreads();
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = DV / kE;
    for (int i = threadIdx.x; i < kBQ * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kE;
      if (q0 + r < Sq && c < DVr)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * o_stride + c) =
            *reinterpret_cast<const uint4*>(ring + r * LDV + c);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + w0 + g + 8 * r;
      if (s >= Sq) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < DVr) store(ob + s * o_stride + c, acc[n][2 * r] * inv[r]);
        if (c + 1 < DVr) store(ob + s * o_stride + c + 1, acc[n][2 * r + 1] * inv[r]);
      }
    }
  }
}

template <typename T, int DP, bool kVec, bool kLse, int DV = DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int Sq, int Sk, int H, int KH, int D, int causal, int window, float scale,
                      cudaStream_t stream, int Dv = 0) {
  constexpr int LD = DP + Traits<T>::kRowPad, LDV = DV + Traits<T>::kRowPad;
  constexpr size_t smem = sizeof(T) * kStages * kBK * (LD + LDV);   // the ring
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  if (smem > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd<T, DP, kVec, kLse, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
      raised = true;
    }
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  return PLAN_LAUNCH("flash_fwd", flash_fwd<T, DP, kVec, kLse, DV>, grid, dim3(kThreads), smem,
                     stream, static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KH, D, causal,
                     window, scale * kLog2e, Sk - Sq, lse, Dv);
}

// The head dim rounds up to the next instantiated width: a multiple of the
// mma's depth (16 in bf16, 8 in f32); the element-by-element path takes 128.
template <typename T, bool kLse, int DP = Traits<T>::kPadTo>
cudaError_t launch(bool vec, const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Sq, int Sk, int H, int KH, int D, int causal, int window,
                   float scale, cudaStream_t s) {
  if (!vec)
    return launch_dp<T, kDMax, false, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal,
                                            window, scale, s);
  if constexpr (DP < kDMax) {
    if (D > DP)
      return launch<T, kLse, DP + Traits<T>::kPadTo>(vec, q, k, v, o, lse, B, Sq, Sk, H, KH, D,
                                                     causal, window, scale, s);
  }
  return launch_dp<T, DP, true, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal, window,
                                      scale, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool valid_shape(int B, int Sq, int Sk, int H, int KH, int D) {
  return D >= 1 && KH >= 1 && H % KH == 0 && B >= 1 && Sq >= 1 && Sk >= 1 && B <= 65535 &&
         H <= 65535;
}

template <bool kLse>
int run(const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
        int Sq, int Sk, int H, int KH, int D, int causal, int window, float scale,
        void* stream) {
  if (!valid_shape(B, Sq, Sk, H, KH, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = (D * elem) % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(o);
  if (D > kDMax) {
    // bf16 with 16-byte rows and pointers only (pixtral-12b's 160)
    if (dtype == 1 && D <= kDWide && vec)
      return (int)launch_dp<__nv_bfloat16, kDWide, true, kLse>(
          q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal, window, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return (int)launch<float, kLse>(vec, q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal, window,
                                    scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, kLse>(vec, q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal,
                                            window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// A v (and o) head dim Dv below q and k's D (the split instantiation).
template <bool kLse>
int run_split(const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
              int Sq, int Sk, int H, int KH, int D, int Dv, int causal, int window, float scale,
              void* stream) {
  if (!valid_shape(B, Sq, Sk, H, KH, D) || dtype != 1 || D <= kDMax || D > kDSplit ||
      D % 8 != 0 || Dv < 1 || Dv > kDvSplit || Dv % 8 != 0 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dp<__nv_bfloat16, kDSplit, true, kLse, kDvSplit>(
      q, k, v, o, lse, B, Sq, Sk, H, KH, D, causal, window, scale,
      static_cast<cudaStream_t>(stream), Dv);
}

}  // namespace

// flash_attention_any.cu includes this file for its helpers, without the
// entry points.
#ifndef FLASH_ATTENTION_HELPERS_ONLY
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  All four
// tensors are contiguous: q and o (B, Sq, H, D), k and v (B, Sk, KH, D).
// 16-byte copies need 16-byte rows and pointers; anything else stages
// element by element in the same kernel.  128 < D <= 160 takes bf16 with
// 16-byte rows and pointers only.
#ifndef FLASH_ATTENTION_LSE
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int KH, int D,
                                   int causal, int window, float scale, void* stream) {
  return run<false>(q, k, v, o, nullptr, dtype, B, Sq, Sk, H, KH, D, causal, window, scale,
                    stream);
}

// A v (and o) head dim Dv below q and k's D: k (B, Sk, KH, D), v (B, Sk,
// KH, Dv), q (B, Sq, H, D), o (B, Sq, H, Dv); bf16 (dtype 1) only, 128 < D
// <= 192, 1 <= Dv <= 128, D and Dv multiples of 8, 16-byte aligned pointers.
extern "C" int flash_attention_fwd_split(const void* q, const void* k, const void* v, void* o,
                                         int dtype, int B, int Sq, int Sk, int H, int KH,
                                         int D, int Dv, int causal, int window, float scale,
                                         void* stream) {
  return run_split<false>(q, k, v, o, nullptr, dtype, B, Sq, Sk, H, KH, D, Dv, causal, window,
                          scale, stream);
}

// Query entries (launch_plan.cuh): the entry's arguments with `plans` in
// place of the stream; the plan each launch site would launch goes to
// `plans` and nothing launches.
extern "C" int flash_attention_fwd_plan(const void* q, const void* k, const void* v, void* o,
                                        int dtype, int B, int Sq, int Sk, int H, int KH, int D,
                                        int causal, int window, float scale, long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_fwd(q, k, v, o, dtype, B, Sq, Sk, H, KH, D, causal, window, scale,
                             nullptr);
}

extern "C" int flash_attention_fwd_split_plan(const void* q, const void* k, const void* v,
                                              void* o, int dtype, int B, int Sq, int Sk, int H,
                                              int KH, int D, int Dv, int causal, int window,
                                              float scale, long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_fwd_split(q, k, v, o, dtype, B, Sq, Sk, H, KH, D, Dv, causal, window,
                                   scale, nullptr);
}
#else
// The same, and lse (B, H, Sq) f32 receives each row's log-sum-exp.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int dtype, int B, int Sq, int Sk, int H,
                                       int KH, int D, int causal, int window, float scale,
                                       void* stream) {
  return run<true>(q, k, v, o, static_cast<float*>(lse), dtype, B, Sq, Sk, H, KH, D, causal,
                   window, scale, stream);
}

extern "C" int flash_attention_fwd_lse_plan(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int dtype, int B, int Sq, int Sk, int H,
                                            int KH, int D, int causal, int window, float scale,
                                            long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_fwd_lse(q, k, v, o, lse, dtype, B, Sq, Sk, H, KH, D, causal, window,
                                 scale, nullptr);
}

// The split head dim (flash_attention_fwd_split's arguments), and lse (B,
// H, Sq) f32 receives each row's log-sum-exp.
extern "C" int flash_attention_fwd_split_lse(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int dtype, int B, int Sq,
                                             int Sk, int H, int KH, int D, int Dv, int causal,
                                             int window, float scale, void* stream) {
  return run_split<true>(q, k, v, o, static_cast<float*>(lse), dtype, B, Sq, Sk, H, KH, D, Dv,
                         causal, window, scale, stream);
}

extern "C" int flash_attention_fwd_split_lse_plan(const void* q, const void* k, const void* v,
                                                  void* o, void* lse, int dtype, int B, int Sq,
                                                  int Sk, int H, int KH, int D, int Dv,
                                                  int causal, int window, float scale,
                                                  long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_fwd_split_lse(q, k, v, o, lse, dtype, B, Sq, Sk, H, KH, D, Dv, causal,
                                       window, scale, nullptr);
}
#endif
#endif  // FLASH_ATTENTION_HELPERS_ONLY
