// Flash attention backward for Hopper (sm_90a) on the tensor cores, plain C
// interface.
//
// Replaces JAX's autodiff of src/repro/models/layers.py:86 blocked_attention
// (the JAX package differentiates attention outside any Pallas kernel; the
// Pallas forward has no custom_vjp).  Given q, k, v, the forward's output o,
// its row log-sum-exp lse (natural log, (B, H, Sq) f32, written by
// flash_attention_fwd_lse) and dO, it computes what autograd of
// attention_ref gives:
//   P  = exp(S * scale - lse)                 S = q k^T
//   dV = P^T dO            dP = dO v^T        Delta = rowsum(dO * o)
//   dS = P * (dP - Delta) * scale  (0 where the mask excludes the key)
//   dQ = dS k              dK = dS^T q
// over the forward's whole contract: causal and sliding-window masks from
// absolute positions with q at the tail of k (q_offset = Sk - Sq), GQA (the
// group's heads summed into their kv head), ragged Sq and Sk, 1 <= D <= 128,
// f32 and bf16 (gradients written in the input dtype).  A row whose keys are
// all masked (causal, q longer than k) takes the reference's uniform softmax
// over all Sk keys: it adds dO / Sk to every dV row and nothing to dq or dk.
//
// Bound on an H100 SXM: the five products, 10 * B * H * (unmasked pairs) *
// D operations, against the bytes of q, k, v, o, dO, dq, dk, dv moved once.
// In bf16 the tensor cores (989 TFLOP/s) leave the bytes as the bound: at
// DiT-XL's training shape (B 8, S 256, H 16, D 72) 37.8 MB, 0.0113 ms.  In
// f32 the products run as 3xTF32 (165 TFLOP/s of f32-accurate work), so
// the operations bound: 6.04 GFLOP, 0.0366 ms.
//
// What the design does about it (FlashAttention-2's backward on mma.sync,
// deterministic: no atomics, so a rerun is bitwise equal):
// - flash_bwd_delta: one warp a query row, Delta = rowsum(dO * o) in f32.
// - flash_bwd_dkdv: one block of 4 warps per (64-key tile, kv head,
//   batch); warp w owns keys 16 w .. 16 w + 15.  K and V are copied once;
//   the block walks the group's heads and, for each, the 64-query tiles
//   the mask leaves, with Q, dO, lse and Delta coming through a 2-stage
//   cp.async ring (16-byte copies with zero fill past Sq and D), so the
//   next tile's copy overlaps this tile's products; one barrier a tile.
//   Each warp forms S^T = K_w Q^T and dP^T = V_w dO^T (16 keys x 64
//   queries), turns them into P^T and dS^T on the accumulator fragments in
//   f32 (mask and keyless rows as the reference), and accumulates dV +=
//   P^T dO and dK += dS^T Q in registers: the accumulator layout of two
//   8-column tiles is the A layout of the next product, so P and dS never
//   go through shared memory.  The group's sum happens inside the block.
// - flash_bwd_dq: one block per (64-query tile, head, batch), warp w owns
//   16 query rows; Q and dO are copied once, K and V walk the key tiles
//   the mask leaves through the same ring; S, dP and dS are recomputed and
//   dQ += dS K accumulates in registers.  dQ is not fused into the dK/dV
//   walk: that would take atomics.
// - bf16: every product is mma.sync m16n8k16 (bf16 in, f32 accumulate),
//   operands from ldmatrix (.trans for the products over queries or keys).
//   P and dS are f32 values: each goes into its product as a bf16 pair,
//   hi = bf16(x) and lo = bf16(x - hi), two mma a fragment.  Rounded once
//   to bf16, P and dS put zamba2's dv 2.04e-2 off float64 on one of four
//   draws (its gate: 2e-2 abs) and tinyllama's dk 1.79e-2 past one
//   rounding (gate 2e-2); the pairs keep every gradient within 1.4e-5 of
//   where f32 P and dS had it (tools/flash_bwd_rounding.py, on the CPU).
// - f32: the same walk through mma.sync m16n8k8 tf32 (the head dim padded
//   to 16 as in bf16), every operand split into big + small and each
//   product summed as small*big + big*small + big*big (3xTF32, as the
//   forward), P and dS included.  The P dO, dS Q
//   and dS K products permute their reduction axis (k slot t <-> column
//   2t, k slot t + 4 <-> 2t + 1) so that the accumulator fragment is the A
//   fragment, and read the walked tile's rows in the same order.
// - Tiles stay in their dtype in shared memory, rows padded by 16 bytes in
//   bf16 and 4 floats in f32, so that ldmatrix and the f32 fragment loads
//   hit distinct banks.  Shared bytes a block: 6 tiles of 64 rows (2 fixed,
//   2 stages of 2 walked) plus 1 KB of lse and Delta: 68,608 at bf16 D 72
//   and 80, room for 3 blocks of 4 warps an SM, where registers (ptxas:
//   243 a thread in dK/dV, 168 in dQ) hold dK/dV to 2 and dQ to 3;
//   105,472 at bf16 D 128 and at f32 D 64 (2 an SM); 130,048 at f32 D 72,
//   padded to 80 as in bf16 (1 an SM).
// - Masks cost only on tiles that straddle a mask edge, Sq or Sk; a warp
//   whose keys (or rows) the mask hides from the whole tile skips it.
// - exp2 on the special function unit with log2(e) folded into the scale.
// - Where D * element size is not a multiple of 16 bytes or a pointer is
//   not 16-byte aligned, the same kernels stage element by element
//   (template flag kVec = false) at the next of 32, 64 or 128 columns.
// - The f32 instantiations compile from flash_attention_bwd_f32.cu (head
//   dims up to 96; FLASH_BWD_F32 1) and flash_attention_bwd_f32_hi.cu
//   (above; FLASH_BWD_F32 2), which include this file, so that the three
//   parts build in parallel; this file holds the bf16 half and the entry
//   point.
// - Head dims above 128 (bf16: pixtral-12b's 160, deepseek-v2's MLA at q/k
//   192 over v 128) are flash_attention_bwd_wide.cu's, a translation unit
//   of its own that includes this file for its helpers, with an entry
//   point of its own (flash_attention_bwd_wide), so that every
//   instantiation here keeps its code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch_plan.cuh"
#include "tc_helpers.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 64;                // query rows of a tile, 16 a warp in dQ
constexpr int kBK = 64;                // keys of a tile, 16 a warp in dK/dV
constexpr int kStages = 2;             // walked tiles in the cp.async ring
constexpr int kDMax = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Head-dim padding: the bf16 mma's reduction depth, for f32 too, which
// halves the f32 widths to build (build time: PERF.md).  Shared rows are
// padded by 16 bytes.
constexpr int kPadTo = 16;
template <typename T>
constexpr int kRowPad = 16 / sizeof(T);

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// (x0, x1) as two packed bf16 pairs: hi rounds each, lo rounds the rest
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

struct Shape {
  int Sq, Sk, H, KH, D, causal, window, q_offset;
  float scale, scale_log2;
};

// Rows row0 .. row0 + 63 (columns 0 .. DP - 1) of a (rows, stride) slice
// into a shared tile of row stride LD; rows >= n_rows and columns >= D
// become 0.  kVec: 16-byte cp.async; otherwise element by element.
template <typename T, int DP, int LD, bool kVec>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long stride, int row0,
                                           int n_rows, int D) {
  constexpr int kRows = 64;
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = DP / kE;
    constexpr int kStep = kThreads / kChunks;   // rows per pass; a thread keeps its column
    const int r0 = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * kE;
    if (r0 >= kStep) return;
    const bool col_ok = c < D;
    for (int r = r0; r < kRows; r += kStep) {
      const bool valid = col_ok && row0 + r < n_rows;
      cp_async16(dst + r * LD + c, valid ? src + (long long)(row0 + r) * stride + c : src,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const int s = row0 + r;
      dst[r * LD + c] = (s < n_rows && c < D) ? src[(long long)s * stride + c] : T(0.f);
    }
  }
}

// S = F1 W1^T and dP = F2 W2^T for the warp's 16 rows of the fixed tiles
// (f1, f2 point at the first of them) against the 64 rows of the walked
// tiles: accumulator tile j holds columns 8 j .. 8 j + 7.
template <typename T, int DP, int LD>
__device__ __forceinline__ void scores(const T* f1, const T* f2, const T* w1, const T* w2,
                                       float s[8][4], float dp[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
    // A: rows (lane & 7) + 8 ((lane >> 3) & 1), columns 8 (lane >> 4);
    // B (x4): rows 16 jp + (0..7 | 8..15) x columns (0..7 | 8..15)
    const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
    const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a1[4], a2[4];
      ldsm_x4(a1, f1 + ar * LD + 16 * kk + ac);
      ldsm_x4(a2, f2 + ar * LD + 16 * kk + ac);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, w1 + (16 * jp + br) * LD + 16 * kk + bc);
        mma_bf16(s[2 * jp], a1, r[0], r[1]);
        mma_bf16(s[2 * jp + 1], a1, r[2], r[3]);
        ldsm_x4(r, w2 + (16 * jp + br) * LD + 16 * kk + bc);
        mma_bf16(dp[2 * jp], a2, r[0], r[1]);
        mma_bf16(dp[2 * jp + 1], a2, r[2], r[3]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t a1b[4], a1s[4], a2b[4], a2s[4];
      {
        const float* p1 = f1 + g * LD + 8 * kk + t;
        const float* p2 = f2 + g * LD + 8 * kk + t;
        const float v1[4] = {p1[0], p1[8 * LD], p1[4], p1[8 * LD + 4]};
        const float v2[4] = {p2[0], p2[8 * LD], p2[4], p2[8 * LD + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(v1[i], a1b[i], a1s[i]);
          split(v2[i], a2b[i], a2s[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        const float* p = w1 + (8 * j + g) * LD + 8 * kk + t;
        split(p[0], bb0, bs0);
        split(p[4], bb1, bs1);
        mma_3xtf32(s[j], a1b, a1s, bb0, bb1, bs0, bs1);
        p = w2 + (8 * j + g) * LD + 8 * kk + t;
        split(p[0], bb0, bs0);
        split(p[4], bb1, bs1);
        mma_3xtf32(dp[j], a2b, a2s, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// acc += X W for X the 16 x 64 accumulator tile x (f32) and W the 64 rows
// of a walked tile; acc tile n holds columns 8 n .. 8 n + 7 of the head dim.
template <typename T, int DP, int LD>
__device__ __forceinline__ void acc_product(float x[8][4], const T* w,
                                            float acc[DP / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    // ldmatrix.trans x4: rows 16 kk + (0..7 | 8..15) x columns 16 np + (0..7 | 8..15)
    const int r = (lane & 7) + 8 * ((lane >> 3) & 1), c = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
      split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
      split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, w + (16 * kk + r) * LD + 16 * np + c);
        mma_bf16(acc[2 * np], lo, b[0], b[1]);
        mma_bf16(acc[2 * np], hi, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
        mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      }
    }
  } else {
    // k slot t <-> column 2t, k slot t + 4 <-> 2t + 1 of each 8-column step
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ab[4], as[4];
      split(x[kk][0], ab[0], as[0]);
      split(x[kk][2], ab[1], as[1]);
      split(x[kk][1], ab[2], as[2]);
      split(x[kk][3], ab[3], as[3]);
      const float* p = w + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split(p[8 * n], bb0, bs0);
        split(p[LD + 8 * n], bb1, bs1);
        mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// s <- P and dp <- dS * scale of query qi and key kj.  Keys past Sk and
// rows past Sq give 0; a masked key gets P = 0 and dS = 0, except in a row
// whose keys are all masked (causal, position < 0), whose P is the
// reference's uniform 1 / Sk.  clear: the tile straddles no edge.
__device__ __forceinline__ void p_ds(const Shape& a, bool clear, int qi, int kj, float lse,
                                     float dl, float& s, float& dp) {
  float p = 0.f, ds = 0.f;
  if (clear) {
    p = ex2(s * a.scale_log2 - lse * kLog2e);
    ds = p * (dp - dl) * a.scale;
  } else if (qi < a.Sq && kj < a.Sk) {
    const int qpos = qi + a.q_offset;
    const bool masked = (a.causal && kj > qpos) || (a.window > 0 && qpos - kj >= a.window);
    if (a.causal && qpos < 0) {
      p = 1.f / a.Sk;
    } else if (!masked) {
      p = ex2(s * a.scale_log2 - lse * kLog2e);
      ds = p * (dp - dl) * a.scale;
    }
  }
  s = p;
  dp = ds;
}

// No query of rows q0 .. q0 + 63 and no key of k0 .. k0 + 63 meets an edge:
// every pair is unmasked and inside Sq and Sk
__device__ __forceinline__ bool clear_tile(const Shape& a, int q0, int k0) {
  const int qpos0 = q0 + a.q_offset;
  return q0 + kBQ <= a.Sq && k0 + kBK <= a.Sk && (!a.causal || k0 + kBK - 1 <= qpos0) &&
         (a.window <= 0 || qpos0 + kBQ - 1 - k0 < a.window);
}

// Delta = rowsum(dO * o) in f32: one warp a row of the (B, Sq, H, D)
// layout, written (B, H, Sq)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ delta,
                long long rows, int Sq, int H, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* po = o + row * D;
  const T* pd = dO + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(load_f(po + c), load_f(pd + c), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;          // b * Sq + s
    const int s = (int)(bs % Sq);
    const long long b = bs / Sq;
    delta[(b * H + h) * Sq + s] = acc;
  }
}

// The 16 x DP accumulator tile of rows row0 + (g, g + 8) into a (rows, stride)
// slice: rows >= n_rows and columns >= D are left out.
template <typename T, int DP, bool kVec>
__device__ __forceinline__ void store_rows(T* base, long long stride, int row0, int n_rows,
                                           int D, float acc[DP / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    T* p = base + (long long)row * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if constexpr (kVec) {   // D even: a pair is in or out
        if (c < D) store2(p + c, acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        if (c < D) store(p + c, acc[n][2 * r]);
        if (c + 1 < D) store(p + c + 1, acc[n][2 * r + 1]);
      }
    }
  }
}

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return sizeof(T) * 6 * 64 * (DP + kRowPad<T>) + sizeof(float) * kStages * 2 * kBQ;
}

template <typename T, int DP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dO, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               Shape a) {
  constexpr int LD = DP + kRowPad<T>;
  constexpr int kTile = 64 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kTile;
  T* ring = sV + kTile;                                          // [stage][Q, dO][64][LD]
  float* rows = reinterpret_cast<float*>(ring + kStages * 2 * kTile);   // [stage][lse, Delta][64]

  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long q_stride = (long long)a.H * a.D, k_stride = (long long)a.KH * a.D;
  const long long kv_off = ((long long)b * a.Sk * a.KH + kh) * a.D;

  // the query tiles that can see a key of this tile; every tile when a row
  // may have all its keys masked (q_offset < 0), since such a row reaches
  // every dV row
  int qt_lo = 0, qt_hi = (a.Sq + kBQ - 1) / kBQ;
  if (a.q_offset >= 0) {
    if (a.causal) qt_lo = max(0, (k0 - a.q_offset) / kBQ);
    if (a.window > 0) {
      const int q_last = k0 + kBK - 1 + a.window - 1 - a.q_offset;   // last row in reach
      qt_hi = q_last < 0 ? 0 : min(qt_hi, q_last / kBQ + 1);
    }
  }
  const int nq = max(0, qt_hi - qt_lo), n_it = G * nq;

  // step it: head kh G + it / nq, query tile qt_lo + it % nq, ring stage it % 2
  auto stage_q = [&](int it) {
    if (it < n_it) {
      const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kBQ;
      T* dst = ring + (it % kStages) * 2 * kTile;
      const long long q_off = ((long long)b * a.Sq * a.H + h) * a.D;
      stage_tile<T, DP, LD, kVec>(dst, q + q_off, q_stride, q0, a.Sq, a.D);
      stage_tile<T, DP, LD, kVec>(dst + kTile, dO + q_off, q_stride, q0, a.Sq, a.D);
      if (threadIdx.x < kBQ) {
        const int i = threadIdx.x;
        const bool ok = q0 + i < a.Sq;
        const long long r = ((long long)b * a.H + h) * a.Sq + q0 + i;
        float* dst_r = rows + (it % kStages) * 2 * kBQ;
        cp_async4(dst_r + i, ok ? lse + r : lse, ok);
        cp_async4(dst_r + kBQ + i, ok ? delta + r : delta, ok);
      }
    }
    cp_async_commit();
  };
  stage_tile<T, DP, LD, kVec>(sK, k + kv_off, k_stride, k0, a.Sk, a.D);
  stage_tile<T, DP, LD, kVec>(sV, v + kv_off, k_stride, k0, a.Sk, a.D);
  cp_async_commit();
  stage_q(0);

  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int key_w = k0 + 16 * warp;     // the warp's first key
  for (int it = 0; it < n_it; ++it) {
    // one barrier a step: it publishes step it, and every warp is past step
    // it - 1, whose stage the next copy reuses
    cp_async_wait<0>();
    __syncthreads();
    stage_q(it + 1);

    const int q0 = (qt_lo + it % nq) * kBQ;
    bool live = key_w < a.Sk;
    if (a.q_offset >= 0 && live) {     // no keyless rows: masked pairs add nothing
      const int qpos_first = q0 + a.q_offset;
      const int qpos_last = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
      if (a.causal && key_w > qpos_last) live = false;
      if (a.window > 0 && qpos_first - (key_w + 15) >= a.window) live = false;
    }
    if (!live) continue;
    const T* tQ = ring + (it % kStages) * 2 * kTile;
    const T* tdO = tQ + kTile;
    const float* tL = rows + (it % kStages) * 2 * kBQ;
    const float* tD = tL + kBQ;

    // S^T = K_w Q^T and dP^T = V_w dO^T: 16 keys x 64 queries
    float s[8][4], dp[8][4];
    scores<T, DP, LD>(sK + 16 * warp * LD, sV + 16 * warp * LD, tQ, tdO, s, dp);
    const bool clear = clear_tile(a, q0, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * t + (e & 1);           // query of the tile
        p_ds(a, clear, q0 + i, key_w + g + 8 * (e >> 1), tL[i], tD[i], s[j][e], dp[j][e]);
      }
    // dV += P^T dO;  dK += dS^T Q
    acc_product<T, DP, LD>(s, tdO, acc_v);
    acc_product<T, DP, LD>(dp, tQ, acc_k);
  }

  store_rows<T, DP, kVec>(dk + kv_off, k_stride, key_w, a.Sk, a.D, acc_k);
  store_rows<T, DP, kVec>(dv + kv_off, k_stride, key_w, a.Sk, a.D, acc_v);
}

template <typename T, int DP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dO, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, Shape a) {
  constexpr int LD = DP + kRowPad<T>;
  constexpr int kTile = 64 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kTile;
  T* ring = sdO + kTile;                                         // [stage][K, V][64][LD]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long q_stride = (long long)a.H * a.D, k_stride = (long long)a.KH * a.D;
  const long long q_off = ((long long)b * a.Sq * a.H + h) * a.D;
  const long long kv_off = ((long long)b * a.Sk * a.KH + kh) * a.D;

  // the key tiles the mask leaves (as in the forward); dS is 0 elsewhere
  int kt_lo = 0, kt_hi = (a.Sk + kBK - 1) / kBK;
  if (a.q_offset >= 0) {
    const int q_first = q0 + a.q_offset;
    const int q_last = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
    if (a.causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (a.window > 0) kt_lo = max(0, (q_first - a.window + 1) / kBK);
  }

  auto stage_kv = [&](int kt) {
    if (kt < kt_hi) {
      T* dst = ring + ((kt - kt_lo) % kStages) * 2 * kTile;
      stage_tile<T, DP, LD, kVec>(dst, k + kv_off, k_stride, kt * kBK, a.Sk, a.D);
      stage_tile<T, DP, LD, kVec>(dst + kTile, v + kv_off, k_stride, kt * kBK, a.Sk, a.D);
    }
    cp_async_commit();
  };
  stage_tile<T, DP, LD, kVec>(sQ, q + q_off, q_stride, q0, a.Sq, a.D);
  stage_tile<T, DP, LD, kVec>(sdO, dO + q_off, q_stride, q0, a.Sq, a.D);
  cp_async_commit();
  stage_kv(kt_lo);

  // lse and Delta of the thread's rows g and g + 8 of the warp
  const int row_w = q0 + 16 * warp;     // the warp's first query row
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_w + g + 8 * r;
    const long long i = ((long long)b * a.H + h) * a.Sq + qi;
    lr[r] = qi < a.Sq ? lse[i] : 0.f;
    dr[r] = qi < a.Sq ? delta[i] : 0.f;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    stage_kv(kt + 1);

    const int k0 = kt * kBK;
    bool live = row_w < a.Sq;
    if (a.q_offset >= 0 && live) {
      const int qpos_first = row_w + a.q_offset;
      const int qpos_last = min(row_w + 16, a.Sq) - 1 + a.q_offset;
      if (a.causal && k0 > qpos_last) live = false;
      if (a.window > 0 && qpos_first - (k0 + kBK - 1) >= a.window) live = false;
    }
    if (!live) continue;
    const T* tK = ring + ((kt - kt_lo) % kStages) * 2 * kTile;
    const T* tV = tK + kTile;

    // S = Q_w K^T and dP = dO_w V^T: 16 rows x 64 keys
    float s[8][4], dp[8][4];
    scores<T, DP, LD>(sQ + 16 * warp * LD, sdO + 16 * warp * LD, tK, tV, s, dp);
    const bool clear = clear_tile(a, q0, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        p_ds(a, clear, row_w + g + 8 * r, k0 + 8 * j + 2 * t + (e & 1), lr[r], dr[r], s[j][e],
             dp[j][e]);
      }
    // dQ += dS K
    acc_product<T, DP, LD>(dp, tK, acc);
  }

  store_rows<T, DP, kVec>(dq + q_off, q_stride, row_w, a.Sq, a.D, acc);
}

template <typename K>
cudaError_t raise_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP, bool kVec>
cudaError_t launch_dp(const void* q, const void* k, const void* v, const void* dO,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                      const Shape& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  static bool raised = false;
  if (!raised) {
    cudaError_t e = raise_smem(flash_bwd_dkdv<T, DP, kVec>, smem);
    if (e == cudaSuccess) e = raise_smem(flash_bwd_dq<T, DP, kVec>, smem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid_kv((a.Sk + kBK - 1) / kBK, a.KH, B);
  cudaError_t e = PLAN_LAUNCH(
      "flash_bwd_dkdv", flash_bwd_dkdv<T, DP, kVec>, grid_kv, dim3(kThreads), smem, stream,
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  if (e != cudaSuccess) return e;
  const dim3 grid_q((a.Sq + kBQ - 1) / kBQ, a.H, B);
  return PLAN_LAUNCH("flash_bwd_dq", flash_bwd_dq<T, DP, kVec>, grid_q, dim3(kThreads), smem,
                     stream, static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
                     static_cast<T*>(dq), a);
}

// The element-by-element path at the next of 32, 64 or 128 columns (up to
// Top: each f32 translation unit instantiates its own range).
template <typename T, int DP = 32, int Top = kDMax>
cudaError_t launch_elementwise(const void* q, const void* k, const void* v, const void* dO,
                               const float* lse, const float* delta, void* dq, void* dk,
                               void* dv, int B, const Shape& a, cudaStream_t s) {
  if constexpr (DP < Top) {
    if (a.D > DP)
      return launch_elementwise<T, 2 * DP, Top>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
  }
  return launch_dp<T, DP, false>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
}

// The head dim rounds up to the next multiple of 16 (up to Top).
template <typename T, int DP = kPadTo, int Top = kDMax>
cudaError_t launch_vec(const void* q, const void* k, const void* v, const void* dO,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       const Shape& a, cudaStream_t s) {
  if constexpr (DP < Top) {
    if (a.D > DP)
      return launch_vec<T, DP + kPadTo, Top>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
  }
  return launch_dp<T, DP, true>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
}

template <typename T>
cudaError_t launch(bool vec, const void* q, const void* k, const void* v, const void* dO,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   const Shape& a, cudaStream_t s) {
  if (!vec) return launch_elementwise<T>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
  return launch_vec<T>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Delta = rowsum(dO * o) of (B, Sq, H, D) o and dO into (B, H, Sq)
template <typename T>
cudaError_t launch_delta(const void* o, const void* dO, float* delta, int B, int Sq, int H, int D,
                         cudaStream_t s) {
  const long long rows = (long long)B * Sq * H;
  return PLAN_LAUNCH("flash_bwd_delta", flash_bwd_delta<T>, dim3((unsigned)((rows + 7) / 8)),
                     dim3(256), 0, s, static_cast<const T*>(o), static_cast<const T*>(dO), delta,
                     rows, Sq, H, D);
}

// The entry's checks (a shape refused launches nothing), then Delta; *vec:
// D and every pointer take 16-byte copies.  Returns the first error.
template <typename T>
cudaError_t prologue(const void* q, const void* k, const void* v, const void* o, const void* dO,
                     void* delta, const void* dq, const void* dk, const void* dv, int B, int Sq,
                     int Sk, int H, int KH, int D, void* stream, bool* vec) {
  if (D < 1 || D > kDMax || KH < 1 || H % KH != 0 || B < 1 || Sq < 1 || Sk < 1 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  *vec = (D * (int)sizeof(T)) % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
         aligned16(dO) && aligned16(dq) && aligned16(dk) && aligned16(dv);
  return launch_delta<T>(o, dO, static_cast<float*>(delta), B, Sq, H, D,
                         static_cast<cudaStream_t>(stream));
}

Shape shape_of(int Sq, int Sk, int H, int KH, int D, int causal, int window, float scale) {
  return Shape{Sq, Sk, H, KH, D, causal, window, Sk - Sq, scale, scale * kLog2e};
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o, const void* dO,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
        int KH, int D, int causal, int window, float scale, void* stream) {
  bool vec;
  const cudaError_t e =
      prologue<T>(q, k, v, o, dO, delta, dq, dk, dv, B, Sq, Sk, H, KH, D, stream, &vec);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<T>(vec, q, k, v, dO, static_cast<const float*>(lse),
                        static_cast<float*>(delta), dq, dk, dv, B,
                        shape_of(Sq, Sk, H, KH, D, causal, window, scale),
                        static_cast<cudaStream_t>(stream));
}

// The f32 instantiations split between two translation units that build
// in parallel: flash_attention_bwd_f32.cu takes 16-byte rows up to head dim
// 96 and element-by-element rows up to 64, flash_attention_bwd_f32_hi.cu
// the wider ones.
constexpr int kF32VecSplit = 96, kF32ElemSplit = 64;

}  // namespace

#if defined(FLASH_BWD_WIDE)
// flash_attention_bwd_wide.cu adds its kernels and its entry point after
// this file.
#elif !defined(FLASH_BWD_F32)
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* dO, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KH, int D, int causal, int window,
                                       float scale, void* stream);

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk and dv share it).
// All contiguous: q, o, dO and dq (B, Sq, H, D); k, v, dk and dv (B, Sk, KH,
// D); lse (the forward's, natural log) and the scratch delta (B, H, Sq) f32.
// Launches three kernels (Delta, dK/dV, dQ) and returns the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dO, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq, int Sk, int H,
                                   int KH, int D, int causal, int window, float scale,
                                   void* stream) {
  if (dtype == 0)
    return flash_attention_bwd_f32(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, D,
                                   causal, window, scale, stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, D,
                              causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// Query entry (launch_plan.cuh): flash_attention_bwd's arguments with
// `plans` in place of the stream; records the three launches (the f32
// half's through the same buffer) and launches nothing.
extern "C" int flash_attention_bwd_plan(const void* q, const void* k, const void* v,
                                        const void* o, const void* dO, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int dtype,
                                        int B, int Sq, int Sk, int H, int KH, int D, int causal,
                                        int window, float scale, long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_bwd(q, k, v, o, dO, lse, delta, dq, dk, dv, dtype, B, Sq, Sk, H, KH, D,
                             causal, window, scale, nullptr);
}
#elif FLASH_BWD_F32 == 1
// The f32 half of flash_attention_bwd: the checks, Delta and the head dims
// of this translation unit (flash_attention_bwd_f32.cu); the wider ones go
// to flash_attention_bwd_f32_hi.cu's flash_attention_bwd_f32_hi.
extern "C" int flash_attention_bwd_f32_hi(const void* q, const void* k, const void* v,
                                          const void* dO, const void* lse, void* delta, void* dq,
                                          void* dk, void* dv, int B, int Sq, int Sk, int H,
                                          int KH, int D, int causal, int window, float scale,
                                          int vec, void* stream);

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* dO, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KH, int D, int causal, int window,
                                       float scale, void* stream) {
  bool vec;
  const cudaError_t e =
      prologue<float>(q, k, v, o, dO, delta, dq, dk, dv, B, Sq, Sk, H, KH, D, stream, &vec);
  if (e != cudaSuccess) return (int)e;
  if (vec ? D > kF32VecSplit : D > kF32ElemSplit)
    return flash_attention_bwd_f32_hi(q, k, v, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KH, D,
                                      causal, window, scale, vec, stream);
  const Shape a = shape_of(Sq, Sk, H, KH, D, causal, window, scale);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_vec<float, kPadTo, kF32VecSplit>(q, k, v, dO, l, dl, dq, dk, dv, B,
                                                             a, s)
                   : launch_elementwise<float, 32, kF32ElemSplit>(q, k, v, dO, l, dl, dq, dk, dv,
                                                                  B, a, s));
}
#else
// The f32 head dims above flash_attention_bwd_f32.cu's (it has checked
// them and launched Delta): flash_attention_bwd_f32_hi.cu.
extern "C" int flash_attention_bwd_f32_hi(const void* q, const void* k, const void* v,
                                          const void* dO, const void* lse, void* delta, void* dq,
                                          void* dk, void* dv, int B, int Sq, int Sk, int H,
                                          int KH, int D, int causal, int window, float scale,
                                          int vec, void* stream) {
  const Shape a = shape_of(Sq, Sk, H, KH, D, causal, window, scale);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_vec<float, kF32VecSplit + kPadTo>(q, k, v, dO, l, dl, dq, dk, dv, B,
                                                              a, s)
                   : launch_elementwise<float, 2 * kF32ElemSplit>(q, k, v, dO, l, dl, dq, dk, dv,
                                                                  B, a, s));
}
#endif
