// Flash attention backward at any head dim for Hopper (sm_90a) on the tensor
// cores, plain C interface: the head dims and layouts that neither
// flash_attention_bwd.cu (D <= 128) nor flash_attention_bwd_wide.cu (bf16,
// 16-byte rows, 160 and 192 over 128) takes.
//
// Replaces JAX's autodiff of src/repro/models/layers.py:86 blocked_attention
// over the rest of its domain (blocked_attention takes any head dim and any
// param dtype): f32 above head dim 128 (pixtral-12b's 160 and deepseek-v2's
// MLA, 192 over 128, with f32 params), bf16 above 160 (or above 192, or v
// above 128, under a wider q/k head dim), and every head dim above 128
// whose rows or pointers are not 16-byte aligned.  The contract is
// flash_attention_bwd.cu's, whose helpers this file includes: given q, k, v,
// o, the forward's row log-sum-exp (natural log) and dO, the same P, dV, dP,
// Delta, dS, dQ and dK, causal and window masks, GQA summed inside the
// block, ragged Sq and Sk, keyless rows, deterministic (no atomics), with a v
// head dim Dv <= D: dV, dO and o have Dv columns, dQ and dK have D.
//
// Bound on an H100 SXM: the five products, 2 * B * H * (unmasked pairs) *
// (3 D + 2 Dv) operations, against the bytes of q, k, v, o, dO, dq, dk, dv
// moved once.  In f32 the products run as 3xTF32 (165 TFLOP/s of
// f32-accurate work): pixtral-12b's training shape (B 2, S 1088, 32 / 8
// heads of 160, causal) is 60.7 GFLOP, 0.368 ms, against 223 MB, 0.067 ms;
// the operations bound.
//
// What the design does about it: each score is formed once a tile pair,
// over D in 64-column slabs, by two groups of 4 warps side by side.
// - flash_bwd_dkdv_any: one block of 8 warps per (64-key tile, column
//   group of 192, kv head, batch), warps 4 s .. 4 s + 3 of side s owning
//   keys 16 w .. 16 w + 15, walking the group's heads and the query tiles
//   the mask leaves.  Side 0 forms S^T = K Q^T over D, side 1 dP^T = V dO^T
//   over Dv in the same steps; side 0 turns S^T into P^T (f32) and hands it
//   to side 1 through a 16 KB tile, side 1 forms dS^T; then side 0
//   accumulates dV += P^T dO and side 1 dK += dS^T Q over the group's
//   columns, slab by slab.  A side holds one accumulator of up to 192
//   columns (96 f32 a thread) beside its 16 x 64 score: dK and dV in one
//   walk without one warp holding both (one warp holding both took 255
//   registers and spilled in f32).  A wider D is more column groups on the
//   grid, each forming S^T and dP^T anew: pixtral's 160 and the MLA's 192
//   over 128 are one group each.
// - flash_bwd_dq_any: one block of 8 warps per (64-query tile, column group
//   of 256, head, batch): side 0 forms S over D, side 1 dP over Dv; P goes
//   to side 1, dS back to side 0 (two 16 KB tiles), and each side
//   accumulates dQ += dS K over half of every 64-column slab of K.
// - The walked slabs come through a 2-stage cp.async ring (16-byte copies
//   with zero fill, or element by element where a row or a pointer is not
//   16-byte aligned), four slabs a stage (K, Q, V, dO in the score steps;
//   Q and dO, or K, in the accumulation steps), one barrier a step.  All
//   8 warps stage, with no producer warp and no TMA: TMA needs 16-byte
//   row strides, which this unit's misaligned rows lack, and one warp
//   staging 4 slabs element by element would starve the other 8.
// - Load balance under the causal mask: the grid is 1-D with the tiles
//   that take the most work first (flash_bwd_split.cuh's tile_of_block).
// - Delta = rowsum(dO * o) is flash_attention_bwd.cu's kernel over Dv.
// - lse and Delta come from device memory (L1) in the P / dS pass.
// - bf16: mma.sync m16n8k16, P and dS as bf16 hi + lo pairs (the other
//   backwards' rounding); f32: 3xTF32 on m16n8k8 (wgmma's tf32 wants both
//   operands K-major and split big / small copies in shared memory, which
//   the f32 slabs leave no room for), P and dS included, each walked
//   tile's part of dK, dV and dQ formed from zero and added to the
//   accumulator in f32 (the tensor cores' own accumulation over thousands
//   of rows rounded 13x worse than the plain version).
//   Shared memory: 2 stages x 4 slabs x 64 x (64 + pad) and two 16 KB
//   exchange tiles: 172,032 bytes in f32, 106,496 in bf16.  ptxas's
//   registers and spills: PERF.md §6.
// Every instantiation of flash_attention_bwd.cu, flash_attention_bwd_f32.cu
// and flash_attention_bwd_wide.cu keeps its code: a translation unit of its
// own with its own entry point, flash_attention_bwd_any.

// flash_attention_bwd.cu's helpers, without its entry points
#define FLASH_BWD_WIDE
#include "flash_attention_bwd.cu"
#include "flash_bwd_split.cuh"

namespace {

constexpr int kW = 64;                      // head-dim columns of a slab
constexpr int kAnyThreads = 2 * kThreads;   // two sides of 4 warps
constexpr int kAccCols = 192;               // dK / dV: a side's accumulator, a column group
constexpr int kAccTiles = kAccCols / 8;
constexpr int kAccSlabs = kAccCols / kW;
constexpr int kQCols = 256;                 // dQ: a column group, each side half of a slab
constexpr int kQSlabs = kQCols / kW;

template <typename T>
struct Slab {
  static constexpr int LD = kW + kRowPad<T>;    // shared row stride, elements
  static constexpr int kSlab = 64 * LD;
  static constexpr int kStage = 4 * kSlab;
  static constexpr size_t kRingBytes = sizeof(T) * 2 * kStage;
  static constexpr size_t kSmem = kRingBytes + 2 * sizeof(float) * 64 * 64;
};

// Rows row0 .. row0 + 63, columns c0 .. c0 + 63 of a (rows, stride) slice
// into a shared slab; rows >= n_rows and columns >= n_cols become 0.  kVec:
// 16-byte cp.async; otherwise element by element.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_slab(T* dst, const T* src, long long stride, int row0,
                                           int n_rows, int c0, int n_cols) {
  constexpr int LD = Slab<T>::LD;
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = kW / kE;
    constexpr int kStep = kAnyThreads / kChunks;
    const int r0 = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * kE;
    const bool col_ok = c0 + c < n_cols;
    for (int r = r0; r < 64; r += kStep) {
      const bool valid = col_ok && row0 + r < n_rows;
      cp_async16(dst + r * LD + c, valid ? src + (long long)(row0 + r) * stride + c0 + c : src,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * kW; i += kAnyThreads) {
      const int r = i / kW, c = i % kW;
      const bool valid = row0 + r < n_rows && c0 + c < n_cols;
      dst[r * LD + c] = valid ? src[(long long)(row0 + r) * stride + c0 + c] : T(0.f);
    }
  }
}

// s += F W^T over the first `ncols` columns of one slab (the rest are 0):
// f points at the warp's first of 16 rows, w at the 64 rows of the walked
// slab; accumulator tile j holds its rows 8 j ..
template <typename T>
__device__ __forceinline__ void slab_scores(const T* f, const T* w, int ncols, float s[8][4]) {
  constexpr int LD = Slab<T>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
    const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk) {
      if (16 * kk >= ncols) break;
      uint32_t a[4];
      ldsm_x4(a, f + ar * LD + 16 * kk + ac);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, w + (16 * jp + br) * LD + 16 * kk + bc);
        mma_bf16(s[2 * jp], a, r[0], r[1]);
        mma_bf16(s[2 * jp + 1], a, r[2], r[3]);
      }
    }
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kW / 8; ++kk) {
      if (8 * kk >= ncols) break;
      const float* p = f + g * LD + 8 * kk + t;
      const float av[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(av[i], ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* pw = w + (8 * j + g) * LD + 8 * kk + t;
        uint32_t bb0, bs0, bb1, bs1;
        split(pw[0], bb0, bs0);
        split(pw[4], bb1, bs1);
        mma_3xtf32(s[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// acc[0 .. N) += X W over columns c0 .. c0 + 8 N of a walked slab, the
// tiles at or past `ncols` (counted from c0) left out: X the warp's 16 x 64
// fragment (16 rows, the slab's 64 rows as the reduction).  f32: each tile's
// part accumulates from zero on the tensor cores over this slab's 64 rows
// only and joins acc with one f32 add; the permuted reduction (k slot t <->
// column 2t, k slot t + 4 <-> 2t + 1) is acc_product's.  bf16: X as hi + lo
// pairs (acc_product's).
template <typename T, int N>
__device__ __forceinline__ void acc_slab(float x[8][4], const T* w, int c0, int ncols,
                                         float (*acc)[4]) {
  constexpr int LD = Slab<T>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const int r = (lane & 7) + 8 * ((lane >> 3) & 1), c = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
      split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
      split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < N / 2; ++np) {
        if (16 * np >= ncols) break;
        uint32_t b[4];
        ldsm_x4_trans(b, w + (16 * kk + r) * LD + c0 + 16 * np + c);
        mma_bf16(acc[2 * np], lo, b[0], b[1]);
        mma_bf16(acc[2 * np], hi, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
        mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      }
    }
  } else if constexpr (N <= 4) {
    // dQ's halves: the N tiles' parts fit beside acc and each split of X
    // serves all N (one tile at a time spilled here)
    float part[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ab[4], as[4];
      split(x[kk][0], ab[0], as[0]);
      split(x[kk][2], ab[1], as[1]);
      split(x[kk][1], ab[2], as[2]);
      split(x[kk][3], ab[3], as[3]);
      const float* p = w + (8 * kk + 2 * t) * LD + c0 + g;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        if (8 * n >= ncols) break;
        uint32_t bb0, bs0, bb1, bs1;
        split(p[8 * n], bb0, bs0);
        split(p[LD + 8 * n], bb1, bs1);
        mma_3xtf32(part[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  } else {
    // dK / dV: one tile's part at a time beside the 96 accumulators
    // (halves of 4 tiles ran 10 % slower)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (8 * n >= ncols) break;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ab[4], as[4];
        split(x[kk][0], ab[0], as[0]);
        split(x[kk][2], ab[1], as[1]);
        split(x[kk][1], ab[2], as[2]);
        split(x[kk][3], ab[3], as[3]);
        const float* p = w + (8 * kk + 2 * t) * LD + c0 + g + 8 * n;
        uint32_t bb0, bs0, bb1, bs1;
        split(p[0], bb0, bs0);
        split(p[LD], bb1, bs1);
        mma_3xtf32(part, ab, as, bb0, bb1, bs0, bs1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

// a warp's 16 x 64 fragment through an exchange tile ([8][128] float4:
// fragment j of thread i of a side at j * 128 + i)
__device__ __forceinline__ void put(float4* ex, int i, const float x[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) ex[j * kThreads + i] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
}
__device__ __forceinline__ void take(const float4* ex, int i, float x[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = ex[j * kThreads + i];
    x[j][0] = v.x;
    x[j][1] = v.y;
    x[j][2] = v.z;
    x[j][3] = v.w;
  }
}

// Block (key tile; column group, kv head, batch) of the 1-D grid, longest
// key tiles first: dK columns c0 .. c0 + 191 into dk (B, Sk, KH, D) and dV
// columns c0 .. into dv (B, Sk, KH, Dv), those below their widths.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kAnyThreads, 1)
flash_bwd_dkdv_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dO, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   Shape a, int Dv, int groups, int B) {
  using Sl = Slab<T>;
  constexpr int LD = Sl::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // [stage][K | Q | V | dO][64][LD]
  float4* ex = reinterpret_cast<float4*>(smem_raw + Sl::kRingBytes);   // P^T

  int kt, rest;
  tile_of_block((a.Sk + kBK - 1) / kBK, groups * a.KH * B, false, kt, rest);
  const int grp = rest % groups, kh = rest / groups % a.KH, b = rest / groups / a.KH;
  const int k0 = kt * kBK, c0 = grp * kAccCols;
  const int G = a.H / a.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, side = warp >> 2, wq = warp & 3;
  const long long q_stride = (long long)a.H * a.D, o_stride = (long long)a.H * Dv;
  const long long k_stride = (long long)a.KH * a.D, v_stride = (long long)a.KH * Dv;
  const long long kv = (long long)b * a.Sk * a.KH + kh;
  const T* kb = k + kv * a.D;
  const T* vb = v + kv * Dv;

  // the query tiles that can see a key of this tile (flash_bwd_dkdv's)
  int qt_lo = 0, qt_hi = (a.Sq + kBQ - 1) / kBQ;
  if (a.q_offset >= 0) {
    if (a.causal) qt_lo = max(0, (k0 - a.q_offset) / kBQ);
    if (a.window > 0) {
      const int q_last = k0 + kBK - 1 + a.window - 1 - a.q_offset;
      qt_hi = q_last < 0 ? 0 : min(qt_hi, q_last / kBQ + 1);
    }
  }
  const int nq = max(0, qt_hi - qt_lo), n_it = G * nq;
  const int nd = (a.D + kW - 1) / kW, ndv = (Dv + kW - 1) / kW;
  const int wk = min(kAccCols, a.D - c0), wv = min(kAccCols, Dv - c0);   // the group's widths
  const int nj = (wk + kW - 1) / kW;   // accumulation steps (Dv <= D: dV needs no more)
  const int per_it = nd + nj, n_steps = n_it * per_it;

  // step i: iteration i / per_it (head kh G + it / nq, query tile qt_lo +
  // it % nq); sub-steps: nd slabs of K, Q, V and dO (V and dO while below
  // Dv), then the group's slabs of Q and dO
  auto stage = [&](int i) {
    if (i < n_steps) {
      const int it = i / per_it, sub = i % per_it;
      const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kBQ;
      const long long row = (long long)b * a.Sq * a.H + h;
      T* dst = ring + (i & 1) * Sl::kStage;
      const int col = sub < nd ? kW * sub : c0 + kW * (sub - nd);
      if (sub < nd) stage_slab<T, kVec>(dst, kb, k_stride, k0, a.Sk, col, a.D);
      stage_slab<T, kVec>(dst + Sl::kSlab, q + row * a.D, q_stride, q0, a.Sq, col, a.D);
      if (col < Dv) {
        if (sub < nd) stage_slab<T, kVec>(dst + 2 * Sl::kSlab, vb, v_stride, k0, a.Sk, col, Dv);
        stage_slab<T, kVec>(dst + 3 * Sl::kSlab, dO + row * Dv, o_stride, q0, a.Sq, col, Dv);
      }
    }
    cp_async_commit();
  };
  stage(0);

  float f[8][4];                // side 0: S^T, then P^T; side 1: dP^T, then dS^T
  float acc[kAccTiles][4];      // side 0: dV, side 1: dK
  zero(acc);
  const int key_w = k0 + 16 * wq;   // the warp's first key
  int step = 0;
  for (int it = 0; it < n_it; ++it) {
    const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kBQ;
    bool live = key_w < a.Sk;
    if (a.q_offset >= 0 && live) {   // no keyless rows: masked pairs add nothing
      const int qpos_first = q0 + a.q_offset;
      const int qpos_last = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
      if (a.causal && key_w > qpos_last) live = false;
      if (a.window > 0 && qpos_first - (key_w + 15) >= a.window) live = false;
    }
    zero(f);
    for (int c = 0; c < nd; ++c, ++step) {
      cp_async_wait<0>();
      __syncthreads();
      stage(step + 1);
      if (!live) continue;
      const T* t0 = ring + (step & 1) * Sl::kStage;
      if (side == 0)   // S^T = K_w Q^T: 16 keys x 64 queries
        slab_scores<T>(t0 + 16 * wq * LD, t0 + Sl::kSlab, a.D - kW * c, f);
      else if (c < ndv)   // dP^T = V_w dO^T
        slab_scores<T>(t0 + 2 * Sl::kSlab + 16 * wq * LD, t0 + 3 * Sl::kSlab, Dv - kW * c, f);
    }
    const bool clear = clear_tile(a, q0, k0);
    const long long lrow = ((long long)b * a.H + h) * a.Sq;
    if (live && side == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          const float lq = qi < a.Sq ? __ldg(lse + lrow + qi) : 0.f;
          f[j][e] = p_of(a, clear, qi, key_w + g + 8 * (e >> 1), lq, f[j][e]);
        }
      put(ex, 32 * wq + lane, f);
    }
#pragma unroll
    for (int jj = 0; jj < kAccSlabs; ++jj) {
      if (jj >= nj) break;
      cp_async_wait<0>();
      __syncthreads();
      stage(step + 1);
      if (live) {
        if (side == 1 && jj == 0) {   // dS^T from side 0's P^T
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 p4 = ex[j * kThreads + 32 * wq + lane];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = q0 + 8 * j + 2 * t + (e & 1);
              const float dl = qi < a.Sq ? __ldg(delta + lrow + qi) : 0.f;
              f[j][e] = ds_of(a, clear, qi, key_w + g + 8 * (e >> 1), p[e], dl, f[j][e]);
            }
          }
        }
        const int ncols = (side == 0 ? wv : wk) - kW * jj;
        const T* w = ring + (step & 1) * Sl::kStage + (side == 0 ? 3 : 1) * Sl::kSlab;
        if (ncols > 0)   // dV += P^T dO, dK += dS^T Q
          acc_slab<T, 8>(f, w, 0, ncols, acc + 8 * jj);
      }
      ++step;
    }
  }

  if (side == 0 && wv > 0)
    store_rows<T, kAccCols, kVec>(dv + kv * Dv + c0, v_stride, key_w, a.Sk, wv, acc);
  if (side == 1)
    store_rows<T, kAccCols, kVec>(dk + kv * a.D + c0, k_stride, key_w, a.Sk, wk, acc);
}

// Block (query tile; column group, head, batch) of the 1-D grid, longest
// query tiles first under a causal mask: dQ of the tile's rows, columns
// c0 .. c0 + 255 (those below D); side s takes columns 32 s .. 32 s + 31 of
// each 64-column slab.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kAnyThreads, 1)
flash_bwd_dq_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dO, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Shape a, int Dv,
                 int groups, int B) {
  using Sl = Slab<T>;
  constexpr int LD = Sl::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // [stage][Q | K | dO | V][64][LD]
  float4* ex_p = reinterpret_cast<float4*>(smem_raw + Sl::kRingBytes);   // P
  float4* ex_s = ex_p + 8 * kThreads;                                     // dS

  int qt, rest;
  tile_of_block((a.Sq + kBQ - 1) / kBQ, groups * a.H * B, a.causal != 0, qt, rest);
  const int grp = rest % groups, h = rest / groups % a.H, b = rest / groups / a.H;
  const int q0 = qt * kBQ, c0 = grp * kQCols;
  const int kh = h / (a.H / a.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, side = warp >> 2, wq = warp & 3;
  const long long q_stride = (long long)a.H * a.D, o_stride = (long long)a.H * Dv;
  const long long k_stride = (long long)a.KH * a.D, v_stride = (long long)a.KH * Dv;
  const long long row = (long long)b * a.Sq * a.H + h;
  const T* kb = k + ((long long)b * a.Sk * a.KH + kh) * a.D;
  const T* vb = v + ((long long)b * a.Sk * a.KH + kh) * Dv;

  int kt_lo = 0, kt_hi = (a.Sk + kBK - 1) / kBK;
  if (a.q_offset >= 0) {
    const int q_first = q0 + a.q_offset;
    const int q_last = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
    if (a.causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (a.window > 0) kt_lo = max(0, (q_first - a.window + 1) / kBK);
  }
  const int nd = (a.D + kW - 1) / kW, ndv = (Dv + kW - 1) / kW;
  const int wq_cols = min(kQCols, a.D - c0), nj = (wq_cols + kW - 1) / kW;
  const int per_it = nd + nj, n_steps = max(0, kt_hi - kt_lo) * per_it;

  // step i: key tile kt_lo + i / per_it; sub-steps: nd slabs of Q, K, dO
  // and V (dO and V while below Dv), then the group's slabs of K
  auto stage = [&](int i) {
    if (i < n_steps) {
      const int k0 = (kt_lo + i / per_it) * kBK, sub = i % per_it;
      T* dst = ring + (i & 1) * Sl::kStage;
      if (sub < nd) {
        stage_slab<T, kVec>(dst, q + row * a.D, q_stride, q0, a.Sq, kW * sub, a.D);
        stage_slab<T, kVec>(dst + Sl::kSlab, kb, k_stride, k0, a.Sk, kW * sub, a.D);
        if (sub < ndv) {
          stage_slab<T, kVec>(dst + 2 * Sl::kSlab, dO + row * Dv, o_stride, q0, a.Sq, kW * sub,
                              Dv);
          stage_slab<T, kVec>(dst + 3 * Sl::kSlab, vb, v_stride, k0, a.Sk, kW * sub, Dv);
        }
      } else {
        stage_slab<T, kVec>(dst + Sl::kSlab, kb, k_stride, k0, a.Sk, c0 + kW * (sub - nd), a.D);
      }
    }
    cp_async_commit();
  };
  stage(0);

  // lse and Delta of the thread's rows g and g + 8 of the warp
  const int row_w = q0 + 16 * wq;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_w + g + 8 * r;
    const long long i = ((long long)b * a.H + h) * a.Sq + qi;
    lr[r] = qi < a.Sq ? lse[i] : 0.f;
    dr[r] = qi < a.Sq ? delta[i] : 0.f;
  }

  float f[8][4];                  // side 0: S, P, then dS; side 1: dP, then dS
  float acc[kQSlabs * 4][4];      // 4 tiles of each slab
  zero(acc);
  int step = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    bool live = row_w < a.Sq;
    if (a.q_offset >= 0 && live) {
      const int qpos_first = row_w + a.q_offset;
      const int qpos_last = min(row_w + 16, a.Sq) - 1 + a.q_offset;
      if (a.causal && k0 > qpos_last) live = false;
      if (a.window > 0 && qpos_first - (k0 + kBK - 1) >= a.window) live = false;
    }
    zero(f);
    for (int c = 0; c < nd; ++c, ++step) {
      cp_async_wait<0>();
      __syncthreads();
      stage(step + 1);
      if (!live) continue;
      const T* t0 = ring + (step & 1) * Sl::kStage;
      if (side == 0)   // S = Q_w K^T: 16 rows x 64 keys
        slab_scores<T>(t0 + 16 * wq * LD, t0 + Sl::kSlab, a.D - kW * c, f);
      else if (c < ndv)   // dP = dO_w V^T
        slab_scores<T>(t0 + 2 * Sl::kSlab + 16 * wq * LD, t0 + 3 * Sl::kSlab, Dv - kW * c, f);
    }
    const bool clear = clear_tile(a, q0, k0);
    if (live && side == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          f[j][e] = p_of(a, clear, row_w + g + 8 * r, k0 + 8 * j + 2 * t + (e & 1), lr[r],
                         f[j][e]);
        }
      put(ex_p, 32 * wq + lane, f);
    }
#pragma unroll
    for (int jj = 0; jj < kQSlabs; ++jj) {
      if (jj >= nj) break;
      cp_async_wait<0>();
      __syncthreads();
      stage(step + 1);
      if (jj == 0) {   // dS on side 1 from side 0's P, then back to side 0
        if (live && side == 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 p4 = ex_p[j * kThreads + 32 * wq + lane];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              f[j][e] = ds_of(a, clear, row_w + g + 8 * r, k0 + 8 * j + 2 * t + (e & 1), p[e],
                              dr[r], f[j][e]);
            }
          }
          put(ex_s, 32 * wq + lane, f);
        }
        __syncthreads();
        if (live && side == 0) take(ex_s, 32 * wq + lane, f);
      }
      const int ncols = wq_cols - kW * jj - 32 * side;
      if (live && ncols > 0)   // dQ += dS K
        acc_slab<T, 4>(f, ring + (step & 1) * Sl::kStage + Sl::kSlab, 32 * side, ncols,
                       acc + 4 * jj);
      ++step;
    }
  }

  // tile 4 jj + n holds columns c0 + 64 jj + 32 side + 8 n .. of the rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_w + g + 8 * r;
    if (qi >= a.Sq) continue;
    T* p = dq + row * a.D + (long long)qi * q_stride;
#pragma unroll
    for (int i = 0; i < kQSlabs * 4; ++i) {
      const int col = c0 + kW * (i / 4) + 32 * side + 8 * (i % 4) + 2 * t;
      if constexpr (kVec) {   // D even: a pair is in or out
        if (col < a.D) store2(p + col, acc[i][2 * r], acc[i][2 * r + 1]);
      } else {
        if (col < a.D) store(p + col, acc[i][2 * r]);
        if (col + 1 < a.D) store(p + col + 1, acc[i][2 * r + 1]);
      }
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch_any(const void* q, const void* k, const void* v, const void* dO,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       const Shape& a, int Dv, cudaStream_t stream) {
  constexpr size_t smem = Slab<T>::kSmem;
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  static bool raised = false;
  cudaError_t e;
  if (!raised) {
    if ((e = raise_smem(flash_bwd_dkdv_any<T, kVec>, smem)) != cudaSuccess) return e;
    if ((e = raise_smem(flash_bwd_dq_any<T, kVec>, smem)) != cudaSuccess) return e;
    raised = true;
  }
  const int g_kv = (a.D + kAccCols - 1) / kAccCols, g_q = (a.D + kQCols - 1) / kQCols;
  const long long x_kv = (long long)((a.Sk + kBK - 1) / kBK) * g_kv * a.KH * B;
  const long long x_q = (long long)((a.Sq + kBQ - 1) / kBQ) * g_q * a.H * B;
  if (x_kv > 2147483647LL || x_q > 2147483647LL) return cudaErrorInvalidValue;
  e = PLAN_LAUNCH("flash_bwd_dkdv_any", flash_bwd_dkdv_any<T, kVec>, dim3((unsigned)x_kv),
                  dim3(kAnyThreads), smem, stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dO),
                  lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a, Dv, g_kv, B);
  if (e != cudaSuccess) return e;
  return PLAN_LAUNCH("flash_bwd_dq_any", flash_bwd_dq_any<T, kVec>, dim3((unsigned)x_q),
                     dim3(kAnyThreads), smem, stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const T*>(dO), lse, delta, static_cast<T*>(dq), a, Dv, g_q, B);
}

template <typename T>
int run_any(const void* q, const void* k, const void* v, const void* o, const void* dO,
            const float* lse, float* delta, void* dq, void* dk, void* dv, int B, const Shape& a,
            int Dv, cudaStream_t s) {
  const cudaError_t e = launch_delta<T>(o, dO, delta, B, a.Sq, a.H, Dv, s);
  if (e != cudaSuccess) return (int)e;
  const int elem = sizeof(T);
  const bool vec = (a.D * elem) % 16 == 0 && (Dv * elem) % 16 == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(dO) && aligned16(dq) &&
                   aligned16(dk) && aligned16(dv);
  if (vec) return (int)launch_any<T, true>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, Dv, s);
  return (int)launch_any<T, false>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, Dv, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk and dv share it).
// All contiguous: q and dq (B, Sq, H, D); o and dO (B, Sq, H, Dv); k and dk
// (B, Sk, KH, D); v and dv (B, Sk, KH, Dv), any 1 <= Dv <= D; lse (the
// forward's, natural log) and the scratch delta (B, H, Sq) f32.  Launches
// three kernels (Delta, dK/dV, dQ) and returns the first error.
extern "C" int flash_attention_bwd_any(const void* q, const void* k, const void* v,
                                       const void* o, const void* dO, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int dtype,
                                       int B, int Sq, int Sk, int H, int KH, int D, int Dv,
                                       int causal, int window, float scale, void* stream) {
  if (D < 1 || Dv < 1 || Dv > D || KH < 1 || H % KH != 0 || B < 1 || Sq < 1 || Sk < 1 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Shape a{Sq, Sk, H, KH, D, causal, window, Sk - Sq, scale, scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) return run_any<float>(q, k, v, o, dO, l, dl, dq, dk, dv, B, a, Dv, s);
  return run_any<__nv_bfloat16>(q, k, v, o, dO, l, dl, dq, dk, dv, B, a, Dv, s);
}

// Query entry (launch_plan.cuh): flash_attention_bwd_any's arguments with
// `plans` in place of the stream; records the three launches, launches
// nothing.
extern "C" int flash_attention_bwd_any_plan(const void* q, const void* k, const void* v,
                                            const void* o, const void* dO, const void* lse,
                                            void* delta, void* dq, void* dk, void* dv, int dtype,
                                            int B, int Sq, int Sk, int H, int KH, int D, int Dv,
                                            int causal, int window, float scale,
                                            long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_bwd_any(q, k, v, o, dO, lse, delta, dq, dk, dv, dtype, B, Sq, Sk, H, KH,
                                 D, Dv, causal, window, scale, nullptr);
}
