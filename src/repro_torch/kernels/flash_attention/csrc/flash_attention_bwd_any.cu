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
// What the design does about it: flash_attention_bwd.cu's walks with no
// full-D tile resident, as the forward of flash_attention_any.cu.
// - flash_bwd_dkdv_any, two walks (template flag kGradK, launched one
//   after the other, as flash_attention_bwd_wide.cu does): one block of 4
//   warps per (64-key tile, 64-column group, kv head, batch), warp w owning
//   keys 16 w .. 16 w + 15, walking the group's heads and the query tiles
//   the mask leaves.  A step of the 2-stage cp.async ring stages two 64 x
//   64 slabs: S^T = K Q^T forms over D in slabs (K and Q), and in the dK
//   walk dP^T = V dO^T over Dv (V and dO); then the group's slab of dO
//   feeds dV[:, group] += P^T dO, or that of Q dK[:, group] += dS^T Q.  A
//   walk holds one accumulator of 64 columns (32 f32 a thread) beside S^T
//   and dP^T, whatever D: the dQ spill of flash_attention_bwd_wide.cu at
//   192 over 128 (255 registers, 100 B) cannot recur, and one walk holding
//   both dK and dV took 255 registers and spilled 12 B in f32 with acc_tile
//   below.  A width above 64 is more groups on the grid, each forming S^T
//   anew: ceil(Dv / 64) + ceil(D / 64) times for the two walks.
// - flash_bwd_dq_any: one block per (64-query tile, 64-column group of D,
//   head, batch): S over D and dP over Dv slab by slab, then the group's K
//   slab feeds dQ[:, group] += dS K.
// - Delta = rowsum(dO * o) is flash_attention_bwd.cu's kernel over Dv.
// - lse and Delta come from device memory (L1) in the P / dS pass, not
//   through the ring.
// - bf16: mma.sync m16n8k16, P and dS as bf16 hi + lo pairs (the other
//   backwards' rounding); f32: 3xTF32 on m16n8k8, P and dS included, each
//   walked tile's part of dK, dV and dQ formed from zero and added to the
//   accumulator in f32 (acc_tile: the tensor cores' own accumulation over
//   thousands of rows rounded 13x worse than the plain version).
//   Shared memory: 2 stages x 2 slabs x 64 x (64 + pad): 69,632 bytes in
//   f32, 36,864 in bf16.  ptxas's registers and spills: PERF.md §6.
// Every instantiation of flash_attention_bwd.cu, flash_attention_bwd_f32.cu
// and flash_attention_bwd_wide.cu keeps its code: a translation unit of its
// own with its own entry point, flash_attention_bwd_any.

// flash_attention_bwd.cu's helpers, without its entry points
#define FLASH_BWD_WIDE
#include "flash_attention_bwd.cu"

namespace {

constexpr int kW = 64;   // head-dim columns a slab, and a group of dQ, dK, dV

template <typename T>
struct Slab {
  static constexpr int LD = kW + kRowPad<T>;    // shared row stride, elements
  static constexpr int kSlab = 64 * LD;
  static constexpr int kStage = 2 * kSlab;
  static constexpr size_t kSmem = sizeof(T) * 2 * kStage;
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
    constexpr int kStep = kThreads / kChunks;
    const int r0 = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * kE;
    const bool col_ok = c0 + c < n_cols;
    for (int r = r0; r < 64; r += kStep) {
      const bool valid = col_ok && row0 + r < n_rows;
      cp_async16(dst + r * LD + c, valid ? src + (long long)(row0 + r) * stride + c0 + c : src,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * kW; i += kThreads) {
      const int r = i / kW, c = i % kW;
      const bool valid = row0 + r < n_rows && c0 + c < n_cols;
      dst[r * LD + c] = valid ? src[(long long)(row0 + r) * stride + c0 + c] : T(0.f);
    }
  }
}

// s += F W^T over one slab: f points at the warp's first of 16 rows, w at
// the 64 rows of the walked slab; accumulator tile j holds its rows 8 j ..
template <typename T>
__device__ __forceinline__ void slab_scores(const T* f, const T* w, float s[8][4]) {
  constexpr int LD = Slab<T>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
    const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk) {
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
#pragma unroll
    for (int kk = 0; kk < kW / 8; ++kk) {
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

// acc += X W (acc_product's product: X the 16 x 64 accumulator tile, W the
// 64 rows of a walked slab, acc the group's 64 columns).  f32: each 8-column
// tile of X W accumulates from zero on the tensor cores, over this slab's
// 64 rows only, and joins acc with one f32 add.  A chain of mma.sync
// accumulations over every walked tile rounded dK and dV at pixtral's
// shape (4352 query rows of a GQA group) 13x past the plain f32 version
// (3.6e-4 against 2.8e-5 abs); the tensor cores' f32 accumulation does not
// round to nearest.
template <typename T>
__device__ __forceinline__ void acc_tile(float x[8][4], const T* w, float acc[8][4]) {
  constexpr int LD = Slab<T>::LD;
  if constexpr (sizeof(T) == 2) {
    acc_product<T, kW, LD>(x, w, acc);
  } else {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < kW / 8; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        // k slot t <-> column 2t, k slot t + 4 <-> 2t + 1 (acc_product's order)
        uint32_t ab[4], as[4];
        split(x[kk][0], ab[0], as[0]);
        split(x[kk][2], ab[1], as[1]);
        split(x[kk][1], ab[2], as[2]);
        split(x[kk][3], ab[3], as[3]);
        const float* p = w + (8 * kk + 2 * t) * LD + g + 8 * n;
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

// Block (key tile * groups + group, kv head, batch): one walk over the
// query tiles that see the key tile.  kGradK: dK += dS^T Q, forming S^T
// over D and dP^T over Dv, into dkv (B, Sk, KH, D); otherwise dV += P^T dO,
// forming S^T alone, into dkv (B, Sk, KH, Dv).  Columns 64 group .. 64
// group + 63 of the output (those below its width).
template <typename T, bool kVec, bool kGradK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dO, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dkv, Shape a, int Dv,
                   int groups) {
  using Sl = Slab<T>;
  constexpr int LD = Sl::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // [stage][2][64][LD]

  const int grp = blockIdx.x % groups, c0 = grp * kW;
  const int k0 = (blockIdx.x / groups) * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long q_stride = (long long)a.H * a.D, o_stride = (long long)a.H * Dv;
  const long long k_stride = (long long)a.KH * a.D, v_stride = (long long)a.KH * Dv;
  const T* kb = k + ((long long)b * a.Sk * a.KH + kh) * a.D;
  const T* vb = v + ((long long)b * a.Sk * a.KH + kh) * Dv;

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
  const int nd = (a.D + kW - 1) / kW, ndv = kGradK ? (Dv + kW - 1) / kW : 0;
  const int per_it = nd + ndv + 1, n_steps = n_it * per_it;

  // step i: iteration i / per_it (head kh G + it / nq, query tile qt_lo +
  // it % nq); sub-steps: nd slabs of K and Q, (kGradK) ndv of V and dO,
  // then the group's slab of Q (kGradK) or of dO
  auto stage = [&](int i) {
    if (i < n_steps) {
      const int it = i / per_it, sub = i % per_it;
      const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kBQ;
      const long long row = (long long)b * a.Sq * a.H + h;
      T* dst = ring + (i & 1) * Sl::kStage;
      if (sub < nd) {
        stage_slab<T, kVec>(dst, kb, k_stride, k0, a.Sk, kW * sub, a.D);
        stage_slab<T, kVec>(dst + Sl::kSlab, q + row * a.D, q_stride, q0, a.Sq, kW * sub, a.D);
      } else if (sub < nd + ndv) {
        const int j = sub - nd;
        stage_slab<T, kVec>(dst, vb, v_stride, k0, a.Sk, kW * j, Dv);
        stage_slab<T, kVec>(dst + Sl::kSlab, dO + row * Dv, o_stride, q0, a.Sq, kW * j, Dv);
      } else if (kGradK) {
        stage_slab<T, kVec>(dst, q + row * a.D, q_stride, q0, a.Sq, c0, a.D);
      } else {
        stage_slab<T, kVec>(dst, dO + row * Dv, o_stride, q0, a.Sq, c0, Dv);
      }
    }
    cp_async_commit();
  };
  stage(0);

  float acc[8][4];
  zero(acc);
  const int key_w = k0 + 16 * warp;   // the warp's first key
  int step = 0;
  for (int it = 0; it < n_it; ++it) {
    const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kBQ;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    for (int sub = 0; sub < nd + ndv; ++sub, ++step) {
      cp_async_wait<0>();
      __syncthreads();
      stage(step + 1);
      const T* t0 = ring + (step & 1) * Sl::kStage;
      // S^T = K_w Q^T, then (kGradK) dP^T = V_w dO^T: 16 keys x 64 queries
      if (sub < nd)
        slab_scores<T>(t0 + 16 * warp * LD, t0 + Sl::kSlab, s);
      else
        slab_scores<T>(t0 + 16 * warp * LD, t0 + Sl::kSlab, dp);
    }
    const bool clear = clear_tile(a, q0, k0);
    const long long lrow = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 8 * j + 2 * t + (e & 1);
        const float lq = qi < a.Sq ? __ldg(lse + lrow + qi) : 0.f;
        const float dl = kGradK && qi < a.Sq ? __ldg(delta + lrow + qi) : 0.f;
        p_ds(a, clear, qi, key_w + g + 8 * (e >> 1), lq, dl, s[j][e], dp[j][e]);
      }
    cp_async_wait<0>();
    __syncthreads();
    stage(step + 1);
    if constexpr (kGradK)
      acc_tile<T>(dp, ring + (step & 1) * Sl::kStage, acc);   // dK += dS^T Q
    else
      acc_tile<T>(s, ring + (step & 1) * Sl::kStage, acc);    // dV += P^T dO
    ++step;
  }

  const int width = kGradK ? a.D : Dv;
  if (c0 < width)
    store_rows<T, kW, kVec>(dkv + ((long long)b * a.Sk * a.KH + kh) * width + c0,
                            (long long)a.KH * width, key_w, a.Sk, width - c0, acc);
}

// Block (query tile * groups + group, head, batch): dQ of the tile's rows,
// columns 64 group .. 64 group + 63 (those below D).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dO, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Shape a, int Dv,
                 int groups) {
  using Sl = Slab<T>;
  constexpr int LD = Sl::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int grp = blockIdx.x % groups, c0 = grp * kW;
  const int q0 = (blockIdx.x / groups) * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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
  const int nd = (a.D + kW - 1) / kW, ndv = (Dv + kW - 1) / kW, per_it = nd + ndv + 1;
  const int n_steps = (kt_hi - kt_lo) * per_it;

  // step i: key tile kt_lo + i / per_it; sub-steps: nd slabs of Q and K,
  // ndv of dO and V, then the group's slab of K
  auto stage = [&](int i) {
    if (i < n_steps) {
      const int kt = kt_lo + i / per_it, sub = i % per_it;
      T* dst = ring + (i & 1) * Sl::kStage;
      if (sub < nd) {
        stage_slab<T, kVec>(dst, q + row * a.D, q_stride, q0, a.Sq, kW * sub, a.D);
        stage_slab<T, kVec>(dst + Sl::kSlab, kb, k_stride, kt * kBK, a.Sk, kW * sub, a.D);
      } else if (sub < nd + ndv) {
        const int j = sub - nd;
        stage_slab<T, kVec>(dst, dO + row * Dv, o_stride, q0, a.Sq, kW * j, Dv);
        stage_slab<T, kVec>(dst + Sl::kSlab, vb, v_stride, kt * kBK, a.Sk, kW * j, Dv);
      } else {
        stage_slab<T, kVec>(dst, kb, k_stride, kt * kBK, a.Sk, c0, a.D);
      }
    }
    cp_async_commit();
  };
  stage(0);

  // lse and Delta of the thread's rows g and g + 8 of the warp
  const int row_w = q0 + 16 * warp;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_w + g + 8 * r;
    const long long i = ((long long)b * a.H + h) * a.Sq + qi;
    lr[r] = qi < a.Sq ? lse[i] : 0.f;
    dr[r] = qi < a.Sq ? delta[i] : 0.f;
  }

  float acc[8][4];
  zero(acc);
  int step = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    for (int sub = 0; sub < nd + ndv; ++sub, ++step) {
      cp_async_wait<0>();
      __syncthreads();
      stage(step + 1);
      const T* t0 = ring + (step & 1) * Sl::kStage;
      // S = Q_w K^T, then dP = dO_w V^T: 16 rows x 64 keys
      if (sub < nd)
        slab_scores<T>(t0 + 16 * warp * LD, t0 + Sl::kSlab, s);
      else
        slab_scores<T>(t0 + 16 * warp * LD, t0 + Sl::kSlab, dp);
    }
    const int k0 = kt * kBK;
    const bool clear = clear_tile(a, q0, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        p_ds(a, clear, row_w + g + 8 * r, k0 + 8 * j + 2 * t + (e & 1), lr[r], dr[r], s[j][e],
             dp[j][e]);
      }
    cp_async_wait<0>();
    __syncthreads();
    stage(step + 1);
    acc_tile<T>(dp, ring + (step & 1) * Sl::kStage, acc);   // dQ += dS K
    ++step;
  }

  if (c0 < a.D)
    store_rows<T, kW, kVec>(dq + row * a.D + c0, q_stride, row_w, a.Sq, a.D - c0, acc);
}

template <typename T, bool kVec, bool kGradK>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dO,
                        const float* lse, const float* delta, void* dkv, int B, const Shape& a,
                        int Dv, cudaStream_t stream) {
  constexpr size_t smem = Slab<T>::kSmem;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = raise_smem(flash_bwd_dkdv_any<T, kVec, kGradK>, smem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const int groups = ((kGradK ? a.D : Dv) + kW - 1) / kW;
  const long long x = (long long)((a.Sk + kBK - 1) / kBK) * groups;
  if (x > 2147483647LL) return cudaErrorInvalidValue;
  return PLAN_LAUNCH(kGradK ? "flash_bwd_dkdv_any (dK)" : "flash_bwd_dkdv_any (dV)",
                     flash_bwd_dkdv_any<T, kVec, kGradK>, dim3((unsigned)x, a.KH, B),
                     dim3(kThreads), smem, stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const T*>(dO), lse, delta, static_cast<T*>(dkv), a, Dv,
                     groups);
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
    if ((e = raise_smem(flash_bwd_dq_any<T, kVec>, smem)) != cudaSuccess) return e;
    raised = true;
  }
  e = launch_dkdv<T, kVec, false>(q, k, v, dO, lse, delta, dv, B, a, Dv, stream);
  if (e == cudaSuccess)
    e = launch_dkdv<T, kVec, true>(q, k, v, dO, lse, delta, dk, B, a, Dv, stream);
  if (e != cudaSuccess) return e;
  const int g_q = (a.D + kW - 1) / kW;
  const long long x_q = (long long)((a.Sq + kBQ - 1) / kBQ) * g_q;
  if (x_q > 2147483647LL) return cudaErrorInvalidValue;
  return PLAN_LAUNCH("flash_bwd_dq_any", flash_bwd_dq_any<T, kVec>, dim3((unsigned)x_q, a.H, B),
                     dim3(kThreads), smem, stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v),
                     static_cast<const T*>(dO), lse, delta, static_cast<T*>(dq), a, Dv, g_q);
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
// four kernels (Delta, the dV walk, the dK walk, dQ) and returns the first
// error.
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
// `plans` in place of the stream; records the four launches, launches
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
