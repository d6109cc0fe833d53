// Flash attention backward above head dim 128 for Hopper (sm_90a) on the
// tensor cores, bf16, plain C interface.
//
// Replaces JAX's autodiff of src/repro/models/layers.py:86 blocked_attention
// at the two head-dim pairs above 128 that the repository's models train
// at: pixtral-12b (q, k and v of 160; 32 heads over 8) and deepseek-v2's
// MLA (q and k of 192 = 128 nope + 64 rope, v of 128; 128 heads).  The
// contract is flash_attention_bwd.cu's (whose helpers this file includes):
// the same P, dV, dP, Delta, dS, dQ and dK, causal and window masks, GQA
// summed inside the block, ragged Sq and Sk, keyless rows, deterministic
// (no atomics), with a v head dim Dv <= D: dV, dO and o have Dv columns,
// dQ and dK have D.  bf16 with 16-byte rows and pointers only; the
// forward that writes lse at these head dims is flash_attention_lse.cu's.
//
// Bound on an H100 SXM: the five products, 2 * B * H * (unmasked pairs) *
// (3 D + 2 Dv) operations, against the bytes of q, k, v, o, dO, dq, dk, dv
// moved once.  pixtral-12b's training shape (B 2, S 1088, 32 / 8 heads of
// 160, causal: 592,416 pairs a head) is 60.7 GFLOP, 0.0613 ms at 989
// TFLOP/s, against 111.7 MB, 0.0333 ms: the operations bound.  deepseek-v2's
// (B 4, S 512, 128 heads of 192 over 128, causal) is 111.9 GFLOP, 0.113 ms,
// against 671 MB, 0.200 ms: the bytes bound.
//
// What the design does about it (flash_attention_bwd.cu's walks, reshaped
// for the registers):
// - Registers.  flash_attention_bwd.cu's dK/dV walk keeps a warp's 16 keys
//   x D of dK and of dV in registers, D / 2 + D / 2 f32 a thread, beside the
//   16 x 64 S^T and dP^T fragments (64 more): 243 registers at D 128.  At
//   160, or 192 over 128, the accumulators alone are 160.  Here dV and dK
//   are two walks, two instantiations of flash_bwd_dkdv_wide (template flag
//   kGradK) launched one after the other: the dV walk forms S^T alone and
//   accumulates dV += P^T dO (Dv / 2 + 32 f32), the dK walk forms S^T and
//   dP^T and accumulates dK += dS^T Q (D / 2 + 64).  S^T = K Q^T is formed
//   twice: 2 D more operations a pair, +20 % at 160 and +23 % at 192 over
//   128.  Weighed against it: a 32-query walked tile, which halves S^T and
//   dP^T to 32 registers but keeps dK and dV both live (160 + 32, and the
//   addressing, at the 255 limit), and warp pairs that split dK and dV's
//   columns (P^T and dS^T through shared memory, a barrier between the
//   score and the accumulation products).  The two walks are the simple
//   one.  ptxas: the dV walk 182 registers at 160 (161 at 192 over 128),
//   the dK walk 240 (246), dQ 244 (255 and 100 B of spill stores at 192
//   over 128, the one instantiation that spills); 2, 1 and 1 blocks an SM.
// - dQ: flash_attention_bwd.cu's walk, with V and dO tiles of Dv columns:
//   D / 2 accumulators and the 64 of S and dP.
// - Shared rows padded by 16 bytes: LD = D + 8, LDV = Dv + 8 bf16.  Bytes
//   a block: the dK walk (K and V fixed, 2 stages of Q and dO, 1 KB of lse
//   and Delta) 130,048 at 160 (6 x 64 x 168 x 2 + 1,024) and at 192 over
//   128 (3 x 64 x (200 + 136) x 2 + 1,024); the dV walk (no V tile)
//   108,544 and 112,640; dQ (Q and dO fixed, 2 stages of K and V) 129,024
//   at both.
// - Delta = rowsum(dO * o) is flash_attention_bwd.cu's kernel over Dv.
// - Every instantiation of flash_attention_bwd.cu keeps its code: this is
//   a translation unit of its own (FLASH_BWD_WIDE), built beside it in
//   parallel, with its own entry point, flash_attention_bwd_wide.

#define FLASH_BWD_WIDE
#include "flash_attention_bwd.cu"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kDWide = 160;      // q, k and v at 160 (pixtral-12b)
constexpr int kDSplit = 192;     // q and k at 192 ...
constexpr int kDvSplit = 128;    // ... over v at 128 (deepseek-v2's MLA)

template <int DP, int DV>
struct Wide {
  static constexpr int LD = DP + kRowPad<bf16>;    // Q and K rows
  static constexpr int LDV = DV + kRowPad<bf16>;   // V and dO rows
  static constexpr int kTile = 64 * LD;
  static constexpr int kTileV = 64 * LDV;
};

// S = F1 W1^T over DP columns (rows of stride LD) and, kDP, dP = F2 W2^T
// over DV columns (stride LDV): the warp's 16 rows of the fixed tiles
// against the 64 rows of the walked ones; accumulator tile j holds columns
// 8 j .. 8 j + 7.
template <int DP, int DV, bool kDP>
__device__ __forceinline__ void scores_wide(const bf16* f1, const bf16* f2, const bf16* w1,
                                            const bf16* w2, float s[8][4], float dp[8][4]) {
  constexpr int LD = Wide<DP, DV>::LD, LDV = Wide<DP, DV>::LDV;
  const int lane = threadIdx.x & 31;
  // A: rows (lane & 7) + 8 ((lane >> 3) & 1), columns 8 (lane >> 4);
  // B (x4): rows 16 jp + (0..7 | 8..15) x columns (0..7 | 8..15)
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
  const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a1[4];
    ldsm_x4(a1, f1 + ar * LD + 16 * kk + ac);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      ldsm_x4(r, w1 + (16 * jp + br) * LD + 16 * kk + bc);
      mma_bf16(s[2 * jp], a1, r[0], r[1]);
      mma_bf16(s[2 * jp + 1], a1, r[2], r[3]);
    }
  }
  if constexpr (kDP) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t a2[4];
      ldsm_x4(a2, f2 + ar * LDV + 16 * kk + ac);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, w2 + (16 * jp + br) * LDV + 16 * kk + bc);
        mma_bf16(dp[2 * jp], a2, r[0], r[1]);
        mma_bf16(dp[2 * jp + 1], a2, r[2], r[3]);
      }
    }
  }
}

template <int DP, int DV, bool kGradK>
constexpr size_t dkdv_smem() {
  using W = Wide<DP, DV>;
  return sizeof(bf16) * (W::kTile + (kGradK ? W::kTileV : 0) +
                         kStages * (W::kTile + W::kTileV)) +
         sizeof(float) * kStages * 2 * kBQ;
}

template <int DP, int DV>
constexpr size_t dq_smem() {
  using W = Wide<DP, DV>;
  return sizeof(bf16) * (1 + kStages) * (W::kTile + W::kTileV);
}

// One block per (64-key tile, kv head, batch), warp w owning keys 16 w ..
// 16 w + 15, walking the group's heads and their query tiles as
// flash_bwd_dkdv does.  kGradK: dK += dS^T Q into dkv (B, Sk, KH, D);
// otherwise dV += P^T dO into dkv (B, Sk, KH, Dv).
template <int DP, int DV, bool kGradK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dkv, Shape a, int Dv) {
  using W = Wide<DP, DV>;
  constexpr int LD = W::LD, LDV = W::LDV;
  constexpr int kStage = W::kTile + W::kTileV;                    // Q then dO
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + W::kTile;                                        // the dK walk's alone
  bf16* ring = sV + (kGradK ? W::kTileV : 0);                      // [stage][Q, dO]
  float* rows = reinterpret_cast<float*>(ring + kStages * kStage);  // [stage][lse, Delta][64]

  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long q_stride = (long long)a.H * a.D, o_stride = (long long)a.H * Dv;
  const long long k_stride = (long long)a.KH * a.D, v_stride = (long long)a.KH * Dv;
  const long long k_off = ((long long)b * a.Sk * a.KH + kh) * a.D;
  const long long v_off = ((long long)b * a.Sk * a.KH + kh) * Dv;

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

  // step it: head kh G + it / nq, query tile qt_lo + it % nq, ring stage it % 2
  auto stage_q = [&](int it) {
    if (it < n_it) {
      const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kBQ;
      bf16* dst = ring + (it % kStages) * kStage;
      const long long row = (long long)b * a.Sq * a.H + h;
      stage_tile<bf16, DP, LD, true>(dst, q + row * a.D, q_stride, q0, a.Sq, a.D);
      stage_tile<bf16, DV, LDV, true>(dst + W::kTile, dO + row * Dv, o_stride, q0, a.Sq, Dv);
      if (threadIdx.x < kBQ) {
        const int i = threadIdx.x;
        const bool ok = q0 + i < a.Sq;
        const long long r = ((long long)b * a.H + h) * a.Sq + q0 + i;
        float* dst_r = rows + (it % kStages) * 2 * kBQ;
        cp_async4(dst_r + i, ok ? lse + r : lse, ok);
        if constexpr (kGradK) cp_async4(dst_r + kBQ + i, ok ? delta + r : delta, ok);
      }
    }
    cp_async_commit();
  };
  stage_tile<bf16, DP, LD, true>(sK, k + k_off, k_stride, k0, a.Sk, a.D);
  if constexpr (kGradK) stage_tile<bf16, DV, LDV, true>(sV, v + v_off, v_stride, k0, a.Sk, Dv);
  cp_async_commit();
  stage_q(0);

  constexpr int kN = (kGradK ? DP : DV) / 8;   // accumulator tiles: dK over D, dV over Dv
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int key_w = k0 + 16 * warp;     // the warp's first key
  for (int it = 0; it < n_it; ++it) {
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
    const bf16* tQ = ring + (it % kStages) * kStage;
    const bf16* tdO = tQ + W::kTile;
    const float* tL = rows + (it % kStages) * 2 * kBQ;
    const float* tD = tL + kBQ;

    // S^T = K_w Q^T (and dP^T = V_w dO^T): 16 keys x 64 queries
    float s[8][4], dp[8][4];
    scores_wide<DP, DV, kGradK>(sK + 16 * warp * LD, sV + 16 * warp * LDV, tQ, tdO, s, dp);
    const bool clear = clear_tile(a, q0, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * t + (e & 1);           // query of the tile
        const int kj = key_w + g + 8 * (e >> 1);
        if constexpr (kGradK) {
          p_ds(a, clear, q0 + i, kj, tL[i], tD[i], s[j][e], dp[j][e]);
        } else {
          float unused = 0.f;
          p_ds(a, clear, q0 + i, kj, tL[i], 0.f, s[j][e], unused);
        }
      }
    if constexpr (kGradK)
      acc_product<bf16, DP, LD>(dp, tQ, acc);       // dK += dS^T Q
    else
      acc_product<bf16, DV, LDV>(s, tdO, acc);      // dV += P^T dO
  }

  if constexpr (kGradK)
    store_rows<bf16, DP, true>(dkv + k_off, k_stride, key_w, a.Sk, a.D, acc);
  else
    store_rows<bf16, DV, true>(dkv + v_off, v_stride, key_w, a.Sk, Dv, acc);
}

// One block per (64-query tile, head, batch), warp w owning 16 query rows,
// walking the key tiles the mask leaves as flash_bwd_dq does; V and dO
// tiles have Dv columns.
template <int DP, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dO,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, Shape a, int Dv) {
  using W = Wide<DP, DV>;
  constexpr int LD = W::LD, LDV = W::LDV;
  constexpr int kStage = W::kTile + W::kTileV;                    // K then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + W::kTile;
  bf16* ring = sdO + W::kTileV;                                    // [stage][K, V]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long q_stride = (long long)a.H * a.D, o_stride = (long long)a.H * Dv;
  const long long k_stride = (long long)a.KH * a.D, v_stride = (long long)a.KH * Dv;
  const long long row = (long long)b * a.Sq * a.H + h;
  const long long key = (long long)b * a.Sk * a.KH + kh;

  int kt_lo = 0, kt_hi = (a.Sk + kBK - 1) / kBK;
  if (a.q_offset >= 0) {
    const int q_first = q0 + a.q_offset;
    const int q_last = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
    if (a.causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (a.window > 0) kt_lo = max(0, (q_first - a.window + 1) / kBK);
  }

  auto stage_kv = [&](int kt) {
    if (kt < kt_hi) {
      bf16* dst = ring + ((kt - kt_lo) % kStages) * kStage;
      stage_tile<bf16, DP, LD, true>(dst, k + key * a.D, k_stride, kt * kBK, a.Sk, a.D);
      stage_tile<bf16, DV, LDV, true>(dst + W::kTile, v + key * Dv, v_stride, kt * kBK, a.Sk,
                                      Dv);
    }
    cp_async_commit();
  };
  stage_tile<bf16, DP, LD, true>(sQ, q + row * a.D, q_stride, q0, a.Sq, a.D);
  stage_tile<bf16, DV, LDV, true>(sdO, dO + row * Dv, o_stride, q0, a.Sq, Dv);
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
    const bf16* tK = ring + ((kt - kt_lo) % kStages) * kStage;
    const bf16* tV = tK + W::kTile;

    // S = Q_w K^T and dP = dO_w V^T: 16 rows x 64 keys
    float s[8][4], dp[8][4];
    scores_wide<DP, DV, true>(sQ + 16 * warp * LD, sdO + 16 * warp * LDV, tK, tV, s, dp);
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
    acc_product<bf16, DP, LD>(dp, tK, acc);
  }

  store_rows<bf16, DP, true>(dq + row * a.D, q_stride, row_w, a.Sq, a.D, acc);
}

template <int DP, int DV, bool kGradK>
cudaError_t launch_dkdv_wide(const void* q, const void* k, const void* v, const void* dO,
                             const float* lse, const float* delta, void* dkv, int B,
                             const Shape& a, int Dv, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem<DP, DV, kGradK>();
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = raise_smem(flash_bwd_dkdv_wide<DP, DV, kGradK>, smem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid((a.Sk + kBK - 1) / kBK, a.KH, B);
  return PLAN_LAUNCH(kGradK ? "flash_bwd_dkdv_wide (dK)" : "flash_bwd_dkdv_wide (dV)",
                     flash_bwd_dkdv_wide<DP, DV, kGradK>, grid, dim3(kThreads), smem, stream,
                     static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
                     static_cast<bf16*>(dkv), a, Dv);
}

template <int DP, int DV>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* o,
                        const void* dO, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, const Shape& a, int Dv, cudaStream_t s) {
  cudaError_t e = launch_delta<bf16>(o, dO, delta, B, a.Sq, a.H, Dv, s);
  if (e == cudaSuccess)
    e = launch_dkdv_wide<DP, DV, false>(q, k, v, dO, lse, delta, dv, B, a, Dv, s);
  if (e == cudaSuccess)
    e = launch_dkdv_wide<DP, DV, true>(q, k, v, dO, lse, delta, dk, B, a, Dv, s);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = dq_smem<DP, DV>();
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  static bool raised = false;
  if (!raised) {
    if ((e = raise_smem(flash_bwd_dq_wide<DP, DV>, smem)) != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  return PLAN_LAUNCH("flash_bwd_dq_wide", flash_bwd_dq_wide<DP, DV>, grid, dim3(kThreads), smem,
                     s, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
                     static_cast<bf16*>(dq), a, Dv);
}

}  // namespace

// bf16 (dtype 1) only.  All contiguous: q and dq (B, Sq, H, D); o and dO
// (B, Sq, H, Dv); k and dk (B, Sk, KH, D); v and dv (B, Sk, KH, Dv); lse
// (the forward's, natural log) and the scratch delta (B, H, Sq) f32.
// 128 < D, D and Dv multiples of 8, 16-byte aligned pointers; Dv == D <=
// 160, or D <= 192 over Dv <= 128.  Launches four kernels (Delta, dV, dK,
// dQ) and returns the first error.
extern "C" int flash_attention_bwd_wide(const void* q, const void* k, const void* v,
                                        const void* o, const void* dO, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int dtype,
                                        int B, int Sq, int Sk, int H, int KH, int D, int Dv,
                                        int causal, int window, float scale, void* stream) {
  if (dtype != 1 || D <= kDMax || D % 8 != 0 || Dv < 8 || Dv % 8 != 0 || Dv > D || KH < 1 ||
      H % KH != 0 || B < 1 || Sq < 1 || Sk < 1 || B > 65535 || H > 65535 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dO) || !aligned16(dq) || !aligned16(dk) ||
      !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  const Shape a{Sq, Sk, H, KH, D, causal, window, Sk - Sq, scale, scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (Dv == D && D <= kDWide)
    return (int)launch_wide<kDWide, kDWide>(q, k, v, o, dO, l, dl, dq, dk, dv, B, a, Dv, s);
  if (D <= kDSplit && Dv <= kDvSplit)
    return (int)launch_wide<kDSplit, kDvSplit>(q, k, v, o, dO, l, dl, dq, dk, dv, B, a, Dv, s);
  return (int)cudaErrorInvalidValue;
}

// Query entry (launch_plan.cuh): flash_attention_bwd_wide's arguments with
// `plans` in place of the stream; records the four launches, launches
// nothing.
extern "C" int flash_attention_bwd_wide_plan(const void* q, const void* k, const void* v,
                                             const void* o, const void* dO, const void* lse,
                                             void* delta, void* dq, void* dk, void* dv,
                                             int dtype, int B, int Sq, int Sk, int H, int KH,
                                             int D, int Dv, int causal, int window, float scale,
                                             long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_bwd_wide(q, k, v, o, dO, lse, delta, dq, dk, dv, dtype, B, Sq, Sk, H,
                                  KH, D, Dv, causal, window, scale, nullptr);
}
