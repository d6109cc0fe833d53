// Flash attention forward at any head dim for Hopper (sm_90a) on the tensor
// cores, plain C interface: the head dims and layouts that no instantiation
// of flash_attention.cu takes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_pallas (body _fa_kernel) over the rest of its domain: the
// Pallas kernel takes whole-D blocks in any dtype, so any head dim D and any
// v head dim Dv <= D.  It computes what flash_attention.cu computes (online
// softmax with f32 running max, sum and accumulator; causal and sliding-
// window masks from absolute positions with q at the tail of k; GQA; ragged
// Sq and Sk; keys excluded by a mask score -1e30, keys past Sk -inf), for
// f32 and bf16, with or without each row's log-sum-exp (kLse: the training
// forward, read by flash_attention_bwd_any.cu and the other backwards).  The
// wrapper (ops.py `route`) sends here f32 above head dim 128, bf16 with Dv
// == D above 160, bf16 above 192 or with Dv above 128 under a wider D, and
// every head dim above 128 whose rows or pointers are not 16-byte aligned:
// pixtral-12b's 160 and deepseek-v2's MLA (192 over 128) in f32, the prompt
// encoder's 288, Gemma's 256, odd widths.
//
// Bound on an H100 SXM: 4 * B * H * (unmasked pairs) * D operations (2 D
// for Q K^T, 2 Dv for P V) against the bytes of q, k, v and o moved once.
// In f32 the products run as 3xTF32, 165 TFLOP/s of f32-accurate work: at
// pixtral-12b's training shape (B 2, S 1088, 32 / 8 heads of 160, causal)
// 24.2 GFLOP take 0.147 ms against 111 MB (0.033 ms), so the operations
// bound.  In bf16 the tensor cores (989 TFLOP/s) leave the bytes as the
// bound.
//
// What the design does about it.  No full-D tile is resident:
// - One block of 4 warps per (64-query tile, 64-column group of Dv, head,
//   batch); each warp owns 16 query rows.  The block walks the key tiles
//   the mask leaves.  For each key tile it forms S = Q K^T over D in
//   slabs of 64 columns (a step stages the Q slab and the K slab), then
//   O[:, group] += P V[:, group] (a step stages the V slab of the group).
//   Every step goes through a 2-stage cp.async ring (16-byte copies with
//   zero fill past Sq, Sk, D and Dv; element by element where rows or
//   pointers are not 16-byte aligned, template flag kVec = false): the next
//   step's copy overlaps this step's products, one barrier a step.
// - O's accumulator is one 64-column group: 32 f32 a thread beside S's 32,
//   for every D.  A Dv above 64 is more groups on the grid; each group's
//   block forms the same S with the same code, so m and l agree bitwise
//   across groups, and group 0 writes the lse.  Q K^T is formed once a
//   group: ceil(Dv / 64) times in all (pixtral's 160: 3, MLA's 128: 2, the
//   encoder's 288: 5), where a block holding every group would need 64 x Dv
//   f32 of O in shared memory (73.7 KB at 288) and Q re-staged regardless.
// - Tile sizes: 64 queries x 64 keys x 64 columns a slab.  Shared memory:
//   2 stages x 2 slabs x 64 x (64 + pad) elements, rows padded by 16 bytes
//   (LD 68 f32, 72 bf16) so that fragment loads and ldmatrix hit distinct
//   banks: 69,632 bytes in f32 (the opt-in above 48 KB), 36,864 in bf16.
//   Registers: S 32, O 32, the row state 4, and the operand fragments of
//   one k-step; ptxas's counts and spills are in PERF.md §6 and chip_smoke's
//   build log.
// - bf16: mma.sync m16n8k16 with ldmatrix (.trans for V); P is rounded to
//   bf16 before P V, as blocked_attention does.  f32: mma.sync m16n8k8 tf32
//   as 3xTF32 (every operand split into big + small), P included, with P V's
//   reduction axis permuted so that the accumulator fragment is the A
//   fragment (flash_attention.cu's f32 path).
// - exp2 on the special function unit (log2(e) folded into the scale).
// Every instantiation of flash_attention.cu and flash_attention_lse.cu keeps
// its code: this is a translation unit of its own with its own entry point.

// flash_attention.cu's helpers and constants, without its entry points
#define FLASH_ATTENTION_HELPERS_ONLY
#include "flash_attention.cu"

namespace {

constexpr int kW = 64;                // head-dim columns a slab, and an O group

template <typename T>
struct Tile {
  static constexpr int LD = kW + Traits<T>::kRowPad;     // shared row stride, elements
  static constexpr int kSlab = 64 * LD;                  // one 64-row slab
  static constexpr int kStage = 2 * kSlab;               // Q and K (or V alone)
  static constexpr size_t kSmem = sizeof(T) * 2 * kStage;
};

// Rows row0 .. row0 + 63, columns c0 .. c0 + 63 of a (rows, stride) slice
// into a shared slab of row stride LD; rows >= n_rows and columns >= n_cols
// become 0.  kVec: 16-byte cp.async (n_cols * sizeof(T) and c0 multiples of
// 16 bytes, src 16-byte aligned); otherwise element by element.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_slab(T* dst, const T* src, long long stride, int row0,
                                           int n_rows, int c0, int n_cols) {
  constexpr int LD = Tile<T>::LD;
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = kW / kE;
    constexpr int kStep = kThreads / kChunks;   // rows a pass; a thread keeps its column
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

// s += Q_w K^T over one 64-column slab: the warp's 16 rows of the Q slab
// against the 64 rows of the K slab; accumulator tile j holds keys 8 j ..
template <typename T>
__device__ __forceinline__ void qk_slab(const T* tQ, const T* tK, int w0, float s[8][4]) {
  constexpr int LD = Tile<T>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
    const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, tQ + (w0 + ar) * LD + 16 * kk + ac);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, tK + (16 * jp + br) * LD + 16 * kk + bc);
        mma_bf16(s[2 * jp], a, r[0], r[1]);
        mma_bf16(s[2 * jp + 1], a, r[2], r[3]);
      }
    }
  } else {
    const float* fQ = reinterpret_cast<const float*>(tQ);
    const float* fK = reinterpret_cast<const float*>(tK);
#pragma unroll
    for (int kk = 0; kk < kW / 8; ++kk) {
      const float* p = fQ + (w0 + g) * LD + 8 * kk + t;
      const float av[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(av[i], ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* pk = fK + (8 * j + g) * LD + 8 * kk + t;
        uint32_t bb0, bs0, bb1, bs1;
        split(pk[0], bb0, bs0);
        split(pk[4], bb1, bs1);
        mma_3xtf32(s[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// acc += P V over the 64 keys of the tile, for the group's 64 columns of V
template <typename T>
__device__ __forceinline__ void pv_slab(float s[8][4], const T* tV, float acc[8][4]) {
  constexpr int LD = Tile<T>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const int key = (lane & 7) + 8 * ((lane >> 3) & 1), c = 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kW / 16; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, tV + (16 * kk + key) * LD + 16 * np + c);
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
      for (int n = 0; n < kW / 8; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split(p[8 * n], bb0, bs0);
        split(p[LD + 8 * n], bb1, bs1);
        mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// Block (query tile * groups + group, head, batch).  lse (B, H, Sq) f32 is
// written by group 0 where kLse.
template <typename T, bool kVec, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KH, int D,
              int Dv, int causal, int window, float scale_log2, int q_offset, int groups) {
  using Tl = Tile<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);   // [stage][Q | V, K][64][LD]

  const int grp = blockIdx.x % groups;
  const int q0 = (blockIdx.x / groups) * kBQ, c0 = grp * kW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long q_stride = (long long)H * D, k_stride = (long long)KH * D;
  const long long v_stride = (long long)KH * Dv, o_stride = (long long)H * Dv;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * KH + kh) * D;
  const T* vb = v + ((long long)b * Sk * KH + kh) * Dv;

  int kt_lo = 0, kt_hi = (Sk + kBK - 1) / kBK;
  if (q_offset >= 0) {   // every row keeps its diagonal key
    const int q_first = q0 + q_offset;
    const int q_last = min(q0 + kBQ, Sq) - 1 + q_offset;
    if (causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (window > 0) kt_lo = max(0, (q_first - window + 1) / kBK);
  }
  const int nd = (D + kW - 1) / kW;          // Q K^T steps a key tile, then one P V step
  const int n_steps = (kt_hi - kt_lo) * (nd + 1);

  // step i: key tile kt_lo + i / (nd + 1); sub-step < nd stages the Q and K
  // slabs of columns 64 sub, sub-step nd the group's V slab; stage i % 2
  auto stage = [&](int i) {
    if (i < n_steps) {
      const int kt = kt_lo + i / (nd + 1), sub = i % (nd + 1);
      T* dst = ring + (i & 1) * Tl::kStage;
      if (sub < nd) {
        stage_slab<T, kVec>(dst, qb, q_stride, q0, Sq, kW * sub, D);
        stage_slab<T, kVec>(dst + Tl::kSlab, kb, k_stride, kt * kBK, Sk, kW * sub, D);
      } else {
        stage_slab<T, kVec>(dst, vb, v_stride, kt * kBK, Sk, c0, Dv);
      }
    }
    cp_async_commit();
  };
  stage(0);

  const int w0 = warp * 16;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, log2 domain
  float l[2] = {0.f, 0.f};                       // this thread's part of the row sum
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int wq_first = q0 + w0;
  const int wq_last = min(q0 + w0 + 15, Sq - 1);
  const int qpos_g = q0 + w0 + g + q_offset;     // positions of rows g, g + 8

  int step = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int sub = 0; sub < nd; ++sub, ++step) {
      // one barrier a step: it publishes this step's stage, and every warp
      // is past the previous step, whose stage the next copy reuses
      cp_async_wait<0>();
      __syncthreads();
      stage(step + 1);
      const T* tQ = ring + (step & 1) * Tl::kStage;
      qk_slab<T>(tQ, tQ + Tl::kSlab, w0, s);
    }

    // scale into the log2 domain; masks only where the tile straddles an edge
    const int k0 = kt * kBK;
    const bool clear = k0 + kBK <= Sk &&
                       (!causal || k0 + kBK - 1 <= wq_first + q_offset) &&
                       (window <= 0 || wq_last + q_offset - k0 < window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!clear) {
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
      float t8[8];
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
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    cp_async_wait<0>();
    __syncthreads();
    stage(step + 1);
    pv_slab<T>(s, ring + (step & 1) * Tl::kStage, acc);
    ++step;
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    inv[r] = lr > 0.f ? 1.f / lr : 0.f;
    if constexpr (kLse) {
      // a row whose keys are all masked (max kMasked) gets the reference's -1e30
      const int s = q0 + w0 + g + 8 * r;
      if (grp == 0 && t == 0 && s < Sq)
        lse[((long long)b * H + h) * Sq + s] =
            m[r] <= 0.5f * kMasked ? kMasked : (m[r] + __log2f(lr)) * kLn2;
    }
  }
  T* ob = o + ((long long)b * Sq * H + h) * Dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + w0 + g + 8 * r;
    if (s >= Sq) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if constexpr (kVec) {   // Dv even: a pair is in or out
        if (c < Dv)
          store2(ob + s * o_stride + c, acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
      } else {
        if (c < Dv) store(ob + s * o_stride + c, acc[n][2 * r] * inv[r]);
        if (c + 1 < Dv) store(ob + s * o_stride + c + 1, acc[n][2 * r + 1] * inv[r]);
      }
    }
  }
}

template <typename T, bool kVec, bool kLse>
cudaError_t launch_any(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, int KH, int D, int Dv, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = Tile<T>::kSmem;
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  if (smem > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_any<T, kVec, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      raised = true;
    }
  }
  const int groups = (Dv + kW - 1) / kW;
  const long long tiles = (long long)((Sq + kBQ - 1) / kBQ) * groups;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, H, B);
  return PLAN_LAUNCH("flash_fwd_any", flash_fwd_any<T, kVec, kLse>, grid, dim3(kThreads), smem,
                     stream, static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KH, D, Dv,
                     causal, window, scale * kLog2e, Sk - Sq, groups);
}

template <typename T, bool kVec>
cudaError_t launch_lse(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, int KH, int D, int Dv, int causal, int window,
                       float scale, cudaStream_t s) {
  if (lse != nullptr)
    return launch_any<T, kVec, true>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, Dv, causal, window,
                                     scale, s);
  return launch_any<T, kVec, false>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, Dv, causal, window,
                                    scale, s);
}

template <typename T>
cudaError_t run_any(bool vec, const void* q, const void* k, const void* v, void* o, float* lse,
                    int B, int Sq, int Sk, int H, int KH, int D, int Dv, int causal, int window,
                    float scale, cudaStream_t s) {
  if (vec)
    return launch_lse<T, true>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, Dv, causal, window, scale,
                               s);
  return launch_lse<T, false>(q, k, v, o, lse, B, Sq, Sk, H, KH, D, Dv, causal, window, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  All
// contiguous: q (B, Sq, H, D), k (B, Sk, KH, D), v (B, Sk, KH, Dv), o (B,
// Sq, H, Dv), any 1 <= Dv <= D.  lse: null (serving), or (B, H, Sq) f32
// for each row's log-sum-exp (natural log; training).  16-byte copies where
// D and Dv rows and every pointer are 16-byte aligned; element by element
// otherwise.
extern "C" int flash_attention_fwd_any(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int dtype, int B, int Sq, int Sk, int H, int KH,
                                       int D, int Dv, int causal, int window, float scale,
                                       void* stream) {
  if (D < 1 || Dv < 1 || Dv > D || KH < 1 || H % KH != 0 || B < 1 || Sq < 1 || Sk < 1 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = (D * elem) % 16 == 0 && (Dv * elem) % 16 == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)run_any<float>(vec, q, k, v, o, l, B, Sq, Sk, H, KH, D, Dv, causal, window, scale,
                               s);
  return (int)run_any<__nv_bfloat16>(vec, q, k, v, o, l, B, Sq, Sk, H, KH, D, Dv, causal, window,
                                     scale, s);
}

// Query entry (launch_plan.cuh): flash_attention_fwd_any's arguments with
// `plans` in place of the stream; records the launch, launches nothing.
extern "C" int flash_attention_fwd_any_plan(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int dtype, int B, int Sq, int Sk, int H,
                                            int KH, int D, int Dv, int causal, int window,
                                            float scale, long long* plans) {
  plan::Scope scope(plans);
  return flash_attention_fwd_any(q, k, v, o, lse, dtype, B, Sq, Sk, H, KH, D, Dv, causal, window,
                                 scale, nullptr);
}
