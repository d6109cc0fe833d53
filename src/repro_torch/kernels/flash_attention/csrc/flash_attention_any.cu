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
// What the design does about it: each score is formed once a tile pair,
// and every product the block issues is one the bound counts, up to the
// padding of the last 16 columns of D and of Dv.
// - One block of 4 warps per (64-query tile, head, batch) owns every
//   output column of its rows for Dv <= 192: pixtral's 160 and the MLA's
//   128 are one block per tile, each warp holding 16 rows x up to 192
//   columns of O (96 f32 a thread) beside its 16 x 64 score tile (32).  A
//   wider Dv takes ceil(Dv / 192) column groups on the grid, each an equal
//   share of 64-column slabs (the encoder's 288: 192 + 96; Gemma's 256:
//   128 + 128), each forming the same S with the same code, so m and l
//   agree bitwise across groups; group 0 writes the lse.  Measured on an
//   H100 against this (tools/flash_fwd_ab.py): two 4-warp sides sharing S
//   through shared memory, each with half of O (128 registers, 16 warps
//   an SM), tied at pixtral f32, ran 2-4 % slower at the MLA and lost
//   Gemma f32's second block an SM; 8 warps x 128 queries, on an earlier
//   cut of this design, ran 8 % slower.
// - Q is staged once a block: its 64 rows x D columns (zero-padded to a
//   multiple of 16) stay in shared memory for the whole walk over keys,
//   and each k-step splits its fragment into big + small as it loads it (a
//   split Q would take twice the shared memory).  Where Q and the ring
//   would not fit in 227 KB (f32 above D 768, bf16 above 1664), each Q
//   slab is staged again beside its K slab in the ring (`resident` = 0):
//   the whole domain keeps one kernel.
// - The walk: for each key tile the mask leaves, S = Q K^T over D one K
//   slab (64 keys x 64 columns) a step, then O += P V over the group's
//   columns one V slab a step.  Steps come through a 2-stage cp.async ring
//   (16-byte copies with zero fill past Sq, Sk, D and Dv; element by
//   element where rows or pointers are not 16-byte aligned, template flag
//   kVec = false, loads batched ahead of their stores), the next step's
//   copy in flight during this step's products, one barrier a step.  A
//   third stage was no faster at pixtral's and the MLA's f32 shapes and
//   cost Gemma's f32 256 its second block an SM.
// - Columns past D and Dv are skipped 16 at a time: a slab's products are
//   a body without branches for whole slabs and one for each width of a
//   partial last slab (D 160 runs 20 k-steps of 8 in f32, not 24).  A
//   branch per k-step or n-tile instead kept the compiler from loading
//   the next fragments during the current products (0.82 ms against 0.62
//   at pixtral f32 on an H100, tools/flash_fwd_ab.py).  In f32 the three 8-tile blocks of O rotate through
//   one block after each V slab, so that one P V body serves every slab.
// - Fragments: ldmatrix in both dtypes for Q K^T (in f32 an 8 x 8 matrix
//   of b16 is 8 rows of 4 floats, and thread (g, t) receives row g, float
//   t: the tf32 fragment's layout), with .trans for V in bf16; f32 V is
//   read float by float (P V's reduction axis is V's rows).
// - Load balance under the causal mask: a 1-D grid whose first blocks take
//   the query tiles that walk the most key tiles (the last ones), as
//   flash_bwd_split.cuh's tile_of_block orders the general backward's dQ;
//   the blocks of one tile sweep the heads that share a kv head together.
// - Shared memory: Q (64 x (D padded + pad)) and 2 ring stages of one
//   64 x LD slab (with a Q slab beside it outside `resident`), rows padded
//   by 16 bytes (LD 68 f32, 72 bf16) so that fragment loads and ldmatrix
//   hit distinct banks: 76,800 bytes at pixtral's f32 shape and 84,992 at
//   the MLA's, 52,224 at Gemma's bf16 256.  The block raises its limit to
//   227 KB at its first call, which runs eagerly before any graph captures
//   it; the launch asks for what the shape needs.
// - bf16: mma.sync m16n8k16; P is rounded to bf16 before P V, as
//   blocked_attention does.  f32: mma.sync m16n8k8 tf32 as 3xTF32 (every
//   operand split into big + small), P included, with P V's reduction axis
//   permuted so that the accumulator fragment is the A fragment
//   (flash_attention.cu's f32 path).  wgmma's tf32 wants B K-major, which
//   V's (key, Dv) rows are not.
// - exp2 on the special function unit (log2(e) folded into the scale).
// ptxas's registers and spills, and the times, are in PERF.md §6 and
// chip_smoke's build log.  Every instantiation of flash_attention.cu and
// flash_attention_lse.cu keeps its code: this is a translation unit of its
// own with its own entry point.

// flash_attention.cu's helpers and constants, without its entry points
#define FLASH_ATTENTION_HELPERS_ONLY
#include "flash_attention.cu"

namespace {

// a block: kWarps = 4 warps (kThreads), kBQ = 64 query rows, 16 a warp
constexpr int kAnyStages = 2;             // slabs in the cp.async ring
constexpr int kW = 64;                    // head-dim columns a slab
constexpr int kGroupSlabs = 3;            // V slabs a block owns at most ...
constexpr int kGroupCols = kGroupSlabs * kW;   // ... 192 output columns
constexpr int kSmemMax = 232448;          // a block's shared memory, 227 KB

template <typename T>
struct Tile {
  static constexpr int LD = kW + Traits<T>::kRowPad;   // shared row stride, elements
  static constexpr int kK = kBK * LD;                  // a K or V slab, 64 keys
  static constexpr int kQ = kBQ * LD;                  // a Q slab
};

// Rows row0 .. row0 + kRows - 1, columns c0 .. c0 + 63 of a (rows, stride)
// slice into shared rows of stride ld; rows >= n_rows and columns >= n_cols
// become 0, and columns >= n_room are not written (a Q slab past its
// padded width).  kVec: 16-byte cp.async (n_cols * sizeof(T), n_room and
// c0 multiples of 16 bytes, src 16-byte aligned); otherwise element by
// element, loads batched ahead of their stores so that a thread waits for
// memory a few times a slab, not once an element.
template <typename T, bool kVec, int kRows>
__device__ __forceinline__ void stage_slab(T* dst, int ld, const T* src, long long stride,
                                           int row0, int n_rows, int c0, int n_cols,
                                           int n_room) {
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = kW / kE;
    constexpr int kStep = kThreads / kChunks;   // rows a pass; a thread keeps its column
    const int r0 = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * kE;
    if (c0 + c >= n_room) return;
    const bool col_ok = c0 + c < n_cols;
#pragma unroll
    for (int r = r0; r < kRows; r += kStep) {
      const bool valid = col_ok && row0 + r < n_rows;
      cp_async16(dst + r * ld + c, valid ? src + (long long)(row0 + r) * stride + c0 + c : src,
                 valid);
    }
  } else {
    constexpr int kIters = kRows * kW / kThreads, kBatch = 8;
    static_assert(kIters % kBatch == 0, "whole batches");
#pragma unroll 1
    for (int i0 = 0; i0 < kIters; i0 += kBatch) {
      T x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = threadIdx.x + (i0 + u) * kThreads, r = i / kW, c = i % kW;
        x[u] = row0 + r < n_rows && c0 + c < n_cols
                   ? src[(long long)(row0 + r) * stride + c0 + c] : T(0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = threadIdx.x + (i0 + u) * kThreads, r = i / kW, c = i % kW;
        if (c0 + c < n_room) dst[r * ld + c] = x[u];
      }
    }
  }
}

// s += Q_w K^T over the first 16 * N16 columns of one slab: tQ points at
// the warp's first of 16 Q rows (row stride ldq), tK at the 64 rows of the
// K slab; accumulator tile j holds keys 8 j ..  ldmatrix loads the
// fragments in both dtypes: in f32 an 8 x 8 matrix of b16 is 8 rows of 4
// floats, and thread (g, t) receives row g, float t, which is the tf32
// fragment's layout.  N16 is a constant so that the body has no branch
// (see the note at the top).
template <typename T, int N16>
__device__ __forceinline__ void qk_slab(const T* tQ, int ldq, const T* tK, float s[8][4]) {
  constexpr int LD = Tile<T>::LD;
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    const int ar = (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
    const int br = (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < N16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, tQ + ar * ldq + 16 * kk + ac);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, tK + (16 * jp + br) * LD + 16 * kk + bc);
        mma_bf16(s[2 * jp], a, r[0], r[1]);
        mma_bf16(s[2 * jp + 1], a, r[2], r[3]);
      }
    }
  } else {
    // matrix m = lane / 8 of an x4 load takes its row from lane % 8.  A:
    // rows 0-7 / 8-15 (m & 1) x floats 0-3 / 4-7 (m >> 1), so a0 .. a3 =
    // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).  B: keys 16 jp + 0-7
    // / 8-15 (m >> 1) x floats 0-3 / 4-7 (m & 1): b0, b1 of tiles 2 jp and
    // 2 jp + 1.
    const int lr = lane & 7, lm = lane >> 3;
    const float* pa = reinterpret_cast<const float*>(tQ) + (lr + 8 * (lm & 1)) * ldq +
                      4 * (lm >> 1);
    const float* pb = reinterpret_cast<const float*>(tK) + (8 * (lm >> 1) + lr) * LD +
                      4 * (lm & 1);
#pragma unroll
    for (int kk = 0; kk < 2 * N16; ++kk) {
      uint32_t a[4], ab[4], as[4];
      ldsm_x4(a, pa + 8 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ab[i], as[i]);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, pb + 16 * jp * LD + 8 * kk);
        uint32_t bb0, bs0, bb1, bs1;
        split(__uint_as_float(r[0]), bb0, bs0);
        split(__uint_as_float(r[1]), bb1, bs1);
        mma_3xtf32(s[2 * jp], ab, as, bb0, bb1, bs0, bs1);
        split(__uint_as_float(r[2]), bb0, bs0);
        split(__uint_as_float(r[3]), bb1, bs1);
        mma_3xtf32(s[2 * jp + 1], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// acc += P V over the 64 keys of the tile for the first 16 * N16 columns
// of one V slab; acc holds the slab's accumulator tiles of 8 columns
template <typename T, int N16>
__device__ __forceinline__ void pv_slab(const float s[8][4], const T* tV, float (*acc)[4]) {
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
      for (int np = 0; np < N16; ++np) {
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
      for (int n = 0; n < 2 * N16; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split(p[8 * n], bb0, bs0);
        split(p[LD + 8 * n], bb1, bs1);
        mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// The first n16 16-column steps of a slab (1 .. 4, the columns left of D
// or of the block's share of Dv rounded up to 16; the staging zero-fills
// the rest): whole slabs through the full body, a partial last slab
// through its own.
template <typename T>
__device__ __forceinline__ void qk_cols(int n16, const T* tQ, int ldq, const T* tK,
                                        float s[8][4]) {
  switch (n16) {
    case 4: qk_slab<T, 4>(tQ, ldq, tK, s); break;
    case 3: qk_slab<T, 3>(tQ, ldq, tK, s); break;
    case 2: qk_slab<T, 2>(tQ, ldq, tK, s); break;
    default: qk_slab<T, 1>(tQ, ldq, tK, s);
  }
}
template <typename T>
__device__ __forceinline__ void pv_cols(int n16, const float s[8][4], const T* tV,
                                        float (*acc)[4]) {
  switch (n16) {
    case 4: pv_slab<T, 4>(s, tV, acc); break;
    case 3: pv_slab<T, 3>(s, tV, acc); break;
    case 2: pv_slab<T, 2>(s, tV, acc); break;
    default: pv_slab<T, 1>(s, tV, acc);
  }
}

// 1-D grid: block L = tile-major over (query tile, rest), rest = (batch *
// H + head) * groups + group; the query tiles that walk the most keys come
// first (the last ones under a causal mask).  A block owns the output
// columns gw * group .. + gw - 1 (gw a multiple of 64, at most 192) and
// writes lse (B, H, Sq) f32 where kLse and it is group 0.  resident: Q
// stays in shared memory for the whole walk; otherwise each K step stages
// the Q slab beside the K slab.
template <typename T, bool kVec, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_any(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KH, int D,
              int Dv, int causal, int window, float scale_log2, int q_offset, int groups,
              int gw, int resident) {
  using Tl = Tile<T>;
  constexpr int LD = Tl::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nd = (D + kW - 1) / kW;                       // K slabs a key tile
  const int DP = (D + 15) / 16 * 16;                      // Q's columns, zero past D
  const int ldq = resident ? DP + Traits<T>::kRowPad : LD;   // Q's shared row stride
  T* sQ = reinterpret_cast<T*>(smem_raw);                 // [kBQ][ldq] if resident
  T* ring = sQ + (resident ? kBQ * ldq : 0);              // [stage][K | V (, Q)]
  const int stage_elems = Tl::kK + (resident ? 0 : Tl::kQ);

  const int n_tiles = (Sq + kBQ - 1) / kBQ;
  const int rest = gridDim.x / n_tiles;
  int tile = blockIdx.x / rest;
  const int r = blockIdx.x % rest;
  if (causal) tile = n_tiles - 1 - tile;
  const int grp = r % groups;
  const int h = (r / groups) % H, b = r / (groups * H);
  const int q0 = tile * kBQ, c0 = grp * gw;
  const int gcols = min(gw, Dv - c0);                     // this block's output columns
  const int nv = (gcols + kW - 1) / kW;                   // V slabs a key tile, <= 3
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
  const int per_tile = nd + nv;
  const int n_steps = (kt_hi - kt_lo) * per_tile;

  // step i: key tile kt_lo + i / per_tile; sub-step < nd stages K's slab of
  // columns 64 sub (and Q's beside it unless resident), the rest the
  // group's V slabs; stage i % kAnyStages, one commit group a step (empty
  // past the walk)
  auto stage = [&](int i) {
    if (i < n_steps) {
      const int kt = kt_lo + i / per_tile, sub = i % per_tile;
      T* dst = ring + (i % kAnyStages) * stage_elems;
      if (sub < nd) {
        const int c = kW * sub;
        stage_slab<T, kVec, kBK>(dst, LD, kb, k_stride, kt * kBK, Sk, c, D, c + kW);
        if (!resident)
          stage_slab<T, kVec, kBQ>(dst + Tl::kK, LD, qb, q_stride, q0, Sq, c, D, c + kW);
      } else {
        const int c = c0 + kW * (sub - nd);
        stage_slab<T, kVec, kBK>(dst, LD, vb, v_stride, kt * kBK, Sk, c, c0 + gcols, c + kW);
      }
    }
    cp_async_commit();
  };
  if (resident)   // Q once, in the first step's commit group
    for (int sub = 0; sub < nd; ++sub)
      stage_slab<T, kVec, kBQ>(sQ + kW * sub, ldq, qb, q_stride, q0, Sq, kW * sub, D, DP);
#pragma unroll
  for (int i = 0; i < kAnyStages - 1; ++i) stage(i);

  const int w0 = warp * 16;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, log2 domain
  float l[2] = {0.f, 0.f};                       // this thread's part of the row sum
  float acc[kGroupSlabs * 8][4];
#pragma unroll
  for (int n = 0; n < kGroupSlabs * 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int wq_first = q0 + w0;
  const int wq_last = min(q0 + w0 + 15, Sq - 1);
  const int qpos_g = q0 + w0 + g + q_offset;     // positions of rows g, g + 8

  // the next step's stage: one barrier a step publishes it, and every warp
  // is past the previous step, whose stage the newest copy reuses
  int step = 0;
  auto next_stage = [&]() -> const T* {
    cp_async_wait<kAnyStages - 2>();
    __syncthreads();
    stage(step + kAnyStages - 1);
    return ring + (step++ % kAnyStages) * stage_elems;
  };
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int sub = 0; sub < nd; ++sub) {
      const T* buf = next_stage();
      const T* tQ = resident ? sQ + kW * sub : buf + Tl::kK;
      qk_cols<T>((min(kW, D - kW * sub) + 15) / 16, tQ + w0 * ldq, ldq, buf, s);
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
    for (int n = 0; n < kGroupSlabs * 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    if constexpr (sizeof(T) == 2) {
      // unrolled, so that each slab's accumulator tiles stay in registers
#pragma unroll
      for (int j = 0; j < kGroupSlabs; ++j)
        if (j < nv)
          pv_cols<T>((min(kW, gcols - kW * j) + 15) / 16, s, next_stage(), acc + 8 * j);
    } else {
      // one P V body for every slab, the f32 one being large: slab j
      // accumulates into acc[0 .. 7], and the three 8-tile blocks rotate
      // after each slab (96 moves a slab), so that the accumulator stays in
      // registers without a copy of the body for each slab (unrolled, the
      // copies took pixtral f32 from 0.566 to 0.629 ms on an H100)
#pragma unroll 1
      for (int j = 0; j < kGroupSlabs; ++j) {
        if (j < nv) pv_cols<T>((min(kW, gcols - kW * j) + 15) / 16, s, next_stage(), acc);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = acc[n][e];
            acc[n][e] = acc[8 + n][e];
            acc[8 + n][e] = acc[16 + n][e];
            acc[16 + n][e] = x;
          }
      }
    }
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
    for (int n = 0; n < kGroupSlabs * 8; ++n) {
      if (8 * n >= gcols) break;
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
  using Tl = Tile<T>;
  static_assert(sizeof(T) * kAnyStages * (Tl::kK + Tl::kQ) <= kSmemMax,
                "the ring outside `resident` fits");
  static bool raised = false;   // at the first call, which runs eagerly
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_any<T, kVec, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const int DP = (D + 15) / 16 * 16;   // Q's columns, zero past D
  const size_t ring = sizeof(T) * kAnyStages * Tl::kK;
  const size_t with_q = sizeof(T) * (size_t)kBQ * (DP + Traits<T>::kRowPad) + ring;
  const int resident = with_q <= (size_t)kSmemMax;
  const size_t smem = resident ? with_q : sizeof(T) * kAnyStages * (Tl::kK + Tl::kQ);
  // ceil(Dv / 192) groups, each an equal share of Dv's 64-column slabs
  const int slabs = (Dv + kW - 1) / kW;
  const int groups = (Dv + kGroupCols - 1) / kGroupCols;
  const int gw = kW * ((slabs + groups - 1) / groups);
  const long long blocks = (long long)((Sq + kBQ - 1) / kBQ) * groups * H * B;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  return PLAN_LAUNCH("flash_fwd_any", flash_fwd_any<T, kVec, kLse>, dim3((unsigned)blocks),
                     dim3(kThreads), smem, stream, static_cast<const T*>(q),
                     static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
                     lse, Sq, Sk, H, KH, D, Dv, causal, window, scale * kLog2e, Sk - Sq, groups,
                     gw, resident);
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
