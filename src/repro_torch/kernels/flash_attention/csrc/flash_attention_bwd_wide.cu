// Flash attention backward above head dim 128 for Hopper (sm_90a) on the
// warpgroup tensor cores (wgmma), bf16, plain C interface.
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
// against 671 MB, 0.200 ms: the bytes bound.  As run, P and dS enter their
// products as bf16 hi + lo pairs, so the two products over them count
// twice: 7 products of 5.
//
// What the design does about it (FlashAttention-3's shape for the
// backward):
// - flash_bwd_dkdv_wide: one block per (64-key tile, kv head, batch) of
//   three warpgroups.  Warpgroup 2 is the producer: one thread keeps a
//   3-stage ring of the walked Q and dO tiles full with TMA (a 4-D tensor
//   map per operand, (D, heads, S, B), 64 x 64 boxes in the 128-byte
//   swizzle, zero fill past Sq and past D) behind full / empty mbarriers,
//   after loading the block's K and V tiles once; it gives back its
//   registers (setmaxnreg 24) to the consumers (240).  Warpgroup 0 forms
//   S^T = K Q^T over the full D, turns it into P^T in f32 (the masks and
//   keyless rows of p_ds), hands P^T to warpgroup 1 through a 16 KB f32
//   tile behind two named barriers, and accumulates dV += P^T dO.
//   Warpgroup 1 forms dP^T = V dO^T over Dv at the same time, takes P^T,
//   forms dS^T and accumulates dK += dS^T Q.  S^T and dP^T are formed once
//   a (key tile, query tile); the accumulators are split between the
//   warpgroups (Dv / 2 and D / 2 f32 a thread).  GQA: the block walks the
//   group's heads.
// - flash_bwd_dq_wide: one block per (128-query tile, head, batch), two
//   consumer warpgroups of 64 query rows each over one 2-stage ring of K
//   and V tiles (Q and dO loaded once): S = Q K^T and dP = dO V^T once a key
//   tile, then dQ += dS K.  Deterministic: no atomics.
// - Every product is wgmma m64nNk16 (f32 accumulate).  Both score products
//   read A and B K-major from shared memory; the three accumulation
//   products take P^T, dS^T or dS from registers as A (the accumulator
//   layout of the score is the A layout, as in flash_attention_bwd.cu) and
//   Q, dO or K as MN-major B through the descriptor's transpose bit.  160
//   is not a multiple of the 64-column swizzle atom: the tiles are stored
//   in 64-column chunks of 64 rows x 128 bytes, the last one zero-filled
//   past D (160 takes 192 columns of shared memory: +20 % of the tiles'
//   bytes, no product over the padding), and an accumulation product over
//   D is one wgmma per chunk, N = 64, 64 and 32.
// - P and dS enter their products as bf16 pairs, hi = bf16(x) and lo =
//   bf16(x - hi) (flash_attention_bwd.cu's rounding).
// - Load balance under the causal mask: the grid is 1-D with the tiles
//   that take the most work first (the first key tiles in dK/dV, the last
//   query tiles in dQ; flash_bwd_split.cuh's tile_of_block).
// - Delta = rowsum(dO * o) is flash_attention_bwd.cu's kernel over Dv.
// - Shared bytes a block (plus 1 KB for alignment and barriers): dK/dV at
//   160: K + V 48 KB, ring 3 x 48 KB, P^T 16 KB = 208 KB; at 192 over 128:
//   K + V 40 KB, ring 3 x 40 KB, P^T 16 KB = 176 KB.  dQ at 160: Q + dO
//   96 KB, ring 2 x 48 KB = 192 KB; at 192 over 128: 80 + 80 = 160 KB.
//   ptxas's registers and spills: PERF.md §6.
// - Every instantiation of flash_attention_bwd.cu keeps its code: this is
//   a translation unit of its own (FLASH_BWD_WIDE), built beside it in
//   parallel, with its own entry point, flash_attention_bwd_wide.

#define FLASH_BWD_WIDE
#include "flash_attention_bwd.cu"
#include "flash_bwd_split.cuh"

#include <cuda.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kDWide = 160;      // q, k and v at 160 (pixtral-12b)
constexpr int kDSplit = 192;     // q and k at 192 ...
constexpr int kDvSplit = 128;    // ... over v at 128 (deepseek-v2's MLA)
constexpr int kChunk = 64;                  // columns of a 128-byte swizzle atom
constexpr int kChunkBytes = 64 * 128;       // 64 rows of one chunk
constexpr int kWg = 128;                    // threads of a warpgroup
constexpr int kWideThreads = 3 * kWg;       // two consumer warpgroups, one producer
constexpr int kRingKV = 3;                  // stages of the walked Q, dO tiles (dK/dV)
constexpr int kRingQ = 2;                   // and of K, V (dQ: Q and dO fill the rest)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// A tile of 64 rows and W columns: its 64-column chunks and their bytes
template <int W>
struct Cols {
  static constexpr int kChunks = (W + kChunk - 1) / kChunk;
  static constexpr int kLast = W - kChunk * (kChunks - 1);   // columns of the last chunk
  static constexpr int kBytes = kChunks * kChunkBytes;
  static constexpr int kRegs = 32 * (kChunks - 1) + kLast / 2;   // f32 of a 64 x W accumulator
};

// d (64 x 64, f32) (+)= A B over 16 of K, A and B both K-major in shared
// memory (descriptors); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A B over 16 of K: A from registers (each warp's
// m16n8k16 A fragment of its 16 rows), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs64t(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A B over 16 of K: A from registers (each warp's
// m16n8k16 A fragment of its 16 rows), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs32t(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup's products are pending
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving an accumulator across an asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: the 8-row groups 1024
// bytes apart.  K-major, the leading offset is unused; MN-major with N <=
// 64 (one swizzle atom wide) the stride between atoms is never taken, so
// both offsets are 1024 whichever of the two the hardware reads.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand: step ks of 16 columns of a tile stored in 64-column chunks
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return desc128(tile + (ks >> 2) * kChunkBytes + (ks & 3) * 32);
}
// MN-major operand: rows 16 kk .. 16 kk + 15 (the reduction) of chunk nc
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int nc, int kk) {
  return desc128(tile + nc * kChunkBytes + kk * 16 * 128);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a 64 x 64 box of a 4-D tensor map at (column, head, row, batch) into
// shared memory, counted on `bar`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c, int h,
                                        int r, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(r), "r"(b), "r"(bar)
      : "memory");
}
// every chunk of a 64-row tile of W columns
template <int W>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int h, int r,
                                         int b, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < Cols<W>::kChunks; ++c)
    tma_box(dst + c * kChunkBytes, map, c * kChunk, h, r, b, bar);
}
// named barrier `id` over the two consumer warpgroups
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * kWg) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * kWg) : "memory");
}

// x (the 64 x 64 accumulator of a score, f32) as bf16 hi and lo A fragments
// of the four 16-wide steps over its columns
__device__ __forceinline__ void a_pairs(const float* x, uint32_t hi[4][4], uint32_t lo[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* p = x + 8 * kk;
    split_bf16(p[0], p[1], hi[kk][0], lo[kk][0]);
    split_bf16(p[2], p[3], hi[kk][1], lo[kk][1]);
    split_bf16(p[4], p[5], hi[kk][2], lo[kk][2]);
    split_bf16(p[6], p[7], hi[kk][3], lo[kk][3]);
  }
}

// acc (64 x W, chunk c at acc + 32 c) += X B for X given as hi + lo pairs
// over 64 of the reduction and B the MN-major tile at `tile`: issued and
// committed; acc, hi and lo stay untouched until a wg_wait covers it
template <int W>
__device__ __forceinline__ void acc_issue(float* acc, const uint32_t hi[4][4],
                                          const uint32_t lo[4][4], uint32_t tile) {
  fence_regs<Cols<W>::kRegs>(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < Cols<W>::kChunks; ++c) {
      const uint64_t d = desc_mn(tile, c, kk);
      if (c + 1 < Cols<W>::kChunks || Cols<W>::kLast == 64) {
        wgmma_rs64t(acc + 32 * c, lo[kk], d);
        wgmma_rs64t(acc + 32 * c, hi[kk], d);
      } else {
        static_assert(Cols<W>::kLast == 64 || Cols<W>::kLast == 32, "chunks of 64 or 32");
        wgmma_rs32t(acc + 32 * c, lo[kk], d);
        wgmma_rs32t(acc + 32 * c, hi[kk], d);
      }
    }
  wg_commit();
  fence_regs<Cols<W>::kRegs>(acc);
}

// the same, waited for
template <int W>
__device__ __forceinline__ void acc_pairs(float* acc, const uint32_t hi[4][4],
                                          const uint32_t lo[4][4], uint32_t tile) {
  acc_issue<W>(acc, hi, lo, tile);
  wg_wait();
  fence_regs<Cols<W>::kRegs>(acc);
}

// s (64 x 64) = A B^T over W columns, both tiles K-major: issued and
// committed; s stays untouched until a wg_wait covers it
template <int W>
__device__ __forceinline__ void score_issue(float* s, uint32_t a, uint32_t b) {
  fence_regs<32>(s);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) wgmma_ss64(s, desc_k(a, ks), desc_k(b, ks), ks > 0);
  wg_commit();
  fence_regs<32>(s);
}

// the same, waited for
template <int W>
__device__ __forceinline__ void score(float* s, uint32_t a, uint32_t b) {
  score_issue<W>(s, a, b);
  wg_wait();
  fence_regs<32>(s);
}

// The 64 x W accumulator (chunk c at acc + 32 c) of rows row0 + the
// thread's (16 warp + g, + 8) into a (rows, stride) bf16 slice: rows >=
// n_rows and columns >= D left out (D even)
template <int W>
__device__ __forceinline__ void store_acc(bf16* base, long long stride, int row0, int n_rows,
                                          int D, const float* acc) {
  const int tid = threadIdx.x % kWg, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * (tid >> 5) + g + 8 * r;
    if (row >= n_rows) continue;
    bf16* p = base + (long long)row * stride;
#pragma unroll
    for (int c = 0; c < Cols<W>::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < (c + 1 < Cols<W>::kChunks ? 8 : Cols<W>::kLast / 8); ++j) {
        const int col = kChunk * c + 8 * j + 2 * t;
        if (col < D) store2(p + col, acc[32 * c + 4 * j + 2 * r], acc[32 * c + 4 * j + 2 * r + 1]);
      }
  }
}

template <int DP, int DV>
struct DkdvSmem {
  static constexpr int kK = 0, kV = kK + Cols<DP>::kBytes, kRing0 = kV + Cols<DV>::kBytes;
  static constexpr int kStage = Cols<DP>::kBytes + Cols<DV>::kBytes;   // Q then dO
  static constexpr int kEx = kRing0 + kRingKV * kStage;                  // P^T, f32
  static constexpr int kBars = kEx + 64 * 64 * 4;                      // kv, full[], empty[]
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kRingKV) + 1024;
};

template <int DP, int DV>
struct DqSmem {
  static constexpr int kQ = 0, kO = kQ + 2 * Cols<DP>::kBytes, kRing0 = kO + 2 * Cols<DV>::kBytes;
  static constexpr int kStage = Cols<DP>::kBytes + Cols<DV>::kBytes;   // K then V
  static constexpr int kBars = kRing0 + kRingQ * kStage;                // qo, full[], empty[]
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kRingQ) + 1024;
};

// the block's shared memory rounded up to the 1024 bytes of a swizzle
// pattern
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw) {
  return (smem_addr(raw) + 1023u) & ~1023u;
}

// Step `it` of a dK/dV block's walk on consumer warpgroup wg: the row
// values of the thread's 16 queries (lse or Delta) into rv, the wait for
// the step's tiles, and the score issued into x (S^T = K Q^T on
// warpgroup 0, dP^T = V dO^T on 1), not waited for.
template <int DP, int DV>
__device__ __forceinline__ void start_step(int wg, int it, int h0, int qt_lo, int nq, int b,
                                           const Shape& a, int t, const float* rows,
                                           uint32_t base, int off_k, int off_v, int off_ring,
                                           int stage_bytes, uint32_t full, float* rv,
                                           float* x) {
  const int h = h0 + it / nq, q0 = (qt_lo + it % nq) * kBQ;
  const long long lrow = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int qi = q0 + 8 * (i >> 1) + 2 * t + (i & 1);
    rv[i] = qi < a.Sq ? __ldg(rows + lrow + qi) : 0.f;
  }
  mbar_wait(full, (it / kRingKV) & 1);
  const uint32_t sQ = base + off_ring + (it % kRingKV) * stage_bytes;
  if (wg == 0)
    score_issue<DP>(x, base + off_k, sQ);
  else
    score_issue<DV>(x, base + off_v, sQ + Cols<DP>::kBytes);
}

// Block (key tile, kv head, batch) of the 1-D grid, longest key tiles
// first: dK (B, Sk, KH, D) and dV (B, Sk, KH, Dv).
template <int DP, int DV>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dkdv_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, Shape a, int Dv, int B) {
  using L = DkdvSmem<DP, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bar_kv = base + L::kBars;
  auto bar_full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8 * (1 + kRingKV + s); };

  const int n_kt = (a.Sk + kBK - 1) / kBK;
  int kt, rest;
  tile_of_block(n_kt, a.KH * B, false, kt, rest);
  const int k0 = kt * kBK, kh = rest % a.KH, b = rest / a.KH;
  const int G = a.H / a.KH;
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

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kRingKV; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);   // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  if (wg == 2) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0 && n_it > 0) {
      mbar_expect(bar_kv, Cols<DP>::kBytes + Cols<DV>::kBytes);
      tma_tile<DP>(base + L::kK, &tk, kh, k0, b, bar_kv);
      tma_tile<DV>(base + L::kV, &tv, kh, k0, b, bar_kv);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kRingKV;
        if (it >= kRingKV) mbar_wait(bar_empty(s), (it / kRingKV - 1) & 1);
        const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kBQ;
        const uint32_t st = base + L::kRing0 + s * L::kStage;
        mbar_expect(bar_full(s), L::kStage);
        tma_tile<DP>(st, &tq, h, q0, b, bar_full(s));
        tma_tile<DV>(st + Cols<DP>::kBytes, &to, h, q0, b, bar_full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int key_r = k0 + 16 * warp + g;   // the thread's keys: key_r, key_r + 8
  float4* ex = reinterpret_cast<float4*>(gbase + L::kEx);   // [8][128]: P^T fragments
  constexpr int kAcc = Cols<(DP > DV ? DP : DV)>::kRegs;
  float acc[kAcc];   // warpgroup 0: dV over DV, warpgroup 1: dK over DP
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  if (n_it > 0) mbar_wait(bar_kv, 0);

  // Software pipeline: the score of step it + 1 (S^T or dP^T) is issued
  // before step it's P^T or dS^T is formed, so that the exponentials, the
  // exchange and the accumulation's issue run under it (the 3-stage ring
  // keeps step it's tiles while step it + 1's are read).  rv: the row
  // values of the thread's 16 queries (lse for warpgroup 0, Delta for 1),
  // loaded before the tiles' wait so that their latency hides too.
  const float* rows = wg == 0 ? lse : delta;
  float rv[16], x[32];
  if (n_it > 0)
    start_step<DP, DV>(wg, 0, kh * G, qt_lo, nq, b, a, t, rows, base, L::kK, L::kV,
                       L::kRing0, L::kStage, bar_full(0), rv, x);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kRingKV;
    const int q0 = (qt_lo + it % nq) * kBQ;
    const uint32_t sQ = base + L::kRing0 + s * L::kStage, sdO = sQ + Cols<DP>::kBytes;
    const bool clear = clear_tile(a, q0, k0);
    const bool next = it + 1 < n_it;
    float rn[16], xn[32];
    if (next) {
      start_step<DP, DV>(wg, it + 1, kh * G, qt_lo, nq, b, a, t, rows, base, L::kK, L::kV,
                         L::kRing0, L::kStage, bar_full((it + 1) % kRingKV), rn, xn);
      wg_wait<1>();   // step it's score; step it + 1's may run on
    } else {
      wg_wait<0>();
    }
    fence_regs<32>(x);
    uint32_t hi[4][4], lo[4][4];
    if (wg == 0) {   // P^T, handed to warpgroup 1; dV += P^T dO
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          x[4 * j + e] = p_of(a, clear, qi, key_r + 8 * (e >> 1), rv[2 * j + (e & 1)],
                              x[4 * j + e]);
        }
      if (it > 0) named_sync(2);   // warpgroup 1 has read the last P^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ex[j * kWg + tid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      named_arrive(1);
      a_pairs(x, hi, lo);
      acc_issue<DV>(acc, hi, lo, sdO);
    } else {   // dS^T from P^T; dK += dS^T Q
      named_sync(1);   // P^T is in ex
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p4 = ex[j * kWg + tid];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          x[4 * j + e] = ds_of(a, clear, qi, key_r + 8 * (e >> 1), p[e], rv[2 * j + (e & 1)],
                               x[4 * j + e]);
        }
      }
      named_arrive(2);
      a_pairs(x, hi, lo);
      acc_issue<DP>(acc, hi, lo, sQ);
    }
    wg_wait<0>();
    fence_regs<kAcc>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(s));
    if (next) {
      fence_regs<32>(xn);
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = xn[i];
#pragma unroll
      for (int i = 0; i < 16; ++i) rv[i] = rn[i];
    }
  }
  if (wg == 0 && n_it > 0) named_sync(2);   // warpgroup 1's last arrival

  const long long kv = (long long)b * a.Sk * a.KH + kh;
  if (wg == 0)
    store_acc<DV>(dv + kv * Dv, (long long)a.KH * Dv, k0, a.Sk, Dv, acc);
  else
    store_acc<DP>(dk + kv * a.D, (long long)a.KH * a.D, k0, a.Sk, a.D, acc);
}

// Block (128-query tile, head, batch) of the 1-D grid, longest query tiles
// first: consumer warpgroup w takes rows 64 w .. 64 w + 63 of the tile.
template <int DP, int DV>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dq_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, Shape a, int Dv, int B) {
  using L = DqSmem<DP, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t bar_qo = base + L::kBars;
  auto bar_full = [&](int s) { return bar_qo + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_qo + 8 * (1 + kRingQ + s); };

  const int n_qt = (a.Sq + 2 * kBQ - 1) / (2 * kBQ);
  int qt, rest;
  tile_of_block(n_qt, a.H * B, a.causal != 0, qt, rest);
  const int q0 = qt * 2 * kBQ, h = rest % a.H, b = rest / a.H;
  const int kh = h / (a.H / a.KH);
  // the key tiles the mask leaves to any row of the block
  int kt_lo = 0, kt_hi = (a.Sk + kBK - 1) / kBK;
  if (a.q_offset >= 0) {
    const int q_first = q0 + a.q_offset;
    const int q_last = min(q0 + 2 * kBQ, a.Sq) - 1 + a.q_offset;
    if (a.causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (a.window > 0) kt_lo = max(0, (q_first - a.window + 1) / kBK);
  }
  const int n_it = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_qo, 1);
    for (int s = 0; s < kRingQ; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  if (wg == 2) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0 && n_it > 0) {
      mbar_expect(bar_qo, 2 * (Cols<DP>::kBytes + Cols<DV>::kBytes));
      for (int w = 0; w < 2; ++w) {
        tma_tile<DP>(base + L::kQ + w * Cols<DP>::kBytes, &tq, h, q0 + 64 * w, b, bar_qo);
        tma_tile<DV>(base + L::kO + w * Cols<DV>::kBytes, &to, h, q0 + 64 * w, b, bar_qo);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kRingQ;
        if (it >= kRingQ) mbar_wait(bar_empty(s), (it / kRingQ - 1) & 1);
        const int k0 = (kt_lo + it) * kBK;
        const uint32_t st = base + L::kRing0 + s * L::kStage;
        mbar_expect(bar_full(s), L::kStage);
        tma_tile<DP>(st, &tk, kh, k0, b, bar_full(s));
        tma_tile<DV>(st + Cols<DP>::kBytes, &tv, kh, k0, b, bar_full(s));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row_w = q0 + 64 * wg;             // the warpgroup's first row
  const int row_r = row_w + 16 * warp + g;    // the thread's rows: row_r, row_r + 8
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_r + 8 * r;
    const long long i = ((long long)b * a.H + h) * a.Sq + qi;
    lr[r] = qi < a.Sq ? lse[i] : 0.f;
    dr[r] = qi < a.Sq ? delta[i] : 0.f;
  }
  // the warpgroup's own key tiles (a row past Sq sees none)
  int my_lo = kt_lo, my_hi = row_w < a.Sq ? kt_hi : kt_lo;
  if (a.q_offset >= 0 && row_w < a.Sq) {
    const int q_first = row_w + a.q_offset;
    const int q_last = min(row_w + kBQ, a.Sq) - 1 + a.q_offset;
    if (a.causal) my_hi = min(my_hi, q_last / kBK + 1);
    if (a.window > 0) my_lo = max(my_lo, (q_first - a.window + 1) / kBK);
  }
  constexpr int kAcc = Cols<DP>::kRegs;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const uint32_t sQ = base + L::kQ + wg * Cols<DP>::kBytes;
  const uint32_t sdO = base + L::kO + wg * Cols<DV>::kBytes;
  if (n_it > 0) mbar_wait(bar_qo, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kRingQ, kt = kt_lo + it;
    mbar_wait(bar_full(s), (it / kRingQ) & 1);
    if (kt >= my_lo && kt < my_hi) {
      const uint32_t sK = base + L::kRing0 + s * L::kStage, sV = sK + Cols<DP>::kBytes;
      const int k0 = kt * kBK;
      float sc[32], dp[32];
      score<DP>(sc, sQ, sK);    // S = Q K^T
      score<DV>(dp, sdO, sV);   // dP = dO V^T
      const bool clear = clear_tile(a, row_w, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, qi = row_r + 8 * r, kj = k0 + 8 * j + 2 * t + (e & 1);
          const float p = p_of(a, clear, qi, kj, lr[r], sc[4 * j + e]);
          dp[4 * j + e] = ds_of(a, clear, qi, kj, p, dr[r], dp[4 * j + e]);
        }
      uint32_t hi[4][4], lo[4][4];
      a_pairs(dp, hi, lo);
      acc_pairs<DP>(acc, hi, lo, sK);   // dQ += dS K
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(s));
  }

  const long long row = (long long)b * a.Sq * a.H + h;
  store_acc<DP>(dq + row * a.D, (long long)a.H * a.D, row_w, a.Sq, a.D, acc);
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (the library links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (B, S, heads, W) bf16 tensor at `ptr` as a 4-D map (W, heads, S, B)
// read in 64-column x 64-row boxes of one head, 128-byte swizzle, zeros
// past each edge
bool tile_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int W) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)heads * W * 2,
                                 (cuuint64_t)S * heads * W * 2};
  const cuuint32_t box[4] = {kChunk, 1, 64, 1}, unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise the kernel's shared memory once, and refuse it unless its registers
// at launch cover what setmaxnreg moves (2 x 128 consumers at 240, 128
// producers at 24): otherwise setmaxnreg.inc would wait forever.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (attr.numRegs * kWideThreads < 2 * kWg * kConsumerRegs + kWg * kProducerRegs)
    return cudaErrorInvalidConfiguration;
  return raise_smem(kernel, smem);
}

template <int DP, int DV>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* o,
                        const void* dO, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, const Shape& a, int Dv, cudaStream_t s) {
  constexpr size_t smem_kv = DkdvSmem<DP, DV>::kBytes, smem_q = DqSmem<DP, DV>::kBytes;
  static_assert(smem_kv <= 232448 && smem_q <= 232448, "a block has 227 KB of shared memory");
  static cudaError_t ready = [] {
    const cudaError_t e = prepare(flash_bwd_dkdv_wide<DP, DV>, smem_kv);
    return e == cudaSuccess ? prepare(flash_bwd_dq_wide<DP, DV>, smem_q) : e;
  }();
  if (ready != cudaSuccess) return ready;
  CUtensorMap tq, tk, tv, to;
  if (!tile_map(&tq, q, B, a.Sq, a.H, a.D) || !tile_map(&tk, k, B, a.Sk, a.KH, a.D) ||
      !tile_map(&tv, v, B, a.Sk, a.KH, Dv) || !tile_map(&to, dO, B, a.Sq, a.H, Dv))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_delta<bf16>(o, dO, delta, B, a.Sq, a.H, Dv, s);
  if (e != cudaSuccess) return e;
  const long long n_kv = (long long)((a.Sk + kBK - 1) / kBK) * a.KH * B;
  const long long n_q = (long long)((a.Sq + 2 * kBQ - 1) / (2 * kBQ)) * a.H * B;
  if (n_kv > 2147483647LL || n_q > 2147483647LL) return cudaErrorInvalidValue;
  e = PLAN_LAUNCH("flash_bwd_dkdv_wide", flash_bwd_dkdv_wide<DP, DV>, dim3((unsigned)n_kv),
                  dim3(kWideThreads), smem_kv, s, tq, tk, tv, to, lse, delta,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), a, Dv, B);
  if (e != cudaSuccess) return e;
  return PLAN_LAUNCH("flash_bwd_dq_wide", flash_bwd_dq_wide<DP, DV>, dim3((unsigned)n_q),
                     dim3(kWideThreads), smem_q, s, tq, tk, tv, to, lse, delta,
                     static_cast<bf16*>(dq), a, Dv, B);
}

}  // namespace

// bf16 (dtype 1) only.  All contiguous: q and dq (B, Sq, H, D); o and dO
// (B, Sq, H, Dv); k and dk (B, Sk, KH, D); v and dv (B, Sk, KH, Dv); lse
// (the forward's, natural log) and the scratch delta (B, H, Sq) f32.
// 128 < D, D and Dv multiples of 8, 16-byte aligned pointers; Dv == D <=
// 160, or D <= 192 over Dv <= 128.  Launches three kernels (Delta, dK/dV,
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
// `plans` in place of the stream; records the three launches, launches
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
