// Mamba2 SSD (chunked state-space-dual) scan for Hopper (sm_90a) on the
// tensor cores, plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py::ssd_pallas (body
// _ssd_kernel).  For each (batch b, head h) and each tile of T = 64 tokens,
// with dA = dt * A (<= 0) and cs its inclusive prefix sum inside the tile:
//
//   S[i][j]  = (C_i . B_j) * exp(cs_i - cs_j) * dt_j      for j <= i, else 0
//   y_i      = sum_j S[i][j] x_j  +  exp(cs_i) * (h C_i)   (h from earlier tiles)
//   h       <- h * exp(cs_last) + sum_j x_j (exp(cs_last - cs_j) dt_j B_j)^T
//
// y (b,s,h,p) and the final h (b,h,p,n) are f32; B and C are shared by all
// heads (n_groups = 1).  x, B and C are read in place, in their own dtype
// (bf16 or f32), through strides with a unit stride on the last axis: on
// the serving path they are views of the conv output xBC.  dt (b,s,h) and
// A (h,) are contiguous f32.  A ragged tail is padded with dt = 0 and zero
// x, B, C, which adds nothing to y or h and leaves cs flat; the tile is
// always 64 tokens, also where the plain version takes a ragged s as one
// chunk: the result does not depend on the chunking beyond rounding.
//
// Bound on an H100 SXM: the causal half of C B^T once per (b, tile), as B
// and C are shared by the heads, the causal half of S x per (b, h, tile),
// and C h^T and the state update over (p, n) per token, against x, dt, B,
// C read once and y, h written once (chip_smoke.py's ssd_fwd_work).  At
// the zamba2-2.7b serving shape (b 4, s 512, h 80, p = n = 64) that is
// 3.37 GFLOP, 0.0205 ms at the 165 TFLOP/s of f32-accurate (3xTF32)
// tensor-core work, against 0.0271 ms of bytes in f32 and less with the
// path's bf16 x, B and C, so the two bounds are close.
//
// What the design does about it:
// - Two kernels from the one C entry ssd_fwd.  ssd_cb_kernel writes C B^T
//   for every (b, tile) into an f32 scratch of b * tiles * 64 * 64 (0.5 MB
//   at the main shape: it stays in L2); ssd_scan_kernel reads it for every
//   head instead of recomputing it h times.  The scratch is in the order of
//   the scan's mma A fragments, so each thread of the scan reads its part
//   of a k-step with one 16-byte load, a tile ahead into registers, and the
//   tile takes no shared memory: 66 KB a block in bf16, 3 blocks an SM.
// - Products on the tensor cores: mma.sync m16n8k8 TF32.  One TF32 product
//   misses the 2e-4 / 1e-3 tolerance (tests/test_torch_ssd_numerics.py), so
//   an f32 operand splits into big + small and a product sums the small
//   terms and big * big (3xTF32, as the flash kernel does).  A bf16 input
//   is exact in TF32 and is not split: with the path's bf16 x, B and C the
//   S x, C h^T and x^T (w B) products take two TF32 products, C B^T one.
// - Blocks: one per (32-column group of p, head, batch), which walks the
//   tiles in order with its part of h in registers (the mma accumulators
//   of the state product) and a copy in shared memory for C h^T.  The rows
//   of h and the columns of y of one group depend only on that group's
//   columns of x, so the groups are independent; at p = 64 they double the
//   blocks (640 at b 4, 160 at b 1, for 132 SMs taking 3 blocks each in
//   bf16, 2 in f32) and add no scratch.  The alternative, Mamba2's
//   chunk-state / state-passing / chunk-scan split, is parallel over tiles
//   too but writes and reads a (b, tiles, h, p, n) f32 state (42 MB at the
//   main shape); not taken.
// - Four warps: for y each warp owns 16 token rows (S x over the keys up to
//   its diagonal only, and C h^T); for the state each owns 16 columns of n
//   of the group's 32 x 64 h.
// - The prefix sum cs runs in token order with no FMA, one add after the
//   other, as torch.cumsum sums dt * A in the plain version, so that cs is
//   the plain version's to the bit.  cs reaches the hundreds in a tile, and
//   a warp's tree scan, rounding differently, moved exp(cs_i - cs_j) enough
//   to put y 2.2e-4 past the tolerance on one draw (PERF.md).  Warp 0, whose
//   causal share of S x is the smallest, runs the 64 adds for the next tile
//   at the end of this one, into the other half of a double buffer of cs
//   and w; it copies that tile's dt in a cp.async group of its own, ahead
//   of x, B and C, so that it waits for dt alone.
// - cp.async: the next tile's x, B, C and dt are copied into the other
//   stage of a two-stage ring while this tile computes; one barrier a
//   tile.  Shared rows are padded so that every fragment load hits 32
//   distinct banks.  Where an address or a row is not a multiple of 16
//   bytes, the same kernel stages element by element (kVec = false).
// Measured times and what holds them back are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch_plan.cuh"
#include "tc_helpers.cuh"

namespace {

constexpr int kT = 64;          // tokens per tile
constexpr int kD = 64;          // largest head dim p and state n
constexpr int kPG = 32;         // columns of p per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdF = kD + 4;    // f32 rows of h (floats)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Shared row strides (elements) of the staged x, B and C tiles; all rows
// are multiples of 16 bytes (cp.async) and the fragment loads of each are
// free of bank conflicts.
template <typename T>
struct Ld {
  static constexpr bool kExact = sizeof(T) == 2;   // bf16: exact in TF32
  static constexpr int x = kPG + 8;
  static constexpr int b = kD + 8;
  static constexpr int c = kD + (kExact ? 8 : 4);
};

// An A (16 x 8) or B (8 x 8) fragment of an f32 operand as TF32 halves;
// small is left out where the operand is exact in TF32.
template <int K, bool kExact>
struct Frag {
  uint32_t big[K], small[K];
  __device__ __forceinline__ explicit Frag(const float (&v)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if constexpr (kExact) {
        big[i] = __float_as_uint(v[i]);
      } else {
        split(v[i], big[i], small[i]);
      }
    }
  }
};

// c += a b, f32-accurate: the small terms first, then big * big
template <bool kExA, bool kExB>
__device__ __forceinline__ void mma(float c[4], const Frag<4, kExA>& a, const Frag<2, kExB>& b) {
  if constexpr (!kExA) mma_tf32(c, a.small, b.big[0], b.big[1]);
  if constexpr (!kExB) mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// Stage rows 0 .. kT - 1, columns 0 .. W - 1 of a (rows, stride) slice into
// a shared tile of row stride LD; rows >= n_rows and columns >= cols become
// 0.  kVec: 16-byte cp.async (the caller guarantees 16-byte aligned rows
// and cols a multiple of 16 / sizeof(T)); otherwise element by element.
template <typename T, int W, int LD, bool kVec>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride, int n_rows,
                                           int cols) {
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = W / kE;
    for (int i = threadIdx.x; i < kT * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kE;
      const bool valid = r < n_rows && c < cols;
      cp_async16(dst + r * LD + c, valid ? src + r * stride + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kT * W; i += kThreads) {
      const int r = i / W, c = i % W;
      dst[r * LD + c] = (r < n_rows && c < cols) ? src[r * stride + c] : T(0.f);
    }
  }
}

// C B^T of one (b, tile): C_i . B_j, f32, zero past s.  Warp w owns rows
// 16 w .. 16 w + 15, all 64 columns.  Written in the order the scan reads
// its A fragments: element (i, j) goes to warp i / 16, k-step j / 8, lane
// 4 (i % 8) + j % 4, slot (i % 16) / 8 + 2 ((j % 8) / 4), four floats a
// lane.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ cb, int S,
              int N, long long bs_b, long long bs_t, long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int LD = Ld<T>::c;          // conflict-free for both operands here
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  T* sc = sb + kT * LD;
  const int tile = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int t0 = tile * kT, rows = min(kT, S - t0);
  stage_rows<T, kD, LD, kVec>(sb, B + b * bs_b + t0 * bs_t, bs_t, rows, N);
  stage_rows<T, kD, LD, kVec>(sc, C + b * cs_b + t0 * cs_t, cs_t, rows, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const T* pc = sc + (r0 + g) * LD + 8 * kk + t;
    const float av[4] = {to_f32(pc[0]), to_f32(pc[8 * LD]), to_f32(pc[4]), to_f32(pc[8 * LD + 4])};
    const Frag<4, kEx> a(av);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T* pb = sb + (8 * j + g) * LD + 8 * kk + t;
      const float bv[2] = {to_f32(pb[0]), to_f32(pb[4])};
      mma(acc[j], a, Frag<2, kEx>(bv));
    }
  }
  float* out = cb + ((long long)b * nt + tile) * kT * kT + warp * 8 * 32 * 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int li = g + 8 * (e >> 1), lc = 2 * t + (e & 1);   // in the warp's 16 x 8 step
      out[(j * 32 + (li & 7) * 4 + (lc & 3)) * 4 + (li >> 3) + 2 * (lc >> 2)] = acc[j][e];
    }
}

template <typename T>
struct ScanSmem {
  static constexpr int kX = kT * Ld<T>::x * sizeof(T);
  static constexpr int kB = kT * Ld<T>::b * sizeof(T);
  static constexpr int kC = kT * Ld<T>::c * sizeof(T);
  static constexpr int kStage = kX + kB + kC + kT * 4;     // + dt
  static constexpr int kH = kPG * kLdF * 4;                      // one copy of h
  static constexpr int kBytes = 2 * kStage + 2 * kH + 2 * 2 * kT * 4;   // + cs, w twice
  static_assert(kX % 16 == 0 && kB % 16 == 0 && kC % 16 == 0, "16-byte stage parts");
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};

// 3 blocks an SM in bf16 (at most 170 registers), 2 in f32
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, Ld<T>::kExact ? 3 : 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ cb, float* __restrict__ y, float* __restrict__ hout,
                int S, int H, int P, int N, long long xs_b, long long xs_t, long long xs_h,
                long long bs_b, long long bs_t, long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int LX = Ld<T>::x, LB = Ld<T>::b, LC = Ld<T>::c;
  using Sm = ScanSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto sx = [&](int st) { return reinterpret_cast<T*>(smem_raw + st * Sm::kStage); };
  auto sb = [&](int st) { return reinterpret_cast<T*>(smem_raw + st * Sm::kStage + Sm::kX); };
  auto sc = [&](int st) {
    return reinterpret_cast<T*>(smem_raw + st * Sm::kStage + Sm::kX + Sm::kB);
  };
  auto sdt = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * Sm::kStage + Sm::kX + Sm::kB + Sm::kC);
  };
  auto sh = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + 2 * Sm::kStage + st * Sm::kH);
  };

  const int grp = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int p0 = grp * kPG, pw = min(kPG, P - p0);   // this block's columns of p
  const int nt = (S + kT - 1) / kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // cs, then w_j = exp(cs_last - cs_j) dt_j, of the tiles of either parity
  float* cs_s = reinterpret_cast<float*>(smem_raw + 2 * Sm::kStage + 2 * Sm::kH);

  const T* xb = x + b * xs_b + hd * xs_h + p0;
  const T* Bb = B + b * bs_b;
  const T* Cb = C + b * cs_b;
  const float* dtb = dt + (long long)b * S * H + hd;
  // this warp's A fragments of C B^T: 8 k-steps of 32 lanes x 4 floats a tile
  const float4* cbw = reinterpret_cast<const float4*>(cb + (long long)b * nt * kT * kT) +
                      warp * 8 * 32 + lane;
  const float a = A[hd];

  // two commit groups a tile: dt (copied by warp 0, which scans it), then
  // x, B and C
  auto stage = [&](int tile, int st) {
    const int t0 = tile * kT, rows = min(kT, S - t0);
    if (warp == 0) {
#pragma unroll
      for (int r = lane; r < kT; r += 32)
        cp_async4(sdt(st) + r, r < rows ? dtb + (long long)(t0 + r) * H : dtb, r < rows);
    }
    cp_async_commit();
    stage_rows<T, kPG, LX, kVec>(sx(st), xb + t0 * xs_t, xs_t, rows, pw);
    stage_rows<T, kD, LB, kVec>(sb(st), Bb + t0 * bs_t, bs_t, rows, N);
    stage_rows<T, kD, LC, kVec>(sc(st), Cb + t0 * cs_t, cs_t, rows, N);
    cp_async_commit();
  };
  // warp 0, once the dt of stage st has landed: cs and w into cs_s's half st
  auto scan = [&](int st) {
    const float* d = sdt(st);
    float* c = cs_s + st * 2 * kT;
    float acc = 0.f, c_lo = 0.f, c_hi = 0.f;
#pragma unroll 8
    for (int i = 0; i < kT; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(d[i], a));
      if (i == lane) c_lo = acc;
      if (i == lane + 32) c_hi = acc;
    }
    c[lane] = c_lo;
    c[lane + 32] = c_hi;
    c[kT + lane] = __expf(acc - c_lo) * d[lane];
    c[kT + lane + 32] = __expf(acc - c_hi) * d[lane + 32];
  };

  // the state: rows p = 16 mi + g (+ 8), columns n = nb + 8 ni + 2 t (+ 1)
  const int nb = 16 * warp;
  float hacc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[mi][ni][e] = 0.f;

  // the keys of warp w's rows end in k-step 2 w + 1 (causal)
  float4 cbr[kT / 8];
  auto load_cb = [&](int tile) {
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk)
      if (kk <= 2 * warp + 1) cbr[kk] = __ldg(cbw + (long long)tile * kT * kT / 4 + kk * 32);
  };

  stage(0, 0);
  load_cb(0);
  if (warp == 0) {
    cp_async_wait<1>();   // the dt group
    __syncwarp();
    scan(0);
  }
  for (int tile = 0; tile < nt; ++tile) {
    const int st = tile & 1;
    // one barrier a tile: it publishes this tile's stage, cs and w, and the
    // h of the previous tile, and every warp is past the previous tile,
    // whose stage, cs and h copy are written next
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < nt) stage(tile + 1, st ^ 1);
    const T* tx = sx(st);
    const T* tb = sb(st);
    const T* tc = sc(st);
    const float* tdt = sdt(st);
    const float* cs_w = cs_s + st * 2 * kT;
    const float* w_w = cs_w + kT;

    // y for rows r0 + g and r0 + g + 8: 4 tiles of 8 columns of p
    const int r0 = 16 * warp;
    const float cs_g = cs_w[r0 + g], cs_g8 = cs_w[r0 + g + 8];
    float yd[4][4], yo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yd[j][e] = yo[j][e] = 0.f;
    // S x over the keys j <= r0 + 15 (causal): 2 warp + 2 steps of 8
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      if (kk > 2 * warp + 1) break;
      const int j0 = 8 * kk + t, j1 = j0 + 4, i0 = r0 + g, i1 = i0 + 8;
      const float e0 = cs_w[j0], e1 = cs_w[j1], d0 = tdt[j0], d1 = tdt[j1];
      const float4 c = cbr[kk];   // (i0, j0), (i1, j0), (i0, j1), (i1, j1)
      // selects, not products: exp of j > i may overflow
      const float sv[4] = {j0 <= i0 ? c.x * __expf(cs_g - e0) * d0 : 0.f,
                           j0 <= i1 ? c.y * __expf(cs_g8 - e0) * d0 : 0.f,
                           j1 <= i0 ? c.z * __expf(cs_g - e1) * d1 : 0.f,
                           j1 <= i1 ? c.w * __expf(cs_g8 - e1) * d1 : 0.f};
      const Frag<4, false> af(sv);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float bv[2] = {to_f32(tx[j0 * LX + 8 * n + g]), to_f32(tx[j1 * LX + 8 * n + g])};
        mma(yd[n], af, Frag<2, kEx>(bv));
      }
    }
    // C h^T with h after the previous tile (zero before the first)
    if (tile > 0) {
      const float* th = sh(st);
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        const T* pc = tc + (r0 + g) * LC + 8 * kk + t;
        const float av[4] = {to_f32(pc[0]), to_f32(pc[8 * LC]), to_f32(pc[4]),
                             to_f32(pc[8 * LC + 4])};
        const Frag<4, kEx> af(av);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* ph = th + (8 * n + g) * kLdF + 8 * kk + t;
          const float bv[2] = {ph[0], ph[4]};
          mma(yo[n], af, Frag<2, false>(bv));
        }
      }
    }
    {
      const int s0 = tile * kT + r0 + g;
      const float eg[2] = {__expf(cs_g), __expf(cs_g8)};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = s0 + 8 * r;
        if (s >= S) continue;
        float* yr = y + (((long long)b * S + s) * H + hd) * P + p0;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * t;
          const float v0 = yd[n][2 * r] + eg[r] * yo[n][2 * r];
          const float v1 = yd[n][2 * r + 1] + eg[r] * yo[n][2 * r + 1];
          if constexpr (kVec) {
            if (c < pw) *reinterpret_cast<float2*>(yr + c) = make_float2(v0, v1);
          } else {
            if (c < pw) yr[c] = v0;
            if (c + 1 < pw) yr[c + 1] = v1;
          }
        }
      }
    }

    // h <- h exp(cs_last) + x^T (w B): this warp's 16 columns of n
    const float decay = __expf(cs_w[kT - 1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[mi][ni][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const int j0 = 8 * kk + t, j1 = j0 + 4;
      const float w0 = w_w[j0], w1 = w_w[j1];
      Frag<2, false> bf[2] = {
          Frag<2, false>({to_f32(tb[j0 * LB + nb + g]) * w0, to_f32(tb[j1 * LB + nb + g]) * w1}),
          Frag<2, false>({to_f32(tb[j0 * LB + nb + 8 + g]) * w0,
                          to_f32(tb[j1 * LB + nb + 8 + g]) * w1})};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int p = 16 * mi + g;
        const float av[4] = {to_f32(tx[j0 * LX + p]), to_f32(tx[j0 * LX + p + 8]),
                             to_f32(tx[j1 * LX + p]), to_f32(tx[j1 * LX + p + 8])};
        const Frag<4, kEx> af(av);
        mma(hacc[mi][0], af, bf[0]);
        mma(hacc[mi][1], af, bf[1]);
      }
    }
    if (tile + 1 < nt) {   // the next tile's C B^T, cs and w; the copy of h
      load_cb(tile + 1);   // that its C h^T reads
      if (warp == 0) {
        cp_async_wait<1>();   // the next tile's dt group
        __syncwarp();
        scan(st ^ 1);
      }
      float* hn = sh(st ^ 1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          float* ph = hn + (16 * mi + g) * kLdF + nb + 8 * ni + 2 * t;
          *reinterpret_cast<float2*>(ph) = make_float2(hacc[mi][ni][0], hacc[mi][ni][1]);
          *reinterpret_cast<float2*>(ph + 8 * kLdF) =
              make_float2(hacc[mi][ni][2], hacc[mi][ni][3]);
        }
    }
  }

  float* hb = hout + ((long long)b * H + hd) * P * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * mi + g + 8 * (e >> 1), n = nb + 8 * ni + 2 * t + (e & 1);
        if (p < pw && n < N) hb[(long long)(p0 + p) * N + n] = hacc[mi][ni][e];
      }
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B,
                   const void* C, float* cb, float* y, float* hout, int b, int s, int h, int p,
                   int n, const long long* st, cudaStream_t stream) {
  const int nt = (s + kT - 1) / kT;
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  constexpr int cb_smem = 2 * kT * Ld<T>::c * sizeof(T);
  cudaError_t e = PLAN_LAUNCH("ssd_cb_kernel", ssd_cb_kernel<T, kVec>, dim3(nt, b),
                              dim3(kThreads), cb_smem, stream, Bt, Ct, cb, s, n, st[3], st[4],
                              st[5], st[6]);
  if (e != cudaSuccess) return e;
  constexpr int smem = ScanSmem<T>::kBytes;
  static bool raised = false;
  if (!raised) {
    e = cudaFuncSetAttribute(ssd_scan_kernel<T, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid((p + kPG - 1) / kPG, h, b);
  return PLAN_LAUNCH("ssd_scan_kernel", ssd_scan_kernel<T, kVec>, grid, dim3(kThreads), smem,
                     stream, static_cast<const T*>(x), dt, A, Bt, Ct, cb, y, hout, s, h, p, n,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// ssd_any.cu includes this file for its helpers, without the entry points.
#ifndef SSD_HELPERS_ONLY
// dtype: 0 = float32, 1 = bfloat16, the type of x, B and C.  x (b, s, h, p)
// with element strides xs_b, xs_t, xs_h and a unit stride on p; B and C
// (b, s, n) with strides bs_b, bs_t and cs_b, cs_t and a unit stride on n.
// dt (b, s, h) and A (h,) contiguous f32; cb a scratch of b * ceil(s / 64)
// * 64 * 64 f32; y (b, s, h, p) and hout (b, h, p, n) contiguous f32.  p and
// n at most 64.  16-byte copies need 16-byte aligned pointers and strides
// and p, n multiples of 16 bytes; anything else stages element by element
// in the same kernels.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, void* cb, void* y, void* hout, int dtype, int b, int s,
                       int h, int p, int n, long long xs_b, long long xs_t, long long xs_h,
                       long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                       void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || h > 65535 || p < 1 || p > kD || n < 1 ||
      n > kD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[7] = {xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t};
  const int elem = dtype == 0 ? 4 : 2, per16 = 16 / elem;
  bool vec = aligned16(x) && aligned16(B) && aligned16(C) && p % per16 == 0 && n % per16 == 0;
  for (long long v : st) vec = vec && v % per16 == 0;
  const cudaStream_t q = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* cbf = static_cast<float*>(cb);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hout);
  if (dtype == 0)
    return (int)(vec ? launch<float, true>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n, st, q)
                     : launch<float, false>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n, st, q));
  return (int)(vec ? launch<__nv_bfloat16, true>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n,
                                                 st, q)
                   : launch<__nv_bfloat16, false>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n,
                                                  st, q));
}

// Query entry (launch_plan.cuh): ssd_fwd's arguments with `plans` in place
// of the stream; both launches are recorded, none made.
extern "C" int ssd_fwd_plan(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* cb, void* y, void* hout, int dtype, int b, int s,
                            int h, int p, int n, long long xs_b, long long xs_t, long long xs_h,
                            long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                            long long* plans) {
  plan::Scope scope(plans);
  return ssd_fwd(x, dt, A, B, C, cb, y, hout, dtype, b, s, h, p, n, xs_b, xs_t, xs_h, bs_b, bs_t,
                 cs_b, cs_t, nullptr);
}
#endif
