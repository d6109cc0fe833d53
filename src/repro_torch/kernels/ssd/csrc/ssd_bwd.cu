// Backward of the Mamba2 SSD (chunked state-space-dual) scan for Hopper
// (sm_90a) on the tensor cores, plain C interface.
//
// Replaces JAX's autodiff of src/repro/models/ssm.py:207 ssd_chunked (the
// JAX package differentiates the scan outside any Pallas kernel; ssd_pallas
// has no backward).  Given the forward's inputs x (b,s,h,p), dt (b,s,h),
// A (h), B and C (b,s,n, shared by the heads), the output gradient dy
// (b,s,h,p) and optionally the final state's gradient dh_final (b,h,p,n),
// it computes what ssd_bwd_ref (ref.py) computes, per 64-token tile c with
// cs the inclusive cumsum of dt A inside it, E_ij = exp(cs_i - cs_j) for
// j <= i and w_j = exp(cs_L - cs_j) dt_j:
//
//   H_c  = exp(cs_L) H_{c-1} + sum_j w_j x_j B_j^T           (state leaving c)
//   G_c  = dL/dH_c:  G_{c-1} = exp(cs_L) G_c + sum_t exp(cs_t) dy_t C_t^T
//   M_ij = (C_i . B_j) E_ij dt_j        dM_ij = dy_i . x_j
//   dx_j = sum_i M_ij dy_i + w_j G_c B_j
//   dC_i = sum_j dCB_ij B_j + exp(cs_i) H_{c-1}^T dy_i      dCB = dM E dt_j
//   dB_j = sum_i dCB_ij C_i + w_j G_c^T x_j
//   dcs  = the log-decay gradient (through M, exp(cs_i) of y's carried-state
//          term, w and exp(cs_L)); ddA = its reverse cumsum in the tile;
//          ddt += A ddA; dA = sum dt ddA
//
// x, B and C are read in place, in their own dtype (bf16 or f32), through
// strides with a unit stride on the last axis (views of the conv output
// xBC on the training path); dt, A, dy and dh_final are contiguous f32.  dx
// is written in x's dtype, rounded once from f32 (JAX casts x to f32
// before ssd_chunked); dB and dC (b,s,n) in B's dtype; ddt and dA f32.  A
// ragged tail is padded with dt = 0 and zero x, B, C, dy.  p, n <= 64.
//
// Bound on an H100 SXM: per (b, h, tile) the causal half of dy x^T and
// M^T dy over p and five full products over (p, n) (G B, H^T dy, x^T G and
// the two tile-local states); per (b, tile) the causal half of C B^T, dCB B
// and dCB^T C over n; the inputs read and the outputs written once.  At the
// train shape (b 8, s 128, h 80, p = n = 64, bf16 views) 4.05 GFLOP at the
// 2x/3xTF32 rates take 0.0184 ms against 43 MB (chip_smoke.py's
// ssd_bwd_work): the operations bound.
//
// What the design does about it (mamba_ssm's ssd_combined backward: chunk
// state, state passing, chunk scan), deterministic with no atomics:
// - ssd_bwd_state_kernel, 4 warps per (tile, head, batch): the tile-local
//   state sum_j w_j x_j B_j^T of every tile but the last and the local
//   state gradient sum_t exp(cs_t) dy_t C_t^T of every tile but the first,
//   as tensor-core products in parallel over tiles, and exp(cs_L).
// - ssd_bwd_pass_kernel, only the recurrence: one thread per (p, n) of a
//   (head, batch) walks the tiles, turning the local states into H_c and
//   the local gradients into G_c in place.  With two tiles (the train
//   shape) and no dh_final there is nothing to pass and it is not
//   launched.  Scratch: 2 * b * (tiles - 1) * h * p * n f32.
// - ssd_bwd_tile_kernel, 8 warps per (tile, head group, batch): C B^T once,
//   then for each head of the group dy x^T, M^T dy, G B, H^T dy and x^T G,
//   each warp a 16 x 32 part of a 64 x 64 result; dCB is summed over the
//   group in registers, so dC's and dB's dCB products run once a block
//   and the group's dB and dC partials go out once (b * s * groups * n f32
//   each).  M is formed on the accumulator fragments and passes through
//   shared memory, in H's buffer once H^T dy is done.  Shared bytes: x, B,
//   C in their dtype (rows padded by 16 bytes), dy, H, G in f32: 84,736 in
//   bf16 and 109,312 in f32, 2 blocks an SM either way (the launch bounds
//   hold a thread to 128 registers; ptxas spills 12 to 36 bytes).
// - Head groups: the host picks a group size that keeps about 256 blocks
//   (5 heads at the train shape: 16 groups); the last group takes what is
//   left of h.
// - Products: mma.sync m16n8k8 TF32.  An f32 operand splits into big +
//   small (3xTF32, the forward's split); a bf16 value is exact in TF32 and
//   is not split, so a product with an x, B or C operand takes two TF32
//   products on bf16 views (C B^T one) and every f32 product three.
// - The serial tails run on warp shuffles: cs is the forward's prefix sum
//   (one add after the other in token order, as torch.cumsum in the plain
//   version: each lane of warp 0 runs it and keeps its two tokens); the
//   reverse cumsum of dcs, the row and column sums of T, and dA's and
//   <G, H>'s reductions are shuffle trees in a fixed order.
// - ssd_bwd_reduce_kernel sums the groups' dB and dC partials in group
//   order and dA's partials in (b, tile) order, one thread per output.
// - exp is expf, not the fast approximation: the gradient is held against
//   float64.  Where an address or a row is not a multiple of 16 bytes, the
//   same kernels stage element by element (kVec = false).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch_plan.cuh"
#include "tc_helpers.cuh"

namespace {

constexpr int kT = 64;              // tokens per tile
constexpr int kD = 64;              // largest head dim p and state n
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared row strides (elements): the tile kernel's x, B, C in their dtype;
// dy and G in f32 read along rows (4 mod 32 floats), H and the state
// kernel's tiles read down columns (8 mod 32).  Rows are multiples of 16 B.
template <typename T>
struct Ld {
  static constexpr bool kExact = sizeof(T) == 2;   // bf16: exact in TF32
  static constexpr int in = kExact ? kD + 8 : kD + 4;
};
constexpr int kLdRow = kD + 4, kLdCol = kD + 8;

// An A (16 x 8) or B (8 x 8) fragment of an f32 operand as TF32 halves;
// small is left out where the operand is exact in TF32.
template <int K, bool kExact>
struct Frag {
  uint32_t big[K], small[K];
  __device__ __forceinline__ explicit Frag(const float (&v)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if constexpr (kExact) big[i] = __float_as_uint(v[i]);
      else split(v[i], big[i], small[i]);
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

// acc += A B over the 8-deep k-steps s_lo <= s < s_hi of 64: A(r, k) for
// the warp's 16 rows, B(k, c) for its 8 NT columns.  acc[n][e] is row
// g + 8 (e >> 1), column 8 n + 2 t + (e & 1).
template <int NT, bool kExA, bool kExB, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[NT][4], int s_lo, int s_hi, FA a_at, FB b_at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < kD / 8; ++s) {
    if (s < s_lo || s >= s_hi) continue;
    const int k = 8 * s + t;
    const Frag<4, kExA> af({a_at(g, k), a_at(g + 8, k), a_at(g, k + 4), a_at(g + 8, k + 4)});
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const Frag<2, kExB> bf({b_at(k, 8 * n + g), b_at(k + 4, 8 * n + g)});
      mma(acc[n], af, bf);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// fn(r, c, n, e) for each element acc[n][e] of the warp's tile: row r = g
// + 8 (e >> 1), column c = 8 n + 2 t + (e & 1)
template <int NT, typename F>
__device__ __forceinline__ void each(float (&acc)[NT][4], F fn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) fn(g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1), n, e);
}

// v[q], a thread's part of row g + 8 q of the warp's tile, summed over the
// quad (its columns) into dst[g + 8 q]
__device__ __forceinline__ void quad_rows(float (&v)[2], float* dst) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    v[q] += __shfl_xor_sync(kFull, v[q], 1);
    v[q] += __shfl_xor_sync(kFull, v[q], 2);
    if ((lane & 3) == 0) dst[(lane >> 2) + 8 * q] = v[q];
  }
}

// Rows and columns 0 .. 63 of a (rows, stride) slice into a shared tile of
// row stride LD, 0 past n_rows and cols.  kVec: 16-byte cp.async (16-byte
// aligned rows, cols a multiple of 16 bytes); otherwise element by element.
template <typename T, int LD, bool kVec, int kThreads>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride, int n_rows,
                                      int cols) {
  // not unrolled: the compiler kept every copy's offset live across the
  // tile kernel's head loop and spilled 304 bytes
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T), kChunks = kD / kE;
#pragma unroll 1
    for (int i = threadIdx.x; i < kT * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kE;
      const bool valid = r < n_rows && c < cols;
      cp_async16(dst + r * LD + c, valid ? src + r * stride + c : src, valid);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
      const int r = i / kD, c = i % kD;
      dst[r * LD + c] = (r < n_rows && c < cols) ? src[r * stride + c] : T(0.f);
    }
  }
}

// dt of one (tile, head), zero past s, by the first 64 threads
__device__ __forceinline__ void stage_dt(float* sdt, const float* dt, long long b, int t0, int S,
                                         int H, int hd) {
  const int r = threadIdx.x;
  if (r < kT) cp_async4(sdt + r, t0 + r < S ? dt + (b * S + t0 + r) * H + hd : dt, t0 + r < S);
}

// Warp 0: cs, exp(cs) and w of the tile, from its dt.  cs is the forward's
// prefix sum, one add after the other in token order; each lane runs it
// and keeps tokens lane and lane + 32.  Returns cs_L.
__device__ __forceinline__ float scan_cs(const float* sdt, float a, float* cs, float* ecs,
                                        float* w) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f, c_lo = 0.f, c_hi = 0.f;
#pragma unroll 8
  for (int i = 0; i < kT; ++i) {
    acc = __fadd_rn(acc, __fmul_rn(sdt[i], a));
    if (i == lane) c_lo = acc;
    if (i == lane + 32) c_hi = acc;
  }
  cs[lane] = c_lo;
  cs[lane + 32] = c_hi;
  ecs[lane] = expf(c_lo);
  ecs[lane + 32] = expf(c_hi);
  w[lane] = expf(acc - c_lo) * sdt[lane];
  w[lane + 32] = expf(acc - c_hi) * sdt[lane + 32];
  return acc;
}

// ---------------------------------------------------------------------------
// tile-local states

template <typename T>
struct StateSmem {
  static constexpr int kIn = kT * kLdCol * sizeof(T);   // x, B, C
  static constexpr int kDy = kT * kLdCol * 4;
  static constexpr int kBytes = 3 * kIn + kDy + 4 * kT * 4;   // + dt, cs, ecs, w
  static_assert(kIn % 16 == 0 && kBytes <= 232448, "a block has 227 KB of shared memory");
};

// Block (tile c, head, batch): tile c's local state (c < tiles - 1) into
// hst slot c, its local state gradient (c > 0) into gst slot c - 1, and
// exp(cs_L) into decay.  Warp w: rows p = 16 w .. 16 w + 15, all of n.
template <typename T, bool kVec>
__global__ void __launch_bounds__(128)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ C, const float* __restrict__ dy,
                     float* __restrict__ hst, float* __restrict__ gst,
                     float* __restrict__ decay, int S, int H, int P, int N, long long xs_b,
                     long long xs_t, long long xs_h, long long bs_b, long long bs_t,
                     long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int LI = kLdCol;
  using Sm = StateSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sX = reinterpret_cast<T*>(smem_raw);
  T* sB = reinterpret_cast<T*>(smem_raw + Sm::kIn);
  T* sC = reinterpret_cast<T*>(smem_raw + 2 * Sm::kIn);
  float* sDy = reinterpret_cast<float*>(smem_raw + 3 * Sm::kIn);
  float* sDt = sDy + kT * kLdCol;
  float *sCs = sDt + kT, *sEcs = sCs + kT, *sW = sEcs + kT;

  const int c = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nt = gridDim.x;
  const int t0 = c * kT, rows = min(kT, S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, p0 = 16 * warp;
  const bool fwd = c < nt - 1, bwd = c > 0;
  if (fwd) {
    stage<T, LI, kVec, 128>(sB, B + b * bs_b + t0 * bs_t, bs_t, rows, N);
    stage<T, LI, kVec, 128>(sX, x + b * xs_b + t0 * xs_t + hd * xs_h, xs_t, rows, P);
  }
  if (bwd) {
    stage<T, LI, kVec, 128>(sC, C + b * cs_b + t0 * cs_t, cs_t, rows, N);
    stage<float, kLdCol, kVec, 128>(sDy, dy + (((long long)b * S + t0) * H + hd) * P,
                                    (long long)H * P, rows, P);
  }
  stage_dt(sDt, dt, b, t0, S, H, hd);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    const float cs_last = scan_cs(sDt, A[hd], sCs, sEcs, sW);
    if (lane == 0) decay[((long long)b * nt + c) * H + hd] = expf(cs_last);
  }
  __syncthreads();

  float acc[8][4];
  auto store = [&](float* base, int slot) {
    float* o = base + (((long long)b * (nt - 1) + slot) * H + hd) * P * N;
    each(acc, [&](int r, int cc, int n, int e) {
      if (p0 + r < P && cc < N) o[(p0 + r) * N + cc] = acc[n][e];
    });
  };
  if (fwd) {   // sum_j x_j[p] (w_j B_j[n])
    zero(acc);
    mm<8, kEx, false>(acc, 0, 8, [&](int r, int k) { return to_f32(sX[k * LI + p0 + r]); },
                      [&](int k, int n) { return sW[k] * to_f32(sB[k * LI + n]); });
    store(hst, c);
  }
  if (bwd) {   // sum_t (exp(cs_t) dy_t[p]) C_t[n]
    zero(acc);
    mm<8, false, kEx>(
        acc, 0, 8, [&](int r, int k) { return sEcs[k] * sDy[k * kLdCol + p0 + r]; },
        [&](int k, int n) { return to_f32(sC[k * LI + n]); });
    store(gst, c - 1);
  }
}

// The recurrence, in place, one thread per (p, n) of a (head, batch): hst
// slot c becomes H_c = exp(cs_L of c) H_{c-1} + local_c (slot 0 is H_0),
// gst slot c G_c = exp(cs_L of c + 1) G_{c+1} + local'_{c+1}, G_last = dhf.
__global__ void __launch_bounds__(256)
ssd_bwd_pass_kernel(float* __restrict__ hst, float* __restrict__ gst,
                    const float* __restrict__ decay, const float* __restrict__ dhf, int nt,
                    int H, int PN) {
  const int e = blockIdx.x * 256 + threadIdx.x, hd = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  auto at = [&](float* base, int c) {
    return base + (((long long)b * (nt - 1) + c) * H + hd) * PN + e;
  };
  const float* dec = decay + (long long)b * nt * H + hd;
  float run = *at(hst, 0);
  for (int c = 1; c < nt - 1; ++c) {
    run = fmaf(run, dec[(long long)c * H], *at(hst, c));
    *at(hst, c) = run;
  }
  run = dhf != nullptr ? dhf[((long long)b * H + hd) * PN + e] : 0.f;
  for (int c = nt - 2; c >= 0; --c) {
    run = fmaf(run, dec[(long long)(c + 1) * H], *at(gst, c));
    *at(gst, c) = run;
  }
}

// ---------------------------------------------------------------------------
// the tile's gradient terms

constexpr int kTileThreads = 256;   // 8 warps: 4 row blocks of 16 x 2 column halves of 32

// per-token vectors of the tile kernel, 64 floats each
enum Vec { kDt, kCs, kEcs, kW, kColT, kRowT = kColT + 2, kYoff = kRowT + 4, kDw = kYoff + 2,
           kRed = kDw + 2, kVecs };

template <typename T>
struct TileSmem {
  static constexpr int kIn = kT * Ld<T>::in * sizeof(T);   // x, B, C
  static constexpr int kRow = kT * kLdRow * 4;              // dy, G
  static constexpr int kCol = kT * kLdCol * 4;              // H, then M, then dCB
  static constexpr int kBytes = 3 * kIn + 2 * kRow + kCol + kVecs * kT * 4;
  static_assert(kIn % 16 == 0 && 2 * (kBytes + 1024) <= 233472, "two blocks an SM");
};

// Block (tile c, head group, batch): every gradient term of its heads.  dx
// and ddt are final here; the group's dB and dC go to dbp and dcp (b, s,
// groups, n) f32, and dA's partial of (b, c, h) to dapart.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kTileThreads, 2)
ssd_bwd_tile_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ B,
                    const T* __restrict__ C, const float* __restrict__ dy,
                    const float* __restrict__ dhf, const float* __restrict__ hst,
                    const float* __restrict__ gst, T* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dbp, float* __restrict__ dcp,
                    float* __restrict__ dapart, int S, int H, int P, int N, int group,
                    long long xs_b, long long xs_t, long long xs_h, long long bs_b,
                    long long bs_t, long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int LI = Ld<T>::in;
  using Sm = TileSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sX = reinterpret_cast<T*>(smem_raw);
  T* sB = reinterpret_cast<T*>(smem_raw + Sm::kIn);
  T* sC = reinterpret_cast<T*>(smem_raw + 2 * Sm::kIn);
  float* sDy = reinterpret_cast<float*>(smem_raw + 3 * Sm::kIn);
  float* sG = sDy + kT * kLdRow;
  float* sH = sG + kT * kLdRow;            // H, then M (rows j, columns i), then dCB
  float* vec = sH + kT * kLdCol;
  auto V = [&](int v) { return vec + v * kT; };
  float *sDt = V(kDt), *sCs = V(kCs), *sEcs = V(kEcs), *sW = V(kW), *sRed = V(kRed);

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, nt = gridDim.x;
  const int h0 = grp * group, h1 = min(H, h0 + group);
  const int t0 = c * kT, rows = min(kT, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;        // rows 16 wr .., columns 32 wc ..
  const int r0 = 16 * wr, c0 = 32 * wc;
  const bool has_h = c > 0, has_g = c < nt - 1 || dhf != nullptr;
  const bool live = !(wc == 0 && wr >= 2);        // some pair of the warp has i >= j
  const long long slot = (long long)P * N;

  stage<T, LI, kVec, kTileThreads>(sB, B + b * bs_b + t0 * bs_t, bs_t, rows, N);
  stage<T, LI, kVec, kTileThreads>(sC, C + b * cs_b + t0 * cs_t, cs_t, rows, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T as CB^T (rows j, columns i), B_j . C_i, once for the block
  float cbt[4][4] = {}, dcbt[4][4] = {}, dcacc[4][4] = {}, dbacc[4][4] = {}, acc[4][4];
  if (live)
    mm<4, kEx, kEx>(cbt, 0, 8, [&](int r, int k) { return to_f32(sB[(r0 + r) * LI + k]); },
                    [&](int k, int cc) { return to_f32(sC[(c0 + cc) * LI + k]); });

  for (int hd = h0; hd < h1; ++hd) {
    const float a = A[hd];
    stage<T, LI, kVec, kTileThreads>(sX, x + b * xs_b + t0 * xs_t + hd * xs_h, xs_t, rows, P);
    stage<float, kLdRow, kVec, kTileThreads>(sDy, dy + (((long long)b * S + t0) * H + hd) * P,
                                             (long long)H * P, rows, P);
    if (has_h)
      stage<float, kLdCol, kVec, kTileThreads>(
          sH, hst + (((long long)b * (nt - 1) + c - 1) * H + hd) * slot, N, P, N);
    if (has_g)
      stage<float, kLdRow, kVec, kTileThreads>(
          sG, c < nt - 1 ? gst + (((long long)b * (nt - 1) + c) * H + hd) * slot
                         : dhf + ((long long)b * H + hd) * slot, N, P, N);
    stage_dt(sDt, dt, b, t0, S, H, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // cs, exp(cs), w; <G, H> for the state's decay, in a fixed order
    if (warp == 0) scan_cs(sDt, a, sCs, sEcs, sW);
    if (has_h && has_g) {
      float gh = 0.f;
      for (int i = tid; i < kD * kD; i += kTileThreads)
        gh = fmaf(sG[(i / kD) * kLdRow + i % kD], sH[(i / kD) * kLdCol + i % kD], gh);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(kFull, gh, o);
      if (lane == 0) sRed[warp] = gh;
    }
    __syncthreads();

    // dC_i += exp(cs_i) H^T dy_i (rows i, columns n); y's carried-state
    // term gives dcs_i its share sum_n C_i[n] exp(cs_i) (H^T dy_i)[n]
    float part[2] = {0.f, 0.f};
    if (has_h) {
      zero(acc);
      mm<4, false, false>(acc, 0, 8, [&](int r, int k) { return sDy[(r0 + r) * kLdRow + k]; },
                          [&](int k, int cc) { return sH[k * kLdCol + c0 + cc]; });
      each(acc, [&](int r, int cc, int n, int e) {
        const float v = sEcs[r0 + r] * acc[n][e];
        dcacc[n][e] += v;
        part[r >> 3] = fmaf(to_f32(sC[(r0 + r) * LI + c0 + cc]), v, part[r >> 3]);
      });
    }
    quad_rows(part, V(kYoff + wc) + r0);

    // dM^T (rows j, columns i) = x_j . dy_i, then M^T, dCB^T and T^T on the
    // causal pairs i >= j; colT_j = sum_i T_ij (a row of T^T: the quad,
    // then the column halves), rowT_i = sum_j T_ij dt_j (a column: the 8
    // row groups, then the row blocks)
    float mt[4][4], rowp[4][2] = {};
    zero(acc);
    if (live)
      mm<4, kEx, false>(acc, 0, 8, [&](int r, int k) { return to_f32(sX[(r0 + r) * LI + k]); },
                        [&](int k, int cc) { return sDy[(c0 + cc) * kLdRow + k]; });
    part[0] = part[1] = 0.f;
    each(acc, [&](int r, int cc, int n, int e) {
      const int j = r0 + r, i = c0 + cc;
      float m = 0.f, d = 0.f, tt = 0.f;
      if (i >= j) {   // a select: exp of i < j may overflow
        const float ee = expf(sCs[i] - sCs[j]);
        m = cbt[n][e] * ee * sDt[j];
        d = acc[n][e] * ee * sDt[j];
        tt = acc[n][e] * cbt[n][e] * ee;
      }
      mt[n][e] = m;
      dcbt[n][e] += d;
      part[r >> 3] += tt;
      rowp[n][e & 1] = fmaf(tt, sDt[j], rowp[n][e & 1]);
    });
    quad_rows(part, V(kColT + wc) + r0);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = rowp[n][q];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
        if (g == 0) V(kRowT + wr)[c0 + 8 * n + 2 * t + q] = v;
      }
    __syncthreads();   // every warp is done with H
    float* sM = sH;
    each(mt, [&](int r, int cc, int n, int e) { sM[(r0 + r) * kLdCol + c0 + cc] = mt[n][e]; });
    __syncthreads();

    // dx_j = w_j G B_j + sum_i M_ij dy_i (rows j, columns p); dw_j = x_j . G B_j
    zero(acc);
    part[0] = part[1] = 0.f;
    if (has_g) {
      mm<4, kEx, false>(acc, 0, 8, [&](int r, int k) { return to_f32(sB[(r0 + r) * LI + k]); },
                        [&](int k, int cc) { return sG[(c0 + cc) * kLdRow + k]; });
      each(acc, [&](int r, int cc, int n, int e) {
        part[r >> 3] = fmaf(to_f32(sX[(r0 + r) * LI + c0 + cc]), acc[n][e], part[r >> 3]);
        acc[n][e] *= sW[r0 + r];
      });
    }
    quad_rows(part, V(kDw + wc) + r0);
    mm<4, false, false>(acc, 2 * wr, 8, [&](int r, int k) { return sM[(r0 + r) * kLdCol + k]; },
                        [&](int k, int cc) { return sDy[k * kLdRow + c0 + cc]; });
    each(acc, [&](int r, int cc, int n, int e) {
      if (r0 + r < rows && c0 + cc < P)
        st(dx + (((long long)b * S + t0 + r0 + r) * H + hd) * P + c0 + cc, acc[n][e]);
    });

    // dB_j += w_j G^T x_j (rows j, columns n)
    if (has_g) {
      zero(acc);
      mm<4, kEx, false>(acc, 0, 8, [&](int r, int k) { return to_f32(sX[(r0 + r) * LI + k]); },
                        [&](int k, int cc) { return sG[k * kLdRow + c0 + cc]; });
      each(acc, [&](int r, int, int n, int e) {
        dbacc[n][e] = fmaf(sW[r0 + r], acc[n][e], dbacc[n][e]);
      });
    }
    __syncthreads();   // every partial of this head is in shared memory

    // dcs, its reverse cumsum ddA, ddt and dA's partial (warp 0, two tokens
    // a lane: lane and lane + 32)
    if (warp == 0) {
      float gh = 0.f;
      if (has_h && has_g)
        for (int i = 0; i < kTileThreads / 32; ++i) gh += sRed[i];
      float d[2], dwv[2], colT[2], wdw = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int u = lane + 32 * q;
        const float rowT = V(kRowT)[u] + V(kRowT + 1)[u] + V(kRowT + 2)[u] + V(kRowT + 3)[u];
        colT[q] = V(kColT)[u] + V(kColT + 1)[u];
        dwv[q] = V(kDw)[u] + V(kDw + 1)[u];
        d[q] = rowT - sDt[u] * colT[q] + V(kYoff)[u] + V(kYoff + 1)[u] - sW[u] * dwv[q];
        wdw = fmaf(sW[u], dwv[q], wdw);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) wdw += __shfl_xor_sync(kFull, wdw, o);
      if (lane == 31) d[1] += sEcs[kT - 1] * gh + wdw;
      // reverse inclusive scans: tokens 32 .. 63, then 0 .. 31 plus their sum
#pragma unroll
      for (int q = 1; q >= 0; --q)
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_down_sync(kFull, d[q], o);
          if (lane + o < 32) d[q] += v;
        }
      d[0] += __shfl_sync(kFull, d[1], 0);
      float da = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int u = lane + 32 * q;
        da = fmaf(sDt[u], d[q], da);
        if (u < rows)
          ddt[((long long)b * S + t0 + u) * H + hd] =
              colT[q] + expf(sCs[kT - 1] - sCs[u]) * dwv[q] + a * d[q];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(kFull, da, o);
      if (lane == 0) dapart[((long long)b * nt + c) * H + hd] = da;
    }
    __syncthreads();   // the next head's copies reuse the tiles and vectors
  }

  // dCB (summed over the group's heads) through shared memory as dCB^T;
  // dC_i += sum_{j <= i} dCB_ij B_j, dB_j += sum_{i >= j} dCB_ij C_i
  float* sD = sH;
  each(dcbt, [&](int r, int cc, int n, int e) { sD[(r0 + r) * kLdCol + c0 + cc] = dcbt[n][e]; });
  __syncthreads();
  mm<4, false, kEx>(dcacc, 0, 2 * wr + 2, [&](int r, int k) { return sD[k * kLdCol + r0 + r]; },
                    [&](int k, int cc) { return to_f32(sB[k * LI + c0 + cc]); });
  mm<4, false, kEx>(dbacc, 2 * wr, 8, [&](int r, int k) { return sD[(r0 + r) * kLdCol + k]; },
                    [&](int k, int cc) { return to_f32(sC[k * LI + c0 + cc]); });
  each(dcacc, [&](int r, int cc, int n, int e) {
    if (r0 + r < rows && c0 + cc < N) {
      const long long o = (((long long)b * S + t0 + r0 + r) * gridDim.y + grp) * N + c0 + cc;
      dcp[o] = dcacc[n][e];
      dbp[o] = dbacc[n][e];
    }
  });
}

// dB, dC: the groups' partials summed in group order, one thread per (b, t,
// n); the last block sums dA's (b, tile) partials in order.
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                      const float* __restrict__ dapart, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, long long rows_n, int ngroups, int N, int H,
                      int parts) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += 256) {
      float s = 0.f;
      for (int i = 0; i < parts; ++i) s += dapart[(long long)i * H + h];
      dA[h] = s;
    }
    return;
  }
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;   // (b, t) * N + n
  if (e >= rows_n) return;
  const long long off = e / N * ngroups * N + e % N;
  const float *pb = dbp + off, *pc = dcp + off;
  float sb = 0.f, sc = 0.f;
  for (int q = 0; q < ngroups; ++q) {
    sb += pb[(long long)q * N];
    sc += pc[(long long)q * N];
  }
  st(dB + e, sb);
  st(dC + e, sc);
}

struct Args {
  const void *x, *B, *C;
  const float *dt, *A, *dy, *dhf;
  float *hst, *gst, *decay, *ddt, *dbp, *dcp, *dapart, *dA;
  void *dx, *dB, *dC;
  int b, s, h, p, n, group;
  long long st[7];
};

template <typename K>
cudaError_t raise_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, bool kVec>
cudaError_t launch(const Args& r, cudaStream_t stream) {
  const int nt = (r.s + kT - 1) / kT, ngroups = (r.h + r.group - 1) / r.group;
  const T* x = static_cast<const T*>(r.x);
  const T* B = static_cast<const T*>(r.B);
  const T* C = static_cast<const T*>(r.C);
  const long long* s = r.st;
  static bool raised = false;
  cudaError_t e;
  if (!raised) {
    e = raise_smem(ssd_bwd_state_kernel<T, kVec>, StateSmem<T>::kBytes);
    if (e != cudaSuccess || (e = raise_smem(ssd_bwd_tile_kernel<T, kVec>,
                                            TileSmem<T>::kBytes)) != cudaSuccess)
      return e;
    raised = true;
  }
  if (nt > 1) {
    e = PLAN_LAUNCH("ssd_bwd_state_kernel", ssd_bwd_state_kernel<T, kVec>, dim3(nt, r.h, r.b),
                    dim3(128), StateSmem<T>::kBytes, stream, x, r.dt, r.A, B, C, r.dy, r.hst,
                    r.gst, r.decay, r.s, r.h, r.p, r.n, s[0], s[1], s[2], s[3], s[4], s[5],
                    s[6]);
    if (e != cudaSuccess) return e;
    if (nt > 2 || r.dhf != nullptr) {
      const int pn = r.p * r.n;
      e = PLAN_LAUNCH("ssd_bwd_pass_kernel", ssd_bwd_pass_kernel,
                      dim3((pn + 255) / 256, r.h, r.b), dim3(256), 0, stream, r.hst, r.gst,
                      r.decay, r.dhf, nt, r.h, pn);
      if (e != cudaSuccess) return e;
    }
  }
  e = PLAN_LAUNCH("ssd_bwd_tile_kernel", ssd_bwd_tile_kernel<T, kVec>, dim3(nt, ngroups, r.b),
                  dim3(kTileThreads), TileSmem<T>::kBytes, stream, x, r.dt, r.A, B, C, r.dy,
                  r.dhf, r.hst, r.gst, static_cast<T*>(r.dx), r.ddt, r.dbp, r.dcp, r.dapart, r.s,
                  r.h, r.p, r.n, r.group, s[0], s[1], s[2], s[3], s[4], s[5], s[6]);
  if (e != cudaSuccess) return e;
  const long long rows_n = (long long)r.b * r.s * r.n;
  const long long blocks = (rows_n + 255) / 256 + 1;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  return PLAN_LAUNCH("ssd_bwd_reduce_kernel", ssd_bwd_reduce_kernel<T>, dim3((unsigned)blocks),
                     dim3(256), 0, stream, r.dbp, r.dcp, r.dapart, static_cast<T*>(r.dB),
                     static_cast<T*>(r.dC), r.dA, rows_n, ngroups, r.n, r.h, r.b * nt);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// ssd_bwd_any.cu includes this file for its helpers, without the entry
// points.
#ifndef SSD_HELPERS_ONLY
// dtype: 0 = float32, 1 = bfloat16, the type of x, B, C, dx, dB and dC.  x
// (b, s, h, p) with strides xs_b, xs_t, xs_h; B and C (b, s, n) with
// strides bs_b, bs_t and cs_b, cs_t; unit strides on p and n.  dt, A, dy
// and dhf (b, h, p, n, or null for 0) contiguous f32.  group: heads a tile
// block walks (1 .. h).  Scratch, f32: hst and gst (b, tiles - 1, h, p, n),
// decay and dapart (b, tiles, h), dbp and dcp (b, s, ceil(h / group), n).
// Outputs, contiguous: dx (b, s, h, p), dB and dC (b, s, n) in dtype, ddt
// (b, s, h) and dA (h,) f32.  p, n <= 64.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* dy, const void* dhf, void* hst, void* gst,
                       void* decay, void* dx, void* ddt, void* dbp, void* dcp, void* dapart,
                       void* dB, void* dC, void* dA, int dtype, int b, int s, int h, int p,
                       int n, int group, long long xs_b, long long xs_t, long long xs_h,
                       long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                       void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || p < 1 || p > kD || n < 1 || n > kD ||
      (dtype != 0 && dtype != 1) || group < 1 || group > h || h > 65535)
    return (int)cudaErrorInvalidValue;
  Args r{x, B, C, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(dy), static_cast<const float*>(dhf),
         static_cast<float*>(hst), static_cast<float*>(gst), static_cast<float*>(decay),
         static_cast<float*>(ddt), static_cast<float*>(dbp), static_cast<float*>(dcp),
         static_cast<float*>(dapart), static_cast<float*>(dA), dx, dB, dC, b, s, h, p, n, group,
         {xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t}};
  const int elem = dtype == 0 ? 4 : 2, per16 = 16 / elem;
  bool vec = aligned16(x) && aligned16(B) && aligned16(C) && aligned16(dy) &&
             (dhf == nullptr || aligned16(dhf)) && aligned16(hst) && aligned16(gst) &&
             p % per16 == 0 && n % per16 == 0;
  for (long long v : r.st) vec = vec && v % per16 == 0;
  const cudaStream_t q = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vec ? launch<float, true>(r, q) : launch<float, false>(r, q));
  return (int)(vec ? launch<__nv_bfloat16, true>(r, q) : launch<__nv_bfloat16, false>(r, q));
}

// Query entry (launch_plan.cuh): ssd_bwd's arguments with `plans` in place
// of the stream; every launch is recorded, none made.
extern "C" int ssd_bwd_plan(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* dy, const void* dhf, void* hst, void* gst,
                            void* decay, void* dx, void* ddt, void* dbp, void* dcp,
                            void* dapart, void* dB, void* dC, void* dA, int dtype, int b, int s,
                            int h, int p, int n, int group, long long xs_b, long long xs_t,
                            long long xs_h, long long bs_b, long long bs_t, long long cs_b,
                            long long cs_t, long long* plans) {
  plan::Scope scope(plans);
  return ssd_bwd(x, dt, A, B, C, dy, dhf, hst, gst, decay, dx, ddt, dbp, dcp, dapart, dB, dC, dA,
                 dtype, b, s, h, p, n, group, xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t, nullptr);
}
#endif
