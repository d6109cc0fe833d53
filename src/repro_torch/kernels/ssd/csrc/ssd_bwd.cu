// Backward of the Mamba2 SSD (chunked state-space-dual) scan for Hopper
// (sm_90a), plain C interface.
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
// strides with a unit stride on the last axis (on the training path they
// are views of the conv output xBC).  dt, A, dy and dh_final are contiguous
// f32.  dx is written contiguous in x's dtype, rounded once from f32 (JAX
// casts x to f32 before ssd_chunked, so its gradient rounds once); dB and
// dC contiguous (b,s,n) in B's dtype; ddt and dA f32.  A ragged tail is
// padded with dt = 0 and zero x, B, C, dy, as in the forward.
//
// Bound on an H100 SXM: about ten products of 2 * 64^3 operations per
// (b, h, tile) (C B^T, dy x^T, M^T dy, G B, dCB B, dy H, dCB^T C, x G and
// the two state passes), against x, B, C, dy, dt read once and dx, ddt, dB,
// dC written once.  At zamba2-2.7b's serving shape (b 4, s 512, h 80,
// p = n = 64) that is about 13 GFLOP against about 110 MB: the operations
// bound on the f32 CUDA cores, the tensor cores' 3xTF32 rate on a later
// redesign.
//
// What the design does about it: a simple, deterministic SIMT kernel in
// f32 with no atomics (the tensor-core redesign is later work, PERF.md):
// - ssd_bwd_state_kernel, one block per (head, batch): walks the tiles
//   forward, writing the state entering each (H_{c-1}, recomputed rather
//   than saved by the forward, so the serving kernels in ssd.cu do not
//   change), then backward, writing G_c for each.  Each thread holds 16 of
//   the 64 x 64 state in registers.  Scratch: 2 * b * tiles * h * p * n f32.
// - ssd_bwd_tile_kernel, one block of 256 threads per (tile, head, batch):
//   stages x, dy, B, C, H_{c-1} and G_c of the tile as f32 in shared memory
//   (169 KB), forms M, dCB and T = dM (C.B) E as 64 x 64 tiles, and each
//   thread computes a 4 x 4 patch of every 64 x 64 product.  dx and ddt are
//   final here; dB and dC of this head, and dA's partial of this (b, tile),
//   go to f32 scratch.
// - ssd_bwd_reduce_kernel sums the heads' dB and dC partials in head order
//   and dA's partials in (b, tile) order, one thread per output: no
//   atomics, so a rerun is bitwise equal.
// - cs is the forward's prefix sum (one add after the other in token
//   order); exp is expf, not the fast approximation: the gradient is held
//   against float64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;              // tokens per tile
constexpr int kD = 64;              // largest head dim p and state n
constexpr int kLd = kD + 1;         // shared row stride (floats)
constexpr int kMat = kT * kLd;      // one staged 64 x 64 f32 tile
constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Rows 0 .. 63 and columns 0 .. 63 of a (rows, stride) slice with a unit
// column stride into an f32 shared tile; rows >= n_rows and columns >= cols
// become 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride, int n_rows,
                                      int cols) {
  for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    dst[r * kLd + c] = (r < n_rows && c < cols) ? ld(src + r * stride + c) : 0.f;
  }
}

// dt of one tile (zero past s) and, by thread 0, its prefix sum cs in the
// forward's order
__device__ __forceinline__ void stage_dt(float* sdt, const float* dt, long long b, int t0, int S,
                                         int H, int hd) {
  for (int r = threadIdx.x; r < kT; r += kThreads)
    sdt[r] = t0 + r < S ? dt[(b * S + t0 + r) * H + hd] : 0.f;
}
__device__ __forceinline__ void scan_cs(const float* sdt, float a, float* cs) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < kT; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(sdt[i], a));
      cs[i] = acc;
    }
  }
}

// The states entering (hin) and the gradients leaving (gout) every tile of
// one (head, batch): (b, tiles, h, p, n) f32 each.  Thread t holds row
// p = t / 4, columns n = 16 (t % 4) .. + 15 of the state.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ B,
                     const T* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ dhf, float* __restrict__ hin,
                     float* __restrict__ gout, int S, int H, int P, int N, long long xs_b,
                     long long xs_t, long long xs_h, long long bs_b, long long bs_t,
                     long long cs_b, long long cs_t) {
  __shared__ float sa[kMat], sb[kMat], sdt[kT], scs[kT], sw[kT];
  const int hd = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int pr = tid >> 2, n0 = (tid & 3) * 16;
  const int nt = (S + kT - 1) / kT;
  const float a = A[hd];
  float acc[16];
  auto out_row = [&](float* base, int tile) {
    return base + ((((long long)b * nt + tile) * H + hd) * P + pr) * N;
  };

  // forward: H_{c-1}, then H_c = exp(cs_L) H_{c-1} + sum_j w_j x_j B_j^T
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int tile = 0; tile < nt; ++tile) {
    const int t0 = tile * kT, rows = min(kT, S - t0);
    stage(sa, x + b * xs_b + t0 * xs_t + hd * xs_h, xs_t, rows, P);
    stage(sb, B + b * bs_b + t0 * bs_t, bs_t, rows, N);
    stage_dt(sdt, dt, b, t0, S, H, hd);
    __syncthreads();
    scan_cs(sdt, a, scs);
    __syncthreads();
    if (tid < kT) sw[tid] = expf(scs[kT - 1] - scs[tid]) * sdt[tid];
    if (pr < P) {
      float* o = out_row(hin, tile);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (n0 + i < N) o[n0 + i] = acc[i];
    }
    __syncthreads();
    const float decay = expf(scs[kT - 1]);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= decay;
    for (int j = 0; j < kT; ++j) {
      const float xw = sa[j * kLd + pr] * sw[j];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(xw, sb[j * kLd + n0 + i], acc[i]);
    }
    __syncthreads();
  }

  // backward: G_c, then G_{c-1} = exp(cs_L) G_c + sum_t exp(cs_t) dy_t C_t^T
#pragma unroll
  for (int i = 0; i < 16; ++i)
    acc[i] = (dhf != nullptr && pr < P && n0 + i < N)
                 ? dhf[(((long long)b * H + hd) * P + pr) * N + n0 + i]
                 : 0.f;
  for (int tile = nt - 1; tile >= 0; --tile) {
    const int t0 = tile * kT, rows = min(kT, S - t0);
    stage(sa, dy + (((long long)b * S + t0) * H + hd) * P, (long long)H * P, rows, P);
    stage(sb, C + b * cs_b + t0 * cs_t, cs_t, rows, N);
    stage_dt(sdt, dt, b, t0, S, H, hd);
    __syncthreads();
    scan_cs(sdt, a, scs);
    __syncthreads();
    if (tid < kT) sw[tid] = expf(scs[tid]);
    if (pr < P) {
      float* o = out_row(gout, tile);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (n0 + i < N) o[n0 + i] = acc[i];
    }
    __syncthreads();
    const float decay = expf(scs[kT - 1]);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= decay;
    for (int t = 0; t < kT; ++t) {
      const float de = sa[t * kLd + pr] * sw[t];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(de, sb[t * kLd + n0 + i], acc[i]);
    }
    __syncthreads();
  }
}

// Shared layout of the tile kernel: ten 64 x 64 f32 tiles, then vectors.
enum Mat { kX, kDY, kB, kC, kHin, kGout, kM, kDCB, kTT, kGB, kMats };
enum Vec { kDt, kCs, kEcs, kW, kDw, kColT, kRowT, kYoff, kDcs, kVecs };
constexpr int kTileSmem = (kMats * kMat + kVecs * kT + 8) * 4;
static_assert(kTileSmem <= 232448, "a block has 227 KB of shared memory");

// acc[ra][cb] += sum_k P(ty + 16 ra, k) Q(k, tx + 16 cb), k < 64
template <typename FP, typename FQ>
__device__ __forceinline__ void mm(float (&acc)[4][4], int ty, int tx, FP pget, FQ qget) {
#pragma unroll 4
  for (int k = 0; k < kD; ++k) {
    float pv[4], qv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = pget(ty + 16 * r, k);
#pragma unroll
    for (int c = 0; c < 4; ++c) qv[c] = qget(k, tx + 16 * c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pv[r], qv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// Every gradient term of one (tile, head, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_tile_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ B,
                    const T* __restrict__ C, const float* __restrict__ dy,
                    const float* __restrict__ hin, const float* __restrict__ gout,
                    T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbh,
                    float* __restrict__ dch, float* __restrict__ dapart, int S, int H, int P,
                    int N, long long xs_b, long long xs_t, long long xs_h, long long bs_b,
                    long long bs_t, long long cs_b, long long cs_t) {
  extern __shared__ __align__(16) float smem[];
  auto mat = [&](int m) { return smem + m * kMat; };
  auto vec = [&](int v) { return smem + kMats * kMat + v * kT; };
  float* red = smem + kMats * kMat + kVecs * kT;     // 8 warp partials
  float *X = mat(kX), *DY = mat(kDY), *Bm = mat(kB), *Cm = mat(kC);
  float *HIN = mat(kHin), *GOUT = mat(kGout), *M = mat(kM), *DCB = mat(kDCB);
  float *TT = mat(kTT), *GB = mat(kGB);
  float *sdt = vec(kDt), *cs = vec(kCs), *ecs = vec(kEcs), *w = vec(kW), *dw = vec(kDw);
  float *colT = vec(kColT), *rowT = vec(kRowT), *yoff = vec(kYoff), *dcs = vec(kDcs);

  const int tile = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int nt = gridDim.x, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int t0 = tile * kT, rows = min(kT, S - t0);
  const float a = A[hd];
  const long long st_off = (((long long)b * nt + tile) * H + hd) * P * N;

  stage(X, x + b * xs_b + t0 * xs_t + hd * xs_h, xs_t, rows, P);
  stage(DY, dy + (((long long)b * S + t0) * H + hd) * P, (long long)H * P, rows, P);
  stage(Bm, B + b * bs_b + t0 * bs_t, bs_t, rows, N);
  stage(Cm, C + b * cs_b + t0 * cs_t, cs_t, rows, N);
  stage(HIN, hin + st_off, N, P, N);
  stage(GOUT, gout + st_off, N, P, N);
  stage_dt(sdt, dt, b, t0, S, H, hd);
  __syncthreads();
  scan_cs(sdt, a, cs);
  __syncthreads();
  if (tid < kT) {
    ecs[tid] = expf(cs[tid]);
    w[tid] = expf(cs[kT - 1] - cs[tid]) * sdt[tid];
  }

  // C B^T and dy x^T, then M, dCB and T over the causal pairs (i >= j)
  float cb[4][4], dm[4][4];
  zero(cb);
  zero(dm);
  mm(cb, ty, tx, [&](int i, int k) { return Cm[i * kLd + k]; },
     [&](int k, int j) { return Bm[j * kLd + k]; });
  mm(dm, ty, tx, [&](int i, int k) { return DY[i * kLd + k]; },
     [&](int k, int j) { return X[j * kLd + k]; });
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      float m = 0.f, d = 0.f, t = 0.f;
      if (j <= i) {            // a select: exp of j > i may overflow
        const float e = expf(cs[i] - cs[j]);
        m = cb[r][c] * e * sdt[j];
        d = dm[r][c] * e * sdt[j];
        t = dm[r][c] * cb[r][c] * e;
      }
      M[i * kLd + j] = m;
      DCB[i * kLd + j] = d;
      TT[i * kLd + j] = t;
    }
  // GB = G_c B_j (token j, column p)
  float acc[4][4], acc2[4][4];
  zero(acc);
  mm(acc, ty, tx, [&](int j, int k) { return Bm[j * kLd + k]; },
     [&](int k, int p) { return GOUT[p * kLd + k]; });
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) GB[(ty + 16 * r) * kLd + tx + 16 * c] = acc[r][c];
  __syncthreads();

  // dx_j = sum_i M_ij dy_i + w_j GB_j
  zero(acc);
  mm(acc, ty, tx, [&](int j, int k) { return M[k * kLd + j]; },
     [&](int k, int p) { return DY[k * kLd + p]; });
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (j >= rows) continue;
    T* o = dx + (((long long)b * S + t0 + j) * H + hd) * P;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      if (p < P) st(o + p, acc[r][c] + w[j] * GB[j * kLd + p]);
    }
  }

  // dC_i = sum_j dCB_ij B_j + exp(cs_i) H^T dy_i; y's carried-state term
  // gives dcs_i its share sum_n C_i[n] exp(cs_i) (H^T dy_i)[n]
  zero(acc);
  zero(acc2);
  mm(acc, ty, tx, [&](int i, int k) { return DCB[i * kLd + k]; },
     [&](int k, int n) { return Bm[k * kLd + n]; });
  mm(acc2, ty, tx, [&](int i, int k) { return DY[i * kLd + k]; },
     [&](int k, int n) { return HIN[k * kLd + n]; });
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    float part = 0.f;
    float* o = dch + (((long long)b * S + t0 + i) * H + hd) * N;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = tx + 16 * c;
      const float off = ecs[i] * acc2[r][c];
      part = fmaf(Cm[i * kLd + n], off, part);
      if (i < rows && n < N) o[n] = acc[r][c] + off;
    }
    // the 16 threads of one row are the lanes of one half-warp
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) part += __shfl_xor_sync(0xffffffffu, part, s);
    if (tx == 0) yoff[i] = part;
  }

  // dB_j = sum_i dCB_ij C_i + w_j G_c^T x_j
  zero(acc);
  zero(acc2);
  mm(acc, ty, tx, [&](int j, int k) { return DCB[k * kLd + j]; },
     [&](int k, int n) { return Cm[k * kLd + n]; });
  mm(acc2, ty, tx, [&](int j, int k) { return X[j * kLd + k]; },
     [&](int k, int n) { return GOUT[k * kLd + n]; });
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (j >= rows) continue;
    float* o = dbh + (((long long)b * S + t0 + j) * H + hd) * N;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = tx + 16 * c;
      if (n < N) o[n] = acc[r][c] + w[j] * acc2[r][c];
    }
  }

  // <G_c, H_{c-1}> for the state's decay, reduced in a fixed order
  float gh = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int idx = (ty + 16 * r) * kLd + tx + 16 * c;
      gh = fmaf(GOUT[idx], HIN[idx], gh);
    }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, s);
  if ((tid & 31) == 0) red[tid >> 5] = gh;
  // per token: the column and weighted row sums of T, and dw_t = x_t . GB_t
  if (tid < kT) {
    float ct = 0.f, rt = 0.f, d = 0.f;
    for (int k = 0; k < kT; ++k) {
      ct += TT[k * kLd + tid];
      rt = fmaf(TT[tid * kLd + k], sdt[k], rt);
    }
    for (int p = 0; p < kD; ++p) d = fmaf(X[tid * kLd + p], GB[tid * kLd + p], d);
    colT[tid] = ct;
    rowT[tid] = rt;
    dw[tid] = d;
  }
  __syncthreads();

  // dcs, its reverse cumsum ddA, ddt and dA's partial (thread 0, in order)
  if (tid == 0) {
    float ghs = 0.f, wdw = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) ghs += red[i];
    for (int t = 0; t < kT; ++t) {
      dcs[t] = rowT[t] - sdt[t] * colT[t] + yoff[t] - w[t] * dw[t];
      wdw = fmaf(w[t], dw[t], wdw);
    }
    dcs[kT - 1] += ecs[kT - 1] * ghs + wdw;
    float run = 0.f, da = 0.f;
    for (int t = kT - 1; t >= 0; --t) {
      run += dcs[t];
      dcs[t] = run;                 // ddA_t
      da = fmaf(sdt[t], run, da);
    }
    dapart[((long long)b * nt + tile) * H + hd] = da;
  }
  __syncthreads();
  if (tid < rows)
    ddt[((long long)b * S + t0 + tid) * H + hd] =
        colT[tid] + expf(cs[kT - 1] - cs[tid]) * dw[tid] + a * dcs[tid];
}

// dB, dC: the heads' partials summed in head order, one thread per (b, t,
// n); the last block sums dA's (b, tile) partials in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dbh, const float* __restrict__ dch,
                      const float* __restrict__ dapart, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, long long rows_n, int H, int N, int parts) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (int i = 0; i < parts; ++i) s += dapart[(long long)i * H + h];
      dA[h] = s;
    }
    return;
  }
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;   // (b, t) * N + n
  if (e >= rows_n) return;
  const long long bt = e / N;
  const int n = (int)(e % N);
  const float* pb = dbh + bt * H * N + n;
  const float* pc = dch + bt * H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(long long)h * N];
    sc += pc[(long long)h * N];
  }
  st(dB + e, sb);
  st(dC + e, sc);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   const float* dy, const float* dhf, float* hin, float* gout, void* dx,
                   float* ddt, float* dbh, float* dch, float* dapart, void* dB, void* dC,
                   float* dA, int b, int s, int h, int p, int n, const long long* st_,
                   cudaStream_t stream) {
  const int nt = (s + kT - 1) / kT;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  ssd_bwd_state_kernel<T><<<dim3(h, b), kThreads, 0, stream>>>(
      xt, dt, A, Bt, Ct, dy, dhf, hin, gout, s, h, p, n, st_[0], st_[1], st_[2], st_[3], st_[4],
      st_[5], st_[6]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static bool raised = false;
  if (!raised) {
    e = cudaFuncSetAttribute(ssd_bwd_tile_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  ssd_bwd_tile_kernel<T><<<dim3(nt, h, b), kThreads, kTileSmem, stream>>>(
      xt, dt, A, Bt, Ct, dy, hin, gout, static_cast<T*>(dx), ddt, dbh, dch, dapart, s, h, p, n,
      st_[0], st_[1], st_[2], st_[3], st_[4], st_[5], st_[6]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rows_n = (long long)b * s * n;
  const long long blocks = (rows_n + kThreads - 1) / kThreads + 1;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  ssd_bwd_reduce_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      dbh, dch, dapart, static_cast<T*>(dB), static_cast<T*>(dC), dA, rows_n, h, n, b * nt);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of x, B, C, dx, dB and dC.  x
// (b, s, h, p) with element strides xs_b, xs_t, xs_h and a unit stride on
// p; B and C (b, s, n) with strides bs_b, bs_t and cs_b, cs_t and a unit
// stride on n.  dt (b, s, h), A (h,), dy (b, s, h, p) and dhf (b, h, p, n,
// or null for a zero gradient) contiguous f32.  Scratch: hin and gout of
// b * ceil(s / 64) * h * p * n f32, dbh and dch of b * s * h * n f32,
// dapart of b * ceil(s / 64) * h f32.  Outputs, contiguous: dx (b, s, h,
// p), dB and dC (b, s, n) in dtype, ddt (b, s, h) and dA (h,) f32.  p and n
// at most 64.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* dy, const void* dhf, void* hin, void* gout,
                       void* dx, void* ddt, void* dbh, void* dch, void* dapart, void* dB,
                       void* dC, void* dA, int dtype, int b, int s, int h, int p, int n,
                       long long xs_b, long long xs_t, long long xs_h, long long bs_b,
                       long long bs_t, long long cs_b, long long cs_t, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || h > 65535 || p < 1 || p > kD || n < 1 ||
      n > kD || (dtype != 0 && dtype != 1) || (s + kT - 1) / kT > 2147483647)
    return (int)cudaErrorInvalidValue;
  const long long st_[7] = {xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t};
  const cudaStream_t q = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_A = static_cast<const float*>(A);
  const float* f_dy = static_cast<const float*>(dy);
  const float* f_dhf = static_cast<const float*>(dhf);
  float* f_hin = static_cast<float*>(hin);
  float* f_gout = static_cast<float*>(gout);
  float* f_ddt = static_cast<float*>(ddt);
  float* f_dbh = static_cast<float*>(dbh);
  float* f_dch = static_cast<float*>(dch);
  float* f_dap = static_cast<float*>(dapart);
  float* f_dA = static_cast<float*>(dA);
  if (dtype == 0)
    return (int)launch<float>(x, f_dt, f_A, B, C, f_dy, f_dhf, f_hin, f_gout, dx, f_ddt, f_dbh,
                              f_dch, f_dap, dB, dC, f_dA, b, s, h, p, n, st_, q);
  return (int)launch<__nv_bfloat16>(x, f_dt, f_A, B, C, f_dy, f_dhf, f_hin, f_gout, dx, f_ddt,
                                    f_dbh, f_dch, f_dap, dB, dC, f_dA, b, s, h, p, n, st_, q);
}
