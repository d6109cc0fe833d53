// Mamba2 SSD (chunked state-space-dual) scan for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py::ssd_pallas (body
// _ssd_kernel).  For each (batch b, head h) and each tile of T tokens, with
// dA = dt * A (<= 0) and cs its inclusive prefix sum inside the tile:
//
//   S[i][j]  = (C_i . B_j) * exp(cs_i - cs_j) * dt_j      for j <= i, else 0
//   y_i      = sum_j S[i][j] x_j  +  exp(cs_i) * (h C_i)   (h from earlier tiles)
//   h       <- h * exp(cs_last) + sum_j x_j (exp(cs_last - cs_j) dt_j B_j)^T
//
// y (b,s,h,p) and the final h (b,h,p,n) are f32; B and C are shared by all
// heads (n_groups = 1).  The TPU kernel carries h in VMEM scratch across a
// chunk grid axis that runs in order; CUDA blocks run in no order, so here
// one block per (b, h) walks the tiles itself with h (p x n, at most
// 64 x 64 f32 = 16 KB) in shared memory.  The tile is always T = 64 tokens,
// also where the plain version takes a ragged s as one chunk: the scan's
// result does not depend on the chunking beyond rounding.  A ragged tail is padded with dt = 0 and zero
// x, B, C, which adds nothing to y or h and leaves cs flat, so no mask is
// needed past the end.  Above the diagonal exp(cs_i - cs_j) would overflow;
// it is evaluated only for j <= i.
//
// Bound on an H100 SXM: C B^T once per (b, tile), as B and C are shared by
// the heads, and three products of 2 * 64^3 operations per (b, h, tile),
// against x, dt, B, C read once and y, h written once; at the zamba2-2.7b
// serving shape (b 4, s 512, h 80, p = n = 64) that is 4.04 GFLOP against
// 91 MB, so the operations bound it.  This first version computes
// in f32 FMAs on the CUDA cores (67 TFLOP/s peak), because the reference is
// f32 and TF32 tensor cores would change the numbers.  Each thread of a
// 16 x 16 grid owns a 4 x 4 register tile of every 64 x 64 product and
// reads its operands from shared memory rows padded to 65 floats (no bank
// conflicts on either operand).  Known waste, left to the speed work:
// C B^T is the same for every head of a batch row and is recomputed by
// each of the h blocks; at b 1 only h blocks (80 for zamba2) fill the
// card's 132 SMs; no tensor cores, no TMA, no overlap of loads with math.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // tokens per tile
constexpr int kD = 64;          // largest head dim p and state n
constexpr int kLd = kD + 1;     // padded row stride of every 64-wide tile
constexpr int kGrid = 16;       // threads per side of the 16 x 16 grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kR = kD / kGrid;  // rows (and columns) a thread owns: 4

struct Smem {
  float x[kT * kLd];   // x[t][p]
  float b[kT * kLd];   // B[t][n]
  float c[kT * kLd];   // C[t][n]
  float h[kD * kLd];   // h[p][n], carried across tiles
  float s[kT * kLd];   // S[i][j]
  float dt[kT];
  float cs[kT];        // inclusive prefix sum of dt * A inside the tile
  float w[kT];         // exp(cs_last - cs_j) * dt_j
};

__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ C, float* __restrict__ y,
               float* __restrict__ hout, int S, int H, int P, int N) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x / H;
  const int hd = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const float a = A[hd];

  const long long xs = (long long)H * P;          // between tokens of x, y
  const float* xb = x + (long long)b * S * xs + (long long)hd * P;
  float* yb = y + (long long)b * S * xs + (long long)hd * P;
  const float* dtb = dt + (long long)b * S * H + hd;
  const float* Bb = B + (long long)b * S * N;
  const float* Cb = C + (long long)b * S * N;

  for (int i = tid; i < kD * kLd; i += kThreads) sm.h[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int T = min(kT, S - t0);
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < kT * kD; i += kThreads) {
      const int t = i / kD, c = i - t * kD;
      const bool tok = t < T;
      const long long row = (long long)(t0 + t);
      sm.x[t * kLd + c] = tok && c < P ? xb[row * xs + c] : 0.f;
      sm.b[t * kLd + c] = tok && c < N ? Bb[row * N + c] : 0.f;
      sm.c[t * kLd + c] = tok && c < N ? Cb[row * N + c] : 0.f;
    }
    if (tid < kT) sm.dt[tid] = tid < T ? dtb[(long long)(t0 + tid) * H] : 0.f;
    __syncthreads();
    if (tid < kT) {                      // in token order, as a cumsum sums
      float acc = 0.f;
      for (int j = 0; j <= tid; ++j) acc += sm.dt[j] * a;
      sm.cs[tid] = acc;
    }
    __syncthreads();
    if (tid < kT) sm.w[tid] = expf(sm.cs[kT - 1] - sm.cs[tid]) * sm.dt[tid];

    // S = (C B^T) masked and weighted: rows i = ty + 16 r, columns j = tx + 16 q
    {
      float acc[kR][kR] = {};
      for (int k = 0; k < N; ++k) {
        float cv[kR], bv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) cv[r] = sm.c[(ty + kGrid * r) * kLd + k];
#pragma unroll
        for (int q = 0; q < kR; ++q) bv[q] = sm.b[(tx + kGrid * q) * kLd + k];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < kR; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + kGrid * r;
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          const int j = tx + kGrid * q;
          sm.s[i * kLd + j] =
              j <= i ? acc[r][q] * expf(sm.cs[i] - sm.cs[j]) * sm.dt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = S x + exp(cs) (C h^T): rows i = ty + 16 r, columns p = tx + 16 q
    {
      float acc[kR][kR] = {}, off[kR][kR] = {};
      for (int j = 0; j < T; ++j) {
        float sv[kR], xv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) sv[r] = sm.s[(ty + kGrid * r) * kLd + j];
#pragma unroll
        for (int q = 0; q < kR; ++q) xv[q] = sm.x[j * kLd + tx + kGrid * q];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < kR; ++q) acc[r][q] = fmaf(sv[r], xv[q], acc[r][q]);
      }
      for (int k = 0; k < N; ++k) {
        float cv[kR], hv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) cv[r] = sm.c[(ty + kGrid * r) * kLd + k];
#pragma unroll
        for (int q = 0; q < kR; ++q) hv[q] = sm.h[(tx + kGrid * q) * kLd + k];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < kR; ++q) off[r][q] = fmaf(cv[r], hv[q], off[r][q]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + kGrid * r;
        if (i >= T) continue;
        const float e = expf(sm.cs[i]);
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          const int p = tx + kGrid * q;
          if (p < P) yb[(long long)(t0 + i) * xs + p] = acc[r][q] + e * off[r][q];
        }
      }
    }

    // h <- h exp(cs_last) + x^T (w B): rows p = ty + 16 r, columns n = tx + 16 q
    float hn[kR][kR] = {};
    for (int j = 0; j < T; ++j) {
      const float wj = sm.w[j];
      float xv[kR], bv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) xv[r] = sm.x[j * kLd + ty + kGrid * r] * wj;
#pragma unroll
      for (int q = 0; q < kR; ++q) bv[q] = sm.b[j * kLd + tx + kGrid * q];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int q = 0; q < kR; ++q) hn[r][q] = fmaf(xv[r], bv[q], hn[r][q]);
    }
    const float decay = expf(sm.cs[kT - 1]);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int q = 0; q < kR; ++q)
        hn[r][q] += sm.h[(ty + kGrid * r) * kLd + tx + kGrid * q] * decay;
    __syncthreads();                     // every read of the old h is done
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int q = 0; q < kR; ++q)
        sm.h[(ty + kGrid * r) * kLd + tx + kGrid * q] = hn[r][q];
  }
  __syncthreads();

  float* hb = hout + (long long)blockIdx.x * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    hb[i] = sm.h[p * kLd + n];
  }
}

}  // namespace

// All seven tensors f32 and contiguous: x and y (b, s, h, p), dt (b, s, h),
// A (h,), B and C (b, s, n), hout (b, h, p, n).  p and n at most 64.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, void* y, void* hout, int b, int s, int h,
                       int p, int n, void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < 1 || p > kD || n < 1 || n > kD ||
      (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<<<b * h, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(hout),
      s, h, p, n);
  return (int)cudaGetLastError();
}
