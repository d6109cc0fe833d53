// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces JAX's autodiff of src/repro/models/layers.py:86 blocked_attention
// (the JAX package differentiates attention outside any Pallas kernel; the
// Pallas forward has no custom_vjp).  Given q, k, v, the forward's output o,
// its row log-sum-exp lse (natural log, (B, H, Sq) f32, written by
// flash_attention_fwd) and dO, it computes what autograd of attention_ref
// gives:
//   P  = exp(S * scale - lse)                 S = q k^T
//   dV = P^T dO            dP = dO v^T        Delta = rowsum(dO * o)
//   dS = P * (dP - Delta)  (0 where the mask excludes the key)
//   dQ = dS k * scale      dK = dS^T q * scale
// over the forward's whole contract: causal and sliding-window masks from
// absolute positions with q at the tail of k (q_offset = Sk - Sq), GQA (the
// group's heads summed into their kv head), ragged Sq and Sk, 1 <= D <= 128,
// f32 and bf16 (converted on load; gradients written in the input dtype).
// A row whose keys are all masked (causal, q longer than k) takes the
// reference's uniform softmax over all Sk keys: it adds dO / Sk to every dV
// row and nothing to dq or dk.
//
// Bound on an H100 SXM: the five products, 10 * B * H * (unmasked pairs) *
// D operations, against the bytes of q, k, v, o, dO, dq, dk, dv moved once.
// At DiT-XL's training shape (B 8, S 256, H 16, D 72, f32) 6.04 GFLOP take
// 0.090 ms on the f32 CUDA cores (67 TFLOP/s) against 0.023 ms of bytes
// (75.5 MB): the operations bound.
//
// What the design does about it: a simple, deterministic SIMT kernel with
// no atomics (the tensor-core redesign is later work, PERF.md):
// - flash_bwd_delta: one warp a query row, Delta = rowsum(dO * o) in f32.
// - flash_bwd_dkdv: one block of 256 threads per (64-key tile, kv head,
//   batch).  K and V stay in shared memory; the block walks the group's
//   heads and, for each, the 64-query tiles that the mask leaves, staging
//   Q, dO, lse and Delta.  Each thread computes a 4 x 4 patch of S and dP
//   (rows ty + 16 r, keys tx + 16 c: conflict-free shared reads with odd row
//   strides), turns them into P and dS in shared memory, and accumulates a
//   4 x NC patch of dV += P^T dO and dK += dS^T q in registers (keys
//   ty + 16 r, columns tx + 16 c).  The group's sum happens inside the block.
// - flash_bwd_dq: one block per (64-query tile, head, batch) walks the key
//   tiles the mask leaves, recomputes S, dP and dS the same way and
//   accumulates dQ += dS k in registers.
// - S is recomputed in full f32 FMA (P from the saved lse, exp2 with
//   log2(e) folded into the scale); every sum runs in f32.  The head dim is
//   padded with zero columns to NC * 16, NC = ceil(D / 16).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr int kBQ = 64;                // query rows of a tile
constexpr int kBK = 64;                // keys of a tile
constexpr int kLDP = kBQ + 1;          // shared row stride of P and dS
constexpr int kDMax = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Shape {
  int Sq, Sk, H, KH, D, causal, window, q_offset;
  float scale, scale_log2;
};

// Rows row0 .. row0 + kRows - 1 of a (rows, stride) slice into an f32
// shared tile of row stride LD; rows >= n_rows and columns >= D become 0.
template <typename T, int DP, int LD, int kRows>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride, int row0,
                                      int n_rows, int D) {
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int s = row0 + r;
    dst[r * LD + c] = (s < n_rows && c < D) ? load_f(src + s * stride + c) : 0.f;
  }
}

// lse (in the log2 domain) and Delta of the query tile q0 of row (b, h)
__device__ __forceinline__ void stage_rows(float* sL, float* sDl, const float* lse,
                                           const float* delta, long long row_base, int q0,
                                           int Sq) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool ok = q0 + i < Sq;
    sL[i] = ok ? lse[row_base + q0 + i] * kLog2e : 0.f;
    sDl[i] = ok ? delta[row_base + q0 + i] : 0.f;
  }
}

// S and dP of the 4 x 4 pairs (rows ty + 16 r, keys tx + 16 c) of a tile
template <int DP, int LD>
__device__ __forceinline__ void s_dp(const float* sQ, const float* sdO, const float* sK,
                                     const float* sV, int ty, int tx, float s[4][4],
                                     float dp[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = sQ[(ty + 16 * r) * LD + d];
      ov[r] = sdO[(ty + 16 * r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = sK[(tx + 16 * c) * LD + d];
      vv[c] = sV[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
}

// P and dS * scale of query qi (tile row i) and key kj, written to shared
// memory.  Keys past Sk and rows past Sq give 0; a masked key gets P = 0
// and dS = 0, except in a row whose keys are all masked (causal, position
// < 0), whose P is the reference's uniform 1 / Sk.
__device__ __forceinline__ void p_ds(const Shape& a, float s, float dp, int i, int qi, int kj,
                                     const float* sL, const float* sDl, float* sP, float* sdS,
                                     int j) {
  float p = 0.f, ds = 0.f;
  if (qi < a.Sq && kj < a.Sk) {
    const int qpos = qi + a.q_offset;
    const bool masked = (a.causal && kj > qpos) || (a.window > 0 && qpos - kj >= a.window);
    if (a.causal && qpos < 0) {
      p = 1.f / a.Sk;
    } else if (!masked) {
      p = exp2f(s * a.scale_log2 - sL[i]);
      ds = p * (dp - sDl[i]) * a.scale;
    }
  }
  if (sP != nullptr) sP[i * kLDP + j] = p;
  sdS[i * kLDP + j] = ds;
}

// Delta = rowsum(dO * o) in f32: one warp a row of the (B, Sq, H, D)
// layout, written (B, H, Sq)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ delta,
                long long rows, int Sq, int H, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* po = o + row * D;
  const T* pd = dO + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(load_f(po + c), load_f(pd + c), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;          // b * Sq + s
    const int s = (int)(bs % Sq);
    const long long b = bs / Sq;
    delta[(b * H + h) * Sq + s] = acc;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dO, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               Shape a) {
  constexpr int DP = 16 * NC, LD = DP + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * LD;
  float* sQ = sV + kBK * LD;
  float* sdO = sQ + kBQ * LD;
  float* sP = sdO + kBQ * LD;
  float* sdS = sP + kBQ * kLDP;
  float* sL = sdS + kBQ * kLDP;
  float* sDl = sL + kBQ;

  const int k0 = blockIdx.x * kBK, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q_stride = (long long)a.H * a.D, k_stride = (long long)a.KH * a.D;
  const long long kv_off = ((long long)b * a.Sk * a.KH + kh) * a.D;
  stage<T, DP, LD, kBK>(sK, k + kv_off, k_stride, k0, a.Sk, a.D);
  stage<T, DP, LD, kBK>(sV, v + kv_off, k_stride, k0, a.Sk, a.D);

  // the query tiles that can see a key of this tile; every tile when a row
  // may have all its keys masked (q_offset < 0), since such a row reaches
  // every dV row
  int qt_lo = 0, qt_hi = (a.Sq + kBQ - 1) / kBQ;
  if (a.q_offset >= 0) {
    if (a.causal) qt_lo = max(0, (k0 - a.q_offset) / kBQ);
    if (a.window > 0) {
      const int q_last = k0 + kBK - 1 + a.window - 1 - a.q_offset;   // last row in reach
      qt_hi = q_last < 0 ? 0 : min(qt_hi, q_last / kBQ + 1);
    }
  }

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    const long long q_off = ((long long)b * a.Sq * a.H + h) * a.D;
    const long long row_base = ((long long)b * a.H + h) * a.Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // every thread is done with the last tile's Q, dO, P, dS
      stage<T, DP, LD, kBQ>(sQ, q + q_off, q_stride, q0, a.Sq, a.D);
      stage<T, DP, LD, kBQ>(sdO, dO + q_off, q_stride, q0, a.Sq, a.D);
      stage_rows(sL, sDl, lse, delta, row_base, q0, a.Sq);
      __syncthreads();

      float s[4][4], dp[4][4];
      s_dp<DP, LD>(sQ, sdO, sK, sV, ty, tx, s, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * r, j = tx + 16 * c;
          p_ds(a, s[r][c], dp[r][c], i, q0 + i, k0 + j, sL, sDl, sP, sdS, j);
        }
      __syncthreads();

      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] q[i]
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        float pv[4], dsv[4], ov[NC], qv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = sP[i * kLDP + ty + 16 * r];
          dsv[r] = sdS[i * kLDP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = sdO[i * LD + tx + 16 * c];
          qv[c] = sQ[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[r][c] = fmaf(pv[r], ov[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(dsv[r], qv[c], acc_k[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= a.Sk) continue;
    T* pk = dk + kv_off + j * k_stride;
    T* pv = dv + kv_off + j * k_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) {
        store_f(pk + d, acc_k[r][c]);
        store_f(pv + d, acc_v[r][c]);
      }
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dO, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, Shape a) {
  constexpr int DP = 16 * NC, LD = DP + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * LD;
  float* sK = sdO + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sdS = sV + kBK * LD;
  float* sL = sdS + kBQ * kLDP;
  float* sDl = sL + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long q_stride = (long long)a.H * a.D, k_stride = (long long)a.KH * a.D;
  const long long q_off = ((long long)b * a.Sq * a.H + h) * a.D;
  const long long kv_off = ((long long)b * a.Sk * a.KH + kh) * a.D;
  stage<T, DP, LD, kBQ>(sQ, q + q_off, q_stride, q0, a.Sq, a.D);
  stage<T, DP, LD, kBQ>(sdO, dO + q_off, q_stride, q0, a.Sq, a.D);
  stage_rows(sL, sDl, lse, delta, ((long long)b * a.H + h) * a.Sq, q0, a.Sq);

  // the key tiles the mask leaves (as in the forward); dS is 0 elsewhere
  int kt_lo = 0, kt_hi = (a.Sk + kBK - 1) / kBK;
  if (a.q_offset >= 0) {
    const int q_first = q0 + a.q_offset;
    const int q_last = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
    if (a.causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (a.window > 0) kt_lo = max(0, (q_first - a.window + 1) / kBK);
  }

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // every thread is done with the last tile's K and dS
    stage<T, DP, LD, kBK>(sK, k + kv_off, k_stride, k0, a.Sk, a.D);
    stage<T, DP, LD, kBK>(sV, v + kv_off, k_stride, k0, a.Sk, a.D);
    __syncthreads();

    float s[4][4], dp[4][4];
    s_dp<DP, LD>(sQ, sdO, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * r, j = tx + 16 * c;
        p_ds(a, s[r][c], dp[r][c], i, q0 + i, k0 + j, sL, sDl, nullptr, sdS, j);
      }
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] k[j]
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float dsv[4], kv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = sdS[(ty + 16 * r) * kLDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsv[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= a.Sq) continue;
    T* p = dq + q_off + i * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.D) store_f(p + d, acc[r][c]);
    }
  }
}

template <typename K>
cudaError_t raise_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* dO,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                      const Shape& a, cudaStream_t stream) {
  constexpr int LD = 16 * NC + 1;
  constexpr size_t smem_kv =
      sizeof(float) * ((2 * kBK + 2 * kBQ) * LD + 2 * kBQ * kLDP + 2 * kBQ);
  constexpr size_t smem_q = sizeof(float) * ((2 * kBK + 2 * kBQ) * LD + kBQ * kLDP + 2 * kBQ);
  static_assert(smem_kv <= 232448, "a block has 227 KB of shared memory");
  static bool raised = false;
  if (!raised) {
    cudaError_t e = raise_smem(flash_bwd_dkdv<T, NC>, smem_kv);
    if (e == cudaSuccess) e = raise_smem(flash_bwd_dq<T, NC>, smem_q);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const dim3 grid_kv((a.Sk + kBK - 1) / kBK, a.KH, B);
  flash_bwd_dkdv<T, NC><<<grid_kv, kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_q((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_bwd_dq<T, NC><<<grid_q, kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), lse, delta, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

// NC = ceil(D / 16) column groups of 16: the head dim's padded width
template <typename T, int NC = 1>
cudaError_t launch(int nc, const void* q, const void* k, const void* v, const void* dO,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   const Shape& a, cudaStream_t s) {
  if constexpr (NC < kDMax / 16) {
    if (nc > NC) return launch<T, NC + 1>(nc, q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
  }
  return launch_nc<T, NC>(q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* o, const void* dO,
                const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
                const Shape& a, cudaStream_t s) {
  const long long rows = (long long)B * a.Sq * a.H;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_delta<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), delta, rows, a.Sq, a.H, a.D);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch<T>((a.D + 15) / 16, q, k, v, dO, lse, delta, dq, dk, dv, B, a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk and dv share it).
// All contiguous: q, o, dO and dq (B, Sq, H, D); k, v, dk and dv (B, Sk, KH,
// D); lse (the forward's, natural log) and the scratch delta (B, H, Sq) f32.
// Launches three kernels (Delta, dK/dV, dQ) and returns the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dO, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq, int Sk, int H,
                                   int KH, int D, int causal, int window, float scale,
                                   void* stream) {
  if (D < 1 || D > kDMax || KH < 1 || H % KH != 0 || B < 1 || Sq < 1 || Sk < 1 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape a{Sq, Sk, H, KH, D, causal, window, Sk - Sq, scale, scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)run<float>(q, k, v, o, dO, l, dl, dq, dk, dv, B, a, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(q, k, v, o, dO, l, dl, dq, dk, dv, B, a, s);
  return (int)cudaErrorInvalidValue;
}
