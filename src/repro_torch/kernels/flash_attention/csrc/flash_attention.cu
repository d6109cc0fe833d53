// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_pallas (body _fa_kernel): softmax(q k^T * scale + mask) v
// with an online softmax whose running max, sum and accumulator stay in f32,
// output in q's dtype, optional causal and sliding-window masks taken from
// absolute positions with q at the tail of k (q_offset = Sk - Sq), and GQA
// (kv head = h / (H / KH)).
//
// Bound on an H100 SXM: 4 * B * H * Sq * Sk * D operations against the bytes
// of q, k, v and o read or written once.  At the DiT-XL shape (S = 256,
// D = 72) that is about 37 operations per byte in f32, so the operations
// bound it.  This first version runs them as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), not on the tensor cores: it is simple and exact, and
// wgmma/TMA tiles are later work.  What the design does about the bound:
// every K/V tile is staged once in shared memory and reused by all 32 query
// rows of the block, each lane keeps 8 rows' scores and accumulators in
// registers, and only the output is written back, once.
//
// Layout: one block of 4 warps per (Q tile of 32 rows, head, batch).  Each
// warp owns 8 query rows.  The block walks K/V in tiles of 32 keys; in a
// tile lane j scores key j against the warp's 8 rows, the warp reduces max
// and sum with shuffles, then each lane accumulates P @ V for head-dim
// columns lane, lane+32, lane+64 and lane+96.  The head dim is a runtime
// value up to 128 and need not be a multiple of anything; Sq and Sk need not
// divide the tiles (ragged tails are masked).  Keys past Sk score -inf and
// weigh nothing; keys excluded by the causal or window mask score -1e30, as
// in the reference, so a row whose keys are all masked averages all Sk keys
// just like attention_ref.  When q_offset >= 0 every row keeps its diagonal
// key, and tiles that are masked for every row of the block are skipped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 32;                  // keys per tile: one per lane
constexpr int kDMax = 128;
constexpr int kDC = kDMax / 32;          // head-dim columns per lane
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Sk, int H, int KH, int D, int causal,
          int window, float scale, int q_offset) {
  extern __shared__ float smem[];
  float* sq = smem;                      // kBQ x D, pre-scaled queries
  float* sk = sq + kBQ * D;              // kBK x (D + 1): padded rows, no bank conflicts
  float* sv = sk + kBK * (D + 1);        // kBK x D

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long q_stride = (long long)H * D;     // between sequence positions
  const long long k_stride = (long long)KH * D;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * KH + kh) * D;
  const T* vb = v + ((long long)b * Sk * KH + kh) * D;

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int s = q0 + r;
    sq[i] = s < Sq ? to_f32(qb[s * q_stride + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[r][c] = 0.f;
  }

  int kt_lo = 0, kt_hi = (Sk + kBK - 1) / kBK;
  if (q_offset >= 0) {
    const int q_first = q0 + q_offset;
    const int q_last = min(q0 + kBQ, Sq) - 1 + q_offset;
    if (causal) kt_hi = min(kt_hi, q_last / kBK + 1);
    if (window > 0) kt_lo = max(0, (q_first - window + 1) / kBK);
  }

  const float* qw = sq + warp * kRows * D;
  const int row0 = q0 + warp * kRows;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                     // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const int s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < Sk) {
        kx = to_f32(kb[s * k_stride + d]);
        vx = to_f32(vb[s * k_stride + d]);
      }
      sk[j * (D + 1) + d] = kx;
      sv[j * D + d] = vx;
    }
    __syncthreads();

    // scores: lane owns key k0 + lane, for the warp's kRows query rows
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = 0.f;
    const float* krow = sk + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = fmaf(qw[r * D + d], kd, p[r]);
    }

    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = row0 + r + q_offset;
      bool ok = true;
      if (causal) ok = ok && key <= qpos;
      if (window > 0) ok = ok && qpos - key < window;
      const float s = key < Sk ? (ok ? p[r] : kMasked) : -CUDART_INF_F;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float e = expf(s - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(e);
      m[r] = m_new;
      p[r] = e;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[r][c] *= alpha;
    }

    // P @ V: broadcast key j's weight from lane j, columns lane + 32 c
    for (int j = 0; j < kBK; ++j) {
      float vj[kDC];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < D ? sv[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = row0 + r;
    if (s >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + ((long long)b * Sq * H + (long long)s * H + h) * D;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[r][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int H, int KH, int D, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kBQ * D + kBK * (D + 1) + kBK * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KH, D, causal, window, scale, Sk - Sq);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  All four
// tensors are contiguous: q and o (B, Sq, H, D), k and v (B, Sk, KH, D).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int KH, int D,
                                   int causal, int window, float scale, void* stream) {
  if (D < 1 || D > kDMax || KH < 1 || H % KH != 0 || B < 1 || Sq < 1 || Sk < 1 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, B, Sq, Sk, H, KH, D, causal, window, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, D, causal, window,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
