// Fused forecast for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/forecast/forecast.py
// ::forecast_pallas (body _forecast_kernel): out[b, n] = sum_i c[b, i] *
// d[b, i, n], f32 accumulation, one write in d's dtype.  With batch 1 and
// one coefficient vector it is exactly forecast_pallas; the batch axis lets
// the serving engine forecast every slot (each with its own offset u and
// n_valid mask, so its own coefficients) in one launch.
//
// Bound on an H100 SXM: bytes.  It reads (m+1) * N elements and writes N,
// with 2 (m+1) operations per written element, so the card's 3.35 TB/s
// bounds it at (m+2) * N * itemsize / 3.35e12 seconds.  What the design
// does about it: each thread reads each history element exactly once with
// 16-byte loads (4 floats or 8 bfloat16), keeps the sum in registers and
// writes once; no padding copy is made, a row whose length or address does
// not allow 16-byte access takes the scalar path instead.
//
// Why CUDA and not Triton: this is a weighted reduction that Triton would
// serve as well; CUDA keeps one build path and one loader for the port.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC = 16 / sizeof(T) on the vector path, 1 on the scalar path.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
forecast_kernel(const T* __restrict__ d, const float* __restrict__ c, T* __restrict__ o,
                int m1, long long n) {
  const int b = blockIdx.y;
  const long long n0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (n0 >= n) return;
  const T* db = d + (long long)b * m1 * n + n0;
  const float* cb = c + (long long)b * m1;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int i = 0; i < m1; ++i) {
    const float ci = cb[i];
    alignas(16) T x[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(x) = __ldg(reinterpret_cast<const uint4*>(db + (long long)i * n));
    } else {
      x[0] = db[(long long)i * n];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = fmaf(ci, to_f32(x[e]), acc[e]);
  }
  alignas(16) T y[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) y[e] = from_f32<T>(acc[e]);
  T* ob = o + (long long)b * n + n0;
  if constexpr (VEC > 1) {
    *reinterpret_cast<uint4*>(ob) = *reinterpret_cast<const uint4*>(y);
  } else {
    ob[0] = y[0];
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* d, const float* c, void* o, int batch, int m1, long long n,
                   cudaStream_t stream) {
  const long long items = (n + VEC - 1) / VEC;
  const dim3 grid((unsigned)((items + kThreads - 1) / kThreads), batch);
  forecast_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(d), c, static_cast<T*>(o), m1, n);
  return cudaGetLastError();
}

}  // namespace

// d: (batch, m1, n) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// c: (batch, m1) float32; o: (batch, n) in d's dtype.  vec != 0 selects
// 16-byte access: the caller guarantees n % (16 / itemsize) == 0 and
// 16-byte aligned d and o.
extern "C" int forecast_fwd(const void* d, const void* c, void* o, int dtype, int batch,
                            int m1, long long n, int vec, void* stream) {
  if (batch < 1 || batch > 65535 || m1 < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  if (dtype == 0)
    return (int)(vec ? launch<float, 4>(d, cf, o, batch, m1, n, s)
                     : launch<float, 1>(d, cf, o, batch, m1, n, s));
  if (dtype == 1)
    return (int)(vec ? launch<__nv_bfloat16, 8>(d, cf, o, batch, m1, n, s)
                     : launch<__nv_bfloat16, 1>(d, cf, o, batch, m1, n, s));
  return (int)cudaErrorInvalidValue;
}
