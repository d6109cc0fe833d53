// Fused forecast for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/forecast/forecast.py
// ::forecast_pallas (body _forecast_kernel): out[b, n] = sum_i c[b, i] *
// d[b, i, n], f32 accumulation, one write in d's dtype.  With batch 1 and
// one coefficient vector it is exactly forecast_pallas; the batch axis lets
// the serving engine forecast every slot (each with its own offset u and
// n_valid mask, so its own coefficients) in one launch.
//
// Two entry points share the kernel:
//   forecast_fwd        takes the (batch, m1) coefficients from the caller.
//   forecast_basis_fwd  evaluates them in the kernel's prologue, as XLA
//                       fuses JAX's forecast_from_diffs under jit: each
//                       thread computes its slot's m1 weights at
//                       u = (step - last_step) / interval, masked by
//                       n_valid, for the taylor, newton, hermite, ab and
//                       foca bases, in the order of operations of the plain
//                       basis_coeffs (round-to-nearest intrinsics keep the
//                       compiler from contracting them into FMAs).  A skip
//                       tick of the serving engine is then one launch.
//                       The steps, last_step and n_valid are all read from
//                       device memory: a CUDA graph replays the launch
//                       with its arguments frozen, so a step passed by
//                       value would stay the capturing tick's forever.  The
//                       serving engine refills its static steps buffer
//                       before each replay.
//
// Bound on an H100 SXM: bytes.  It reads (m+1) * N elements and writes N,
// with 2 (m+1) operations per written element, so the card's 3.35 TB/s
// bounds it at (m+2) * N * itemsize / 3.35e12 seconds: 0.08 us at the
// serving shape (4 slots, m+1 = 3, N = 4096, f32), below the launch itself.
// So the host path is what costs, and the design keeps it to one launch
// and one ctypes call a tick.  On the device each thread reads each history
// element exactly once with 16-byte loads (4 floats or 8 bfloat16), keeps
// the sum in registers and writes once; no padding copy is made, a row
// whose length or address does not allow 16-byte access takes the scalar
// path instead.
//
// Why CUDA and not Triton: this is a weighted reduction that Triton would
// serve as well; CUDA keeps one build path and one loader for the port.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "launch_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM1 = 8;       // order + 1
constexpr int kMaxSlots = 64;   // slots of one forecast_basis launch

enum Basis { kGiven = -1, kTaylor = 0, kNewton = 1, kHermite = 2, kAb = 3, kFoca = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// The weights of basis_coeffs (kernels/forecast/ref.py) at offset u, with
// orders i >= n_valid weighing 0.  FoCa's d[0] weight is never masked: its
// iterated BDF2 + Heun step reduces to d[0] + min(ceil(u), 64) d[1].
// Unrolled over kMaxM1 so cf stays in registers.
__device__ __forceinline__ void basis_weights(int basis, float u, int n_valid, int m1,
                                              double sigma, float cf[kMaxM1]) {
  float fact = 1.f;                  // i!, exact in f32 for i < kMaxM1
  const float su = mul((float)sigma, u);
  float h_prev = 1.f, h = mul(2.f, su);   // Hermite H_0, H_1 at sigma u
  float upow = 1.f;
#pragma unroll
  for (int i = 0; i < kMaxM1; ++i) {
    if (i > 0) fact *= (float)i;
    float c = 0.f;
    if (basis == kTaylor) {
      c = __fdiv_rn(upow, fact);
    } else if (basis == kNewton) {
      float p = 1.f;
#pragma unroll
      for (int j = 0; j < i; ++j) p = mul(p, __fadd_rn(u, (float)j));
      c = __fdiv_rn(p, fact);
    } else if (basis == kHermite) {
      if (i == 0) {
        c = 1.f;
      } else {
        double si = 1.0;
        for (int j = 0; j < i; ++j) si *= sigma;
        c = __fdiv_rn(mul((float)si, h), fact);
        // H_{i+1} = 2 x H_i - 2 i H_{i-1}, x = sigma u
        const float nxt = __fsub_rn(mul(mul(2.f, su), h), mul(2.f * (float)i, h_prev));
        h_prev = h;
        h = nxt;
      }
    } else if (basis == kAb) {
      c = i == 0 ? 1.f : i == 1 ? u : i == 2 ? mul(0.5f, u) : 0.f;
    } else {   // kFoca
      c = i == 0 ? 1.f : i == 1 ? fminf(fmaxf(ceilf(u), 0.f), 64.f) : 0.f;
    }
    const bool valid = (basis == kFoca && i == 0) || n_valid > i;
    cf[i] = i < m1 ? mul(c, valid ? 1.f : 0.f) : 0.f;
    upow = mul(upow, u);
  }
}

// VEC = 16 / sizeof(T) on the vector path, 1 on the scalar path.  basis ==
// kGiven reads the weights from c; otherwise the prologue computes them.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
forecast_kernel(const T* __restrict__ d, const float* __restrict__ c, T* __restrict__ o,
                int m1, long long n, int basis, const int* __restrict__ steps,
                const int* __restrict__ last,
                const int* __restrict__ n_valid, int interval, double sigma) {
  const int b = blockIdx.y;
  const long long n0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (n0 >= n) return;
  float cf[kMaxM1];
  if (basis == kGiven) {
#pragma unroll
    for (int i = 0; i < kMaxM1; ++i) cf[i] = i < m1 ? c[(long long)b * m1 + i] : 0.f;
  } else {
    const float u = __fdiv_rn((float)(steps[b] - last[b]), (float)interval);
    basis_weights(basis, u, n_valid[b], m1, sigma, cf);
  }
  const T* db = d + (long long)b * m1 * n + n0;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxM1; ++i) {
    if (i >= m1) break;
    alignas(16) T x[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(x) = __ldg(reinterpret_cast<const uint4*>(db + (long long)i * n));
    } else {
      x[0] = db[(long long)i * n];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = fmaf(cf[i], to_f32(x[e]), acc[e]);
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
                   int basis, const int* steps, const int* last, const int* n_valid,
                   int interval, double sigma, cudaStream_t stream) {
  const long long items = (n + VEC - 1) / VEC;
  const dim3 grid((unsigned)((items + kThreads - 1) / kThreads), batch);
  return PLAN_LAUNCH("forecast_kernel", forecast_kernel<T, VEC>, grid, dim3(kThreads), 0, stream,
                     static_cast<const T*>(d), c, static_cast<T*>(o), m1, n, basis, steps, last,
                     n_valid, interval, sigma);
}

int dispatch(const void* d, const float* c, void* o, int dtype, int batch, int m1,
             long long n, int vec, int basis, const int* st, const int* last,
             const int* n_valid, int interval, double sigma, void* stream) {
  if (batch < 1 || batch > 65535 || m1 < 1 || m1 > kMaxM1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vec ? launch<float, 4>(d, c, o, batch, m1, n, basis, st, last, n_valid,
                                        interval, sigma, s)
                     : launch<float, 1>(d, c, o, batch, m1, n, basis, st, last, n_valid,
                                        interval, sigma, s));
  if (dtype == 1)
    return (int)(vec ? launch<__nv_bfloat16, 8>(d, c, o, batch, m1, n, basis, st, last,
                                                n_valid, interval, sigma, s)
                     : launch<__nv_bfloat16, 1>(d, c, o, batch, m1, n, basis, st, last,
                                                n_valid, interval, sigma, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// d: (batch, m1, n) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// c: (batch, m1) float32; o: (batch, n) in d's dtype.  vec != 0 selects
// 16-byte access: the caller guarantees n % (16 / itemsize) == 0 and
// 16-byte aligned d and o.  m1 at most kMaxM1.
extern "C" int forecast_fwd(const void* d, const void* c, void* o, int dtype, int batch,
                            int m1, long long n, int vec, void* stream) {
  return dispatch(d, static_cast<const float*>(c), o, dtype, batch, m1, n, vec, kGiven, nullptr,
                  nullptr, nullptr, 1, 0.0, stream);
}

// As forecast_fwd, with the weights of `basis` (0 taylor, 1 newton, 2
// hermite, 3 ab, 4 foca; sigma for hermite) at u = (steps[b] - last[b]) /
// interval, masked by n_valid[b]: steps, last and n_valid are device arrays
// of `batch` int32 (at most kMaxSlots slots).
extern "C" int forecast_basis_fwd(const void* d, const void* steps, const void* last,
                                  const void* n_valid, void* o, int dtype, int batch, int m1,
                                  long long n, int vec, int basis, int interval, double sigma,
                                  void* stream) {
  if (batch > kMaxSlots || basis < kTaylor || basis > kFoca || interval < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch(d, nullptr, o, dtype, batch, m1, n, vec, basis,
                  static_cast<const int*>(steps), static_cast<const int*>(last),
                  static_cast<const int*>(n_valid), interval, sigma, stream);
}

// Query entries (launch_plan.cuh): each entry's arguments with `plans` in
// place of the stream; the launch is recorded, not made.
extern "C" int forecast_fwd_plan(const void* d, const void* c, void* o, int dtype, int batch,
                                 int m1, long long n, int vec, long long* plans) {
  plan::Scope scope(plans);
  return forecast_fwd(d, c, o, dtype, batch, m1, n, vec, nullptr);
}

extern "C" int forecast_basis_fwd_plan(const void* d, const void* steps, const void* last,
                                       const void* n_valid, void* o, int dtype, int batch,
                                       int m1, long long n, int vec, int basis, int interval,
                                       double sigma, long long* plans) {
  plan::Scope scope(plans);
  return forecast_basis_fwd(d, steps, last, n_valid, o, dtype, batch, m1, n, vec, basis,
                            interval, sigma, nullptr);
}
