// Mamba2 SSD scan at any head dim p and state width n for Hopper (sm_90a)
// on the tensor cores, plain C interface: what ssd.cu (p, n <= 64) does not
// take.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py::ssd_pallas (body
// _ssd_kernel) over the rest of its domain: the Pallas scan takes any p and
// n (every published Mamba2 checkpoint has a state of 128; zamba2-2.7b's
// Mamba2 layer at ssm_state 128 reaches it).  It computes what ssd.cu
// computes, per 64-token tile with cs the inclusive prefix sum of dt A:
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j + exp(cs_i) h C_i
//   h  <- h exp(cs_last) + sum_j x_j (exp(cs_last - cs_j) dt_j B_j)^T
//
// y (b,s,h,p) and the final h (b,h,p,n) f32; x, B and C read in place in
// their dtype (bf16 or f32) through strides with a unit stride on the last
// axis, dt and A contiguous f32, a ragged tail padded with dt = 0.
//
// Bound on an H100 SXM (chip_smoke.py's ssd_fwd_work): the causal half of
// C B^T once per (b, tile) over n, the causal half of S x per (b, h, tile)
// over p, and C h^T and the state product over (p, n) per token, against
// x, dt, B, C read once and y, h written once.  At zamba2's shape with n
// 128 (b 4, s 512, h 80, p 64) that is 6.07 GFLOP: in f32 0.0368 ms at the
// 165 TFLOP/s of 3xTF32 against 97 MB (0.029 ms), on bf16 xBC views
// 0.0245 ms (C B^T at the bf16 rate, the rest at 2xTF32) against 75 MB
// (0.022 ms): the operations bound either way.
//
// What the design does about it.  n has no limit, because no n-wide tile
// is resident:
// - ssd_cb_any: C B^T of each (b, tile), summed over n in 64-column slabs,
//   into the scan's f32 scratch in ssd.cu's fragment order.
// - ssd_scan_any: one block of 4 warps per (32-column group of p, head,
//   batch), walking the tiles in order; any p is more groups, the ragged
//   last one masked.  Each tile stages x and dt once and computes S x
//   (ssd.cu's causal walk over the C B^T fragments); then, for each
//   64-column slab of n, it stages the B and C slabs and adds C h^T and the
//   slab's state product.  The running state h lives in the output h_final
//   itself (b, h, p, n f32, this block's rows): its own elements a thread
//   reads back, decays and adds to, the C h^T operand every thread reads
//   after a barrier.  No state scratch, no shared memory that grows with
//   n: 44,800 bytes of static shared memory (x 64 x 36, B and C slabs 64 x
//   68, dt, cs and w, all f32).
// - Staging is element by element with the conversion to f32, for any
//   stride and alignment; no cp.async ring: a simple kernel first.
// - Products: mma.sync m16n8k8 TF32, 3xTF32 for f32 operands, 2xTF32 where
//   one operand is a bf16 value (exact in TF32), as in ssd.cu.  The prefix
//   sum is ssd.cu's (one add after the other in token order).
// ssd.cu's kernels keep their code: this is a translation unit of its own,
// with its own entry point, that includes ssd.cu for its helpers only.

#define SSD_HELPERS_ONLY
#include "ssd.cu"

namespace {

constexpr int kSn = 64;              // columns of n a slab
constexpr int kLdA = kSn + 4;        // f32 rows of the B and C slabs
constexpr int kLdX = kPG + 4;        // f32 rows of the x tile

// rows 0 .. 63, columns c0 .. c0 + W - 1 of a (rows, stride) slice into a
// shared f32 tile of row stride LD, 0 past n_rows and n_cols
template <typename T, int W, int LD>
__device__ __forceinline__ void load_f32(float* dst, const T* src, long long stride, int n_rows,
                                         int c0, int n_cols) {
  for (int i = threadIdx.x; i < kT * W; i += kThreads) {
    const int r = i / W, c = i % W;
    dst[r * LD + c] =
        (r < n_rows && c0 + c < n_cols) ? to_f32(src[r * stride + c0 + c]) : 0.f;
  }
}

// C B^T of one (b, tile) over every slab of n, written as ssd_cb_kernel
// writes it.  Warp w owns rows 16 w .. 16 w + 15.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_any(const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ cb, int S,
           int N, long long bs_b, long long bs_t, long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  __shared__ __align__(16) float sb[kT * kLdA];
  __shared__ __align__(16) float sc[kT * kLdA];
  const int tile = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int t0 = tile * kT, rows = min(kT, S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kSn) {
    __syncthreads();   // every warp is done with the previous slab
    load_f32<T, kSn, kLdA>(sb, B + b * bs_b + t0 * bs_t, bs_t, rows, n0, N);
    load_f32<T, kSn, kLdA>(sc, C + b * cs_b + t0 * cs_t, cs_t, rows, n0, N);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSn / 8; ++kk) {
      const float* pc = sc + (r0 + g) * kLdA + 8 * kk + t;
      const float av[4] = {pc[0], pc[8 * kLdA], pc[4], pc[8 * kLdA + 4]};
      const Frag<4, kEx> a(av);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* pb = sb + (8 * j + g) * kLdA + 8 * kk + t;
        const float bv[2] = {pb[0], pb[4]};
        mma(acc[j], a, Frag<2, kEx>(bv));
      }
    }
  }
  float* out = cb + ((long long)b * nt + tile) * kT * kT + warp * 8 * 32 * 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int li = g + 8 * (e >> 1), lc = 2 * t + (e & 1);
      out[(j * 32 + (li & 7) * 4 + (lc & 3)) * 4 + (li >> 3) + 2 * (lc >> 2)] = acc[j][e];
    }
}

// Block (p group, head, batch).  hout (b, h, p, n) is the running state
// and, after the last tile, the final one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_any(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
             const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ cb,
             float* __restrict__ y, float* hout, int S, int H, int P, int N, long long xs_b,
             long long xs_t, long long xs_h, long long bs_b, long long bs_t, long long cs_b,
             long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  __shared__ __align__(16) float sx[kT * kLdX];
  __shared__ __align__(16) float sb[kT * kLdA];
  __shared__ __align__(16) float sc[kT * kLdA];
  __shared__ float sdt[kT], scs[kT], sw[kT];

  const int grp = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int p0 = grp * kPG, pw = min(kPG, P - p0);
  const int nt = (S + kT - 1) / kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp, nb = 16 * warp;
  const T* xb = x + b * xs_b + hd * xs_h + p0;
  const T* Bb = B + b * bs_b;
  const T* Cb = C + b * cs_b;
  const float* dtb = dt + (long long)b * S * H + hd;
  const float4* cbw = reinterpret_cast<const float4*>(cb + (long long)b * nt * kT * kT) +
                      warp * 8 * 32 + lane;
  float* hb = hout + ((long long)b * H + hd) * P * N + (long long)p0 * N;   // row p of the group
  const float a = A[hd];

  for (int tile = 0; tile < nt; ++tile) {
    const int t0 = tile * kT, rows = min(kT, S - t0);
    __syncthreads();   // every warp is done with the previous tile's x, dt, cs
    load_f32<T, kPG, kLdX>(sx, xb + t0 * xs_t, xs_t, rows, 0, pw);
    if (threadIdx.x < kT)
      sdt[threadIdx.x] = (int)threadIdx.x < rows ? dtb[(long long)(t0 + threadIdx.x) * H] : 0.f;
    float4 cbr[kT / 8];
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk)
      if (kk <= 2 * warp + 1) cbr[kk] = __ldg(cbw + (long long)tile * kT * kT / 4 + kk * 32);
    __syncthreads();
    if (warp == 0) {   // cs and w, ssd.cu's prefix sum
      float acc = 0.f, c_lo = 0.f, c_hi = 0.f;
#pragma unroll 8
      for (int i = 0; i < kT; ++i) {
        acc = __fadd_rn(acc, __fmul_rn(sdt[i], a));
        if (i == lane) c_lo = acc;
        if (i == lane + 32) c_hi = acc;
      }
      scs[lane] = c_lo;
      scs[lane + 32] = c_hi;
      sw[lane] = __expf(acc - c_lo) * sdt[lane];
      sw[lane + 32] = __expf(acc - c_hi) * sdt[lane + 32];
    }
    __syncthreads();

    // S x for rows r0 + g and r0 + g + 8 over the keys up to the diagonal
    const float cs_g = scs[r0 + g], cs_g8 = scs[r0 + g + 8];
    float yd[4][4], yo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yd[j][e] = yo[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      if (kk > 2 * warp + 1) break;
      const int j0 = 8 * kk + t, j1 = j0 + 4, i0 = r0 + g, i1 = i0 + 8;
      const float e0 = scs[j0], e1 = scs[j1], d0 = sdt[j0], d1 = sdt[j1];
      const float4 c = cbr[kk];
      const float sv[4] = {j0 <= i0 ? c.x * __expf(cs_g - e0) * d0 : 0.f,
                           j0 <= i1 ? c.y * __expf(cs_g8 - e0) * d0 : 0.f,
                           j1 <= i0 ? c.z * __expf(cs_g - e1) * d1 : 0.f,
                           j1 <= i1 ? c.w * __expf(cs_g8 - e1) * d1 : 0.f};
      const Frag<4, false> af(sv);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float bv[2] = {sx[j0 * kLdX + 8 * n + g], sx[j1 * kLdX + 8 * n + g]};
        mma(yd[n], af, Frag<2, kEx>(bv));
      }
    }

    const float decay = __expf(scs[kT - 1]);
    for (int n0 = 0; n0 < N; n0 += kSn) {
      __syncthreads();   // every warp is done with the previous slab
      load_f32<T, kSn, kLdA>(sb, Bb + t0 * bs_t, bs_t, rows, n0, N);
      load_f32<T, kSn, kLdA>(sc, Cb + t0 * cs_t, cs_t, rows, n0, N);
      __syncthreads();
      // C h^T with the state after the previous tile (zero before the first)
      if (tile > 0) {
#pragma unroll
        for (int kk = 0; kk < kSn / 8; ++kk) {
          const float* pc = sc + (r0 + g) * kLdA + 8 * kk + t;
          const float av[4] = {pc[0], pc[8 * kLdA], pc[4], pc[8 * kLdA + 4]};
          const Frag<4, kEx> af(av);
          const int c0 = n0 + 8 * kk + t;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int p = 8 * n + g;
            const float* ph = hb + (long long)p * N;
            const float bv[2] = {p < pw && c0 < N ? ph[c0] : 0.f,
                                 p < pw && c0 + 4 < N ? ph[c0 + 4] : 0.f};
            mma(yo[n], af, Frag<2, false>(bv));
          }
        }
      }
      // the slab's state: rows p = 16 mi + g (+ 8), columns n0 + nb + 8 ni +
      // 2 t (+ 1); x^T (w B) from zero on the tensor cores, then h
      // exp(cs_last) added in f32 (accumulating onto h in the mma chain
      // rounds h a little at every tile: the tensor cores' f32 accumulation
      // does not round to nearest)
      float hacc[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kT / 8; ++kk) {
        const int j0 = 8 * kk + t, j1 = j0 + 4;
        const float w0 = sw[j0], w1 = sw[j1];
        Frag<2, false> bf[2] = {
            Frag<2, false>({sb[j0 * kLdA + nb + g] * w0, sb[j1 * kLdA + nb + g] * w1}),
            Frag<2, false>({sb[j0 * kLdA + nb + 8 + g] * w0, sb[j1 * kLdA + nb + 8 + g] * w1})};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int p = 16 * mi + g;
          const float av[4] = {sx[j0 * kLdX + p], sx[j0 * kLdX + p + 8], sx[j1 * kLdX + p],
                               sx[j1 * kLdX + p + 8]};
          const Frag<4, kEx> af(av);
          mma(hacc[mi][0], af, bf[0]);
          mma(hacc[mi][1], af, bf[1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 16 * mi + g + 8 * (e >> 1), n = n0 + nb + 8 * ni + 2 * t + (e & 1);
            if (tile > 0 && p < pw && n < N)
              hacc[mi][ni][e] = fmaf(hb[(long long)p * N + n], decay, hacc[mi][ni][e]);
          }
      __syncthreads();   // every warp has read this slab of h for C h^T
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 16 * mi + g + 8 * (e >> 1), n = n0 + nb + 8 * ni + 2 * t + (e & 1);
            if (p < pw && n < N) hb[(long long)p * N + n] = hacc[mi][ni][e];
          }
    }

    const int s0 = t0 + r0 + g;
    const float eg[2] = {__expf(cs_g), __expf(cs_g8)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = s0 + 8 * r;
      if (s >= S) continue;
      float* yr = y + (((long long)b * S + s) * H + hd) * P + p0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < pw) yr[c] = yd[n][2 * r] + eg[r] * yo[n][2 * r];
        if (c + 1 < pw) yr[c + 1] = yd[n][2 * r + 1] + eg[r] * yo[n][2 * r + 1];
      }
    }
  }
}

template <typename T>
cudaError_t launch_any(const void* x, const float* dt, const float* A, const void* B,
                       const void* C, float* cb, float* y, float* hout, int b, int s, int h,
                       int p, int n, const long long* st, cudaStream_t stream) {
  const int nt = (s + kT - 1) / kT;
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  cudaError_t e = PLAN_LAUNCH("ssd_cb_any", ssd_cb_any<T>, dim3(nt, b), dim3(kThreads), 0,
                              stream, Bt, Ct, cb, s, n, st[3], st[4], st[5], st[6]);
  if (e != cudaSuccess) return e;
  const dim3 grid((p + kPG - 1) / kPG, h, b);
  return PLAN_LAUNCH("ssd_scan_any", ssd_scan_any<T>, grid, dim3(kThreads), 0, stream,
                     static_cast<const T*>(x), dt, A, Bt, Ct, cb, y, hout, s, h, p, n, st[0],
                     st[1], st[2], st[3], st[4], st[5], st[6]);
}

}  // namespace

// ssd_fwd's arguments and contract (ssd.cu) at any p >= 1 and n >= 1: x
// (b, s, h, p) with element strides xs_b, xs_t, xs_h and a unit stride on
// p; B and C (b, s, n) with strides bs_b, bs_t and cs_b, cs_t and a unit
// stride on n; dt (b, s, h) and A (h,) contiguous f32; cb a scratch of b *
// ceil(s / 64) * 64 * 64 f32; y (b, s, h, p) and hout (b, h, p, n)
// contiguous f32.  Any alignment.
extern "C" int ssd_fwd_any(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, void* cb, void* y, void* hout, int dtype, int b, int s,
                           int h, int p, int n, long long xs_b, long long xs_t, long long xs_h,
                           long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                           void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || h > 65535 || p < 1 || n < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[7] = {xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t};
  const cudaStream_t q = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* cbf = static_cast<float*>(cb);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(hout);
  if (dtype == 0)
    return (int)launch_any<float>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n, st, q);
  return (int)launch_any<__nv_bfloat16>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n, st, q);
}

// Query entry (launch_plan.cuh): ssd_fwd_any's arguments with `plans` in
// place of the stream; both launches are recorded, none made.
extern "C" int ssd_fwd_any_plan(const void* x, const void* dt, const void* A, const void* B,
                                const void* C, void* cb, void* y, void* hout, int dtype, int b,
                                int s, int h, int p, int n, long long xs_b, long long xs_t,
                                long long xs_h, long long bs_b, long long bs_t, long long cs_b,
                                long long cs_t, long long* plans) {
  plan::Scope scope(plans);
  return ssd_fwd_any(x, dt, A, B, C, cb, y, hout, dtype, b, s, h, p, n, xs_b, xs_t, xs_h, bs_b,
                     bs_t, cs_b, cs_t, nullptr);
}
