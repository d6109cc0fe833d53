// Backward of the Mamba2 SSD scan at any head dim p and state width n for
// Hopper (sm_90a) on the tensor cores, plain C interface: what ssd_bwd.cu
// (p, n <= 64) does not take.
//
// Replaces JAX's autodiff of src/repro/models/ssm.py:207 ssd_chunked over
// the rest of its domain (any p and n; zamba2-2.7b's Mamba2 layer at
// ssm_state 128 trains there).  The contract and the decomposition are
// ssd_bwd.cu's, whose helpers this file includes: per 64-token tile the
// tile-local states and state gradients, the recurrence between tiles, then
// every gradient term of the tile (dx, ddt, dA's partial, dB and dC summed
// over a head group) and a reduction of the groups, deterministic with no
// atomics.
//
// Bound on an H100 SXM: ssd_bwd.cu's count with p and n free (chip_smoke.py
// ssd_bwd_work): at zamba2's shape with n 128 (b 4, s 512, h 80, p 64, bf16
// xBC views) the operations at the 2x/3xTF32 rates (C B^T, both operands
// bf16, at the bf16 rate) against the bytes read and written once; the
// numbers are in PERF.md §6.
//
// What the design does about it.  No p- or n-wide tile is resident: every
// product of ssd_bwd.cu is a 64 x 64 result formed over 64-deep slabs.
// - ssd_bwd_state_any, 4 warps per (tile, head, batch): the local state
//   and state gradient of the tile, one 64 x 64 (p, n) block after the
//   other, each from a slab of x (or dy) and of B (or C).
// - ssd_bwd_pass_kernel: ssd_bwd.cu's recurrence, any p * n.
// - ssd_bwd_tile_any, 8 warps per (tile, head group, batch), each warp a
//   16 x 32 part of a 64 x 64 result: C B^T over n slabs once a block; for
//   each head H^T dy, dy x^T, G B, M dy and x^T G over p and n slabs, M in
//   shared memory, dCB summed over the group in registers.  The group's dB
//   and dC partials (b, s, groups, n) f32 accumulate in device memory,
//   each element read and written by the one thread that owns it in the
//   fragment layout, the block's rows zeroed first.  <G, H> reads the two
//   states straight from device memory.
// - Staging is element by element with the conversion to f32, for any
//   stride and alignment, one barrier before and one after each: a simple
//   kernel first.  Shared memory of the tile kernel: three operand slabs
//   and M, 64 x 68 f32 each, and the per-token vectors: 73,472 bytes.
// - Products: mma.sync m16n8k8 TF32, 3xTF32 for f32 operands, 2xTF32 with
//   a bf16 operand; exp is expf (the gradient is held against float64).
// - ssd_bwd_reduce_kernel: ssd_bwd.cu's sums of the groups and of dA.
// ssd_bwd.cu's kernels keep their code: this is a translation unit of its
// own, with its own entry point, that includes ssd_bwd.cu for its helpers.

#define SSD_HELPERS_ONLY
#include "ssd_bwd.cu"

namespace {

constexpr int kLd = kD + 4;   // f32 rows of a staged 64 x 64 slab

// rows 0 .. 63, columns c0 .. c0 + 63 of a (rows, stride) slice into a
// shared f32 slab, 0 past n_rows and n_cols, by kN threads
template <int kN, typename T>
__device__ __forceinline__ void load_f32(float* dst, const T* src, long long stride, int n_rows,
                                         int c0, int n_cols) {
#pragma unroll 1
  for (int i = threadIdx.x; i < kT * kD; i += kN) {
    const int r = i / kD, c = i % kD;
    dst[r * kLd + c] = (r < n_rows && c0 + c < n_cols) ? to_f32(src[r * stride + c0 + c]) : 0.f;
  }
}

// Block (tile c, head, batch): tile c's local state (c < tiles - 1) into
// hst slot c, its local state gradient (c > 0) into gst slot c - 1, and
// exp(cs_L) into decay.  Warp w: rows p = 64 pb + 16 w .. of each block.
template <typename T>
__global__ void __launch_bounds__(128)
ssd_bwd_state_any(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ B, const T* __restrict__ C,
                  const float* __restrict__ dy, float* __restrict__ hst, float* __restrict__ gst,
                  float* __restrict__ decay, int S, int H, int P, int N, long long xs_b,
                  long long xs_t, long long xs_h, long long bs_b, long long bs_t, long long cs_b,
                  long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  __shared__ __align__(16) float s1[kT * kLd];
  __shared__ __align__(16) float s2[kT * kLd];
  __shared__ float sDt[kT], sCs[kT], sEcs[kT], sW[kT];

  const int c = blockIdx.x, hd = blockIdx.y, b = blockIdx.z, nt = gridDim.x;
  const int t0 = c * kT, rows = min(kT, S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, p0 = 16 * warp;
  const bool fwd = c < nt - 1, bwd = c > 0;
  stage_dt(sDt, dt, b, t0, S, H, hd);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    const float cs_last = scan_cs(sDt, A[hd], sCs, sEcs, sW);
    if (lane == 0) decay[((long long)b * nt + c) * H + hd] = expf(cs_last);
  }
  const T* xt = x + b * xs_b + t0 * xs_t + hd * xs_h;
  const float* dyt = dy + (((long long)b * S + t0) * H + hd) * P;
  float acc[8][4];
  for (int pb = 0; pb < P; pb += kD)
    for (int nb = 0; nb < N; nb += kD) {
      auto store = [&](float* base, int slot) {
        float* o = base + (((long long)b * (nt - 1) + slot) * H + hd) * P * N;
        each(acc, [&](int r, int cc, int n, int e) {
          if (pb + p0 + r < P && nb + cc < N) o[(long long)(pb + p0 + r) * N + nb + cc] = acc[n][e];
        });
      };
      if (fwd) {   // sum_j x_j[p] (w_j B_j[n])
        __syncthreads();
        load_f32<128>(s1, xt, xs_t, rows, pb, P);
        load_f32<128>(s2, B + b * bs_b + t0 * bs_t, bs_t, rows, nb, N);
        __syncthreads();
        zero(acc);
        mm<8, kEx, false>(acc, 0, 8, [&](int r, int k) { return s1[k * kLd + p0 + r]; },
                          [&](int k, int n) { return sW[k] * s2[k * kLd + n]; });
        store(hst, c);
      }
      if (bwd) {   // sum_t (exp(cs_t) dy_t[p]) C_t[n]
        __syncthreads();
        load_f32<128>(s1, dyt, (long long)H * P, rows, pb, P);
        load_f32<128>(s2, C + b * cs_b + t0 * cs_t, cs_t, rows, nb, N);
        __syncthreads();
        zero(acc);
        mm<8, false, kEx>(acc, 0, 8, [&](int r, int k) { return sEcs[k] * s1[k * kLd + p0 + r]; },
                          [&](int k, int n) { return s2[k * kLd + n]; });
        store(gst, c - 1);
      }
    }
}

template <typename T>
struct AnySmem {
  static constexpr int kSlab = kT * kLd * 4;
  static constexpr int kBytes = 4 * kSlab + kVecs * kT * 4;   // three slabs, M; vectors
  static_assert(kBytes <= 232448, "a block has 227 KB of shared memory");
};

// Block (tile c, head group, batch): every gradient term of its heads.  dx
// and ddt are final here; the group's dB and dC go to dbp and dcp (b, s,
// groups, n) f32, and dA's partial of (b, c, h) to dapart.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
ssd_bwd_tile_any(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ B, const T* __restrict__ C,
                 const float* __restrict__ dy, const float* __restrict__ dhf,
                 const float* __restrict__ hst, const float* __restrict__ gst,
                 T* __restrict__ dx, float* __restrict__ ddt, float* dbp, float* dcp,
                 float* __restrict__ dapart, int S, int H, int P, int N, int group,
                 long long xs_b, long long xs_t, long long xs_h, long long bs_b, long long bs_t,
                 long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int kN = kTileThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s1 = reinterpret_cast<float*>(smem_raw);
  float* s2 = s1 + kT * kLd;
  float* s3 = s2 + kT * kLd;
  float* sM = s3 + kT * kLd;   // M (rows j, columns i), then dCB^T
  float* vec = sM + kT * kLd;
  auto V = [&](int v) { return vec + v * kT; };
  float *sDt = V(kDt), *sCs = V(kCs), *sEcs = V(kEcs), *sW = V(kW), *sRed = V(kRed);

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, nt = gridDim.x;
  const int ngroups = gridDim.y;
  const int h0 = grp * group, h1 = min(H, h0 + group);
  const int t0 = c * kT, rows = min(kT, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int r0 = 16 * wr, c0 = 32 * wc;
  const bool has_h = c > 0, has_g = c < nt - 1 || dhf != nullptr;
  const long long slot = (long long)P * N;
  const T* Bt = B + b * bs_b + t0 * bs_t;
  const T* Ct = C + b * cs_b + t0 * cs_t;
  // the group's dB / dC partial of token t0 + i, column n
  auto part_at = [&](float* base, int i, int n) {
    return base + (((long long)b * S + t0 + i) * ngroups + grp) * N + n;
  };

  for (int i = tid; i < rows * N; i += kN) {
    *part_at(dcp, i / N, i % N) = 0.f;
    *part_at(dbp, i / N, i % N) = 0.f;
  }

  // C B^T as CB^T (rows j, columns i), B_j . C_i, once for the block
  float cbt[4][4] = {}, dcbt[4][4] = {}, acc[4][4];
  for (int nb = 0; nb < N; nb += kD) {
    __syncthreads();
    load_f32<kN>(s1, Bt, bs_t, rows, nb, N);
    load_f32<kN>(s2, Ct, cs_t, rows, nb, N);
    __syncthreads();
    mm<4, kEx, kEx>(cbt, 0, 8, [&](int r, int k) { return s1[(r0 + r) * kLd + k]; },
                    [&](int k, int cc) { return s2[(c0 + cc) * kLd + k]; });
  }

  for (int hd = h0; hd < h1; ++hd) {
    const float a = A[hd];
    const T* xt = x + b * xs_b + t0 * xs_t + hd * xs_h;
    const float* dyt = dy + (((long long)b * S + t0) * H + hd) * P;
    const long long dys = (long long)H * P;
    const float* Hm = has_h ? hst + (((long long)b * (nt - 1) + c - 1) * H + hd) * slot : nullptr;
    const float* Gm = !has_g ? nullptr
                      : c < nt - 1 ? gst + (((long long)b * (nt - 1) + c) * H + hd) * slot
                                   : dhf + ((long long)b * H + hd) * slot;
    __syncthreads();   // the previous head's vectors are read
    stage_dt(sDt, dt, b, t0, S, H, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // cs, exp(cs), w; <G, H> for the state's decay, in a fixed order
    if (warp == 0) scan_cs(sDt, a, sCs, sEcs, sW);
    if (has_h && has_g) {
      float gh = 0.f;
      for (long long i = tid; i < slot; i += kN) gh = fmaf(Gm[i], Hm[i], gh);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(kFull, gh, o);
      if (lane == 0) sRed[warp] = gh;
    }

    // dC_i += exp(cs_i) H^T dy_i (rows i, columns n); y's carried-state
    // term gives dcs_i its share sum_n C_i[n] exp(cs_i) (H^T dy_i)[n]
    float part[2] = {0.f, 0.f};
    if (has_h) {
      for (int nb = 0; nb < N; nb += kD) {
        zero(acc);
        for (int pb = 0; pb < P; pb += kD) {
          __syncthreads();
          load_f32<kN>(s1, dyt, dys, rows, pb, P);
          load_f32<kN>(s2, Hm + (long long)pb * N, N, P - pb, nb, N);
          __syncthreads();
          mm<4, false, false>(acc, 0, 8, [&](int r, int k) { return s1[(r0 + r) * kLd + k]; },
                              [&](int k, int cc) { return s2[k * kLd + c0 + cc]; });
        }
        __syncthreads();
        load_f32<kN>(s3, Ct, cs_t, rows, nb, N);
        __syncthreads();
        each(acc, [&](int r, int cc, int n, int e) {
          const float v = sEcs[r0 + r] * acc[n][e];
          if (r0 + r < rows && nb + c0 + cc < N) *part_at(dcp, r0 + r, nb + c0 + cc) += v;
          part[r >> 3] = fmaf(s3[(r0 + r) * kLd + c0 + cc], v, part[r >> 3]);
        });
      }
    }
    quad_rows(part, V(kYoff + wc) + r0);

    // dM^T (rows j, columns i) = x_j . dy_i over p, then M^T, dCB^T and T^T
    // on the causal pairs i >= j (ssd_bwd.cu's reductions)
    zero(acc);
    for (int pb = 0; pb < P; pb += kD) {
      __syncthreads();
      load_f32<kN>(s1, xt, xs_t, rows, pb, P);
      load_f32<kN>(s2, dyt, dys, rows, pb, P);
      __syncthreads();
      mm<4, kEx, false>(acc, 0, 8, [&](int r, int k) { return s1[(r0 + r) * kLd + k]; },
                        [&](int k, int cc) { return s2[(c0 + cc) * kLd + k]; });
    }
    float rowp[4][2] = {};
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
      sM[j * kLd + i] = m;
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

    // dx_j = w_j G B_j + sum_i M_ij dy_i (rows j, columns p), a slab of p at
    // a time; dw_j = x_j . G B_j
    part[0] = part[1] = 0.f;
    for (int pb = 0; pb < P; pb += kD) {
      zero(acc);
      if (has_g) {
        for (int nb = 0; nb < N; nb += kD) {
          __syncthreads();
          load_f32<kN>(s1, Bt, bs_t, rows, nb, N);
          load_f32<kN>(s2, Gm + (long long)pb * N, N, P - pb, nb, N);
          __syncthreads();
          mm<4, kEx, false>(acc, 0, 8, [&](int r, int k) { return s1[(r0 + r) * kLd + k]; },
                            [&](int k, int cc) { return s2[(c0 + cc) * kLd + k]; });
        }
        __syncthreads();
        load_f32<kN>(s3, xt, xs_t, rows, pb, P);
        __syncthreads();
        each(acc, [&](int r, int cc, int n, int e) {
          part[r >> 3] = fmaf(s3[(r0 + r) * kLd + c0 + cc], acc[n][e], part[r >> 3]);
          acc[n][e] *= sW[r0 + r];
        });
      }
      __syncthreads();
      load_f32<kN>(s1, dyt, dys, rows, pb, P);
      __syncthreads();
      mm<4, false, false>(acc, 2 * wr, 8, [&](int r, int k) { return sM[(r0 + r) * kLd + k]; },
                          [&](int k, int cc) { return s1[k * kLd + c0 + cc]; });
      each(acc, [&](int r, int cc, int n, int e) {
        if (r0 + r < rows && pb + c0 + cc < P)
          st(dx + (((long long)b * S + t0 + r0 + r) * H + hd) * P + pb + c0 + cc, acc[n][e]);
      });
    }
    quad_rows(part, V(kDw + wc) + r0);

    // dB_j += w_j G^T x_j (rows j, columns n)
    if (has_g) {
      for (int nb = 0; nb < N; nb += kD) {
        zero(acc);
        for (int pb = 0; pb < P; pb += kD) {
          __syncthreads();
          load_f32<kN>(s1, xt, xs_t, rows, pb, P);
          load_f32<kN>(s2, Gm + (long long)pb * N, N, P - pb, nb, N);
          __syncthreads();
          mm<4, kEx, false>(acc, 0, 8, [&](int r, int k) { return s1[(r0 + r) * kLd + k]; },
                            [&](int k, int cc) { return s2[k * kLd + c0 + cc]; });
        }
        each(acc, [&](int r, int cc, int n, int e) {
          if (r0 + r < rows && nb + c0 + cc < N)
            *part_at(dbp, r0 + r, nb + c0 + cc) += sW[r0 + r] * acc[n][e];
        });
      }
    }
    __syncthreads();   // every partial of this head is in shared memory

    // dcs, its reverse cumsum ddA, ddt and dA's partial (warp 0, two tokens
    // a lane: lane and lane + 32), as ssd_bwd.cu
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
  }

  // dCB (summed over the group's heads) through shared memory as dCB^T;
  // dC_i += sum_{j <= i} dCB_ij B_j, dB_j += sum_{i >= j} dCB_ij C_i
  __syncthreads();   // every warp is done with M
  each(dcbt, [&](int r, int cc, int n, int e) { sM[(r0 + r) * kLd + c0 + cc] = dcbt[n][e]; });
  for (int nb = 0; nb < N; nb += kD) {
    __syncthreads();
    load_f32<kN>(s1, Bt, bs_t, rows, nb, N);
    load_f32<kN>(s2, Ct, cs_t, rows, nb, N);
    __syncthreads();
    float dca[4][4] = {}, dba[4][4] = {};
    mm<4, false, kEx>(dca, 0, 2 * wr + 2, [&](int r, int k) { return sM[k * kLd + r0 + r]; },
                      [&](int k, int cc) { return s1[k * kLd + c0 + cc]; });
    mm<4, false, kEx>(dba, 2 * wr, 8, [&](int r, int k) { return sM[(r0 + r) * kLd + k]; },
                      [&](int k, int cc) { return s2[k * kLd + c0 + cc]; });
    each(dca, [&](int r, int cc, int n, int e) {
      if (r0 + r < rows && nb + c0 + cc < N) {
        *part_at(dcp, r0 + r, nb + c0 + cc) += dca[n][e];
        *part_at(dbp, r0 + r, nb + c0 + cc) += dba[n][e];
      }
    });
  }
}

template <typename T>
cudaError_t launch_any(const Args& r, cudaStream_t stream) {
  const int nt = (r.s + kT - 1) / kT, ngroups = (r.h + r.group - 1) / r.group;
  const T* x = static_cast<const T*>(r.x);
  const T* B = static_cast<const T*>(r.B);
  const T* C = static_cast<const T*>(r.C);
  const long long* s = r.st;
  constexpr int smem = AnySmem<T>::kBytes;
  static bool raised = false;
  cudaError_t e;
  if (!raised) {
    if ((e = raise_smem(ssd_bwd_tile_any<T>, smem)) != cudaSuccess) return e;
    raised = true;
  }
  if (nt > 1) {
    e = PLAN_LAUNCH("ssd_bwd_state_any", ssd_bwd_state_any<T>, dim3(nt, r.h, r.b), dim3(128), 0,
                    stream, x, r.dt, r.A, B, C, r.dy, r.hst, r.gst, r.decay, r.s, r.h, r.p, r.n,
                    s[0], s[1], s[2], s[3], s[4], s[5], s[6]);
    if (e != cudaSuccess) return e;
    if (nt > 2 || r.dhf != nullptr) {
      const long long pn = (long long)r.p * r.n;
      if (pn > 2147483647LL) return cudaErrorInvalidValue;
      e = PLAN_LAUNCH("ssd_bwd_pass_kernel", ssd_bwd_pass_kernel,
                      dim3((unsigned)((pn + 255) / 256), r.h, r.b), dim3(256), 0, stream, r.hst,
                      r.gst, r.decay, r.dhf, nt, r.h, (int)pn);
      if (e != cudaSuccess) return e;
    }
  }
  e = PLAN_LAUNCH("ssd_bwd_tile_any", ssd_bwd_tile_any<T>, dim3(nt, ngroups, r.b),
                  dim3(kTileThreads), smem, stream, x, r.dt, r.A, B, C, r.dy, r.dhf, r.hst,
                  r.gst, static_cast<T*>(r.dx), r.ddt, r.dbp, r.dcp, r.dapart, r.s, r.h, r.p,
                  r.n, r.group, s[0], s[1], s[2], s[3], s[4], s[5], s[6]);
  if (e != cudaSuccess) return e;
  const long long rows_n = (long long)r.b * r.s * r.n;
  const long long blocks = (rows_n + 255) / 256 + 1;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  return PLAN_LAUNCH("ssd_bwd_reduce_kernel", ssd_bwd_reduce_kernel<T>, dim3((unsigned)blocks),
                     dim3(256), 0, stream, r.dbp, r.dcp, r.dapart, static_cast<T*>(r.dB),
                     static_cast<T*>(r.dC), r.dA, rows_n, ngroups, r.n, r.h, r.b * nt);
}

}  // namespace

// ssd_bwd's arguments, scratch and contract (ssd_bwd.cu) at any p >= 1 and
// n >= 1, any alignment.
extern "C" int ssd_bwd_any(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* dy, const void* dhf, void* hst, void* gst,
                           void* decay, void* dx, void* ddt, void* dbp, void* dcp, void* dapart,
                           void* dB, void* dC, void* dA, int dtype, int b, int s, int h, int p,
                           int n, int group, long long xs_b, long long xs_t, long long xs_h,
                           long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                           void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || p < 1 || n < 1 || (dtype != 0 && dtype != 1) ||
      group < 1 || group > h || h > 65535)
    return (int)cudaErrorInvalidValue;
  Args r{x, B, C, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(dy), static_cast<const float*>(dhf),
         static_cast<float*>(hst), static_cast<float*>(gst), static_cast<float*>(decay),
         static_cast<float*>(ddt), static_cast<float*>(dbp), static_cast<float*>(dcp),
         static_cast<float*>(dapart), static_cast<float*>(dA), dx, dB, dC, b, s, h, p, n, group,
         {xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t}};
  const cudaStream_t q = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_any<float>(r, q);
  return (int)launch_any<__nv_bfloat16>(r, q);
}

// Query entry (launch_plan.cuh): ssd_bwd_any's arguments with `plans` in
// place of the stream; every launch is recorded, none made.
extern "C" int ssd_bwd_any_plan(const void* x, const void* dt, const void* A, const void* B,
                                const void* C, const void* dy, const void* dhf, void* hst,
                                void* gst, void* decay, void* dx, void* ddt, void* dbp, void* dcp,
                                void* dapart, void* dB, void* dC, void* dA, int dtype, int b,
                                int s, int h, int p, int n, int group, long long xs_b,
                                long long xs_t, long long xs_h, long long bs_b, long long bs_t,
                                long long cs_b, long long cs_t, long long* plans) {
  plan::Scope scope(plans);
  return ssd_bwd_any(x, dt, A, B, C, dy, dhf, hst, gst, decay, dx, ddt, dbp, dcp, dapart, dB, dC,
                     dA, dtype, b, s, h, p, n, group, xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t,
                     nullptr);
}
