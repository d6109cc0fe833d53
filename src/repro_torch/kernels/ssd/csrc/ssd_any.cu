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
// What the design does about it (ssd.cu's, with n walked in 64-column
// slabs):
// - ssd_cb_any: C B^T of each (b, tile), summed over n slab by slab (each
//   slab's part from zero, the parts added in f32, as C h^T below), into
//   the scan's f32 scratch in ssd.cu's fragment order; the next slab of B
//   and C is copied by cp.async into the other half of a double buffer
//   while this one is multiplied, one barrier a slab.
// - ssd_scan_any: one block of 4 warps per (32-column group of p, head,
//   batch), walking the tiles in order; any p is more groups, the ragged
//   last one masked.  A step is one (tile, 64-column slab of n): a
//   two-stage cp.async ring holds the step's B and C slabs, and the next
//   step's are in flight while this one computes; x and dt are copied with
//   a tile's first slab, into a buffer of the tile's parity, dt in a
//   cp.async group of its own so that warp 0 waits for it alone and runs
//   the next tile's prefix sum (ssd.cu's, one add after the other) at the
//   end of this one.  Per step: S x at the tile's first slab (ssd.cu's
//   causal walk over the C B^T fragments, read a tile ahead into
//   registers), C h^T over the slab into y's accumulators, and the slab's
//   state: x^T (w B) from zero on the tensor cores in the accumulator
//   registers, then h exp(cs_last) added in f32 (accumulating onto h in
//   the mma chain would round h a little at every tile: the tensor cores'
//   f32 accumulation does not round to nearest).
// - The block's 32 rows of h are resident in shared memory in f32 for the
//   whole walk (rows of ceil(n / 64) * 64 + 4 floats: C h^T's B fragments
//   hit 32 distinct banks), read for C h^T and the decay and rewritten
//   slab by slab, two barriers a step (the copy is single: a second would
//   cost f32 its second block an SM); h_final is written once, after the
//   last tile.  Up to n = kMaxResidentN = 1024 (16 slabs: 225,280 bytes of
//   shared memory in f32); a wider state walks h in h_final itself, the
//   same code with h's rows in device memory (kResident = false).
// - Shared memory at n 128: 65,536 bytes on bf16 views (3 blocks an SM),
//   110,592 in f32 (2).  Where an address or a row is not a multiple of 16
//   bytes, the same kernels stage element by element (kVec = false).
// - Products: mma.sync m16n8k8 TF32, 3xTF32 for f32 operands, 2xTF32 where
//   one operand is a bf16 value (exact in TF32), C B^T on bf16 views at one
//   product, as in ssd.cu; exp is ssd.cu's __expf.
// ssd.cu's kernels keep their code: this is a translation unit of its own,
// with its own entry point, that includes ssd.cu for its helpers only.

#define SSD_HELPERS_ONLY
#include "ssd.cu"

namespace {

constexpr int kSn = 64;                 // columns of n a slab
constexpr int kMaxResidentN = 1024;     // the widest n whose h stays in shared memory

// Shared memory of ssd_scan_any: two ring stages of a B and a C slab, x of
// either tile parity, the vectors (dt, then cs and w, of either parity),
// and the resident h.
template <typename T>
struct AnySmem {
  static constexpr int kB = kT * Ld<T>::b * sizeof(T);
  static constexpr int kC = kT * Ld<T>::c * sizeof(T);
  static constexpr int kStage = kB + kC;
  static constexpr int kX = kT * Ld<T>::x * sizeof(T);
  static constexpr int kVecs = 6 * kT * 4;
  static constexpr int kFixed = 2 * kStage + 2 * kX + kVecs;
  __host__ __device__ static constexpr int ld_h(int ns) { return ns * kSn + 4; }
  __host__ __device__ static constexpr int bytes(int ns, bool resident) {
    return kFixed + (resident ? kPG * ld_h(ns) * 4 : 0);
  }
};
static_assert(AnySmem<float>::kStage % 16 == 0 && AnySmem<float>::kX % 16 == 0 &&
                  AnySmem<__nv_bfloat16>::kStage % 16 == 0 &&
                  AnySmem<__nv_bfloat16>::kX % 16 == 0 && AnySmem<float>::kB % 16 == 0 &&
                  AnySmem<__nv_bfloat16>::kB % 16 == 0,
              "16-byte parts");
static_assert(AnySmem<float>::bytes(kMaxResidentN / kSn, true) <= 232448 &&
                  AnySmem<__nv_bfloat16>::bytes(kMaxResidentN / kSn, true) <= 232448,
              "227 KB of shared memory a block");

// C B^T of one (b, tile) over every slab of n, written as ssd_cb_kernel
// writes it.  Warp w owns rows 16 w .. 16 w + 15.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_cb_any(const T* __restrict__ B, const T* __restrict__ C, float* __restrict__ cb, int S,
           int N, long long bs_b, long long bs_t, long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int LD = Ld<T>::c;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);   // [stage][B, C][64 x LD]
  const int tile = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int t0 = tile * kT, rows = min(kT, S - t0), ns = (N + kSn - 1) / kSn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const T* Bt = B + b * bs_b + t0 * bs_t;
  const T* Ct = C + b * cs_b + t0 * cs_t;
  auto stage = [&](int k) {
    T* d = base + (k & 1) * 2 * kT * LD;
    stage_rows<T, kSn, LD, kVec>(d, Bt + k * kSn, bs_t, rows, N - k * kSn);
    stage_rows<T, kSn, LD, kVec>(d + kT * LD, Ct + k * kSn, cs_t, rows, N - k * kSn);
    cp_async_commit();
  };
  // each thread's elements of the tile's C B^T, in the order the scan
  // reads its A fragments: element (i, j) at warp i / 16, k-step j / 8,
  // lane 4 (i % 8) + j % 4, slot (i % 16) / 8 + 2 ((j % 8) / 4)
  float* out = cb + ((long long)b * nt + tile) * kT * kT + warp * 8 * 32 * 4;
  auto at = [&](int j, int e) {
    const int li = g + 8 * (e >> 1), lc = 2 * t + (e & 1);
    return out + (j * 32 + (li & 7) * 4 + (lc & 3)) * 4 + (li >> 3) + 2 * (lc >> 2);
  };
  // k = -1 only copies slab 0: one call site of stage, which stays inline
  for (int k = -1; k < ns; ++k) {
    // one barrier a slab: it publishes slab k, and every warp is done with
    // slab k - 1, whose half the copy of slab k + 1 takes
    if (k >= 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (k + 1 < ns) stage(k + 1);
    if (k < 0) continue;
    const T* sb = base + (k & 1) * 2 * kT * LD;
    const T* sc = sb + kT * LD;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSn / 8; ++kk) {
      const T* pc = sc + (r0 + g) * LD + 8 * kk + t;
      const float av[4] = {to_f32(pc[0]), to_f32(pc[8 * LD]), to_f32(pc[4]),
                           to_f32(pc[8 * LD + 4])};
      const Frag<4, kEx> a(av);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* pb = sb + (8 * j + g) * LD + 8 * kk + t;
        const float bv[2] = {to_f32(pb[0]), to_f32(pb[4])};
        mma(acc[j], a, Frag<2, kEx>(bv));
      }
    }
    // the slab's part, added to the earlier slabs' in f32 by the thread
    // that owns the element (a second accumulator in registers spilled)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) *at(j, e) = k == 0 ? acc[j][e] : *at(j, e) + acc[j][e];
  }
}

// Block (p group, head, batch).  kResident: h's rows in shared memory, and
// hout (b, h, p, n) written after the last tile; otherwise h lives in hout.
template <typename T, bool kVec, bool kResident>
__global__ void __launch_bounds__(kThreads, Ld<T>::kExact && kResident ? 3 : 2)
ssd_scan_any(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
             const T* __restrict__ B, const T* __restrict__ C, const float* __restrict__ cb,
             float* __restrict__ y, float* hout, int S, int H, int P, int N, long long xs_b,
             long long xs_t, long long xs_h, long long bs_b, long long bs_t, long long cs_b,
             long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int LX = Ld<T>::x, LB = Ld<T>::b, LC = Ld<T>::c;
  using Sm = AnySmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto sb = [&](int st) { return reinterpret_cast<T*>(smem_raw + st * Sm::kStage); };
  auto sc = [&](int st) { return reinterpret_cast<T*>(smem_raw + st * Sm::kStage + Sm::kB); };
  auto sx = [&](int q) { return reinterpret_cast<T*>(smem_raw + 2 * Sm::kStage + q * Sm::kX); };
  float* vecs = reinterpret_cast<float*>(smem_raw + 2 * Sm::kStage + 2 * Sm::kX);
  auto sdt = [&](int q) { return vecs + q * kT; };
  auto scs = [&](int q) { return vecs + 2 * kT + q * 2 * kT; };   // cs, then w

  const int grp = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int p0 = grp * kPG, pw = min(kPG, P - p0);   // this block's columns of p
  const int nt = (S + kT - 1) / kT, ns = (N + kSn - 1) / kSn, steps = nt * ns;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp, nb = 16 * warp;
  const T* xb = x + b * xs_b + hd * xs_h + p0;
  const T* Bb = B + b * bs_b;
  const T* Cb = C + b * cs_b;
  const float* dtb = dt + (long long)b * S * H + hd;
  // this warp's A fragments of C B^T: 8 k-steps of 32 lanes x 4 floats a tile
  const float4* cbw = reinterpret_cast<const float4*>(cb + (long long)b * nt * kT * kT) +
                      warp * 8 * 32 + lane;
  float* hg = hout + ((long long)b * H + hd) * P * N + (long long)p0 * N;   // the group's rows
  float* hs = kResident ? vecs + 6 * kT : hg;
  const int ldh = kResident ? Sm::ld_h(ns) : N;
  const float a = A[hd];

  // two commit groups a step: dt (a tile's first slab only; copied by warp
  // 0, which scans it), then x (the first slab) and the B and C slabs
  auto stage = [&](int step) {
    const int tile = step / ns, k = step % ns, q = tile & 1, st = step & 1;
    const int t0 = tile * kT, rows = min(kT, S - t0);
    if (k == 0 && warp == 0) {
#pragma unroll
      for (int r = lane; r < kT; r += 32)
        cp_async4(sdt(q) + r, r < rows ? dtb + (long long)(t0 + r) * H : dtb, r < rows);
    }
    cp_async_commit();
    if (k == 0) stage_rows<T, kPG, LX, kVec>(sx(q), xb + t0 * xs_t, xs_t, rows, pw);
    stage_rows<T, kSn, LB, kVec>(sb(st), Bb + t0 * bs_t + k * kSn, bs_t, rows, N - k * kSn);
    stage_rows<T, kSn, LC, kVec>(sc(st), Cb + t0 * cs_t + k * kSn, cs_t, rows, N - k * kSn);
    cp_async_commit();
  };
  // warp 0, once the dt of parity q has landed: cs and w into scs(q)
  auto scan = [&](int q) {
    const float* d = sdt(q);
    float* c = scs(q);
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
  // the keys of warp w's rows end in k-step 2 w + 1 (causal)
  float4 cbr[kT / 8];
  auto load_cb = [&](int tile) {
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk)
      if (kk <= 2 * warp + 1) cbr[kk] = __ldg(cbw + (long long)tile * kT * kT / 4 + kk * 32);
  };

  stage(0);
  load_cb(0);
  if (warp == 0) {
    cp_async_wait<1>();   // the dt group
    __syncwarp();
    scan(0);
  }
  float yd[4][4], yo[4][4];
  for (int step = 0; step < steps; ++step) {
    const int tile = step / ns, k = step % ns, q = tile & 1, st = step & 1;
    const int n0 = k * kSn;
    // the step's stage, cs and w, and h of the previous slab; every warp is
    // past the previous step, whose ring stage the next copy takes
    cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < steps) stage(step + 1);
    const T* tx = sx(q);
    const T* tb = sb(st);
    const T* tc = sc(st);
    const float* cs_w = scs(q);
    const float* w_w = cs_w + kT;
    const float* tdt = sdt(q);
    const float cs_g = cs_w[r0 + g], cs_g8 = cs_w[r0 + g + 8];

    if (k == 0) {   // S x for rows r0 + g and r0 + g + 8 over the keys up to the diagonal
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yd[j][e] = yo[j][e] = 0.f;
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
    }
    // C h^T over the slab, with h after the previous tile (zero before the
    // first); h's B fragments from its rows p = 8 n + g.  Each slab's part
    // from zero, added to y's in f32: one mma chain over all of n rounds
    // worse with n (the tensor cores' accumulation does not round to
    // nearest; past n 1000, 2e-4 off float64 on unit-normal inputs)
    if (tile > 0) {
      float part[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kSn / 8; ++kk) {
        const T* pc = tc + (r0 + g) * LC + 8 * kk + t;
        const float av[4] = {to_f32(pc[0]), to_f32(pc[8 * LC]), to_f32(pc[4]),
                             to_f32(pc[8 * LC + 4])};
        const Frag<4, kEx> af(av);
        const int c0 = n0 + 8 * kk + t;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int p = 8 * n + g;
          const float* ph = hs + p * ldh + c0;
          float bv[2];
          if constexpr (kResident) {
            bv[0] = ph[0];
            bv[1] = ph[4];
          } else {
            bv[0] = p < pw && c0 < N ? ph[0] : 0.f;
            bv[1] = p < pw && c0 + 4 < N ? ph[4] : 0.f;
          }
          mma(part[n], af, Frag<2, false>(bv));
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yo[n][e] += part[n][e];
    }
    // the slab's state: rows p = 16 mi + g (+ 8), columns n0 + nb + 8 ni +
    // 2 t (+ 1); x^T (w B) from zero, then h exp(cs_last) added in f32
    float hacc[2][2][4] = {};
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
    if (tile > 0) {
      const float decay = __expf(cs_w[kT - 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 16 * mi + g + 8 * (e >> 1), n = n0 + nb + 8 * ni + 2 * t + (e & 1);
            if (kResident || (p < pw && n < N))
              hacc[mi][ni][e] = fmaf(hs[p * ldh + n], decay, hacc[mi][ni][e]);
          }
    }
    __syncthreads();   // every warp has read this slab of h
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * mi + g + 8 * (e >> 1), n = n0 + nb + 8 * ni + 2 * t + (e & 1);
          if (kResident || (p < pw && n < N)) hs[p * ldh + n] = hacc[mi][ni][e];
        }

    if (k == ns - 1) {   // the tile's last slab: y, then the next tile's C B^T, cs and w
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
      if (tile + 1 < nt) {
        load_cb(tile + 1);
        if (warp == 0) {
          cp_async_wait<1>();   // the next tile's dt group, issued this step
          __syncwarp();
          scan(q ^ 1);
        }
      }
    }
  }
  if constexpr (kResident) {   // h_final, row by row
    __syncthreads();
    for (int i = tid; i < pw * N; i += kThreads) {
      const int r = i / N, c = i % N;
      hg[(long long)r * N + c] = hs[r * ldh + c];
    }
  }
}

template <typename K>
cudaError_t raise_smem(K kernel, bool& raised) {
  if (raised) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  raised = e == cudaSuccess;
  return e;
}

template <typename T, bool kVec, bool kResident>
cudaError_t launch_scan(const void* x, const float* dt, const float* A, const T* B, const T* C,
                        const float* cb, float* y, float* hout, int b, int s, int h, int p,
                        int n, const long long* st, cudaStream_t stream) {
  static bool raised = false;
  cudaError_t e = raise_smem(ssd_scan_any<T, kVec, kResident>, raised);
  if (e != cudaSuccess) return e;
  const int smem = AnySmem<T>::bytes((n + kSn - 1) / kSn, kResident);
  return PLAN_LAUNCH("ssd_scan_any", (ssd_scan_any<T, kVec, kResident>),
                     dim3((p + kPG - 1) / kPG, h, b), dim3(kThreads), smem, stream,
                     static_cast<const T*>(x), dt, A, B, C, cb, y, hout, s, h, p, n, st[0],
                     st[1], st[2], st[3], st[4], st[5], st[6]);
}

template <typename T, bool kVec>
cudaError_t launch_any(const void* x, const float* dt, const float* A, const void* B,
                       const void* C, float* cb, float* y, float* hout, int b, int s, int h,
                       int p, int n, const long long* st, cudaStream_t stream) {
  const int nt = (s + kT - 1) / kT;
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  static bool raised = false;
  cudaError_t e = raise_smem(ssd_cb_any<T, kVec>, raised);
  if (e != cudaSuccess) return e;
  e = PLAN_LAUNCH("ssd_cb_any", (ssd_cb_any<T, kVec>), dim3(nt, b), dim3(kThreads),
                  4 * kT * Ld<T>::c * (int)sizeof(T), stream, Bt, Ct, cb, s, n, st[3], st[4],
                  st[5], st[6]);
  if (e != cudaSuccess) return e;
  if (n <= kMaxResidentN)
    return launch_scan<T, kVec, true>(x, dt, A, Bt, Ct, cb, y, hout, b, s, h, p, n, st, stream);
  return launch_scan<T, kVec, false>(x, dt, A, Bt, Ct, cb, y, hout, b, s, h, p, n, st, stream);
}

}  // namespace

// ssd_fwd's arguments and contract (ssd.cu) at any p >= 1 and n >= 1: x
// (b, s, h, p) with element strides xs_b, xs_t, xs_h and a unit stride on
// p; B and C (b, s, n) with strides bs_b, bs_t and cs_b, cs_t and a unit
// stride on n; dt (b, s, h) and A (h,) contiguous f32; cb a scratch of b *
// ceil(s / 64) * 64 * 64 f32; y (b, s, h, p) and hout (b, h, p, n)
// contiguous f32.  Any alignment: 16-byte copies need 16-byte aligned
// pointers and strides and p, n multiples of 16 bytes; anything else
// stages element by element in the same kernels.
extern "C" int ssd_fwd_any(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, void* cb, void* y, void* hout, int dtype, int b, int s,
                           int h, int p, int n, long long xs_b, long long xs_t, long long xs_h,
                           long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                           void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || h > 65535 || p < 1 || n < 1 ||
      (dtype != 0 && dtype != 1))
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
    return (int)(vec ? launch_any<float, true>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n,
                                               st, q)
                     : launch_any<float, false>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p, n,
                                                st, q));
  return (int)(vec ? launch_any<__nv_bfloat16, true>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h, p,
                                                     n, st, q)
                   : launch_any<__nv_bfloat16, false>(x, dtf, Af, B, C, cbf, yf, hf, b, s, h,
                                                      p, n, st, q));
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
