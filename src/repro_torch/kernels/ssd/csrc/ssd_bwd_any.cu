// Backward of the Mamba2 SSD scan at any head dim p and state width n for
// Hopper (sm_90a) on the tensor cores, plain C interface: what ssd_bwd.cu
// (p, n <= 64) does not take.
//
// Replaces JAX's autodiff of src/repro/models/ssm.py:207 ssd_chunked over
// the rest of its domain (any p and n; zamba2-2.7b's Mamba2 layer at
// ssm_state 128 trains there).  The contract and the math are ssd_bwd.cu's,
// whose helpers this file includes: per 64-token tile the states H_c and
// state gradients G_c, then every gradient term of the tile (dx, ddt, dA's
// partial, dB and dC summed over a head group) and a reduction of the
// groups, deterministic with no atomics.
//
// Bound on an H100 SXM: ssd_bwd.cu's count with p and n free (chip_smoke.py
// ssd_bwd_work): at zamba2's shape with n 128 (b 4, s 512, h 80, p 64, bf16
// xBC views) 14.84 GFLOP at the 2x/3xTF32 rates (C B^T, both operands
// bf16, at the bf16 rate) against 87.3 MB read and written once: 0.0667 ms,
// the operations bound.
//
// What the design does about it:
// - ssd_bwd_scan_any, one warp per (b, tile, head): ssd_bwd.cu's scan_cs
//   (the forward's prefix sum, one add after the other) into a scratch of
//   dt, cs, exp(cs) and w per tile, so that no other kernel runs a serial
//   scan: (4, b, tiles, h, 64) f32, 2.6 MB at zamba2's shape, in place of
//   ssd_bwd.cu's decay scratch.
// - ssd_bwd_state_any, 4 warps per (walk, 64 x 64 block of (p, n), head,
//   batch): the tile-local states and the recurrence in one walk over the
//   tiles, the running sum in registers.  A forward walk, H_c =
//   fmaf(H_{c-1}, exp(cs_L), local_c) with local_c = sum_j x_j (w_j
//   B_j)^T; a backward walk, in blocks of its own, G_{c-1} = fmaf(G_c,
//   exp(cs_L of c), local'_c) from dh_final (or 0) with local'_c = sum_t
//   exp(cs_t) dy_t C_t^T: the pass kernel's order of operations, so H and G
//   keep their values.  Each state is written once
//   (hst, gst) and read once by the tile kernel: at zamba2's shape 4 x
//   73.4 MB, where ssd_bwd.cu's state kernel and its in-place pass moved
//   about 0.8 GB.  A two-stage cp.async ring copies the next tile's slabs
//   while this one is multiplied.
// - ssd_bwd_tile_any, 8 warps per (tile, head group, batch), each warp a
//   16 x 32 part of a 64 x 64 result.  A p wider than 64 is walked as
//   virtual heads, one 64-column slab of a head's p each (the scan's
//   columns are independent; the log-decay gradient sums over them): x and
//   dy of a virtual head are staged once, its H and G 64 x 64 slabs
//   (columns of n) once each through a two-stage cp.async ring that runs
//   across the virtual heads, so every product of a head reads shared
//   memory only.  B and C are resident for the block (staged once) up to n
//   = kNC = 128; C B^T once a block.  Products over n (C B^T, G B) form
//   each slab's part from zero and add the parts in f32: one mma chain
//   over all of n rounds worse with n.  The group's dB and dC partials stay
//   in registers across the heads (2 x 32 a thread at n 128) and each
//   element of dbp / dcp is written once a block.  A wider n walks its
//   128-column chunks inside each virtual head, B and C staged again a
//   chunk, and the chunks' partials are added into dbp / dcp (the first
//   virtual head writes them).  <G, H> from the staged slabs.  Shared
//   memory: 162,816 bytes on bf16 views, 203,776 in f32: one block an SM.
// - Staging: 16-byte cp.async where the rows allow it, else element loads
//   eight in flight a thread before their stores (kVec = false).
// - Products: mma.sync m16n8k8 TF32, 3xTF32 for f32 operands, 2xTF32 with
//   a bf16 operand, C B^T on bf16 views at one product; exp is expf (the
//   gradient is held against float64).
// - ssd_bwd_reduce_kernel: ssd_bwd.cu's sums of the groups and of dA.
// ssd_bwd.cu's kernels keep their code: this is a translation unit of its
// own, with its own entry point, that includes ssd_bwd.cu for its helpers.

#define SSD_HELPERS_ONLY
#include "ssd_bwd.cu"

namespace {

constexpr int kNC = 128;   // columns of n whose dB and dC partials stay in registers

// Rows 0 .. 63 and columns 0 .. 63 of a (rows, stride) slice into a shared
// tile of row stride LD, 0 past n_rows and cols, by kN threads.  kVec:
// 16-byte cp.async (16-byte aligned rows, cols a multiple of 16 bytes), not
// unrolled (ssd_bwd.cu's stage: unrolled, the copies' offsets stay live
// across the tile kernel's loops and spill); otherwise element by element,
// eight loads in flight a thread before their stores.
template <typename T, int LD, bool kVec, int kN>
__device__ __forceinline__ void stage_any(T* dst, const T* src, long long stride, int n_rows,
                                          int cols) {
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T), kChunks = kD / kE;
#pragma unroll 1
    for (int j = 0; j < kT * kChunks / kN; ++j) {
      const int i = threadIdx.x + j * kN, r = i / kChunks, c = (i % kChunks) * kE;
      const bool valid = r < n_rows && c < cols;
      cp_async16(dst + r * LD + c, valid ? src + r * stride + c : src, valid);
    }
  } else {
    constexpr int kBatch = 8;
#pragma unroll 1
    for (int j0 = 0; j0 < kT * kD / kN; j0 += kBatch) {
      T v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (j0 + j) * kN, r = i / kD, c = i % kD;
        v[j] = (r < n_rows && c < cols) ? src[r * stride + c] : T(0.f);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (j0 + j) * kN;
        dst[(i / kD) * LD + i % kD] = v[j];
      }
    }
  }
}

// 64 floats of the tile-scan scratch into shared memory, by threads 0 .. 15
__device__ __forceinline__ void stage_vec(float* dst, const float* src) {
  if (threadIdx.x < kT / 4) cp_async16(dst + 4 * threadIdx.x, src + 4 * threadIdx.x, true);
}

// One warp per (b, tile, head), idx = (b * tiles + tile) * h + head: dt (0
// past s), cs, exp(cs) and w into the four planes of tsc.
__global__ void __launch_bounds__(128)
ssd_bwd_scan_any(const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ tsc, long long total, int S, int H, int nt) {
  __shared__ float sdt[4][kT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long idx = (long long)blockIdx.x * 4 + warp;
  if (idx >= total) return;
  const int hd = (int)(idx % H), c = (int)(idx / H % nt);
  const long long b = idx / H / nt;
  const int t0 = c * kT;
  float* d = sdt[warp];
#pragma unroll
  for (int r = lane; r < kT; r += 32) d[r] = t0 + r < S ? dt[(b * S + t0 + r) * H + hd] : 0.f;
  __syncwarp();
  const long long plane = total * kT;
  float* o = tsc + idx * kT;
  o[lane] = d[lane];
  o[lane + 32] = d[lane + 32];
  scan_cs(d, A[hd], o + plane, o + 2 * plane, o + 3 * plane);
}

// ---------------------------------------------------------------------------
// the states

template <typename T>
struct StateAny {
  static constexpr int kA = kT * kLdCol * 4;             // x (T) or dy (f32)
  static constexpr int kB = kT * kLdCol * sizeof(T);     // B or C
  static constexpr int kStage = kA + kB + (kT + 4) * 4;  // + w or exp(cs), exp(cs_L)
  static constexpr int kBytes = 2 * kStage;
  static_assert(kB % 16 == 0 && kStage % 16 == 0, "16-byte stage parts");
};

// Block (walk, 64 x 64 block of (p, n), head, batch): the first half of
// the grid's x walks forward, step s taking tile s's local state and H_s
// into hst slot s; the second half backward, step s taking tile u = tiles
// - 1 - s's local state gradient and G_{u-1} into gst slot u - 1.  Warp w:
// rows p = 16 w .. 16 w + 15 of the block, its 64 columns of n.
template <typename T, bool kVec>
__global__ void __launch_bounds__(128)
ssd_bwd_state_any(const T* __restrict__ x, const T* __restrict__ B, const T* __restrict__ C,
                  const float* __restrict__ dy, const float* __restrict__ dhf,
                  const float* __restrict__ tsc, float* __restrict__ hst,
                  float* __restrict__ gst, int S, int H, int P, int N, long long xs_b,
                  long long xs_t, long long xs_h, long long bs_b, long long bs_t, long long cs_b,
                  long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  using Sm = StateAny<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pblocks = (P + kD - 1) / kD, blocks = gridDim.x / 2;
  const bool fwd = (int)blockIdx.x < blocks;
  const int pn = fwd ? blockIdx.x : blockIdx.x - blocks;
  const int pp = kD * (pn % pblocks), nn = kD * (pn / pblocks);
  const int hd = blockIdx.y, b = blockIdx.z, nt = (S + kT - 1) / kT, steps = nt - 1;
  const int warp = threadIdx.x >> 5, p0 = 16 * warp;
  const long long plane = (long long)gridDim.z * nt * H * kT;
  const long long slot_size = (long long)P * N;
  auto stage = [&](int s) {
    unsigned char* st = smem_raw + (s & 1) * Sm::kStage;
    const int u = fwd ? s : nt - 1 - s, t0 = u * kT, rows = min(kT, S - t0);
    const float* ecs = tsc + 2 * plane + (((long long)b * nt + u) * H + hd) * kT;
    float* vec = reinterpret_cast<float*>(st + Sm::kA + Sm::kB);
    if (fwd) {
      stage_any<T, kLdCol, kVec, 128>(reinterpret_cast<T*>(st),
                                      x + b * xs_b + t0 * xs_t + hd * xs_h + pp, xs_t, rows,
                                      P - pp);
      stage_any<T, kLdCol, kVec, 128>(reinterpret_cast<T*>(st + Sm::kA),
                                      B + b * bs_b + t0 * bs_t + nn, bs_t, rows, N - nn);
      stage_vec(vec, ecs + plane);   // w
    } else {
      stage_any<float, kLdCol, kVec, 128>(reinterpret_cast<float*>(st),
                                          dy + (((long long)b * S + t0) * H + hd) * P + pp,
                                          (long long)H * P, rows, P - pp);
      stage_any<T, kLdCol, kVec, 128>(reinterpret_cast<T*>(st + Sm::kA),
                                      C + b * cs_b + t0 * cs_t + nn, cs_t, rows, N - nn);
      stage_vec(vec, ecs);
    }
    if (threadIdx.x == 0) cp_async4(vec + kT, ecs + kT - 1, true);   // exp(cs_L)
    cp_async_commit();
  };

  float acc[8][4], run[8][4];
  if (!fwd)   // the backward walk starts from dh_final, or 0
    each(run, [&](int r, int cc, int n, int e) {
      const int p = pp + p0 + r, q = nn + cc;
      run[n][e] = dhf != nullptr && p < P && q < N
                      ? dhf[((long long)b * H + hd) * slot_size + (long long)p * N + q]
                      : 0.f;
    });
  stage(0);
  for (int s = 0; s < steps; ++s) {
    // one barrier a tile: it publishes this step's stage, and every warp is
    // past the previous step, whose stage the next copy takes
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) stage(s + 1);
    const unsigned char* st = smem_raw + (s & 1) * Sm::kStage;
    const float* vec = reinterpret_cast<const float*>(st + Sm::kA + Sm::kB);
    zero(acc);
    if (fwd) {   // sum_j x_j[p] (w_j B_j[n])
      const T* sx = reinterpret_cast<const T*>(st);
      const T* sb = reinterpret_cast<const T*>(st + Sm::kA);
      mm<8, kEx, false>(acc, 0, 8, [&](int r, int k) { return to_f32(sx[k * kLdCol + p0 + r]); },
                        [&](int k, int n) { return vec[k] * to_f32(sb[k * kLdCol + n]); });
    } else {     // sum_t (exp(cs_t) dy_t[p]) C_t[n]
      const float* sdy = reinterpret_cast<const float*>(st);
      const T* sc = reinterpret_cast<const T*>(st + Sm::kA);
      mm<8, false, kEx>(acc, 0, 8, [&](int r, int k) { return vec[k] * sdy[k * kLdCol + p0 + r]; },
                        [&](int k, int n) { return to_f32(sc[k * kLdCol + n]); });
    }
    const float decay = vec[kT];
    each(acc, [&](int r, int cc, int n, int e) {
      run[n][e] = fwd && s == 0 ? acc[n][e] : fmaf(run[n][e], decay, acc[n][e]);
    });
    float* o = (fwd ? hst + (((long long)b * (nt - 1) + s) * H + hd) * slot_size
                    : gst + (((long long)b * (nt - 1) + nt - 2 - s) * H + hd) * slot_size);
    each(run, [&](int r, int cc, int n, int e) {
      const int p = pp + p0 + r, q = nn + cc;
      if (p < P && q < N) o[(long long)p * N + q] = run[n][e];
    });
  }
}

// ---------------------------------------------------------------------------
// the tile's gradient terms

template <typename T>
struct TileAny {
  static constexpr int LI = Ld<T>::in;                    // x
  static constexpr int LBC = kNC + (sizeof(T) == 2 ? 8 : 4);   // B and C, kNC columns
  static constexpr int kBC = kT * LBC * sizeof(T);
  static constexpr int kX = kT * LI * sizeof(T);
  static constexpr int kDy = kT * kLdRow * 4;
  static constexpr int kM = kT * kLdCol * 4;              // M, then dCB^T
  static constexpr int kH = kT * kLdCol * 4, kG = kT * kLdRow * 4;   // a ring stage
  static constexpr int kStage = kH + kG;
  static constexpr int kHeadVecs = 2 * 4 * kT * 4;        // dt, cs, exp(cs), w, two parities
  static constexpr int kBytes = 2 * kBC + kX + kDy + kM + 2 * kStage + kHeadVecs +
                                kVecs * kT * 4;
  static_assert(kBC % 16 == 0 && kX % 16 == 0 && kBytes <= 232448,
                "227 KB of shared memory a block");
};

// Block (tile c, head group, batch): every gradient term of its heads.  dx
// and ddt are final here; the group's dB and dC go to dbp and dcp (b, s,
// groups, n) f32, and dA's partial of (b, c, h) to dapart.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kTileThreads, 1)
ssd_bwd_tile_any(const T* __restrict__ x, const float* __restrict__ A, const T* __restrict__ B,
                 const T* __restrict__ C, const float* __restrict__ dy,
                 const float* __restrict__ dhf, const float* __restrict__ hst,
                 const float* __restrict__ gst, const float* __restrict__ tsc,
                 T* __restrict__ dx, float* __restrict__ ddt, float* dbp, float* dcp,
                 float* __restrict__ dapart, int S, int H, int P, int N, int group,
                 long long xs_b, long long xs_t, long long xs_h, long long bs_b, long long bs_t,
                 long long cs_b, long long cs_t) {
  constexpr bool kEx = Ld<T>::kExact;
  constexpr int kN = kTileThreads, LI = TileAny<T>::LI, LBC = TileAny<T>::LBC;
  using Sm = TileAny<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);
  T* sC = reinterpret_cast<T*>(smem_raw + Sm::kBC);
  T* sX = reinterpret_cast<T*>(smem_raw + 2 * Sm::kBC);
  float* sDy = reinterpret_cast<float*>(smem_raw + 2 * Sm::kBC + Sm::kX);
  float* sM = sDy + kT * kLdRow;      // M (rows j, columns i), then dCB^T
  float* ring = sM + kT * kLdCol;     // [stage][H, G]
  float* head = ring + 2 * (Sm::kStage / 4);   // [parity][dt, cs, exp(cs), w]
  float* vec = head + 2 * 4 * kT;
  auto V = [&](int v) { return vec + v * kT; };
  auto sH = [&](int st) { return ring + st * (Sm::kStage / 4); };
  auto sG = [&](int st) { return ring + st * (Sm::kStage / 4) + Sm::kH / 4; };
  float* sRed = V(kRed);

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, nt = gridDim.x;
  const int ngroups = gridDim.y;
  const int h0 = grp * group, h1 = min(H, h0 + group);
  const int t0 = c * kT, rows = min(kT, S - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;        // rows 16 wr .., columns 32 wc ..
  const int r0 = 16 * wr, c0 = 32 * wc;
  const bool has_h = c > 0, has_g = c < nt - 1 || dhf != nullptr;
  const bool live = !(wc == 0 && wr >= 2);        // some pair of the warp has i >= j
  const int pslabs = (P + kD - 1) / kD, ns = (N + kD - 1) / kD, chunks = (N + kNC - 1) / kNC;
  const int nv = (h1 - h0) * pslabs;              // virtual heads: (head, 64 columns of p)
  const int per_v = has_h || has_g ? ns : 0;      // ring steps a virtual head
  const long long slot = (long long)P * N;
  const long long plane = (long long)gridDim.z * nt * H * kT;
  const T* Bt = B + b * bs_b + t0 * bs_t;
  const T* Ct = C + b * cs_b + t0 * cs_t;
  auto part_at = [&](float* base, int i, int n) {
    return base + (((long long)b * S + t0 + i) * ngroups + grp) * N + n;
  };

  // B and C: columns 128 ch .. 128 ch + 127
  auto stage_bc = [&](int ch) {
#pragma unroll
    for (int kk = 0; kk < kNC / kD; ++kk) {
      const int n0 = kNC * ch + kD * kk;
      if (n0 < N) {
        stage_any<T, LBC, kVec, kN>(sB + kD * kk, Bt + n0, bs_t, rows, N - n0);
        stage_any<T, LBC, kVec, kN>(sC + kD * kk, Ct + n0, cs_t, rows, N - n0);
      }
    }
    cp_async_commit();
  };
  // x and dy of virtual head v, and its head's tile vectors (parity v & 1)
  auto stage_head = [&](int v) {
    const int hd = h0 + v / pslabs, pb = kD * (v % pslabs);
    stage_any<T, LI, kVec, kN>(sX, x + b * xs_b + t0 * xs_t + hd * xs_h + pb, xs_t, rows, P - pb);
    stage_any<float, kLdRow, kVec, kN>(sDy, dy + (((long long)b * S + t0) * H + hd) * P + pb,
                                       (long long)H * P, rows, P - pb);
    const float* tv = tsc + (((long long)b * nt + c) * H + hd) * kT;
    if (tid < kT)
      cp_async16(head + (v & 1) * 4 * kT + 4 * tid, tv + (tid >> 4) * plane + 4 * (tid & 15),
                 true);
    cp_async_commit();
  };
  // ring step s: H and G slabs (rows p of virtual head s / ns, columns n of
  // slab s % ns) into stage s & 1
  auto stage_hg = [&](int s) {
    const int v = s / ns, k = s % ns;
    const int hd = h0 + v / pslabs, pb = kD * (v % pslabs), n0 = kD * k;
    if (has_h)
      stage_any<float, kLdCol, kVec, kN>(
          sH(s & 1), hst + (((long long)b * (nt - 1) + c - 1) * H + hd) * slot + pb * N + n0,
          N, P - pb, N - n0);
    if (has_g)
      stage_any<float, kLdRow, kVec, kN>(
          sG(s & 1),
          (c < nt - 1 ? gst + (((long long)b * (nt - 1) + c) * H + hd) * slot
                      : dhf + ((long long)b * H + hd) * slot) + pb * N + n0,
          N, P - pb, N - n0);
    cp_async_commit();
  };

  const int steps = nv * per_v;
  stage_bc(0);
  stage_head(0);
  stage_hg(0);   // an empty group when there are no steps
  cp_async_wait<2>();   // B and C
  __syncthreads();

  // C B^T as CB^T (rows j, columns i), B_j . C_i, once for the block
  float cbt[4][4] = {}, dcbt[4][4] = {}, acc[4][4], gb[4][4];
  float dcacc[2][4][4] = {}, dbacc[2][4][4] = {};
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch > 0) {
      __syncthreads();   // every warp is done with the previous chunk
      stage_bc(ch);
      cp_async_wait<0>();
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kNC / kD; ++kk)
        if (kNC * ch + kD * kk < N) {   // each slab from zero, added in f32
          zero(acc);
          mm<4, kEx, kEx>(acc, 0, 8,
                          [&](int r, int k) { return to_f32(sB[(r0 + r) * LBC + kD * kk + k]); },
                          [&](int k, int cc) { return to_f32(sC[(c0 + cc) * LBC + kD * kk + k]); });
          each(acc, [&](int, int, int n, int e) { cbt[n][e] += acc[n][e]; });
        }
    }
  }

  // warp 0's sums over a head's p slabs of the per-token vectors (tokens
  // lane and lane + 32): rowT, colT, y's carried-state part, dw; and <G, H>
  float s_rowT[2] = {}, s_colT[2] = {}, s_yoff[2] = {}, s_dw[2] = {}, s_gh = 0.f;
  int step = 0;
  for (int v = 0; v < nv; ++v) {
    const int hd = h0 + v / pslabs, pb = kD * (v % pslabs);
    const float* hv = head + (v & 1) * 4 * kT;
    const float *sDt = hv, *sCs = hv + kT, *sEcs = hv + 2 * kT, *sW = hv + 3 * kT;
    // x, dy and the vectors of v, and its first ring step; every warp is
    // done with the previous virtual head's M
    cp_async_wait<0>();
    __syncthreads();

    // dM^T (rows j, columns i) = x_j . dy_i over the slab's p, then M^T,
    // dCB^T and T^T on the causal pairs i >= j (ssd_bwd.cu's reductions)
    zero(acc);
    if (live)
      mm<4, kEx, false>(acc, 0, 8, [&](int r, int k) { return to_f32(sX[(r0 + r) * LI + k]); },
                        [&](int k, int cc) { return sDy[(c0 + cc) * kLdRow + k]; });
    float part[2] = {0.f, 0.f}, rowp[4][2] = {};
    each(acc, [&](int r, int cc, int n, int e) {
      const int j = r0 + r, i = c0 + cc;
      float m = 0.f, d = 0.f, tt = 0.f;
      if (i >= j) {   // a select: exp of i < j may overflow
        const float ee = expf(sCs[i] - sCs[j]);
        m = cbt[n][e] * ee * sDt[j];
        d = acc[n][e] * ee * sDt[j];
        tt = acc[n][e] * cbt[n][e] * ee;
      }
      sM[j * kLdCol + i] = m;
      dcbt[n][e] += d;
      part[r >> 3] += tt;
      rowp[n][e & 1] = fmaf(tt, sDt[j], rowp[n][e & 1]);
    });
    quad_rows(part, V(kColT + wc) + r0);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float vv = rowp[n][q];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) vv += __shfl_xor_sync(kFull, vv, o);
        if (g == 0) V(kRowT + wr)[c0 + 8 * n + 2 * t + q] = vv;
      }

    // per slab of n: dC_i += exp(cs_i) H^T dy_i and y's carried-state part
    // sum_n C_i[n] exp(cs_i) (H^T dy_i)[n] (rows i, columns n); G B
    // accumulated over n (rows j, columns p); dB_j += w_j G^T x_j (rows j,
    // columns n); <G, H>
    float yoff[2] = {0.f, 0.f}, gh = 0.f;
    zero(gb);
    for (int ch = 0; ch < (per_v ? chunks : 0); ++ch) {
      if (chunks > 1) {   // B and C of the chunk, again
        __syncthreads();
        stage_bc(ch);
        cp_async_wait<0>();
        __syncthreads();
      }
#pragma unroll
      for (int kk = 0; kk < kNC / kD; ++kk) {
        const int k = (kNC / kD) * ch + kk;
        if (k >= ns) break;
        if (k > 0) {   // this step's ring stage
          cp_async_wait<0>();
          __syncthreads();
        }
        if (step + 1 < steps) stage_hg(step + 1);
        const float* th = sH(step & 1);
        const float* tg = sG(step & 1);
        if (has_h) {
          zero(acc);
          mm<4, false, false>(acc, 0, 8, [&](int r, int k2) { return sDy[(r0 + r) * kLdRow + k2]; },
                              [&](int k2, int cc) { return th[k2 * kLdCol + c0 + cc]; });
          each(acc, [&](int r, int cc, int n, int e) {
            const float vv = sEcs[r0 + r] * acc[n][e];
            dcacc[kk][n][e] += vv;
            yoff[r >> 3] =
                fmaf(to_f32(sC[(r0 + r) * LBC + kD * kk + c0 + cc]), vv, yoff[r >> 3]);
          });
        }
        if (has_h && has_g)
          for (int i = tid; i < kD * kD; i += kN)
            gh = fmaf(tg[(i / kD) * kLdRow + i % kD], th[(i / kD) * kLdCol + i % kD], gh);
        if (has_g) {   // G B: each slab from zero, added in f32
          zero(acc);
          mm<4, kEx, false>(acc, 0, 8,
                            [&](int r, int k2) { return to_f32(sB[(r0 + r) * LBC + kD * kk + k2]); },
                            [&](int k2, int cc) { return tg[(c0 + cc) * kLdRow + k2]; });
          each(acc, [&](int, int, int n, int e) { gb[n][e] += acc[n][e]; });
          zero(acc);
          mm<4, kEx, false>(acc, 0, 8, [&](int r, int k2) { return to_f32(sX[(r0 + r) * LI + k2]); },
                            [&](int k2, int cc) { return tg[k2 * kLdRow + c0 + cc]; });
          each(acc, [&](int r, int, int n, int e) {
            dbacc[kk][n][e] = fmaf(sW[r0 + r], acc[n][e], dbacc[kk][n][e]);
          });
        }
        ++step;
      }
      if (chunks > 1) {   // the chunk's partials into dbp / dcp
        const bool first = v == 0;
#pragma unroll
        for (int kk = 0; kk < kNC / kD; ++kk) {
          const int n0 = kNC * ch + kD * kk;
          each(dcacc[kk], [&](int r, int cc, int n, int e) {
            if (r0 + r < rows && n0 + c0 + cc < N) {
              float* pc = part_at(dcp, r0 + r, n0 + c0 + cc);
              float* pbp = part_at(dbp, r0 + r, n0 + c0 + cc);
              *pc = first ? dcacc[kk][n][e] : *pc + dcacc[kk][n][e];
              *pbp = first ? dbacc[kk][n][e] : *pbp + dbacc[kk][n][e];
            }
            dcacc[kk][n][e] = dbacc[kk][n][e] = 0.f;
          });
        }
      }
    }
    quad_rows(yoff, V(kYoff + wc) + r0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(kFull, gh, o);
    if (lane == 0) sRed[warp] = gh;
    __syncthreads();   // M is in shared memory

    // dx_j = w_j G B_j + sum_i M_ij dy_i (rows j, columns p); dw_j = x_j . G B_j
    part[0] = part[1] = 0.f;
    if (has_g)
      each(gb, [&](int r, int cc, int n, int e) {
        part[r >> 3] = fmaf(to_f32(sX[(r0 + r) * LI + c0 + cc]), gb[n][e], part[r >> 3]);
        gb[n][e] *= sW[r0 + r];
      });
    quad_rows(part, V(kDw + wc) + r0);
    mm<4, false, false>(gb, 2 * wr, 8, [&](int r, int k) { return sM[(r0 + r) * kLdCol + k]; },
                        [&](int k, int cc) { return sDy[k * kLdRow + c0 + cc]; });
    each(gb, [&](int r, int cc, int n, int e) {
      if (r0 + r < rows && pb + c0 + cc < P)
        st(dx + (((long long)b * S + t0 + r0 + r) * H + hd) * P + pb + c0 + cc, gb[n][e]);
    });
    __syncthreads();   // every warp is done with x, dy and M; the vectors are in shared memory
    if (v + 1 < nv) stage_head(v + 1);

    // warp 0: the virtual head's vectors into the head's sums; after its
    // last p slab, dcs, its reverse cumsum ddA, ddt and dA's partial (two
    // tokens a lane, as ssd_bwd.cu)
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int u = lane + 32 * q;
        s_rowT[q] += V(kRowT)[u] + V(kRowT + 1)[u] + V(kRowT + 2)[u] + V(kRowT + 3)[u];
        s_colT[q] += V(kColT)[u] + V(kColT + 1)[u];
        s_yoff[q] += V(kYoff)[u] + V(kYoff + 1)[u];
        s_dw[q] += V(kDw)[u] + V(kDw + 1)[u];
      }
      if (has_h && has_g)
        for (int i = 0; i < kTileThreads / 32; ++i) s_gh += sRed[i];
      if (v % pslabs == pslabs - 1) {
        const float a = A[hd];
        float d[2], wdw = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int u = lane + 32 * q;
          d[q] = s_rowT[q] - sDt[u] * s_colT[q] + s_yoff[q] - sW[u] * s_dw[q];
          wdw = fmaf(sW[u], s_dw[q], wdw);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) wdw += __shfl_xor_sync(kFull, wdw, o);
        if (lane == 31) d[1] += sEcs[kT - 1] * s_gh + wdw;
#pragma unroll
        for (int q = 1; q >= 0; --q)
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float vv = __shfl_down_sync(kFull, d[q], o);
            if (lane + o < 32) d[q] += vv;
          }
        d[0] += __shfl_sync(kFull, d[1], 0);
        float da = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int u = lane + 32 * q;
          da = fmaf(sDt[u], d[q], da);
          if (u < rows)
            ddt[((long long)b * S + t0 + u) * H + hd] =
                s_colT[q] + expf(sCs[kT - 1] - sCs[u]) * s_dw[q] + a * d[q];
          s_rowT[q] = s_colT[q] = s_yoff[q] = s_dw[q] = 0.f;
        }
        s_gh = 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(kFull, da, o);
        if (lane == 0) dapart[((long long)b * nt + c) * H + hd] = da;
      }
    }
  }

  // dCB (summed over the group's heads) through shared memory as dCB^T;
  // dC_i += sum_{j <= i} dCB_ij B_j, dB_j += sum_{i >= j} dCB_ij C_i
  each(dcbt, [&](int r, int cc, int n, int e) { sM[(r0 + r) * kLdCol + c0 + cc] = dcbt[n][e]; });
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();   // dCB^T is in shared memory; every warp is done with the chunk before
    if (chunks > 1) {
      stage_bc(ch);
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < kNC / kD; ++kk) {
      const int n0 = kNC * ch + kD * kk;
      if (n0 >= N) break;
      mm<4, false, kEx>(dcacc[kk], 0, 2 * wr + 2,
                        [&](int r, int k) { return sM[k * kLdCol + r0 + r]; },
                        [&](int k, int cc) { return to_f32(sB[k * LBC + kD * kk + c0 + cc]); });
      mm<4, false, kEx>(dbacc[kk], 2 * wr, 8, [&](int r, int k) { return sM[(r0 + r) * kLdCol + k]; },
                        [&](int k, int cc) { return to_f32(sC[k * LBC + kD * kk + c0 + cc]); });
      const bool add = chunks > 1 && nv > 0 && per_v > 0;
      each(dcacc[kk], [&](int r, int cc, int n, int e) {
        if (r0 + r < rows && n0 + c0 + cc < N) {
          float* pc = part_at(dcp, r0 + r, n0 + c0 + cc);
          float* pbp = part_at(dbp, r0 + r, n0 + c0 + cc);
          *pc = add ? *pc + dcacc[kk][n][e] : dcacc[kk][n][e];
          *pbp = add ? *pbp + dbacc[kk][n][e] : dbacc[kk][n][e];
        }
        dcacc[kk][n][e] = dbacc[kk][n][e] = 0.f;
      });
    }
  }
}

template <typename K>
cudaError_t raise_once(K kernel, int smem, bool& raised) {
  if (raised) return cudaSuccess;
  const cudaError_t e = raise_smem(kernel, smem);
  raised = e == cudaSuccess;
  return e;
}

template <typename T, bool kVec>
cudaError_t launch_any(const Args& r, cudaStream_t stream) {
  const int nt = (r.s + kT - 1) / kT, ngroups = (r.h + r.group - 1) / r.group;
  const T* x = static_cast<const T*>(r.x);
  const T* B = static_cast<const T*>(r.B);
  const T* C = static_cast<const T*>(r.C);
  const long long* s = r.st;
  float* tsc = r.decay;   // the tile scans: (4, b, tiles, h, 64)
  static bool raised_state = false, raised_tile = false;
  cudaError_t e;
  if ((e = raise_once(ssd_bwd_state_any<T, kVec>, StateAny<T>::kBytes, raised_state)) !=
          cudaSuccess ||
      (e = raise_once(ssd_bwd_tile_any<T, kVec>, TileAny<T>::kBytes, raised_tile)) !=
          cudaSuccess)
    return e;
  const long long total = (long long)r.b * nt * r.h, warps = (total + 3) / 4;
  if (warps > 2147483647LL) return cudaErrorInvalidValue;
  e = PLAN_LAUNCH("ssd_bwd_scan_any", ssd_bwd_scan_any, dim3((unsigned)warps), dim3(128), 0,
                  stream, r.dt, r.A, tsc, total, r.s, r.h, nt);
  if (e != cudaSuccess) return e;
  if (nt > 1) {
    const long long blocks = 2LL * ((r.p + kD - 1) / kD) * ((r.n + kD - 1) / kD);
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    e = PLAN_LAUNCH("ssd_bwd_state_any", (ssd_bwd_state_any<T, kVec>),
                    dim3((unsigned)blocks, r.h, r.b), dim3(128), StateAny<T>::kBytes, stream, x,
                    B, C, r.dy, r.dhf, tsc, r.hst, r.gst, r.s, r.h, r.p, r.n, s[0], s[1], s[2],
                    s[3], s[4], s[5], s[6]);
    if (e != cudaSuccess) return e;
  }
  e = PLAN_LAUNCH("ssd_bwd_tile_any", (ssd_bwd_tile_any<T, kVec>), dim3(nt, ngroups, r.b),
                  dim3(kTileThreads), TileAny<T>::kBytes, stream, x, r.A, B, C, r.dy, r.dhf,
                  r.hst, r.gst, tsc, static_cast<T*>(r.dx), r.ddt, r.dbp, r.dcp, r.dapart, r.s,
                  r.h, r.p, r.n, r.group, s[0], s[1], s[2], s[3], s[4], s[5], s[6]);
  if (e != cudaSuccess) return e;
  const long long rows_n = (long long)r.b * r.s * r.n;
  const long long blocks = (rows_n + 255) / 256 + 1;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  return PLAN_LAUNCH("ssd_bwd_reduce_kernel", ssd_bwd_reduce_kernel<T>, dim3((unsigned)blocks),
                     dim3(256), 0, stream, r.dbp, r.dcp, r.dapart, static_cast<T*>(r.dB),
                     static_cast<T*>(r.dC), r.dA, rows_n, ngroups, r.n, r.h, r.b * nt);
}

}  // namespace

// ssd_bwd's arguments and contract (ssd_bwd.cu) at any p >= 1 and n >= 1,
// any alignment, except the scratch: hst and gst (b, tiles - 1, h, p, n)
// f32 as ssd_bwd's, and in decay's place the tile scans, (4, b, tiles, h,
// 64) f32.  16-byte copies need 16-byte aligned pointers and strides and p,
// n multiples of 16 bytes; anything else stages element by element.
extern "C" int ssd_bwd_any(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* dy, const void* dhf, void* hst, void* gst,
                           void* tsc, void* dx, void* ddt, void* dbp, void* dcp, void* dapart,
                           void* dB, void* dC, void* dA, int dtype, int b, int s, int h, int p,
                           int n, int group, long long xs_b, long long xs_t, long long xs_h,
                           long long bs_b, long long bs_t, long long cs_b, long long cs_t,
                           void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || p < 1 || n < 1 || (dtype != 0 && dtype != 1) ||
      group < 1 || group > h || h > 65535)
    return (int)cudaErrorInvalidValue;
  Args r{x, B, C, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(dy), static_cast<const float*>(dhf),
         static_cast<float*>(hst), static_cast<float*>(gst), static_cast<float*>(tsc),
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
    return (int)(vec ? launch_any<float, true>(r, q) : launch_any<float, false>(r, q));
  return (int)(vec ? launch_any<__nv_bfloat16, true>(r, q)
                   : launch_any<__nv_bfloat16, false>(r, q));
}

// Query entry (launch_plan.cuh): ssd_bwd_any's arguments with `plans` in
// place of the stream; every launch is recorded, none made.
extern "C" int ssd_bwd_any_plan(const void* x, const void* dt, const void* A, const void* B,
                                const void* C, const void* dy, const void* dhf, void* hst,
                                void* gst, void* tsc, void* dx, void* ddt, void* dbp, void* dcp,
                                void* dapart, void* dB, void* dC, void* dA, int dtype, int b,
                                int s, int h, int p, int n, int group, long long xs_b,
                                long long xs_t, long long xs_h, long long bs_b, long long bs_t,
                                long long cs_b, long long cs_t, long long* plans) {
  plan::Scope scope(plans);
  return ssd_bwd_any(x, dt, A, B, C, dy, dhf, hst, gst, tsc, dx, ddt, dbp, dcp, dapart, dB, dC,
                     dA, dtype, b, s, h, p, n, group, xs_b, xs_t, xs_h, bs_b, bs_t, cs_b, cs_t,
                     nullptr);
}
