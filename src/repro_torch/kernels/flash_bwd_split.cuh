// P and dS of one (query, key) pair, taken apart for the flash attention
// backwards whose two warp groups form S^T and dP^T side by side
// (flash_attention_bwd_wide.cu, flash_attention_bwd_any.cu): one group turns
// S into P, the other takes P through shared memory and forms dS.  Together
// they give bitwise what flash_attention_bwd.cu's p_ds gives, branch for
// branch.  Include after flash_attention_bwd.cu, whose Shape, ex2 and kLog2e
// they use.
#pragma once

namespace {

// P of query qi and key kj from S = q k^T: keys past Sk and rows past Sq
// give 0, a masked key 0, and a row whose keys are all masked (causal,
// position < 0) the reference's uniform 1 / Sk.  clear: the tile straddles
// no edge.
__device__ __forceinline__ float p_of(const Shape& a, bool clear, int qi, int kj, float lse,
                                      float s) {
  if (clear) return ex2(s * a.scale_log2 - lse * kLog2e);
  if (qi < a.Sq && kj < a.Sk) {
    const int qpos = qi + a.q_offset;
    const bool masked = (a.causal && kj > qpos) || (a.window > 0 && qpos - kj >= a.window);
    if (a.causal && qpos < 0) return 1.f / a.Sk;
    if (!masked) return ex2(s * a.scale_log2 - lse * kLog2e);
  }
  return 0.f;
}

// dS * scale of the same pair from its P (p_of's), Delta and dP: 0 wherever
// p_of did not take the exponential, a keyless row included.
__device__ __forceinline__ float ds_of(const Shape& a, bool clear, int qi, int kj, float p,
                                       float dl, float dp) {
  if (clear) return p * (dp - dl) * a.scale;
  if (qi < a.Sq && kj < a.Sk) {
    const int qpos = qi + a.q_offset;
    const bool masked = (a.causal && kj > qpos) || (a.window > 0 && qpos - kj >= a.window);
    if (!(a.causal && qpos < 0) && !masked) return p * (dp - dl) * a.scale;
  }
  return 0.f;
}

// The 1-D grid's block L as (tile, rest), the tile that takes the most
// work under a causal mask first: `longest_last` counts tiles from the
// end (dQ: the last query tiles see the most keys), otherwise from the
// start (dK / dV: the first key tiles are seen by the most queries).
__device__ __forceinline__ void tile_of_block(int n_tiles, int rest, bool longest_last,
                                              int& tile, int& r) {
  const int L = blockIdx.x;
  tile = L / rest;
  r = L % rest;
  if (longest_last) tile = n_tiles - 1 - tile;
}

}  // namespace
