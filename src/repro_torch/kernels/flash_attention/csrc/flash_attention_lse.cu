// The flash-attention forward that also writes each row's log-sum-exp, for
// training (the backward, flash_attention_bwd.cu, recomputes P from it).
//
// It is flash_attention.cu built with FLASH_ATTENTION_LSE defined: every
// kernel is the kLse = true instantiation and the C entry points are
// flash_attention_fwd_lse (D <= 128, and bf16 D <= 160) and
// flash_attention_fwd_split_lse (bf16 q/k 192 over v 128).  A translation unit of its own, so that nvcc
// builds it beside the serving kernels, in parallel, and the serving
// instantiations in flash_attention.cu stay as they were.  The bound and
// the design are flash_attention.cu's; the epilogue adds (B, H, Sq) f32
// stores.
#define FLASH_ATTENTION_LSE
#include "flash_attention.cu"
