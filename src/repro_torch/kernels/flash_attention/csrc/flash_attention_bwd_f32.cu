// The f32 instantiations of the flash attention backward up to head dim 96
// (flash_attention_bwd.cu, which documents them), in a translation unit of
// their own so that they compile beside the bf16 half and the wider f32
// ones (flash_attention_bwd_f32_hi.cu).
#define FLASH_BWD_F32 1
#include "flash_attention_bwd.cu"
