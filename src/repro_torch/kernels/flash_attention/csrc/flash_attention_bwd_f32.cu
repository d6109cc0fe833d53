// The f32 instantiations of the flash attention backward
// (flash_attention_bwd.cu, which documents them), in a translation unit of
// their own so that they compile beside the bf16 half.
#define FLASH_BWD_F32
#include "flash_attention_bwd.cu"
