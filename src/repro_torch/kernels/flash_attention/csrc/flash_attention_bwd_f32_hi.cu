// The f32 instantiations of the flash attention backward above head dim 96
// (16-byte rows) and above 64 (element by element): flash_attention_bwd.cu
// documents them; a translation unit of its own so that the f32 half builds
// in two parts beside the bf16 one.
#define FLASH_BWD_F32 2
#include "flash_attention_bwd.cu"
