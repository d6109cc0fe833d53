"""Whisper-small — encoder-decoder; the mel+conv frontend is a STUB per the
brief: input_specs() provides precomputed 1500-frame embeddings
[arXiv:2212.04356]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    is_encoder_decoder=True, num_encoder_layers=12, encoder_seq=1500,
    source="arXiv:2212.04356",
)
SMOKE = CONFIG.reduced()
