"""Qwen2-7B — dense GQA with QKV bias [arXiv:2407.10671]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)
SMOKE = CONFIG.reduced()
