"""TinyLlama-1.1B — Llama2-architecture small model [arXiv:2401.02385]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000,
    source="arXiv:2401.02385",
)
SMOKE = CONFIG.reduced()
