"""Falcon-Mamba-7B — pure Mamba1, attention-free [arXiv:2410.05355]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    mamba_version=1, ssm_state=16, ssm_expand=2,
    source="arXiv:2410.05355",
)
SMOKE = CONFIG.reduced(num_heads=0, num_kv_heads=0, d_ff=0)
