"""Zamba2-2.7B — Mamba2 backbone + one shared attention+MLP block applied
every 6 Mamba2 layers [arXiv:2411.15242]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    mamba_version=2, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
)
SMOKE = CONFIG.reduced()
