"""Snowflake Arctic 480B — 128-expert top-2 MoE with a parallel dense
residual MLP [hf:Snowflake/snowflake-arctic-base]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864,                 # per-expert FFN width (assigned spec)
    vocab_size=32000,
    num_experts=128, experts_per_token=2,
    moe_dense_residual=True, dense_ff=7168,   # dense-residual branch
    source="hf:Snowflake/snowflake-arctic-base",
)
SMOKE = CONFIG.reduced()
