"""DeepSeek-V2 236B — MLA attention (kv_lora=512) + 160-expert top-6 MoE with
2 shared experts [arXiv:2405.04434]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536,                  # per routed expert
    vocab_size=102400,
    num_experts=160, experts_per_token=6, num_shared_experts=2,
    use_mla=True, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    source="arXiv:2405.04434",
)
SMOKE = CONFIG.reduced()
