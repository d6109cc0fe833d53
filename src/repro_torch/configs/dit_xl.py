"""DiT-XL/2 — the survey's home architecture (Peebles & Xie)
[arXiv:2212.09748]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dit-xl", family="dit",
    num_layers=28, d_model=1152, num_heads=16, num_kv_heads=16,
    d_ff=4608, vocab_size=0,
    is_dit=True, dit_patch_tokens=256, dit_in_dim=16, dit_num_classes=1000,
    source="arXiv:2212.09748 (survey ref [5])",
)
SMOKE = CONFIG.reduced(num_layers=2, dit_patch_tokens=16, dit_in_dim=8)
