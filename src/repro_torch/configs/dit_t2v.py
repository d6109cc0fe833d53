"""Text-to-video DiT — the factorized spatio-temporal dit-video backbone
with a per-block cross-attention branch over prompt embeddings (survey's
T2V scenario; Latte/OpenSora-style conditioning).  Cross-attention runs
on the flat (frames x patches) token layout — per-query softmax over the
shared text keys makes that identical to a frame-folded form."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dit-t2v", family="dit",
    num_layers=28, d_model=1152, num_heads=16, num_kv_heads=16,
    d_ff=4608, vocab_size=0,
    is_dit=True, dit_patch_tokens=256, dit_in_dim=16, dit_num_classes=1000,
    dit_num_frames=16, dit_text_len=77,
    source="arXiv:2401.03048 (Latte) + cross-attn text conditioning "
           "(survey T2V scenario)",
)
SMOKE = CONFIG.reduced(num_layers=2, dit_patch_tokens=8, dit_in_dim=8,
                       dit_num_frames=4, dit_text_len=8)
