"""Text-to-image DiT — the dit-xl backbone with an AdaLN-zero-gated
cross-attention branch per block (survey's central T2I serving scenario).
`dit_text_len` is the padded prompt length every request is normalized to
(CLIP's classic 77): prompt embeddings from repro_torch.conditioning attend
into every block, K/V projected once per admission."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dit-t2i", family="dit",
    num_layers=28, d_model=1152, num_heads=16, num_kv_heads=16,
    d_ff=4608, vocab_size=0,
    is_dit=True, dit_patch_tokens=256, dit_in_dim=16, dit_num_classes=1000,
    dit_text_len=77,
    source="arXiv:2212.09748 (DiT) + cross-attn conditioning "
           "(PixArt-style; survey T2I scenario)",
)
SMOKE = CONFIG.reduced(num_layers=2, dit_patch_tokens=16, dit_in_dim=8,
                       dit_text_len=8)
