"""Audio DiT — diffusion transformer over mel-spectrogram latents, the
shape SmoothCache (Geddes et al.) uses to show one caching scheme spanning
image, audio and video DiTs.  Tokens are mel time-frames, the channel dim is
the mel-bin count, and the backbone is the plain isotropic DiT — only the
token semantics change, which is exactly the cross-modality claim."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dit-audio", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=0,
    is_dit=True, dit_patch_tokens=256, dit_in_dim=80, dit_num_classes=1000,
    source="arXiv:2207.09983 (DiffSound-style mel DiT; SmoothCache audio)",
)
SMOKE = CONFIG.reduced(num_layers=2, dit_patch_tokens=16, dit_in_dim=8)
