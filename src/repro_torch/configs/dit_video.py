"""Video DiT — factorized spatio-temporal diffusion transformer in the
Latte / OpenSora style (survey §IV "video generation" scenarios): spatial
attention over the patches of each frame, temporal attention over the frame
axis at each patch position.  `dit_patch_tokens` is PER FRAME; the latent
clip carries `dit_num_frames * dit_patch_tokens` tokens."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dit-video", family="dit",
    num_layers=28, d_model=1152, num_heads=16, num_kv_heads=16,
    d_ff=4608, vocab_size=0,
    is_dit=True, dit_patch_tokens=256, dit_in_dim=16, dit_num_classes=1000,
    dit_num_frames=16,
    source="arXiv:2401.03048 (Latte; survey video-DiT scenario)",
)
SMOKE = CONFIG.reduced(num_layers=2, dit_patch_tokens=8, dit_in_dim=8,
                       dit_num_frames=4)
