"""Model zoo of the port: so far the DiT (image latents and audio mel
latents, class- or text-conditioned), the factorized spatio-temporal video
DiT (with or without text) and the hybrid (Mamba2 + shared attention)
decoder LM."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import dit, encdec, layers, ssm, transformer, video_dit
from .transformer import decode_step, forward, prefill


def init_params(generator: torch.Generator, cfg, dtype=None, device=None):
    """Random params for `cfg`, drawn from `generator` on `device` (the GPU
    unless the caller passes device="cpu"); the generator must live on the
    same device type."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}: make the generator on the params' device")
    if cfg.family == "hybrid":
        return transformer.init_lm(generator, cfg, dtype, dev)
    if not cfg.is_dit:
        raise NotImplementedError(
            f"repro_torch ports only the DiTs and the hybrid LLM so far "
            f"('{cfg.name}' needs more); see ROADMAP.md §A")
    if cfg.dit_num_frames > 0:
        return video_dit.init_video_dit(generator, cfg, dtype, dev)
    return dit.init_dit(generator, cfg, dtype, dev)


def perturb_zero_init(params, generator: torch.Generator, scale: float = 0.05):
    """Replace all-zero leaves (AdaLN-zero gates, patch_out) with small random
    values.  An untrained AdaLN-zero DiT outputs exactly 0, which makes any
    cache-vs-exact comparison trivial.  Returns a new dict; leaves are
    visited in sorted key order, as JAX flattens a dict."""
    def walk(tree):
        out = {}
        for key in sorted(tree):
            leaf = tree[key]
            if isinstance(leaf, dict):
                out[key] = walk(leaf)
            elif bool((leaf == 0).all()):
                rnd = torch.randn(leaf.shape, generator=generator,
                                  device=leaf.device) * scale
                out[key] = rnd.to(leaf.dtype)
            else:
                out[key] = leaf
        return out
    return walk(params)


__all__ = ["dit", "encdec", "layers", "ssm", "transformer", "video_dit",
           "init_params",
           "perturb_zero_init", "forward", "prefill", "decode_step"]
