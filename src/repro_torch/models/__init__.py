"""Model zoo of the port: the DiT (image latents and audio mel latents,
class- or text-conditioned), the factorized spatio-temporal video DiT (with
or without text), the dense (GQA), moe (MoE FFNs, with GQA or MLA
attention), hybrid (Mamba2 + shared attention), ssm (Mamba1) and vlm
(patch embeddings + dense decoder) decoder LMs, and the Whisper-style
encoder-decoder (`encdec`)."""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves

from . import dit, encdec, layers, mla, moe, ssm, transformer, video_dit
from .transformer import decode_step, forward, prefill


def init_params(generator: torch.Generator, cfg, dtype=None, device=None):
    """Random params for `cfg`, drawn from `generator` on `device` (the GPU
    unless the caller passes device="cpu"); the generator must live on the
    same device type."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}: make the generator on the params' device")
    return _init(generator, cfg, dtype, dev)


def _init(generator, cfg, dtype, dev):
    if cfg.is_encoder_decoder:
        return encdec.init_encdec(generator, cfg, dtype, dev)
    if not cfg.is_dit:
        return transformer.init_lm(generator, cfg, dtype, dev)
    if cfg.dit_num_frames > 0:
        return video_dit.init_video_dit(generator, cfg, dtype, dev)
    return dit.init_dit(generator, cfg, dtype, dev)


def params_shape(cfg, dtype=None):
    """The params tree of `cfg` on the meta device: shapes and dtypes, no
    storage and no draws (the counterpart of JAX's `eval_shape`)."""
    return _init(torch.Generator(), cfg, dtype, torch.device("meta"))


def param_count(cfg) -> int:
    return sum(math.prod(t.shape) for t in tree_leaves(params_shape(cfg)))


def active_param_count(cfg) -> int:
    """Parameters touched per token, the N of MODEL_FLOPS = 6 N_active D:
    a MoE model's without the routed experts a token does not go to."""
    total = param_count(cfg)
    if not cfg.is_moe:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = ((cfg.num_experts - cfg.experts_per_token) * per_expert
                * cfg.num_layers)
    return total - inactive


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


__all__ = ["dit", "encdec", "layers", "mla", "moe", "ssm", "transformer", "video_dit",
           "init_params", "params_shape", "param_count", "active_param_count",
           "perturb_zero_init", "forward", "prefill", "decode_step"]
