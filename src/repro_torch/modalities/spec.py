"""Modality specs and denoise workloads — the port of the JAX
`modalities/spec.py`.

The survey's subtitle is *Toward Efficient Multi-Modal Generation*: the
same cache operator (Eq. 14-15) is claimed to accelerate image, video and
audio diffusion transformers alike.  A ModalitySpec pins down what a
modality is for the cache and serving stack:

  image — class-conditional latent patches, the plain isotropic DiT
          (dit-xl).
  video — latent clips with a frame axis, the factorized spatio-temporal
          DiT (dit-video): tokens = frames x per-frame patches flattened,
          so the serving stack sees the same (B, T, D) rows; the frame
          structure lives in the backbone's factorized attention and in the
          temporal policies (repro_torch.core.temporal).
  audio — mel-spectrogram latents (dit-audio): tokens = mel time-frames,
          channels = mel bins, backbone = the plain DiT.
  t2i   — text-to-image: the image DiT with a cross-attention branch per
          block over prompt embeddings (dit-t2i); requests carry
          prompt_tokens, resolved through the workload's conditioner.
  t2v   — text-to-video: the factorized video DiT with the same branch
          after spatial attention (dit-t2v).

`DenoiseWorkload` binds a spec to (cfg, params) and hands out the pieces
the rest of the stack consumes: a CachedDenoiser, a serving engine, the
exact CFG baseline, and modality-aware policy construction (temporal
policies need the clip's frame count).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import CachePolicy, TemporalPABStack, make_policy
from repro_torch.device import DeviceLike, resolve_device, tree_device


@dataclass(frozen=True)
class ModalitySpec:
    """What a generation modality means to the cache/serving stack."""
    name: str
    arch_id: str            # repro_torch.configs registry id of the backbone
    description: str
    #: does the latent carry a frame axis (factorized video backbone)?
    temporal: bool = False
    #: is the backbone text-conditioned (cross-attention over prompts)?
    text: bool = False

    def config(self, smoke: bool = False):
        return (get_smoke_config(self.arch_id) if smoke
                else get_config(self.arch_id))

    def validate(self, cfg) -> None:
        if not cfg.is_dit:
            raise ValueError(f"modality '{self.name}': config {cfg.name} is "
                             f"not a DiT")
        if self.temporal != (cfg.dit_num_frames > 0):
            raise ValueError(
                f"modality '{self.name}': temporal={self.temporal} but "
                f"cfg.dit_num_frames={cfg.dit_num_frames}")
        if self.text != (cfg.dit_text_len > 0):
            raise ValueError(
                f"modality '{self.name}': text={self.text} but "
                f"cfg.dit_text_len={cfg.dit_text_len}")


MODALITIES: Dict[str, ModalitySpec] = {
    "image": ModalitySpec(
        "image", "dit-xl",
        "class-conditional latent patches, isotropic DiT"),
    "video": ModalitySpec(
        "video", "dit-video",
        "latent clips (frames x patches), factorized spatio-temporal DiT",
        temporal=True),
    "audio": ModalitySpec(
        "audio", "dit-audio",
        "mel-spectrogram latents (time-frames x mel bins), isotropic DiT"),
    "t2i": ModalitySpec(
        "t2i", "dit-t2i",
        "text-to-image: latent patches + cross-attn over prompt embeddings",
        text=True),
    "t2v": ModalitySpec(
        "t2v", "dit-t2v",
        "text-to-video: factorized video DiT + cross-attn text conditioning",
        temporal=True, text=True),
}


def get_modality(name: str) -> ModalitySpec:
    if name not in MODALITIES:
        raise KeyError(f"unknown modality '{name}'; "
                       f"available: {sorted(MODALITIES)}")
    return MODALITIES[name]


@dataclass
class DenoiseWorkload:
    """A modality bound to concrete (cfg, params): everything the cache and
    serving layers need to denoise this modality end to end, on the
    params' device."""
    spec: ModalitySpec
    cfg: Any
    params: Dict[str, Any]
    extras: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.spec.validate(self.cfg)

    @property
    def device(self) -> torch.device:
        return tree_device(self.params)

    # -- shapes ---------------------------------------------------------
    @property
    def tokens(self) -> int:
        return self.cfg.dit_tokens

    @property
    def latent_dim(self) -> int:
        return self.cfg.dit_in_dim

    @property
    def frames(self) -> int:
        return max(self.cfg.dit_num_frames, 1)

    def latent_shape(self, batch: int = 1):
        return (batch, self.tokens, self.latent_dim)

    def noise(self, generator: torch.Generator, batch: int = 1):
        """A standard-normal latent batch drawn from `generator`, on the
        generator's device."""
        return torch.randn(self.latent_shape(batch), generator=generator,
                           device=generator.device)

    # -- policies -------------------------------------------------------
    def make_policy(self, name: str, num_steps: int = 50,
                    **kw) -> CachePolicy:
        """Registry policy with modality-aware defaults: temporal policies
        (teacache_video) get this workload's frame count."""
        if self.spec.temporal:
            kw.setdefault("frames", self.frames)
        return make_policy(name, num_steps=num_steps, **kw)

    def pab_stack(self, ranges: Optional[Dict[str, int]] = None
                  ) -> TemporalPABStack:
        """PAB over the factorized video backbone: per-module-type ranges,
        temporal attention reused over the longest one.  Video only."""
        if not self.spec.temporal:
            raise ValueError(f"modality '{self.spec.name}' has no "
                             f"factorized temporal branches for PAB")
        from repro_torch.models import video_dit
        return TemporalPABStack(video_dit.pab_branch_fns(self.cfg),
                                self.cfg.num_layers, ranges)

    # -- denoising entry points ----------------------------------------
    def denoiser(self, policy: Optional[CachePolicy] = None, **kw):
        """CachedDenoiser over this workload's backbone (single stream)."""
        from repro_torch.diffusion.pipeline import CachedDenoiser
        return CachedDenoiser(self.params, self.cfg, policy,
                              device=self.device, **kw)

    def cfg_denoise_fn(self, cfg_scale: float, class_label: int = 0,
                       null_embed=None, text=None, neg_text=None):
        """The exact (uncached) guided baseline for this modality."""
        from repro_torch.diffusion.pipeline import cfg_denoise_fn
        return cfg_denoise_fn(self.params, self.cfg, cfg_scale, class_label,
                              null_embed, text=text, neg_text=neg_text)

    def conditioner(self, capacity: int = 128, seed: int = 0, metrics=None):
        """A PromptCache over a text encoder freshly drawn from a
        torch.Generator seeded with `seed` on the workload's device, matched
        to this workload's config (text modalities only): what the engine
        resolves DiffusionRequest.prompt_tokens through."""
        if not self.spec.text:
            raise ValueError(f"modality '{self.spec.name}' is not "
                             f"text-conditioned; no conditioner to build")
        from repro_torch.conditioning import (PromptCache, init_text_encoder,
                                              text_encoder_config)
        tc = text_encoder_config(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tparams = init_text_encoder(gen, tc, device=self.device)
        return PromptCache(tparams, tc, capacity=capacity, metrics=metrics,
                           name=self.spec.name)

    def engine(self, policy=None, **kw):
        """A single-modality DiffusionServingEngine over this backbone —
        one sub-pool of a mixed-modality pool."""
        from repro_torch.serving.diffusion import DiffusionServingEngine
        return DiffusionServingEngine(self.params, self.cfg, policy,
                                      device=self.device, **kw)


def make_workload(name: str, cfg=None, params=None, *, smoke: bool = False,
                  seed: int = 0, perturb: bool = True,
                  device: DeviceLike = None) -> DenoiseWorkload:
    """Build a modality workload: registry spec + config + (fresh) params.

    cfg / params default to the spec's registered config (its SMOKE variant
    when `smoke`) and weights drawn from a torch.Generator seeded with
    `seed` on `device` (the GPU unless the caller passes device="cpu");
    `perturb` replaces the AdaLN-zero leaves so an untrained backbone does
    not output exactly zero (repro_torch.models.perturb_zero_init)."""
    from repro_torch.models import init_params, perturb_zero_init
    spec = get_modality(name)
    cfg = cfg if cfg is not None else spec.config(smoke=smoke)
    if params is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(gen, cfg, device=dev)
        if perturb:
            params = perturb_zero_init(params, gen)
    return DenoiseWorkload(spec, cfg, params)
