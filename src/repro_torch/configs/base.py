"""Architecture config system (the port's own copy of the JAX package's
`configs/base.py`; pure dataclasses, no tensors).

One frozen dataclass describes an architecture; each config module exposes
`CONFIG` (the exact published shape) and `SMOKE` (a reduced same-family
variant used by the CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | dit
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_dense_residual: bool = False
    dense_ff: int = 0
    capacity_factor: float = 1.25

    # --- MLA ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- SSM ---
    mamba_version: int = 0
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # --- hybrid ---
    hybrid_attn_every: int = 0

    # --- attention variants ---
    sliding_window: int = 0

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0

    # --- VLM ---
    num_vision_tokens: int = 0
    vision_dim: int = 0

    # --- DiT (diffusion) ---
    is_dit: bool = False
    dit_patch_tokens: int = 0        # latent patches (per frame for video)
    dit_in_dim: int = 0              # patchified latent channel dim
    dit_num_classes: int = 1000
    dit_num_frames: int = 0          # > 0: factorized video DiT
    dit_text_len: int = 0            # > 0: text cross-attention

    # --- numerics ---
    dtype: str = "bfloat16"          # parameter dtype
    source: str = ""                 # citation

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.mamba_version > 0 and self.hybrid_attn_every == 0

    @property
    def is_hybrid(self) -> bool:
        return self.mamba_version > 0 and self.hybrid_attn_every > 0

    @property
    def dit_tokens(self) -> int:
        """Total latent tokens per sample: per-frame patches x frames."""
        return self.dit_patch_tokens * max(self.dit_num_frames, 1)

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test-scale variant of the same family."""
        base = dict(
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            num_shared_experts=min(self.num_shared_experts, 1) if self.num_shared_experts else 0,
            dense_ff=min(self.dense_ff, 128) if self.dense_ff else 0,
            capacity_factor=8.0 if self.num_experts else self.capacity_factor,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_rope_head_dim=16 if self.use_mla else self.qk_rope_head_dim,
            qk_nope_head_dim=32 if self.use_mla else self.qk_nope_head_dim,
            v_head_dim=32 if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 16),
            hybrid_attn_every=1 if self.hybrid_attn_every else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            num_vision_tokens=min(self.num_vision_tokens, 16) if self.num_vision_tokens else 0,
            vision_dim=min(self.vision_dim, 64) if self.vision_dim else 0,
            dit_patch_tokens=min(self.dit_patch_tokens, 16) if self.dit_patch_tokens else 0,
            dit_in_dim=min(self.dit_in_dim, 16) if self.dit_in_dim else 0,
            dit_num_classes=min(self.dit_num_classes, 10),
            dit_num_frames=min(self.dit_num_frames, 4) if self.dit_num_frames else 0,
            dit_text_len=min(self.dit_text_len, 8) if self.dit_text_len else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            dtype="float32",
            name=self.name + "-smoke",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class InputShape:
    """One input shape of the launch cases (`launch/specs.py`)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
