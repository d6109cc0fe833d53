"""Pixtral-12B — Mistral-Nemo decoder consuming Pixtral-ViT patch embeddings
(vision frontend is a STUB per the brief: input_specs() provides precomputed
patch embeddings) [hf:mistralai/Pixtral-12B-2409]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=160, rope_theta=1e9,
    num_vision_tokens=1024, vision_dim=1024,
    source="hf:mistralai/Pixtral-12B-2409",
)
SMOKE = CONFIG.reduced()
