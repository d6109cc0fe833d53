"""The part of the JAX `models/encdec.py` the DiT needs: sinusoidal
position / timestep embeddings.  The encoder-decoder itself is not ported
yet (ROADMAP.md §A)."""
from __future__ import annotations

import math

import torch


def sinusoidal_positions(positions, d_model):
    """positions: (..., S) -> (..., S, d_model) float32."""
    half = d_model // 2
    idx = torch.arange(half, device=positions.device, dtype=torch.float32)
    freqs = torch.exp(-math.log(10000.0) * idx / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
