"""Seeded synthetic data: reproducible from (seed, step) with no state.

A copy of the JAX package's numpy-only `repro/data/synthetic.py` (the port
imports nothing of that package): the same generators give bitwise the
same arrays for the same seed and step."""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


# ----------------------------------------------------------------------
# language modelling: planted bigram chain
# ----------------------------------------------------------------------

def _bigram_table(seed: int, vocab: int, branching: int = 8) -> np.ndarray:
    """Each token transitions to one of `branching` successors — a structure
    a model can learn, giving a measurable loss floor below log(vocab)."""
    g = np.random.default_rng(seed)
    return g.integers(0, vocab, size=(vocab, branching), dtype=np.int64)


def lm_batches(seed: int, batch: int, seq_len: int, vocab: int,
               start_step: int = 0):
    """Infinite iterator of (tokens, targets) int32 arrays (B, S)."""
    table = _bigram_table(seed, vocab)
    branching = table.shape[1]
    step = start_step
    while True:
        g = _rng(seed, step)
        toks = np.empty((batch, seq_len + 1), np.int64)
        toks[:, 0] = g.integers(0, vocab, size=batch)
        choices = g.integers(0, branching, size=(batch, seq_len))
        for s in range(seq_len):
            toks[:, s + 1] = table[toks[:, s], choices[:, s]]
        yield toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
        step += 1


class LMBatchIterator:
    """Checkpointable wrapper: state is just the step counter."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int,
                 step: int = 0):
        self.seed, self.batch, self.seq_len, self.vocab = seed, batch, seq_len, vocab
        self.step = step
        self._it = lm_batches(seed, batch, seq_len, vocab, start_step=step)

    def __next__(self):
        self.step += 1
        return next(self._it)

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, state, batch, seq_len, vocab):
        return cls(state["seed"], batch, seq_len, vocab, step=state["step"])


# ----------------------------------------------------------------------
# diffusion: structured latents (class-dependent mean + low-rank texture)
# ----------------------------------------------------------------------

def latent_batches(seed: int, batch: int, tokens: int, dim: int,
                   num_classes: int, start_step: int = 0):
    """Infinite iterator of (latents (B,T,D) f32, labels (B,) i32).

    Latents are class-conditional Gaussians with a shared low-rank texture —
    enough structure that a trained denoiser beats an untrained one."""
    g0 = np.random.default_rng(seed)
    class_means = g0.normal(0, 1.0, size=(num_classes, dim)).astype(np.float32)
    texture = g0.normal(0, 1.0, size=(8, tokens, dim)).astype(np.float32)
    step = start_step
    while True:
        g = _rng(seed, step)
        labels = g.integers(0, num_classes, size=batch)
        coef = g.normal(0, 0.3, size=(batch, 8, 1, 1)).astype(np.float32)
        x = class_means[labels][:, None, :] + (coef * texture[None]).sum(1)
        x += g.normal(0, 0.1, size=x.shape).astype(np.float32)
        yield x.astype(np.float32), labels.astype(np.int32)
        step += 1


# ----------------------------------------------------------------------
# stand-ins for the modality frontends
# ----------------------------------------------------------------------

def frame_embeddings(seed: int, batch: int, frames: int, dim: int) -> np.ndarray:
    """Whisper stub: precomputed conv-frontend frame embeddings (B, F, D)."""
    g = np.random.default_rng(seed)
    t = np.linspace(0, 8 * np.pi, frames, dtype=np.float32)
    base = np.stack([np.sin(t * (i % 7 + 1)) for i in range(dim)], -1)
    noise = g.normal(0, 0.1, size=(batch, frames, dim)).astype(np.float32)
    return base[None] * 0.5 + noise


def patch_embeddings(seed: int, batch: int, patches: int, dim: int) -> np.ndarray:
    """Pixtral stub: precomputed ViT patch embeddings (B, P, D)."""
    g = np.random.default_rng(seed)
    return g.normal(0, 1.0, size=(batch, patches, dim)).astype(np.float32)
