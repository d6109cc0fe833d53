"""Deterministic synthetic data pipelines (offline: nothing is downloaded) —
the port's copy of the JAX package's numpy-only `repro.data`.

Three generators matching the three workload kinds:

  lm_batches      — token streams with a planted bigram structure so that a
                    trained model measurably reduces loss (used by the
                    end-to-end training example and integration tests)
  latent_batches  — DiT latent patches + class labels (diffusion training)
  frame_embeddings, patch_embeddings
                  — precomputed "encoder frames" and patch embeddings that
                    stand in for the enc-dec and VLM frontends

Each is an infinite iterator of host numpy arrays keyed by a seed; every
batch is reproducible from (seed, step) alone so multi-host sharded loading
needs no coordination — each host slices its shard by process index.
"""
from .synthetic import (LMBatchIterator, frame_embeddings, latent_batches,
                        lm_batches, patch_embeddings)

__all__ = ["lm_batches", "latent_batches", "frame_embeddings",
           "patch_embeddings", "LMBatchIterator"]
