"""Similarity / change metrics of the cache gating policies — the port of
the JAX `core/metrics.py`.

  * rel_l1     — TeaCache Eq. 22, BlockCache Eq. 34
  * mag_ratio  — MagCache Eq. 29
  * transform_rate — EasyCache Eq. 31

Each takes whole tensors and returns a 0-d tensor.  The `*_slots` forms
reduce over every axis but the leading slot axis and return (S,): the
serving engine's want pass thresholds them for every slot at once.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _flat(a):
    return a.reshape(a.shape[0], -1)


def _l1(a):
    return a.abs().sum()


def _l2(a):
    return torch.linalg.vector_norm(a.reshape(-1))


def rel_l1(a, b):
    """Symmetric relative L1 difference (TeaCache Eq. 22)."""
    return _l1(a - b) / (_l1(a) + _l1(b) + _EPS)


def rel_l1_block(a, b):
    """One-sided relative L1 (BlockCache Eq. 34)."""
    return _l1(a - b) / (_l1(a) + _EPS)


def rel_l2(a, b):
    """Relative L2 error ||a-b|| / ||b|| (SpeCa verifier, Eq. 56)."""
    return _l2(a - b) / (_l2(b) + _EPS)


def mag_ratio(r_t, r_prev):
    """Magnitude ratio of adjacent residuals (MagCache Eq. 29)."""
    return _l2(r_t) / (_l2(r_prev) + _EPS)


def transform_rate(v_t, v_prev, x_t, x_prev):
    """Relative transformation rate k_t (EasyCache Eq. 31)."""
    return _l2(v_t - v_prev) / (_l2(x_t - x_prev) + _EPS)


def cosine_sim(a, b):
    a, b = a.reshape(-1), b.reshape(-1)
    return torch.dot(a, b) / (_l2(a) * _l2(b) + _EPS)


def psnr(a, b, data_range: float = 2.0):
    """Peak signal-to-noise ratio, used by the quality benchmarks."""
    mse = ((a - b) ** 2).mean()
    return 10.0 * torch.log10(data_range**2 / (mse + _EPS))


# -- slot-batched forms: (S, ...) -> (S,) ------------------------------------

def l1_slots(a):
    return _flat(a).abs().sum(-1)


def l2_slots(a):
    return torch.linalg.vector_norm(_flat(a), dim=-1)


def rel_l1_slots(a, b):
    return l1_slots(a - b) / (l1_slots(a) + l1_slots(b) + _EPS)


def rel_l1_block_slots(a, b):
    return l1_slots(a - b) / (l1_slots(a) + _EPS)
