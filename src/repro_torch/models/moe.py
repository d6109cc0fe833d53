"""Mixture-of-Experts FFN of the port (counterpart of the JAX
`models/moe.py`): top-k routing with renormalized gates, per-expert
capacity, the load-balance and router-z losses, shared (always-on)
experts (deepseek-v2) and a parallel dense residual FFN (arctic).

Routing is JAX's: a softmax over f32 router logits, `top_k`, gates
renormalized with +1e-9, capacity `max(ceil(T k / E * capacity_factor),
1)`, and each (token, choice) queued at its expert in priority order
(every first choice in token order, then every second choice, ...);
past capacity it is dropped, and the gates are not renormalized after
drops.

Dispatch differs from JAX's dense path, not in its result: JAX builds
(T, E, capacity) one-hot tensors and contracts them (at deepseek-v2's
prefill the dispatch product alone is a 322 GFLOP einsum).  The port
copies each kept token into row `expert * capacity + position` of an
(E * capacity + 1, d) buffer whose last row takes the drops, as JAX's
expert-parallel body does; a queue slot receives at most one token, so
the copy is exact.  The experts run as batched products over (E,
capacity, d), and the combine gathers each choice's row and sums gate *
row in f32, the gates first rounded to x's dtype (JAX's
`comb.astype(x.dtype)`).

The expert-parallel path (JAX's `moe_forward_ep`) needs a device mesh,
which the port does not have yet: `ep=` raises (ROADMAP.md §A.9).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init, dot, init_mlp, mlp_forward, normal_into

def expert_shapes(cfg):
    """The routed experts' weight leaves, each (E, in, out)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"w_gate": (E, d, ff), "w_up": (E, d, ff), "w_down": (E, ff, d)}


def init_experts(generator, cfg, dtype=torch.float32, device=None, lead=()):
    """The routed experts' weights with leading dims `lead` (a stacked
    model's layer axis), N(0, 1/fan_in), drawn in blocks straight into
    their storage (`normal_into`): a full-width arctic layer holds 27 GB of
    experts, and one block's f32 draw is the only transient."""
    return {name: normal_into(torch.empty(tuple(lead) + shape, dtype=dtype,
                                          device=device),
                              generator, 1.0 / math.sqrt(shape[1]))
            for name, shape in expert_shapes(cfg).items()}


def init_moe(generator, cfg, dtype=torch.float32, device=None):
    """The MoE layer's params but its routed experts (`init_experts` draws
    those, for all layers at once): the router, kept f32 whatever `dtype`
    is, and the shared experts and the dense residual where the config has
    them."""
    d, ff = cfg.d_model, cfg.d_ff
    p = {"router": dense_init(generator, d, cfg.num_experts, torch.float32,
                              device=device)}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(generator, d, ff * cfg.num_shared_experts,
                               dtype, device=device)
    if cfg.moe_dense_residual:
        p["dense_res"] = init_mlp(generator, d, cfg.dense_ff, dtype,
                                  device=device)
    return p


def capacity(cfg, tokens: int) -> int:
    """Queue slots per expert for `tokens` tokens (JAX's rule)."""
    return max(int(math.ceil(tokens * cfg.experts_per_token
                             / cfg.num_experts * cfg.capacity_factor)), 1)


def route(logits, k: int, cap: int):
    """JAX's routing of f32 router logits (T, E): (probs (T, E), gates (T,
    k) renormalized, expert indices (T, k), queue positions (T, k), keep
    (T, k) bool: position < cap)."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    # a (token, choice)'s queue position is its rank among the earlier
    # pairs, in priority order, that chose its expert: a stable sort by
    # expert keeps that order, and the rank is the offset from the
    # expert's first pair (JAX cumsums a (k T, E) one-hot instead)
    flat = idx.t().reshape(-1)                       # priority order (k T,)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) \
        - first[flat[order]]
    pos = pos.reshape(k, T).t()
    return probs, gates, idx, pos, pos < cap


def _bmm(a, w):
    """Batched `a @ w` under JAX's type promotion."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.bmm(a.to(dt), w.to(dt))


def moe_forward(p, x, cfg, *, ep=None):
    """x: (B, S, d) -> (y (B, S, d), aux): aux holds JAX's
    load_balance_loss and router_z_loss (0-d f32) and `dropped`, the
    (token, choice) pairs past capacity (0-d integer)."""
    if ep is not None:
        raise NotImplementedError(
            "repro_torch has no device mesh: the expert-parallel MoE "
            "(JAX's moe_forward_ep) is ROADMAP.md §A.9")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    logits = dot(xt.float(), p["router"])                # (T, E) f32
    cap = capacity(cfg, T)
    probs, gates, idx, pos, keep = route(logits, k, cap)
    slot = torch.where(keep, idx * cap + pos, E * cap)   # (T, k)

    # dispatch: every kept (token, choice) into its queue slot
    buf = xt.new_zeros((E * cap + 1, d))
    buf[slot.t().reshape(-1)] = xt.repeat(k, 1)
    exp_in = buf[:E * cap].reshape(E, cap, d)
    h = F.silu(_bmm(exp_in, p["w_gate"])) * _bmm(exp_in, p["w_up"])
    exp_out = _bmm(h, p["w_down"])                       # (E, cap, d)

    # combine: sum_k gate_k * out[slot_k] in f32, gates rounded to x's dtype
    out = torch.cat([exp_out.reshape(E * cap, d),
                     exp_out.new_zeros((1, d))])
    g = (gates * keep).to(x.dtype).float()
    y = torch.einsum("tk,tkd->td", g, out[slot].float())
    y = y.to(torch.promote_types(x.dtype, exp_out.dtype))
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xt)
    if "dense_res" in p:
        y = y + mlp_forward(p["dense_res"], xt)

    # Switch-style aux losses; f_i counts the choices before capacity
    frac_tokens = torch.bincount(idx.reshape(-1), minlength=E).float() / T
    frac_probs = probs.mean(0)
    aux = {"load_balance_loss": E * torch.sum(frac_tokens * frac_probs),
           "router_z_loss": torch.mean(torch.logsumexp(logits, -1) ** 2),
           "dropped": (~keep).sum()}
    return y.reshape(B, S, d), aux


__all__ = ["expert_shapes", "init_experts", "init_moe",
           "capacity", "route", "moe_forward"]
