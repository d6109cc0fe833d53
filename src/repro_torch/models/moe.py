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

The expert-parallel path, `moe_forward_ep` (JAX's), runs the same
dispatch on each rank's tokens under `local_map`: routing and capacity
from the local token count, the (E, cap, d) queues sent to the ranks
that own their experts by one `all_to_all_single` over the expert axis,
the experts' FFN over the inner-sharded ff dim completed by one
all-reduce over the inner axes (JAX's `psum`), the queues sent back by
the reverse all-to-all and combined as above.  The load-balance
fractions f_i and p_i and the z loss are averaged over the batch shards
before their product, as JAX does; `dropped` is summed over them.  The
shared experts and the dense residual run outside, as tensor-parallel
MLPs on DTensors.  `moe_forward(..., ep=kwargs)` dispatches to it (JAX's
`_moe_layer`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch import spmd

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


def _counts(idx, n: int):
    """torch.bincount(idx, minlength=n) for idx < n, its length fixed at n
    (a bincount's length depends on the data, which fake tensors cannot
    size: the dry run traces the MoE on them)."""
    return torch.zeros(n, dtype=idx.dtype, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))


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
    counts = _counts(flat, E)
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


def _routed(xt, router, cfg):
    """Route the tokens xt (T, d) and dispatch them: (the (E, cap, d)
    queues, the slots (T, k), gates, keep, probs, expert indices, logits)."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = dot(xt.float(), router)                     # (T, E) f32
    cap = capacity(cfg, T)
    probs, gates, idx, pos, keep = route(logits, k, cap)
    slot = torch.where(keep, idx * cap + pos, E * cap)   # (T, k)
    # dispatch: every kept (token, choice) into its queue slot
    buf = xt.new_zeros((E * cap + 1, d))
    buf[slot.t().reshape(-1)] = xt.repeat(k, 1)
    return buf[:E * cap].reshape(E, cap, d), slot, gates, keep, probs, idx, \
        logits


def _experts(exp_in, w_gate, w_up, w_down):
    """The SwiGLU experts over their queues (E, C, d)."""
    h = F.silu(_bmm(exp_in, w_gate)) * _bmm(exp_in, w_up)
    return _bmm(h, w_down)


def _combine(exp_out, slot, gates, keep, dtype):
    """sum_k gate_k * out[slot_k] in f32, gates rounded to x's dtype."""
    E, cap, d = exp_out.shape
    out = torch.cat([exp_out.reshape(E * cap, d),
                     exp_out.new_zeros((1, d))])
    g = (gates * keep).to(dtype).float()
    y = torch.einsum("tk,tkd->td", g, out[slot].float())
    return y.to(torch.promote_types(dtype, exp_out.dtype))


def _fractions(idx, probs, E):
    """(f_i, p_i): the share of choices and the mean probability per
    expert; f_i counts the choices before capacity."""
    return _counts(idx.reshape(-1), E).float() / idx.shape[0], probs.mean(0)


def moe_forward(p, x, cfg, *, ep=None):
    """x: (B, S, d) -> (y (B, S, d), aux): aux holds JAX's
    load_balance_loss and router_z_loss (0-d f32) and `dropped`, the
    (token, choice) pairs past capacity (0-d integer).  `ep`: keyword
    arguments of `moe_forward_ep`, which then runs instead."""
    if ep is not None:
        return moe_forward_ep(p, x, cfg, **ep)
    B, S, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(B * S, d)
    exp_in, slot, gates, keep, probs, idx, logits = _routed(xt, p["router"],
                                                            cfg)
    exp_out = _experts(exp_in, p["w_gate"], p["w_up"], p["w_down"])
    y = _combine(exp_out, slot, gates, keep, x.dtype)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], xt)
    if "dense_res" in p:
        y = y + mlp_forward(p["dense_res"], xt)

    # Switch-style aux losses
    frac_tokens, frac_probs = _fractions(idx, probs, E)
    aux = {"load_balance_loss": E * torch.sum(frac_tokens * frac_probs),
           "router_z_loss": torch.mean(torch.logsumexp(logits, -1) ** 2),
           "dropped": (~keep).sum()}
    return y.reshape(B, S, d), aux


# ======================================================================
# expert-parallel path
# ======================================================================

def _all_to_all(t, mesh, axis):
    """Even all-to-all over dim 0 of `t` on the mesh dim `axis` (its
    backward is the reverse all-to-all)."""
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_to_all_single_autograd(t.contiguous(), None, None,
                                            spmd.group(mesh, (axis,)))
    return spmd._wait(out)


def _ep_body(x, router, w_gate, w_up, w_down, *, cfg, mesh, ep_axis,
             inner_axes, batch_ax):
    """The per-rank body under `local_map`.  x: (B_loc, S, d) local tokens
    (replicated over the inner axes); w_*: (E_loc, d, ff_loc) local expert
    shards.  Returns (y_loc, lb, z, dropped)."""
    B, S, d = x.shape
    E = cfg.num_experts
    ep = mesh.size(mesh.mesh_dim_names.index(ep_axis))
    El = E // ep
    exp_in, slot, gates, keep, probs, idx, logits = _routed(
        x.reshape(B * S, d), router, cfg)
    cap = exp_in.shape[1]

    # JAX's tiled all_to_all(split 0, concat 1): (E, cap, d) -> (E/ep,
    # ep*cap, d).  all_to_all_single sends dim-0 chunk j (experts j*El..)
    # to rank j and stacks what it receives in rank order on dim 0
    buf = _all_to_all(exp_in, mesh, ep_axis)             # (ep*El, cap, d)
    buf = buf.reshape(ep, El, cap, d).transpose(0, 1).reshape(El, ep * cap, d)
    out = _experts(buf, w_gate, w_up, w_down)            # partial over inner
    if inner_axes:
        out = spmd.all_reduce(out, mesh, inner_axes)
    # back: split 1, concat 0 -> (E, cap, d)
    out = out.reshape(El, ep, cap, d).transpose(0, 1)
    out = _all_to_all(out, mesh, ep_axis).reshape(E, cap, d)
    y = _combine(out, slot, gates, keep, x.dtype)

    # the aux losses need GLOBAL token fractions: average f_i and p_i over
    # the batch shards BEFORE the (nonlinear) product
    nb = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in batch_ax)
    f, pr = (spmd.all_reduce(v, mesh, batch_ax) / nb
             for v in _fractions(idx, probs, E))
    z = spmd.all_reduce(torch.mean(torch.logsumexp(logits, -1) ** 2), mesh,
                        batch_ax) / nb
    dropped = spmd.all_reduce((~keep).sum(), mesh, batch_ax)
    return y.reshape(B, S, -1), E * torch.sum(f * pr), z, dropped


def moe_forward_ep(p, x, cfg, *, mesh, batch_ax=("data",), ep_axis="data",
                   inner_axes=("attn", "ffn")):
    """Expert-parallel MoE layer over `mesh` (module docstring).  x and
    p's leaves are DTensors on `mesh` (`sharding.distribute`); the routed
    experts are sharded on `ep_axis` (dim 0) and the inner axes (ff),
    each redistributed to that first where they are not.  Returns (y, aux)
    as `moe_forward` does, y sharded on the batch axes."""
    from torch.distributed.tensor import Replicate, Shard
    routed = ("router", "w_gate", "w_up", "w_down")
    if not all(spmd.is_dtensor(t) for t in [x] + [p.get(k) for k in routed]):
        raise TypeError("moe_forward_ep: x and the routed experts' params "
                        "must be DTensors on the mesh (sharding.distribute)")
    names = tuple(mesh.mesh_dim_names)
    inner = tuple(a for a in inner_axes
                  if a in names and mesh.size(names.index(a)) > 1)
    if cfg.num_experts % mesh.size(names.index(ep_axis)):
        raise ValueError(f"moe_forward_ep: {cfg.num_experts} experts do not "
                         f"divide over '{ep_axis}'")

    def pl(batch=None, ep=None, ff=None):
        return [Shard(batch) if a in batch_ax and batch is not None
                else Shard(ep) if a == ep_axis and ep is not None
                else Shard(ff) if a in inner and ff is not None
                else Replicate() for a in names]

    rep = pl()
    body = functools.partial(_ep_body, cfg=cfg, mesh=mesh, ep_axis=ep_axis,
                             inner_axes=inner, batch_ax=tuple(batch_ax))
    y, lb, z, dropped = spmd.local_call(
        body, (x,) + tuple(p[k] for k in routed),
        (pl(batch=0), rep, pl(ep=0, ff=2), pl(ep=0, ff=2), pl(ep=0, ff=1)),
        (pl(batch=0), rep, rep, rep))
    if "shared" in p:
        y = y + mlp_forward(p["shared"], x)
    if "dense_res" in p:
        y = y + mlp_forward(p["dense_res"], x)
    return y, {"load_balance_loss": lb, "router_z_loss": z,
               "dropped": dropped}


__all__ = ["expert_shapes", "init_experts", "init_moe",
           "capacity", "route", "moe_forward", "moe_forward_ep"]
