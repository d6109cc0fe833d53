"""The port's models on DTensors (`torch.distributed.tensor`).

Given params and inputs distributed by `sharding.py`'s specs, the models'
plain PyTorch code runs on DTensors: DTensor propagates the shardings
through each operator.  A few places need more, and the helpers here give
them; each takes its plain-tensor route unchanged (one `isinstance` check)
when no DTensor is involved, so the unsharded path is the same launch for
launch.

  attention, forecast, batch_local
                    a kernel wrapper (flash attention, the decode's blocked
                    attention, the forecast, the SSD scan) on each rank's
                    local shards under `local_map` (`local_call`): the
                    ctypes wrappers take plain CUDA tensors, never a DTensor
  reduce_partial    a result that is a partial sum over one or more mesh
                    dims (after `wo`, after `w_down`), summed by ONE
                    all-reduce over the flattened group of those dims
                    (DTensor issues one all-reduce per mesh dim)
  embed             the vocab-parallel embedding lookup: each rank looks up
                    the tokens of its vocab shard and one all-reduce sums
                    them (DTensor would all-gather the table)
  split_heads       (..., H * hd) -> (..., H, hd), gathering first where a
                    shard would split a head; `gathered` before a slice
  put_rows, put     a decode step's in-place cache writes on each rank's
                    shards (DTensor refuses an in-place write whose value
                    is sharded otherwise)
  all_reduce        the sum of a local tensor over named mesh dims, with
                    an identity backward (the gradient of a replicated
                    result)

`torch.distributed.tensor` is imported only when a DTensor can exist:
`is_dtensor` reads `sys.modules`, so importing the models stays cheap.
"""
from __future__ import annotations

import sys

import torch


def is_dtensor(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def group(mesh, names):
    """A 1-d mesh over the named mesh dims (flattened when several): the
    group one collective over all of them runs on.  Slicing a mesh runs
    operators on its rank tensor: they run outside any dispatch mode (a
    dry run's fake tensors and counters)."""
    from torch.utils._python_dispatch import _disable_current_modes
    names = tuple(names)
    with _disable_current_modes():
        return mesh[names[0]] if len(names) == 1 else mesh[names]._flatten()


def _wait(t):
    wait = getattr(t, "wait", None)
    return wait() if callable(wait) else t


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the backward passes the gradient through (the
    result is replicated, each rank's input one term of the sum)."""

    @staticmethod
    def forward(ctx, t, grp):
        import torch.distributed._functional_collectives as funcol
        return _wait(funcol.all_reduce(t, "sum", grp))

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(t, mesh, names):
    """Sum of the local tensor `t` over the named mesh dims (one
    collective)."""
    return _AllReduce.apply(t, group(mesh, names))


def reduce_partial(t):
    """A DTensor whose Partial(sum) mesh dims are summed into Replicate by
    one all-reduce over those dims flattened; anything else unchanged."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = t.device_mesh
    dims = [i for i, p in enumerate(t.placements) if p.is_partial()]
    if not dims:
        return t
    if any(t.placements[i].reduce_op != "sum" for i in dims):
        raise ValueError(f"reduce_partial: {t.placements} is not a sum")
    names = [mesh.mesh_dim_names[i] for i in dims]
    local = all_reduce(t.to_local(), mesh, names)
    return DTensor.from_local(
        local, mesh, [Replicate() if p.is_partial() else p
                      for p in t.placements],
        run_check=False, shape=t.shape, stride=t.stride())


def _coordinate(mesh, names) -> int:
    """This rank's index in the flattened group of the named dims."""
    idx = 0
    for n in names:
        i = mesh.mesh_dim_names.index(n)
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def split_heads(t, heads: int):
    """t (..., heads * hd) -> (..., heads, hd).  A DTensor sharded on its
    last dim over mesh dims whose product does not divide `heads` (a flat
    tensor axis wider than the heads, KV heads below the shards) is
    gathered on those dims first: DTensor cannot split a head across
    ranks (XLA's involuntary rematerialisation, made explicit)."""
    shape = tuple(t.shape[:-1]) + (heads, t.shape[-1] // heads)
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    last = Shard(t.ndim - 1)
    n = 1
    for i, p in enumerate(t.placements):
        if p == last:
            n *= t.device_mesh.size(i)
    if heads % n:
        t = t.redistribute(placements=[Replicate() if p == last else p
                                       for p in t.placements])
    return t.reshape(shape)


def gathered(t, dim: int):
    """t, or a DTensor t gathered on `dim` first (to slice it there:
    DTensor's slice of a sharded dim at uneven bounds is unsafe)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    return t.redistribute(placements=[Replicate() if p == Shard(dim) else p
                                      for p in t.placements])


def embed(table, tokens):
    """`table[tokens]`; for a DTensor table sharded on its vocab dim, each
    rank gathers the rows of its shard (zero for tokens outside it) and
    one all-reduce over the vocab dims sums them.  The result is sharded
    as `tokens` on its leading dims and replicated on the model dim."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    # vocab shards stay; any other sharding (FSDP's) is gathered first
    pl = [Shard(0) if p == Shard(0) else Replicate()
          for p in table.placements]
    vocab = [mesh.mesh_dim_names[i] for i, p in enumerate(pl)
             if p == Shard(0)]
    tok = [p if isinstance(p, Shard) else Replicate()
           for p in tokens.placements]

    def lookup(t, ids):
        if not vocab:
            return t[ids]
        n = t.shape[0]
        ids = ids - _coordinate(mesh, vocab) * n
        inside = (ids >= 0) & (ids < n)
        out = t[torch.where(inside, ids, 0)] * inside[..., None].to(t.dtype)
        return all_reduce(out, mesh, vocab)

    return local_call(lookup, (table, tokens), (pl, tok), tok)


def put_rows(dst, bidx, slot, value):
    """dst[bidx, slot] = value, with bidx = arange(B): each batch row's
    slot of a cache dst (B, W, ...).  On a DTensor cache each rank writes
    its shard: its batch rows, the slots of its W range where W is
    sharded (sequence-parallel), and value sharded as dst's other dims."""
    if not is_dtensor(dst):
        dst[bidx, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    pl = list(dst.placements)
    seq = [mesh.mesh_dim_names[i] for i, p in enumerate(pl) if p == Shard(1)]
    rows_pl = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    val_pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
              else q for p, q in zip(pl, rows_pl)]

    def write(d, s, v):
        n = d.shape[1]
        s = s - _coordinate(mesh, seq) * n if seq else s
        mine = (s >= 0) & (s < n)
        rows = torch.arange(d.shape[0], device=d.device)
        s = torch.where(mine, s, 0)
        keep = mine.view((-1,) + (1,) * (v.dim() - 1))
        d[rows, s] = torch.where(keep, v.to(d.dtype), d[rows, s])
        return d

    local_call(write, (dst, slot, value), (pl, rows_pl, val_pl), pl)


def put(dst, i: int, value):
    """dst[i] = value (a layer's entry of a stacked cache); a DTensor
    value is first sharded as that entry."""
    if is_dtensor(dst):
        view = dst[i]
        view.copy_(value.redistribute(view.device_mesh, view.placements))
        return
    dst[i] = value


def local_call(fn, args, placements, out_placements):
    """fn(*args) on each rank's local shards under `local_map`: each
    tensor argument redistributed to its entry of `placements` first (no
    collective when it already has it; None for a non-tensor argument; a
    plain tensor counts as replicated, as under `implicit_replication`),
    the output wrapped with `out_placements`."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(placements), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def attention(kernel, q, k, v, *batched, **kw):
    """kernel(q, k, v, *batched, **kw) (flash attention, or the decode's
    blocked attention with its positions in `batched`): on DTensors, on
    each rank's shards, batch (dim 0) on the mesh dims that shard q's
    batch and heads (dim 2) on those that shard q's heads where they
    divide the kv heads too; any other sharding of q, k, v or `batched`
    (a cache's head dim, its sequence) is gathered first."""
    if not is_dtensor(q):
        return kernel(q, k, v, *batched, **kw)
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    pl = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):
            pl.append(Shard(0))
        elif p == Shard(2) and k.shape[2] % n == 0 and q.shape[2] % n == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())

    def run(ql, kl, vl, *rest):
        return kernel(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                      *rest, **kw)

    rows = [p if p == Shard(0) else Replicate() for p in pl]
    return local_call(run, (q, k, v) + batched,
                      [pl, pl, pl] + [rows] * len(batched), pl)


def batch_local(kernel, args, *, unbatched=(), outputs: int = 1):
    """kernel(*args) (an SSD-scan wrapper): on DTensors, on each rank's
    batch shard (dim 0 over the mesh dims that shard args[0]'s dim 0),
    the arguments at the positions in `unbatched` and every other dim
    replicated; each of the `outputs` outputs sharded on its dim 0 alike."""
    if not is_dtensor(args[0]):
        return kernel(*args)
    from torch.distributed.tensor import Replicate, Shard
    bp = [Shard(0) if p == Shard(0) else Replicate()
          for p in args[0].placements]
    rep = [Replicate()] * len(bp)
    out = bp if outputs == 1 else tuple([bp] * outputs)
    return local_call(kernel, args, [rep if i in unbatched else bp
                                     for i in range(len(args))], out)


def forecast(kernel, diffs, *rest):
    """kernel(diffs, *rest) (a forecast wrapper, diffs (m+1, B, ...) or a
    batch of them): on a DTensor stack, on each rank's shards of its dim
    1, the other tensors (weights, steps) replicated."""
    if not is_dtensor(diffs):
        return kernel(diffs, *rest)
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(1) if p == Shard(1) else Replicate() for p in diffs.placements]
    out = [Shard(0) if p == Shard(1) else Replicate() for p in pl]
    rest_pl = [[Replicate()] * len(pl) if isinstance(a, torch.Tensor) else None
               for a in rest]
    return local_call(kernel, (diffs, *rest), [pl] + rest_pl, out)


__all__ = ["is_dtensor", "group", "all_reduce", "reduce_partial",
           "split_heads", "gathered", "embed", "put_rows", "put",
           "batch_local", "local_call", "attention", "forecast"]
