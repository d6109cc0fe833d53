"""Mesh builders of the port (the JAX package's `launch/mesh.py`):
functions, so importing never touches a process group or a device.

Each builds a `DeviceMesh` with JAX's axis names over the process group
that is initialised (`torch.distributed.init_process_group`): the fake
one at world size 256 or 512 for the dry run and the CPU tests
(`torch.testing._internal.distributed.fake_pg.FakeStore`), NCCL on the
cards, gloo in the CPU tests of the numerics.  Where the world is larger
than the mesh, the mesh takes its first ranks, as JAX takes the first
devices.  The mesh's device type is the GPU's unless the caller passes
device="cpu": a mesh is never quietly built on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DeviceLike, resolve_device


def make_mesh(shape, axes, *, device: DeviceLike = None):
    """A DeviceMesh of `shape` named `axes` over the first prod(shape)
    ranks of the initialised process group (JAX's `jax.make_mesh`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialised "
                           "(torch.distributed.init_process_group)")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"make_mesh: a {shape} mesh needs {n} ranks, the "
                         f"world has {world}")
    kind = resolve_device(device).type
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def production_mesh_shape(*, multi_pod: bool = False):
    """(shape, axes) of the production mesh: 16 x 16 ("data", "model"),
    or 2 x 16 x 16 ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The 256-rank pod mesh, or the 512-rank two-pod mesh.  The "pod"
    axis composes with "data" for batch sharding."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device=device)


def attn_shards(cfg) -> int:
    """Largest power of two <= 16 dividing the KV-head count (and H).

    The pod has 16 ranks on the tensor axis, but e.g. qwen2-7b has H = 28,
    KH = 4: a flat 16-way shard of the fused (d, H*hd) projection splits
    heads mid-boundary.  Factoring the tensor axis as (attn = a, ffn =
    16 / a) with a | KH keeps every reshape head-aligned."""
    h = cfg.num_heads or 16
    kh = cfg.num_kv_heads or h
    for a in (16, 8, 4, 2, 1):
        if kh % a == 0 and h % a == 0:
            return a
    return 1


def logical_mesh_shape(cfg, *, multi_pod: bool = False):
    """(shape, axes) of the per-arch logical view of the pod: the tensor
    axis factored into ("attn", "ffn") by `attn_shards`.  Models under 4B
    params trade tensor for data parallelism (data 32, tp 8); multi-pod
    keeps pod * data at 32, so the smallest global batch (32) still
    shards fully."""
    from repro_torch.models import param_count
    small = param_count(cfg) < 4e9
    data = 32 if (small and not multi_pod) else 16
    tp = 256 // data
    a = attn_shards(cfg)
    while a > tp or (cfg.num_kv_heads and cfg.num_kv_heads % a):
        a //= 2
    a = max(a, 1)
    if multi_pod:
        return (2, data, a, tp // a), ("pod", "data", "attn", "ffn")
    return (data, a, tp // a), ("data", "attn", "ffn")


def make_logical_mesh(cfg, *, multi_pod: bool = False,
                      device: DeviceLike = None):
    """The logical mesh of `cfg` over the same 256 / 512 ranks as
    `make_production_mesh`."""
    shape, axes = logical_mesh_shape(cfg, multi_pod=multi_pod)
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None):
    """A small ("data", "model") mesh over the real world (tests,
    examples)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, n)
    model = max(min(model, n // data), 1)
    return make_mesh((data, model), ("data", "model"), device=device)


__all__ = ["make_mesh", "production_mesh_shape", "make_production_mesh",
           "attn_shards", "logical_mesh_shape", "make_logical_mesh",
           "make_host_mesh"]
