"""The port's sharding rules and mesh factoring against the JAX package's,
on the CPU, with no process group: the rules read only a mesh's axis
names and sizes, so both packages get the same stub mesh (JAX's own
tests pass one, tests/test_sharding_rules.py).

Exact equality throughout: `param_spec`, `_sanitize` and `_add_fsdp` on
every leaf of every arch (JAX's params from `jax.eval_shape`, the port's
from the meta-device init), on the contract and logical meshes, single
and multi pod; `cache_spec` on every cache leaf of each family at every
input shape; `attn_shards` and the logical mesh's shape per arch (JAX's
`make_logical_mesh` called with `jax.make_mesh` and `jax.devices`
patched to hand back its arguments).
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro import sharding as jshd  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.specs import effective_window  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import (ALL_ARCH_IDS, ARCH_IDS,  # noqa: E402
                                 INPUT_SHAPES, get_config)
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import encdec, params_shape, transformer  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

META = torch.device("meta")


class Stub:
    """A mesh as the rules see it: axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


@functools.lru_cache(maxsize=None)
def jax_logical(arch, multi_pod):
    """(shape, axes) JAX's make_logical_mesh builds for `arch`."""
    with mock.patch.object(jax, "devices", lambda: list(range(512))), \
            mock.patch.object(jax, "make_mesh",
                              lambda shape, axes, devices=None:
                              (tuple(shape), tuple(axes))):
        return jmesh.make_logical_mesh(jax_get_config(arch),
                                       multi_pod=multi_pod)


def mesh_of(kind, arch):
    if kind == "contract":
        return Stub((16, 16), ("data", "model"))
    if kind == "contract-mp":
        return Stub((2, 16, 16), ("pod", "data", "model"))
    return Stub(*jax_logical(arch, kind == "logical-mp"))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    cfg = jax_get_config(arch)
    tree = jax.eval_shape(functools.partial(jax_init_params, cfg=cfg),
                          jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jshd._path_str(p): leaf for p, leaf in flat}


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return dict(tree_paths(params_shape(get_config(arch))))


MESHES = ("contract", "contract-mp", "logical", "logical-mp")


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_param_rules_match_jax(arch, kind):
    """param_spec, _sanitize and _add_fsdp equal JAX's on every leaf."""
    mesh = mesh_of(kind, arch)
    jp, tp = jax_params(arch), port_params(arch)
    assert set(jp) == set(tp)
    for path, leaf in tp.items():
        jleaf = jp[path]
        assert tuple(leaf.shape) == tuple(jleaf.shape), path
        got = shd.param_spec(path, leaf, mesh)
        want = jshd.param_spec(path, jleaf, mesh)
        assert tuple(got) == tuple(want), (path, got, want)
        got = shd._sanitize(mesh, got, leaf.shape)
        want = jshd._sanitize(mesh, want, jleaf.shape)
        assert tuple(got) == tuple(want), (path, got, want)
        assert tuple(shd._add_fsdp(mesh, got, leaf)) == \
            tuple(jshd._add_fsdp(mesh, want, jleaf)), path
    specs = shd.params_sharding(params_shape(get_config(arch)), mesh,
                                fsdp=True)
    assert len(list(shd._spec_leaves(specs, len(tp)))) == len(tp)


def _caches(arch, shape_name):
    """(port cache tree on the meta device, JAX's {path: leaf})."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ishape = INPUT_SHAPES[shape_name]
    B, S = ishape.global_batch, ishape.seq_len
    if cfg.is_dit:
        eps = (B, cfg.dit_patch_tokens, cfg.dit_in_dim)
        tree = make_policy("taylorseer", interval=4, order=2).init_state(
            eps, torch.bfloat16, device=META)
        jtree = jax.eval_shape(lambda: jax_make_policy(
            "taylorseer", interval=4, order=2).init_state(eps, jnp.bfloat16))
    elif cfg.is_encoder_decoder:
        tree = encdec.init_dec_cache(cfg, B, S, cfg.encoder_seq, device=META)
        jtree = jax.eval_shape(functools.partial(
            jencdec.init_dec_cache, jcfg, B, S, jcfg.encoder_seq))
    else:
        window = effective_window(jcfg, shape_name)
        cache_len = min(S, window) if window > 0 else S
        if cfg.family == "ssm":
            cache_len = 1
        tree = transformer.init_cache(cfg, B, cache_len, device=META)
        jtree = jax.eval_shape(functools.partial(
            jtransformer.init_cache, jcfg, B, cache_len))
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    return tree, {jshd._path_str(p): leaf for p, leaf in flat}


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS + ["dit-xl"])
def test_cache_spec_matches_jax(arch, shape_name):
    """Every cache leaf of each family at every input shape, on the
    contract and logical meshes (long_500k's batch of 1 moves the data
    axis onto the sequence)."""
    tree, jtree = _caches(arch, shape_name)
    paths = dict(tree_paths(tree))
    assert set(paths) == set(jtree)
    for kind in ("contract", "logical"):
        mesh = mesh_of(kind, arch)
        for path, leaf in paths.items():
            assert tuple(leaf.shape) == tuple(jtree[path].shape), path
            got = shd.cache_spec(path, leaf, mesh)
            want = jshd.cache_spec(path, jtree[path], mesh)
            assert tuple(got) == tuple(want), (kind, path, got, want)
    if shape_name == "long_500k" and "k" in paths:
        spec = shd.cache_spec("k", paths["k"], mesh_of("logical", arch))
        assert spec[1] is None and spec[2] == "data"


# JAX's own expectations (tests/test_distributed.py)
ATTN_SHARDS = {"qwen2-7b": 4, "qwen2.5-14b": 8, "arctic-480b": 8,
               "minitron-8b": 8, "pixtral-12b": 8, "tinyllama-1.1b": 4,
               "deepseek-v2-236b": 16, "zamba2-2.7b": 16,
               "whisper-small": 4, "dit-xl": 16}


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_logical_mesh_matches_jax(arch, multi_pod):
    cfg = get_config(arch)
    a = tmesh.attn_shards(cfg)
    assert a == jmesh.attn_shards(jax_get_config(arch))
    if arch in ATTN_SHARDS:
        assert a == ATTN_SHARDS[arch]
    shape, axes = tmesh.logical_mesh_shape(cfg, multi_pod=multi_pod)
    assert (shape, axes) == jax_logical(arch, multi_pod)
    assert shape[0] * shape[1] * shape[2] * (shape[3] if multi_pod else 1) \
        == (512 if multi_pod else 256)
    if not multi_pod:
        assert cfg.num_kv_heads % shape[1] == 0 or cfg.num_kv_heads == 0


def test_inputs_logits_and_placements():
    """inputs_sharding and logits_sharding equal JAX's specs; a composed axis
    becomes one Shard(d) on each of its mesh dims."""
    from jax.sharding import PartitionSpec as JP
    from torch.distributed.tensor import Replicate, Shard
    for mesh in (Stub((16, 4, 4), ("data", "attn", "ffn")),
                 Stub((2, 16, 4, 4), ("pod", "data", "attn", "ffn")),
                 Stub((16, 16), ("data", "model"))):
        for batch in (1, 32, 128):
            leaf = torch.empty((batch, 7), device=META)
            got = shd.inputs_sharding({"t": leaf}, mesh)["t"]
            ba = jshd.batch_axes(mesh)
            want = JP(jshd._fit(mesh, ba, batch), None)
            assert tuple(got) == tuple(want)
            for vocab in (51865, 32000):
                # JAX's logits_sharding wraps its spec in a NamedSharding,
                # which needs real devices: its spec is built from these
                got = shd.logits_sharding(mesh, ndim=2, batch=batch,
                                          vocab=vocab)
                ba_fit = jshd._fit(mesh, jshd.batch_axes(mesh), batch)
                tp_fit = jshd._fit(mesh, jshd.tp_axes(mesh), vocab)
                assert tuple(got) == tuple(JP(ba_fit, tp_fit))

    class Mesh:                              # placements read the names only
        mesh_dim_names = ("data", "attn", "ffn")

        def size(self, i):
            return (2, 2, 2)[i]
    m = Mesh()
    assert shd.placements(m, shd.P(("attn", "ffn"), None)) == \
        [Replicate(), Shard(0), Shard(0)]
    assert shd.placements(m, shd.P("data", None, ("attn", "ffn"))) == \
        [Shard(0), Shard(2), Shard(2)]
    assert shd.placements(m, shd.P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="shards two dims"):
        shd.placements(m, shd.P("attn", "attn"))
    assert shd.local_shape(m, shd.P("data", ("attn", "ffn")), (8, 16)) == \
        (4, 4)
    with pytest.raises(ValueError, match="does not divide"):
        shd.local_shape(m, shd.P(("attn", "ffn")), (6,))
