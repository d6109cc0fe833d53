"""The port's distribution layer, the counterparts of JAX's five
distribution tests (tests/test_distributed.py), on the CPU.

Numerics across ranks run on 4 gloo processes (torch only; they
rendezvous through a FileStore in tmp_path and each has a 120 s
timeout), against JAX's unsharded functions computed here on the same
bridged weights and inputs:
  * expert parallelism: `moe_forward_ep` on (data 2, attn 2, ffn 1)
    against JAX's dense `moe_forward` at drop-free capacity: y 2e-4 abs
    and 1e-3 rel, the load-balance loss 1e-3 rel (JAX's tolerances);
  * the sharded qwen2-7b SMOKE forward (f32) on (2, 2, 1) and (1, 2, 2)
    against JAX's unsharded `transformer.forward` at 2e-3 / 1e-3, with
    CommDebugMode's counts: one all-reduce after `wo` and one after
    `w_down` a layer, one for the vocab-parallel embedding, no all-gather
    (of a weight or anything else); then 3 decode steps on a cache sharded
    by `cache_sharding` against the unsharded decode (1e-4 abs).
The mesh contract, the logical meshes and the dry run run in this
process on a fake process group (world 256 / 512) and fake tensors; the
train cases' `remat=True` is held against the plain forward's gradients.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jax_models  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import ALL_ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(r"""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, store, task, data, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    import dataclasses
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import sharding as shd
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, transformer

    arrays = dict(np.load(data))
    meta = json.loads(str(arrays.pop("meta")))
    params = {}
    for path, a in arrays.items():
        if path.startswith("p/"):
            node = params
            *keys, leaf = path[2:].split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(a)
    mesh = make_mesh(meta["mesh"], ("data", "attn", "ffn"), device="cpu")
    specs = shd.params_sharding(params, mesh)
    dp = shd.distribute(params, specs, mesh)
    x = torch.from_numpy(arrays["x"])
    dx = shd.distribute({"x": x}, shd.inputs_sharding({"x": x}, mesh),
                        mesh)["x"]
    with CommDebugMode() as comm, implicit_replication():
        if task == "ep":
            cfg = dataclasses.replace(
                get_smoke_config("deepseek-v2-236b"), num_experts=8,
                experts_per_token=2, capacity_factor=8.0)
            y, aux = moe.moe_forward(
                dp["layer"]["moe"], dx, cfg,
                ep=dict(mesh=mesh, batch_ax=("data",), ep_axis="data",
                        inner_axes=("attn", "ffn")))
        else:
            cfg = dataclasses.replace(get_smoke_config("qwen2-7b"),
                                      dtype="float32")
            y, aux = transformer.forward(dp, dx, cfg, with_aux=True)
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    res = {"y": y.full_tensor().numpy()}
    if task == "fwd":
        # decode steps on a sharded cache (batch, kv heads, head dim)
        # against the unsharded decode of the same params
        B = x.shape[0]
        cache = transformer.init_cache(cfg, B, 8, device="cpu")
        dcache = shd.distribute(cache, shd.cache_sharding(cache, mesh), mesh)
        tok, pos = x[:, 0], torch.zeros((B,), dtype=torch.long)
        worst = 0.0
        for _ in range(3):
            ref, cache = transformer.decode_step(params, tok, pos, cache, cfg)
            step = shd.distribute({"t": tok, "p": pos}, shd.inputs_sharding(
                {"t": tok, "p": pos}, mesh), mesh)
            with implicit_replication():
                got, dcache = transformer.decode_step(dp, step["t"],
                                                      step["p"], dcache, cfg)
            worst = max(worst, float((got.full_tensor() - ref).abs().max()))
            tok, pos = ref.argmax(-1), pos + 1
        res["decode_err"] = np.asarray(worst)
    for k, v in aux.items():
        res[k] = np.asarray(v.full_tensor() if hasattr(v, "full_tensor")
                            else v)
    if rank == 0:
        np.savez(out, counts=json.dumps(counts), layers=cfg.num_layers,
                 placements=str(y.placements), **res)
    dist.destroy_process_group()
""")


def run_ranks(tmp_path, task, arrays, mesh, world=4, timeout=120):
    """Run the worker on `world` gloo ranks; rank 0's results."""
    data, out = tmp_path / f"{task}.npz", tmp_path / f"{task}_out.npz"
    np.savez(data, meta=json.dumps({"mesh": list(mesh)}), **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    store = tmp_path / f"{task}_store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(store), task,
         str(data), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            logs.append((p.returncode, so[-3000:], se[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc, _, _ in logs), logs
    return dict(np.load(out))


def _flat(tree, prefix="p"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def test_moe_ep_matches_jax_dense(tmp_path):
    """The expert-parallel all_to_all path on (data 2, attn 2, ffn 1)
    against JAX's dense one-hot dispatch on identical routing."""
    import dataclasses
    cfg = dataclasses.replace(jax_smoke("deepseek-v2-236b"), num_experts=8,
                              experts_per_token=2, capacity_factor=8.0)
    p = jax_moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model))
    y, aux = jax_moe.moe_forward(p, x, cfg)
    res = run_ranks(tmp_path, "ep", dict(_flat({"layer": {"moe": p}}),
                                         x=np.asarray(x)), (2, 2, 1))
    np.testing.assert_allclose(res["y"], np.asarray(y), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(float(res["load_balance_loss"]),
                               float(aux["load_balance_loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(res["router_z_loss"]),
                               float(aux["router_z_loss"]), rtol=1e-3)
    assert int(res["dropped"]) == 0
    counts = json.loads(str(res["counts"]))
    # the queues out and back; the shared experts' MLP, the inner ff sum
    # (attn) and the batch means of f_i, p_i, z and the drops
    assert counts == {"all_to_all_single": 2, "all_reduce": 6}, counts


@pytest.mark.parametrize("mesh", [(2, 2, 1), (1, 2, 2)])
def test_sharded_forward_matches_jax(tmp_path, mesh):
    """The qwen2-7b SMOKE forward on DTensor params (f32) against JAX's
    unsharded forward, the collectives it issues, and sharded decode."""
    import dataclasses
    cfg = dataclasses.replace(jax_smoke("qwen2-7b"), dtype="float32")
    params = jax_models.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
    ref, _ = jax_models.transformer.forward(params, jnp.asarray(toks), cfg)
    res = run_ranks(tmp_path, "fwd", dict(_flat(params), x=toks), mesh)
    np.testing.assert_allclose(res["y"], np.asarray(ref), atol=2e-3,
                               rtol=1e-3)
    assert float(res["decode_err"]) <= 1e-4, float(res["decode_err"])
    counts = json.loads(str(res["counts"]))
    layers = int(res["layers"])
    assert counts == {"all_reduce": 2 * layers + 1}, counts
    assert "Shard(dim=0)" in str(res["placements"])


@pytest.fixture
def fake_world():
    """A fake process group in this process, destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import init_fake_world
    yield init_fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def test_production_mesh_contract(fake_world):
    """(16, 16) ("data", "model") and (2, 16, 16) ("pod", "data",
    "model") on 256 / 512 fake ranks; a smoke tinyllama forward traces on
    both under FakeTensorMode, logits sharded on the batch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import params_shape, transformer
    cfg = get_smoke_config("tinyllama-1.1b")
    for mp in (False, True):
        fake_world(512 if mp else 256)
        mesh = make_production_mesh(multi_pod=mp, device="cpu")
        assert mesh.size() == (512 if mp else 256)
        assert mesh.mesh_dim_names == (("pod", "data", "model") if mp
                                       else ("data", "model"))
        pspec = params_shape(cfg)
        toks = torch.empty((32, 16), dtype=torch.long, device="meta")
        with FakeTensorMode(allow_non_fake_inputs=True):
            params, t = shd.from_local_shards(
                (pspec, toks), (shd.params_sharding(pspec, mesh),
                                shd.inputs_sharding(toks, mesh)), mesh,
                lambda shape, dtype: torch.empty(shape, dtype=dtype))
            with implicit_replication():
                logits = transformer.forward(params, t, cfg)
        assert tuple(logits.shape) == (32, 16, cfg.vocab_size)
        assert logits.to_local().shape[0] == (1 if mp else 2)


def test_logical_mesh_attn_alignment(fake_world):
    """Every arch's logical mesh: 256 ranks, attn | KV heads, the names."""
    from repro_torch.launch.mesh import attn_shards, make_logical_mesh
    fake_world(256)
    for arch in ALL_ARCH_IDS:
        cfg = get_config(arch)
        mesh = make_logical_mesh(cfg, device="cpu")
        assert mesh.size() == 256 and mesh.mesh_dim_names == (
            "data", "attn", "ffn")
        a = mesh.size(1)
        assert a <= attn_shards(cfg)
        assert cfg.num_kv_heads == 0 or cfg.num_kv_heads % a == 0
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_logical_mesh(get_config("qwen2-7b"), multi_pod=True,
                          device="cpu")


def test_dryrun_single_case_end_to_end(fake_world, tmp_path):
    """The dry-run CLI's entry point on tinyllama-1.1b train_4k into
    tmp_path; its default directory is git-ignored and not benchmarks/."""
    from repro_torch.launch import dryrun
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    rec = json.load(open(tmp_path / "dryrun_tinyllama-1.1b_train_4k_sp.json"))
    assert rec["status"] == "ok"
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["fits_80gb_hbm"]
    assert rec["roofline"]["chips"] == 256
    assert 0 < rec["useful_flops_ratio"] <= 1
    assert dryrun.RESULTS_DIR.name == "dryrun_out"
    assert "benchmarks" not in dryrun.RESULTS_DIR.parts


@pytest.mark.parametrize("arch", ["qwen2-7b", "dit-xl"])
def test_remat_keeps_loss_and_gradients(arch):
    """`remat=True` (the train cases' per-layer checkpointing) gives the
    loss and gradients of the plain forward (f32 SMOKE, on the CPU)."""
    from repro_torch.models import dit, init_params, transformer
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)
              if t.is_floating_point()]
    g = torch.Generator().manual_seed(1)

    def loss_and_grads(remat):
        g.manual_seed(1)
        if cfg.is_dit:
            lat = torch.randn((2, cfg.dit_patch_tokens, cfg.dit_in_dim),
                              generator=g)
            out = dit.forward(params, lat, torch.tensor([3.0, 700.0]),
                              torch.tensor([1, 2]), cfg, remat=remat)
        else:
            toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
            out = transformer.forward(params, toks, cfg, remat=remat)
        loss = out.float().square().mean()
        return loss.detach(), torch.autograd.grad(loss, leaves)

    (v0, g0), (v1, g1) = loss_and_grads(False), loss_and_grads(True)
    torch.testing.assert_close(v1, v0, rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
