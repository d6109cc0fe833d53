"""The port's training substrate (`repro_torch.data`, `optim`,
`checkpoint`, `train`, `launch.train`, the flash backward's plain version)
against the JAX package on the CPU, at DiT-XL SMOKE size.

Both packages get the same weights (bridged) and the same draws (JAX's
`split(key, 3)` draws injected into the port's `diffusion_loss`).
Tolerances, each with its reason:
- data, checkpoints: bitwise (the same numpy generators; bits stored);
- AdamW, clipping, the schedule: 1e-6 relative (the same f32 formulas);
- the diffusion loss 1e-5 relative and its gradient 1e-4 relative per
  leaf (summation order of XLA and torch);
- 3 train steps: params and moments 1e-4 relative per leaf (AdamW
  normalizes the gradient, so its rounding reaches the update);
- the plain attention backward against autograd: 1e-5 abs in f32 (unit
  normal inputs; one summation order against another).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro import data as jax_data  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.diffusion import linear_schedule as jax_linear_schedule  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro.train import train_loop as jax_train_loop  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch.bridge import to_torch, train_state_to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.diffusion import linear_schedule  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_bwd_ref,  # noqa: E402
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_backward)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps, train_loop  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths, treedef_str  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_tree_close(port, ref, rtol, what):
    """Every leaf of `port` (tensors) within rtol of `ref` (arrays), relative
    to the leaf's largest magnitude; the leaf paths must agree."""
    got, want = tree_paths(port), tree_paths(_np(ref))
    assert [k for k, _ in got] == [k for k, _ in want]
    worst = {k: _rel(g.float().numpy() if isinstance(g, torch.Tensor) else g,
                     np.asarray(w, np.float32))
             for (k, g), (_, w) in zip(got, want)}
    bad = {k: r for k, r in worst.items() if not r <= rtol}
    assert not bad, (what, bad)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("start", [0, 7])
def test_data_generators_bitwise_equal_to_jax(seed, start):
    ours = data.lm_batches(seed, 3, 12, 97, start_step=start)
    ref = jax_data.lm_batches(seed, 3, 12, 97, start_step=start)
    ours_l = data.latent_batches(seed, 2, 8, 5, 10, start_step=start)
    ref_l = jax_data.latent_batches(seed, 2, 8, 5, 10, start_step=start)
    for _ in range(2):
        for a, b in zip(next(ours) + next(ours_l), next(ref) + next(ref_l)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for fn in ("frame_embeddings", "patch_embeddings"):
        a = getattr(data, fn)(seed, 2, 6, 9)
        b = getattr(jax_data, fn)(seed, 2, 6, 9)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_lm_iterator_state_round_trip():
    it = data.LMBatchIterator(5, 2, 8, 50)
    next(it), next(it)
    state = it.state_dict()
    assert state == {"seed": 5, "step": 2}
    resumed = data.LMBatchIterator.from_state(state, 2, 8, 50)
    ref = jax_data.LMBatchIterator.from_state(state, 2, 8, 50)
    for a, b, c in zip(next(resumed), next(ref), next(it)):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert resumed.state_dict() == it.state_dict() == {"seed": 5, "step": 3}


# ----------------------------------------------------------------------
# AdamW, clipping, schedule
# ----------------------------------------------------------------------

def _random_tree(rng, dtype, scale=1.0):
    shapes = {"w": (6, 5), "blocks": {"a": (2, 4, 3), "b": (7,)}}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return jnp.asarray(rng.normal(size=node).astype(np.float32) * scale,
                           dtype)
    return build(shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_adamw_clip_schedule_match_jax(dtype, max_norm):
    """Three clipped AdamW steps under the cosine schedule; clipping bf16
    gradients gives f32 in both packages."""
    rng = np.random.default_rng(1)
    jp = _random_tree(rng, getattr(jnp, dtype))
    tp = to_torch(_np(jp), "cpu")
    js, ts = jax_adamw.adamw_init(jp), adamw.adamw_init(tp)
    for i in range(3):
        jg = _random_tree(rng, getattr(jnp, dtype), scale=3.0)
        tg = to_torch(_np(jg), "cpu")
        jc, jn = jax_adamw.clip_by_global_norm(jg, max_norm)
        tc, tn = adamw.clip_by_global_norm(tg, max_norm)
        assert all(t.dtype == torch.float32 for t in tree_leaves(tc))
        assert all(np.asarray(a).dtype == np.float32
                   for a in jax.tree_util.tree_leaves(jc))
        assert _rel(tn.numpy(), jn) <= 1e-6
        _assert_tree_close(tc, jc, 1e-6, "clipped")
        jlr = jax_adamw.cosine_warmup_schedule(js.step, peak_lr=1e-2,
                                               warmup_steps=1, total_steps=5)
        tlr = adamw.cosine_warmup_schedule(ts.step, peak_lr=1e-2,
                                           warmup_steps=1, total_steps=5)
        assert _rel(tlr.numpy(), jlr) <= 1e-6
        jp, js = jax_adamw.adamw_update(jc, js, jp, lr=jlr, weight_decay=0.1)
        tp, ts = adamw.adamw_update(tc, ts, tp, lr=tlr, weight_decay=0.1)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    _assert_tree_close(tp, jp, 1e-6, "params")
    _assert_tree_close(ts.mu, js.mu, 1e-6, "mu")
    _assert_tree_close(ts.nu, js.nu, 1e-6, "nu")
    assert all(t.dtype == getattr(torch, dtype) for t in tree_leaves(tp))


@pytest.mark.parametrize("warmup,total", [(0, 10), (50, 100), (3, 3)])
def test_cosine_warmup_schedule_matches_jax(warmup, total):
    for s in (0, 1, warmup, warmup + 1, total // 2, total, total + 5):
        want = jax_adamw.cosine_warmup_schedule(s, peak_lr=3e-4,
                                                warmup_steps=warmup,
                                                total_steps=total)
        got = adamw.cosine_warmup_schedule(torch.tensor(s, dtype=torch.int32),
                                           peak_lr=3e-4, warmup_steps=warmup,
                                           total_steps=total)
        assert abs(float(got) - float(want)) <= 1e-6 * max(float(want), 1e-12)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState at DiT-XL SMOKE size with bf16 leaves and a step
    count of 3."""
    cfg = jax_smoke("dit-xl")
    state = jax_steps.init_train_state(jax.random.PRNGKey(0), cfg,
                                       jnp.bfloat16)
    rng = np.random.default_rng(2)
    opt = state.opt._replace(
        step=jnp.asarray(3, jnp.int32),
        mu=jax.tree_util.tree_map(
            lambda m: jnp.asarray(rng.normal(size=m.shape), jnp.float32),
            state.opt.mu))
    return state._replace(opt=opt)


def _port_like(state):
    return train_state_to_torch(state.params, state.opt, "cpu")


def _bitwise(port_tree, jax_tree):
    for (k, a), (_, b) in zip(tree_paths(port_tree), tree_paths(_np(jax_tree))):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16, k
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16)), k
        else:
            assert np.array_equal(a.numpy(), b), k


def test_checkpoint_jax_writes_port_reads(jax_state, tmp_path):
    jax_ckpt.save(str(tmp_path), 3, jax_state, extra={"note": "jax"})
    like = _port_like(jax_state)
    like = like._replace(opt=like.opt._replace(step=torch.tensor(
        0, dtype=torch.int32)))
    tree, step, extra = ckpt.restore(str(tmp_path), like)
    assert step == 3 and extra == {"note": "jax"}
    assert int(tree.opt.step) == 3 and tree.opt.step.dtype == torch.int32
    _bitwise(tree, jax_state)


def test_checkpoint_port_writes_jax_reads(jax_state, tmp_path):
    ckpt.save(str(tmp_path / "port"), 3, _port_like(jax_state))
    jax_ckpt.save(str(tmp_path / "jax"), 3, jax_state)
    tree, step, _ = jax_ckpt.restore(str(tmp_path / "port"), jax_state)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jax_state)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                              np.asarray(b).reshape(-1).view(np.uint8))
    # the sidecars agree: keys (".params/...", ".opt/.step"), dtypes, treedef
    side = [json.loads((tmp_path / w / "step_00000003" / "arrays.json")
                       .read_text()) for w in ("port", "jax")]
    assert side[0] == side[1]
    assert ".opt/.step" in side[0]["keys"]
    assert ".params/blocks/attn/wq" in side[0]["keys"]
    assert side[0]["treedef"] == treedef_str(_port_like(jax_state))


def test_checkpoint_prunes_to_keep_and_latest(tmp_path):
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    for s in (1, 5, 9, 12):
        ckpt.save(str(tmp_path), s, tree)
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (5, 9, 12)]
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert jax_ckpt.latest_step(str(tmp_path)) == 12
    back, step, _ = ckpt.restore(str(tmp_path), tree, step=9)
    assert step == 9 and torch.equal(back["b"][0], tree["b"][0])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


# ----------------------------------------------------------------------
# diffusion loss and steps against JAX (DiT-XL SMOKE)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def dit():
    """Perturbed DiT-XL SMOKE params (so attention has a gradient), a batch,
    JAX's draws of four keys and JAX's loss/gradient and 3-step results."""
    cfg, tcfg = jax_smoke("dit-xl"), get_smoke_config("dit-xl")
    sched, tsched = jax_linear_schedule(1000), linear_schedule(1000)
    state = jax_steps.init_train_state(jax.random.PRNGKey(0), cfg)
    state = state._replace(params=jax_perturb(state.params, 0))
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(B, cfg.dit_patch_tokens, cfg.dit_in_dim))
                .astype(np.float32),
                rng.integers(0, cfg.dit_num_classes, size=B).astype(np.int32),
                jax.random.PRNGKey(10 + i)) for i in range(3)]

    def draws(key, shape):
        kt, ke, kd = jax.random.split(key, 3)
        return (jax.random.randint(kt, (shape[0],), 0, sched.T),
                jax.random.normal(ke, shape, jnp.float32),
                jax.random.bernoulli(kd, 0.1, (shape[0],)))

    x, y, key = batches[0]
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.diffusion_loss(p, x, y, cfg, sched, key),
        has_aux=True))(state.params)
    step = jax.jit(jax_steps.make_diffusion_train_step(cfg, sched, warmup=0,
                                                       total_steps=10))
    s, metrics = state, []
    for x_, y_, k_ in batches:
        s, m = step(s, {"latents": x_, "labels": y_, "key": k_})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"cfg": tcfg, "sched": tsched, "state": state, "batches": batches,
            "draws": [tuple(torch.from_numpy(np.array(a)) for a in
                            draws(k, x.shape)) for x, _, k in batches],
            "loss": float(loss), "grads": grads, "after": s,
            "metrics": metrics}


def _batch(dit, i):
    x, y, _ = dit["batches"][i]
    t, eps, drop = dit["draws"][i]
    return {"latents": torch.from_numpy(x), "labels": torch.from_numpy(y),
            "draws": (t.long(), eps, drop)}


def test_diffusion_loss_and_gradient_match_jax(dit):
    params = to_torch(_np(dit["state"].params), "cpu")
    b = _batch(dit, 0)

    def loss_fn(p, _):
        return steps.diffusion_loss(p, b["latents"], b["labels"], dit["cfg"],
                                    dit["sched"], draws=b["draws"])

    grads, metrics = steps._value_and_grad(loss_fn, params, None)
    assert abs(float(metrics["loss"]) - dit["loss"]) <= 1e-5 * dit["loss"]
    _assert_tree_close(grads, dit["grads"], 1e-4, "gradient")
    assert all(bool((g != 0).any()) for g in tree_leaves(grads))


def test_diffusion_train_step_matches_jax(dit):
    state = _port_like(dit["state"])
    step = steps.make_diffusion_train_step(dit["cfg"], dit["sched"], warmup=0,
                                           total_steps=10)
    for i in range(3):
        state, m = step(state, _batch(dit, i))
        want = dit["metrics"][i]
        assert set(m) == set(want)
        for k in m:
            assert abs(float(m[k]) - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6)
    assert int(state.opt.step) == 3
    _assert_tree_close(state.params, dit["after"].params, 1e-4, "params")
    _assert_tree_close(state.opt.mu, dit["after"].opt.mu, 1e-4, "mu")
    _assert_tree_close(state.opt.nu, dit["after"].opt.nu, 1e-4, "nu")


def test_diffusion_accumulation_equals_one_batch(dit):
    """accum=2 splits the batch and its draws; the mean gradient and so the
    step equal accum=1's up to summation order (JAX's accum=2 diffusion
    step fails on its PRNG key, ROADMAP.md §C.1)."""
    outs = []
    for accum in (1, 2):
        state = _port_like(dit["state"])
        step = steps.make_diffusion_train_step(dit["cfg"], dit["sched"],
                                               warmup=0, total_steps=10,
                                               accum=accum)
        state, m = step(state, _batch(dit, 0))
        outs.append((state, float(m["loss"]), float(m["grad_norm"])))
    (s1, l1, g1), (s2, l2, g2) = outs
    assert abs(l1 - l2) <= 1e-6 * l1 and abs(g1 - g2) <= 1e-5 * g1
    for a, b in zip(tree_leaves(s2), tree_leaves(s1)):
        assert _rel(a.float().numpy(), b.float().numpy()) <= 1e-4


def test_jax_state_continues_in_the_port(dit):
    """A JAX state after one step, bridged, takes the second step as JAX
    does."""
    cfg, sched = jax_smoke("dit-xl"), jax_linear_schedule(1000)
    step = jax.jit(jax_steps.make_diffusion_train_step(cfg, sched, warmup=0,
                                                       total_steps=10))
    x, y, key = dit["batches"][0]
    one, _ = step(dit["state"], {"latents": x, "labels": y, "key": key})
    x, y, key = dit["batches"][1]
    two, _ = step(one, {"latents": x, "labels": y, "key": key})
    state = train_state_to_torch(one.params, one.opt, "cpu")
    assert int(state.opt.step) == 1
    port_step = steps.make_diffusion_train_step(dit["cfg"], dit["sched"],
                                                warmup=0, total_steps=10)
    state, _ = port_step(state, _batch(dit, 1))
    _assert_tree_close(state.params, two.params, 1e-4, "params")
    _assert_tree_close(state.opt.nu, two.opt.nu, 1e-4, "nu")


def test_diffusion_draws_come_from_the_generator(dit):
    """Without injected draws the step draws from the batch's generator:
    the same seed gives the same step, another seed another."""
    b = _batch(dit, 0)
    del b["draws"]
    losses = []
    for seed in (4, 4, 5):
        state = _port_like(dit["state"])
        step = steps.make_diffusion_train_step(dit["cfg"], dit["sched"],
                                               warmup=0, total_steps=10)
        _, m = step(state, dict(b, generator=torch.Generator().manual_seed(seed)))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]
    t, eps, drop = steps.diffusion_draws(torch.Generator().manual_seed(0),
                                         torch.zeros((64, 3, 2)), 1000)
    assert t.min() >= 0 and t.max() < 1000 and eps.shape == (64, 3, 2)
    assert 0 < int(drop.sum()) < 32


# ----------------------------------------------------------------------
# the loop and the launcher
# ----------------------------------------------------------------------

def test_train_loop_history_and_checkpoints_match_jax(dit, tmp_path):
    """Logging steps (the first and every log_every-th), history keys and
    checkpoint cadence as in JAX's loop."""
    cfg, sched = jax_smoke("dit-xl"), jax_linear_schedule(1000)
    jstep = jax_steps.make_diffusion_train_step(cfg, sched, warmup=0,
                                                total_steps=5)
    jbatches = ({"latents": x, "labels": y, "key": k}
                for x, y, k in dit["batches"] * 2)
    _, jhist = jax_train_loop(jstep, dit["state"], jbatches, 5, log_every=2,
                              ckpt_dir=str(tmp_path / "jax"), ckpt_every=2,
                              log_fn=lambda s: None, donate=False)
    tstep = steps.make_diffusion_train_step(dit["cfg"], dit["sched"], warmup=0,
                                            total_steps=5)
    tbatches = (_batch(dit, i % 3) for i in range(6))
    lines = []
    _, thist = train_loop(tstep, _port_like(dit["state"]), tbatches, 5,
                          log_every=2, ckpt_dir=str(tmp_path / "port"),
                          ckpt_every=2, log_fn=lines.append)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [1, 2, 4]
    assert [set(h) for h in thist] == [set(h) for h in jhist]
    assert len(lines) == 3 and lines[0].startswith("step     1")
    for h, j in zip(thist, jhist):
        assert abs(h["loss"] - j["loss"]) <= 1e-4 * j["loss"]
    assert sorted(os.listdir(tmp_path / "port")) \
        == sorted(os.listdir(tmp_path / "jax")) == ["step_00000002",
                                                    "step_00000004"]
    # verify_donation: the first step recorded, every leaf in place
    state = _port_like(dit["state"])
    out, _ = train_loop(tstep, state, iter([_batch(dit, 0)]), 1,
                        log_fn=lines.append, verify_donation=True)
    assert out.opt.step is state.opt.step and int(out.opt.step) == 1


@pytest.mark.parametrize("arch", ["dit-xl", "dit-audio", "dit-t2i"])
def test_launcher_trains_on_the_cpu(arch, capsys):
    """The class-conditioned DiTs JAX's launcher trains (dit-t2i through its
    zero-table text branch); the video DiTs, on which JAX's fails, raise."""
    from repro_torch.launch import train as launch
    state, hist = launch.main(["--arch", arch, "--smoke", "--steps", "2",
                               "--batch", "2", "--device", "cpu"])
    assert [h["step"] for h in hist] == [1] and np.isfinite(hist[0]["loss"])
    assert int(state.opt.step) == 2
    assert "loss" in capsys.readouterr().out
    with pytest.raises(ValueError, match="video"):
        launch.main(["--arch", "dit-t2v" if arch == "dit-t2i" else
                     "dit-video", "--smoke", "--steps", "1", "--device", "cpu"])


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """launch.train with a checkpoint every 2 steps; restored at step 2 and
    rerun to step 4, the state is bitwise the uninterrupted run's (the
    batches and draws are functions of (seed, step))."""
    from repro_torch.launch.train import train
    kw = dict(smoke=True, steps=4, batch=2, warmup=0, device="cpu",
              log_fn=lambda s: None)
    full, _ = train("dit-xl", ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    restored, at, _ = ckpt.restore(str(tmp_path), full, step=2)
    resumed, _ = train("dit-xl", state=restored, start_step=at, **kw)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                                 tree_leaves(full)))


def test_example_small_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "torch_train_dit.py"),
                          "--small", "--steps", "40", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "OK"
    assert any(l.startswith("checkpoint restored from step 40") for l in lines)


# ----------------------------------------------------------------------
# the flash backward's plain version and the wrappers under grad
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", [
    (1, 128, 128, 4, 4, 64), (2, 64, 64, 8, 2, 64), (1, 48, 96, 4, 1, 32),
    (2, 77, 77, 4, 4, 72), (1, 64, 32, 2, 2, 16),   # q longer than k
    (1, 40, 60, 4, 2, 18),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0),
                                           (False, 24)])
def test_attention_bwd_ref_matches_autograd(B, Sq, Sk, H, KH, D, causal,
                                            window):
    g = torch.Generator().manual_seed(B * Sq + Sk + D)
    q = torch.randn((B, Sq, H, D), generator=g, requires_grad=True)
    k = torch.randn((B, Sk, KH, D), generator=g, requires_grad=True)
    v = torch.randn((B, Sk, KH, D), generator=g, requires_grad=True)
    do = torch.randn((B, Sq, H, D), generator=g)
    o = attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = attention_lse_ref(q.detach(), k.detach(), causal=causal,
                            window=window)
    got = flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                   o.detach(), do, lse, causal=causal,
                                   window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= 1e-5
    if causal and Sq > Sk:   # rows with no key: no dq, dv takes dO / Sk
        assert bool((got[0][:, :Sq - Sk] == 0).all())


def test_attention_bwd_ref_bf16_and_f64():
    """bf16 inputs compute in f32 and return bf16 gradients; f64 inputs stay
    f64 (the card's float64 reference)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((1, 32, 2, 16), generator=g) for _ in range(4))
    for dt in (torch.bfloat16, torch.float64):
        args = [t.to(dt) for t in (q, k, v)]
        o = attention_ref(*args)
        lse = attention_lse_ref(*args[:2])
        assert o.dtype == dt and lse.dtype == (torch.float64 if dt is
                                               torch.float64 else torch.float32)
        grads = attention_bwd_ref(*args, o, do.to(dt), lse)
        assert all(t.dtype == dt for t in grads)


def test_flash_wrapper_is_differentiable_on_the_cpu():
    q = torch.randn((1, 16, 2, 8), requires_grad=True)
    o = flash_attention(q, q, q, causal=False)
    assert o.grad_fn is not None
    o.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def test_no_grad_launch_guard():
    """The CUDA wrappers' guard: a launch autograd would not see raises
    under grad when an input requires a gradient, and passes otherwise."""
    x, w = torch.ones(2, requires_grad=True), torch.ones(2)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.no_grad_launch("forecast", "none is needed", w, x)
    _build.no_grad_launch("ssd_scan", "", w, w)
    with torch.no_grad():
        _build.no_grad_launch("ssd_scan", "", w, x)
