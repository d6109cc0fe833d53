"""The port's dense LLM family against the JAX package, on the CPU.

tinyllama-1.1b and qwen2-7b SMOKE (2 layers, d 128, 4 heads over 2 KV
heads, f32; qwen2 with the QKV bias) with the JAX params bridged into
torch; the flash wrapper runs its plain version on CPU tensors.
Tolerances, f32 sums in another order: logits 1e-4 abs, prefill cache
leaves 1e-5 abs; greedy tokens and parameter counts exactly; `lm_loss`
1e-5 relative and its gradient 1e-4 relative per leaf, 3 train steps'
params and AdamW moments 1e-4 relative per leaf (as
tests/test_torch_train_lm.py holds zamba2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import models as jax_models  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.data import lm_batches  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import to_torch, train_state_to_torch  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

DENSE = ("tinyllama-1.1b", "qwen2-7b", "qwen2.5-14b", "minitron-8b")
PARITY = ("tinyllama-1.1b", "qwen2-7b")
jax_init = jax.jit(jax_models.init_params, static_argnums=(1,))
jax_forward = jax.jit(jax_models.forward, static_argnums=(2,))
jax_prefill = jax.jit(jax_models.prefill, static_argnums=(2, 3))
jax_step = jax.jit(jax_models.decode_step, static_argnums=(4,))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module", params=PARITY)
def lm(request):
    jcfg = jax_get_smoke_config(request.param)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:   # JAX inits the biases at 0: give them a value
        keys = jax.random.split(jax.random.PRNGKey(7), 3)
        attn = dict(jp["blocks"]["attn"])
        for k, name in zip(keys, ("bq", "bk", "bv")):
            attn[name] = jax.random.normal(k, attn[name].shape) * 0.1
        jp = dict(jp, blocks=dict(jp["blocks"], attn=attn))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_smoke_config(request.param), tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_param_counts_match_jax(arch):
    """Field for field, SMOKE included; `param_count` from the meta device
    at full width equals JAX's `eval_shape` count, with no storage."""
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_get_smoke_config(arch))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.family == "dense" and ours.num_experts == 0
        assert models.param_count(ours) == jax_models.param_count(theirs)
        assert models.active_param_count(ours) == \
            jax_models.active_param_count(theirs) == models.param_count(ours)
    shapes = models.params_shape(get_config(arch))
    leaf = shapes["blocks"]["mlp"]["w_up"]
    assert leaf.device.type == "meta" and leaf.dtype == torch.bfloat16


def test_zamba2_and_dit_param_counts_match_jax():
    for arch in ("zamba2-2.7b", "dit-xl"):
        assert models.param_count(get_config(arch)) == \
            jax_models.param_count(jax_get_config(arch))


def test_forward_logits_match_jax(lm):
    jcfg, jp, cfg, tp = lm
    toks = _tokens(cfg, 2, 40, seed=2)
    ref, _ = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    out = models.forward(tp, _t(toks), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_prefill_cache_and_decode_match_jax(lm):
    """Every prefill cache leaf (k, v, pos) within 1e-5, then 6 decode
    steps' logits within 1e-4 feeding JAX's argmax to both, with a rolling
    cache of 32 under a 40-token prompt (the slots wrap)."""
    jcfg, jp, cfg, tp = lm
    toks = _tokens(cfg, 2, 40, seed=3)
    for cache_len in (64, 32):
        jl, _, jc = jax_prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                cache_len)
        tl, tc = models.prefill(tp, _t(toks), cfg, cache_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        assert set(tc) == set(jc) == {"k", "v", "pos"}
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape, key
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=1e-5, err_msg=key)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))
        pos = np.full((2,), 40)
        for _ in range(6):
            jl, jc = jax_step(jp, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32), jc, jcfg)
            tl, tc = models.decode_step(tp, _t(tok), _t(pos), tc, cfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
            tok, pos = np.asarray(jnp.argmax(jl, -1)), pos + 1
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_serving_engine_greedy_matches_jax(lm):
    """6 mixed-length prompts (one longer than max_prompt) over 4 slots:
    identical tokens; CPU tensors take the plain versions, no kernel."""
    jcfg, jp, cfg, tp = lm
    before = flash_attention.launches
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (3, 17, 9, 30, 1, 12)]
    ref = JaxServingEngine(jp, jcfg, slots=4, cache_len=64,
                           max_prompt=24).generate(prompts, max_new_tokens=10)
    out = ServingEngine(tp, cfg, slots=4, cache_len=64, max_prompt=24,
                        device="cpu").generate(prompts, max_new_tokens=10)
    for a, b in zip(out, ref):
        assert a.prompt == b.prompt
        assert a.tokens == b.tokens and len(a.tokens) == 10
    assert flash_attention.launches == before


@pytest.fixture(scope="module")
def trained():
    """JAX's loss, gradient and 3 steps on tinyllama SMOKE."""
    cfg = jax_get_smoke_config("tinyllama-1.1b")
    state = jax_steps.init_train_state(jax.random.PRNGKey(0), cfg)
    it = lm_batches(0, 8, 16, cfg.vocab_size)
    batches = [next(it) for _ in range(3)]
    t, y = batches[0]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jnp.asarray(t), jnp.asarray(y), cfg),
        has_aux=True))(state.params)
    step = jax.jit(jax_steps.make_lm_train_step(cfg, warmup=0,
                                                total_steps=10))
    s, hist = state, []
    for t_, y_ in batches:
        s, m = step(s, {"tokens": jnp.asarray(t_), "targets": jnp.asarray(y_)})
        hist.append({k: float(v) for k, v in m.items()})
    return {"cfg": get_smoke_config("tinyllama-1.1b"), "state": state,
            "batches": batches, "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "after": s, "hist": hist}


def _assert_tree_close(port, ref, rtol, what):
    got = tree_paths(port)
    want = tree_paths(jax.tree_util.tree_map(np.asarray, ref))
    assert [k for k, _ in got] == [k for k, _ in want]
    bad = {k: r for (k, g), (_, w) in zip(got, want)
           if not (r := _rel(g.float().numpy(), np.asarray(w, np.float32)))
           <= rtol}
    assert not bad, (what, bad)


def _batch(trained, i):
    t, y = trained["batches"][i]
    return {"tokens": torch.from_numpy(t), "targets": torch.from_numpy(y)}


def test_lm_loss_and_gradient_match_jax(trained):
    """The load-balance and router-z terms are 0, as JAX's are for dense."""
    params = to_torch(jax.tree_util.tree_map(np.asarray,
                                             trained["state"].params), "cpu")
    b = _batch(trained, 0)

    def loss_fn(p, _):
        return steps.lm_loss(p, b["tokens"], b["targets"], trained["cfg"])

    grads, metrics = steps._value_and_grad(loss_fn, params, None)
    assert set(metrics) == set(trained["metrics"])
    assert abs(float(metrics["loss"]) - trained["loss"]) \
        <= 1e-5 * trained["loss"]
    assert float(metrics["lb_loss"]) == float(metrics["z_loss"]) == 0.0
    assert trained["metrics"]["lb_loss"] == trained["metrics"]["z_loss"] == 0
    _assert_tree_close(grads, trained["grads"], 1e-4, "gradient")


def test_lm_train_steps_match_jax(trained):
    state = train_state_to_torch(trained["state"].params,
                                 trained["state"].opt, "cpu")
    step = steps.make_lm_train_step(trained["cfg"], warmup=0, total_steps=10)
    for i, want in enumerate(trained["hist"]):
        state, m = step(state, _batch(trained, i))
        for k, v in want.items():
            assert abs(float(m[k]) - v) <= 1e-4 * max(abs(v), 1e-6), k
    _assert_tree_close(state.params, trained["after"].params, 1e-4, "params")
    _assert_tree_close(state.opt.mu, trained["after"].opt.mu, 1e-4, "mu")
    _assert_tree_close(state.opt.nu, trained["after"].opt.nu, 1e-4, "nu")


def test_launchers_default_to_tinyllama(capsys):
    """Both launchers default to JAX's tinyllama-1.1b; with --smoke and
    --device cpu they run it on the CPU."""
    serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--cache-len", "64"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    state, hist = train.main(["--smoke", "--steps", "2", "--batch", "2",
                              "--seq", "16", "--device", "cpu"])
    assert "tinyllama-1.1b-smoke (dense)" in capsys.readouterr().out
    assert hist and np.isfinite(hist[-1]["loss"]) and int(state.opt.step) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--smoke", "--steps", "1"])


def test_the_families_still_missing_raise():
    """No LM family is missing any more (moe: tests/test_torch_moe.py); a
    dense config relabelled moe has no experts to route to and raises."""
    cfg = dataclasses.replace(get_smoke_config("tinyllama-1.1b"),
                              family="moe")
    with pytest.raises(ValueError, match="experts"):
        models.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_stacked_layers_enter_autograd_once(arch):
    """Under grad every stacked layer leaf reaches the forward through one
    unbind, not a select per layer (each select gives autograd a
    zero-filled full-size gradient per layer: L times the leaf's bytes a
    step at full width)."""
    cfg = get_smoke_config(arch)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    blocks = [t.requires_grad_() for t in tree_leaves(params["blocks"])]
    out = models.forward(params, torch.zeros((1, 8), dtype=torch.long), cfg)
    seen, todo, into = set(), [out.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if getattr(nxt, "variable", None) is not None and any(
                    nxt.variable is b for b in blocks):
                into.append(type(fn).__name__)
            todo.append(nxt)
    assert sorted(into) == ["UnbindBackward0"] * len(blocks)
