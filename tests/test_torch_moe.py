"""The port's moe family against the JAX package, on the CPU.

arctic-480b SMOKE (2 layers, d 128, 4 heads over 2 KV heads, 4 experts
top-2, a dense residual FFN of 128) and deepseek-v2-236b SMOKE (MLA
attention, 4 experts top-2, one shared expert), f32, with the JAX params
bridged into torch; the flash wrapper runs its plain version on CPU
tensors.  The MoE's dispatch copies tokens into queue slots where JAX
contracts one-hot tensors: the same function.  Tolerances, f32 sums in
another order: moe_forward's output 1e-5 abs and its losses 1e-5
relative; routing (top-k experts, queue positions, the keep mask)
identical, each token's k-th and (k+1)-th probabilities first checked
>= 1e-4 relative apart; bf16 params 5e-2 of the largest output; logits
1e-4 abs, prefill cache leaves 1e-5 abs; greedy tokens and parameter
counts exactly; `lm_loss` 1e-5 relative, its gradient 1e-4 relative per
leaf, one train step's params and AdamW moments 1e-4 relative per leaf.
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
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.optim import (adamw_init, adamw_update,  # noqa: E402
                         clip_by_global_norm, cosine_warmup_schedule)
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import to_torch, train_state_to_torch  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCHS = ("arctic-480b", "deepseek-v2-236b")
COUNTS = {"arctic-480b": (478_584_357_888, 17_318_396_928),
          "deepseek-v2-236b": (244_188_410_880, 26_189_460_480)}
MARGIN = 1e-4
jax_init = jax.jit(jax_models.init_params, static_argnums=(1, 2))
jax_forward = jax.jit(jax_models.forward, static_argnums=(2,))
jax_prefill = jax.jit(jax_models.prefill, static_argnums=(2, 3))
jax_step = jax.jit(jax_models.decode_step, static_argnums=(4,))
jax_moe_forward = jax.jit(jax_moe.moe_forward, static_argnums=(2,))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg = jax_get_smoke_config(request.param)
    jp = jax_init(jax.random.PRNGKey(0), jcfg, None)
    return jcfg, jp, get_smoke_config(request.param), to_torch(_np(jp), "cpu")


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _jax_routing(logits, k, E, cap):
    """JAX's routing of f32 logits: (probs, top-k idx, positions, keep)."""
    probs, _, idx = jax_moe._route(jnp.asarray(logits), k)
    pos, _ = jax_moe._queue_positions(idx, E)
    return (np.asarray(probs), np.asarray(idx), np.asarray(pos),
            np.asarray(pos) < cap)


def _check_margin(probs, k):
    """Every token's k-th and (k+1)-th probabilities >= MARGIN relative
    apart, so that top-k's choice does not hang on the sum order."""
    top = -np.sort(-probs, axis=-1)
    gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
    assert gap.min() >= MARGIN, gap.min()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_jax(arch):
    """Field for field, SMOKE included; `param_count` and
    `active_param_count` equal JAX's at SMOKE and, from the meta device at
    full width, JAX's counts (COUNTS, from `repro.models.param_count`); the
    router stays f32 in a bf16 model."""
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_get_smoke_config(arch))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.family == "moe" and ours.is_moe
    smoke = get_smoke_config(arch)
    assert models.param_count(smoke) == \
        jax_models.param_count(jax_get_smoke_config(arch))
    assert models.active_param_count(smoke) == \
        jax_models.active_param_count(jax_get_smoke_config(arch))
    assert (models.param_count(get_config(arch)),
            models.active_param_count(get_config(arch))) == COUNTS[arch]
    blocks = models.params_shape(get_config(arch))["blocks"]
    assert blocks["moe"]["router"].dtype == torch.float32
    assert blocks["moe"]["w_up"].dtype == torch.bfloat16
    assert blocks["moe"]["w_up"].device.type == "meta"


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_forward_and_routing_match_jax(lm, capacity_factor):
    """Each layer's MoE on a (2, 40, d) input: output, losses, routing;
    at capacity factor 0.5 tokens drop (SMOKE's 8.0 drops none) and the
    port counts JAX's drops."""
    jcfg, jp, cfg, tp = lm
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    x = np.random.default_rng(1).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    for layer in range(cfg.num_layers):
        jpl = jax.tree_util.tree_map(lambda a: a[layer],
                                     jp["blocks"]["moe"])
        tpl = to_torch(_np(jpl), "cpu")
        ref, ref_aux = jax_moe_forward(jpl, jnp.asarray(x), jcfg)
        out, aux = moe.moe_forward(tpl, _t(x), cfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        for key in ref_aux:
            assert _rel(aux[key].numpy(), ref_aux[key]) <= 1e-5, key

        logits = x.reshape(-1, cfg.d_model) @ np.asarray(jpl["router"])
        cap = moe.capacity(cfg, 80)
        probs, idx, pos, keep = _jax_routing(logits, cfg.experts_per_token,
                                             cfg.num_experts, cap)
        _check_margin(probs, cfg.experts_per_token)
        _, _, t_idx, t_pos, t_keep = moe.route(
            _t(logits), cfg.experts_per_token, cap)
        np.testing.assert_array_equal(t_idx.numpy(), idx)
        np.testing.assert_array_equal(t_pos.numpy(), pos)
        np.testing.assert_array_equal(t_keep.numpy(), keep)
        assert int(aux["dropped"]) == int((~keep).sum())
        if capacity_factor is None:
            assert int(aux["dropped"]) == 0
        else:
            assert int(aux["dropped"]) > 0


def test_moe_bf16_params_match_jax(lm):
    """bf16 params (the router leaf f32, as JAX's bf16 init keeps it;
    through the bridge and in the port's own init) on bf16 activations:
    within 5e-2 of the largest output, and the output is bf16."""
    jcfg, jp, cfg, _ = lm
    jpl = {k: v if k == "router" else jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), v)
        for k, v in _layer0(jp["blocks"]["moe"]).items()}
    tpl = to_torch(_np(jpl), "cpu")
    assert tpl["router"].dtype == torch.float32
    assert tpl["w_gate"].dtype == torch.bfloat16
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)), jnp.bfloat16)
    ref, ref_aux = jax_moe_forward(jpl, x, jcfg)
    out, aux = moe.moe_forward(tpl, _t(np.asarray(x.astype(jnp.float32)))
                               .bfloat16(), cfg)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) <= 5e-2
    for key in ref_aux:
        assert _rel(aux[key].numpy(), ref_aux[key]) <= 5e-2, key
    own = models.init_params(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.bfloat16, device="cpu")
    assert own["blocks"]["moe"]["router"].dtype == torch.float32
    assert own["blocks"]["moe"]["w_down"].dtype == torch.bfloat16


def test_expert_parallel_raises_and_experts_draw_in_place():
    """`ep=` dispatches to `moe_forward_ep`, which refuses a plain x (it
    runs on DTensors: tests/test_torch_distributed.py); the stacked experts
    are drawn in blocks straight into their (L, E, in, out) storage, N(0,
    1/fan_in), no two matrices alike."""
    cfg = get_smoke_config("arctic-480b")
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    with pytest.raises(TypeError, match="DTensor"):
        moe.moe_forward({}, torch.zeros((1, 2, cfg.d_model)), cfg,
                        ep={"mesh": None})
    w = params["blocks"]["moe"]["w_gate"]
    assert tuple(w.shape) == (cfg.num_layers, cfg.num_experts, cfg.d_model,
                              cfg.d_ff)
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.02
    flat = w.reshape(-1, cfg.d_model * cfg.d_ff)
    assert len({float(r[0]) for r in flat}) == flat.shape[0]


def test_forward_prefill_and_decode_match_jax(lm):
    """forward's logits (1e-4) and summed losses (1e-5 relative); every
    prefill cache leaf (k / v / pos or ckv / kr / pos) within 1e-5, then
    6 decode steps' logits within 1e-4 feeding JAX's argmax to both, with a
    rolling cache of 32 under a 40-token prompt (the slots wrap)."""
    jcfg, jp, cfg, tp = lm
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    ref, ref_aux = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    out, aux = models.forward(tp, _t(toks), cfg, with_aux=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    for key in ref_aux:
        assert _rel(aux[key].numpy(), ref_aux[key]) <= 1e-5, key
    assert int(aux["dropped"]) == 0
    leaves = {"ckv", "kr", "pos"} if cfg.use_mla else {"k", "v", "pos"}
    for cache_len in (64, 32):
        jl, _, jc = jax_prefill(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                cache_len)
        tl, tc = models.prefill(tp, _t(toks), cfg, cache_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        assert set(tc) == set(jc) == leaves
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
        for key in jc:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=1e-5, err_msg=key)


def test_serving_engine_greedy_matches_jax(lm):
    """6 mixed-length prompts (one longer than max_prompt) over 4 slots,
    the padding and the empty slots' rows routed through the MoE as in
    JAX: identical tokens."""
    jcfg, jp, cfg, tp = lm
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (3, 17, 9, 30, 1, 12)]
    ref = JaxServingEngine(jp, jcfg, slots=4, cache_len=64,
                           max_prompt=24).generate(prompts, max_new_tokens=8)
    out = ServingEngine(tp, cfg, slots=4, cache_len=64, max_prompt=24,
                        device="cpu").generate(prompts, max_new_tokens=8)
    for a, b in zip(out, ref):
        assert a.prompt == b.prompt
        assert a.tokens == b.tokens and len(a.tokens) == 8


@pytest.fixture(scope="module")
def trained(lm):
    """JAX's loss (with the MoE losses), gradient and one train step: its
    `make_lm_train_step` (accum 1) applied to that gradient, compiled
    apart from it (the same clip, schedule and AdamW update)."""
    cfg, params, _, _ = lm
    state = jax_steps.TrainState(params=params, opt=adamw_init(params))
    t, y = next(lm_batches(0, 4, 16, cfg.vocab_size))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jnp.asarray(t), jnp.asarray(y), cfg),
        has_aux=True))(state.params)

    def update(grads, state):
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_warmup_schedule(state.opt.step, peak_lr=3e-4,
                                    warmup_steps=0, total_steps=10)
        params, opt = adamw_update(grads, state.opt, state.params, lr=lr,
                                   weight_decay=0.1)
        return jax_steps.TrainState(params, opt), {"grad_norm": gnorm,
                                                   "lr": lr}

    after, m = jax.jit(update)(grads, state)
    m = dict(metrics, **m)
    return {"cfg": lm[2], "state": state,
            "batch": {"tokens": _t(t), "targets": _t(y)},
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "after": after,
            "step_metrics": {k: float(v) for k, v in m.items()}}


def _assert_tree_close(port, ref, rtol, what):
    got, want = tree_paths(port), tree_paths(_np(ref))
    assert [k for k, _ in got] == [k for k, _ in want]
    bad = {k: r for (k, g), (_, w) in zip(got, want)
           if not (r := _rel(g.float().numpy(), np.asarray(w, np.float32)))
           <= rtol}
    assert not bad, (what, bad)


def test_lm_loss_and_gradient_match_jax(trained):
    """The loss, the load-balance and router-z terms 1e-5 relative; every
    leaf's gradient 1e-4 relative (the router's through the gates and the
    probabilities)."""
    params = to_torch(_np(trained["state"].params), "cpu")
    b = trained["batch"]
    grads, metrics = steps._value_and_grad(
        lambda p, _: steps.lm_loss(p, b["tokens"], b["targets"],
                                   trained["cfg"]), params, None)
    assert set(metrics) == set(trained["metrics"])
    for k, v in trained["metrics"].items():
        assert abs(float(metrics[k]) - v) <= 1e-5 * abs(v), k
    assert trained["metrics"]["lb_loss"] > 0
    _assert_tree_close(grads, trained["grads"], 1e-4, "gradient")


def test_lm_train_step_matches_jax(trained):
    state = train_state_to_torch(trained["state"].params,
                                 trained["state"].opt, "cpu")
    step = steps.make_lm_train_step(trained["cfg"], warmup=0, total_steps=10)
    state, m = step(state, trained["batch"])
    for k, v in trained["step_metrics"].items():
        assert abs(float(m[k]) - v) <= 1e-4 * max(abs(v), 1e-6), k
    _assert_tree_close(state.params, trained["after"].params, 1e-4, "params")
    _assert_tree_close(state.opt.mu, trained["after"].opt.mu, 1e-4, "mu")
    _assert_tree_close(state.opt.nu, trained["after"].opt.nu, 1e-4, "nu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_moe_family_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "4", "--cache-len", "64"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    state, hist = train.main(["--arch", arch, "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device",
                              "cpu"])
    assert f"{arch}-smoke (moe)" in capsys.readouterr().out
    assert hist and np.isfinite(hist[-1]["loss"]) and int(state.opt.step) == 2
