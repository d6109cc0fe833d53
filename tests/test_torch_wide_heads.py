"""Training above head dim 128 against the JAX package, on the CPU.

The flash backward's plain version with a v head dim Dv <= D
(`attention_bwd_ref`, which the card's wide backward kernels are held
against) against `jax.vjp` of `blocked_attention`, and the two models of
the repository whose attention heads are wider than 128, at SMOKE size
with their published head dims put back: pixtral-12b (4 heads over 2 of
160, with patch embeddings) and deepseek-v2's MLA (q/k 128 nope + 64 rope
over v 128).  Params are JAX's, bridged; inputs are numpy draws from a
seed.  f32 throughout.  Tolerances, f32 sums in another order: the
attention gradients 1e-5 abs; `lm_loss` 1e-5 relative and every leaf's
gradient 1e-4 relative; one train step's metrics, params and AdamW moments
1e-4 relative per leaf (those of tests/test_torch_vlm.py and
tests/test_torch_moe.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import models as jax_models  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.data import lm_batches, patch_embeddings  # noqa: E402
from repro.models.layers import blocked_attention  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch.bridge import to_torch, train_state_to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref,
    flash_attention_backward)
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

#: SMOKE with the published head dims put back
WIDE = {"pixtral-12b": dict(head_dim=160),
        "deepseek-v2-236b": dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                                 v_head_dim=128)}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_tree_close(port, ref, rtol, what):
    have, want = tree_paths(port), tree_paths(_np(ref))
    assert [k for k, _ in have] == [k for k, _ in want]
    bad = {k: r for (k, g), (_, w) in zip(have, want)
           if not (r := _rel(g.float().numpy(), np.asarray(w, np.float32)))
           <= rtol}
    assert not bad, (what, bad)


def _configs(arch):
    return (dataclasses.replace(jax_get_smoke_config(arch), **WIDE[arch]),
            dataclasses.replace(get_smoke_config(arch), **WIDE[arch]))


# ----------------------------------------------------------------------
# attention_bwd_ref at the wide head dims against jax.vjp
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,Dv,causal", [
    (1, 40, 40, 8, 2, 160, 160, True),     # pixtral's head, GQA group 4
    (2, 32, 32, 4, 4, 192, 128, True),     # deepseek-v2's MLA, causal
    (1, 32, 32, 4, 4, 192, 128, False),    # ... and not
    (1, 77, 77, 4, 1, 192, 128, True),     # a ragged S, GQA group 4
])
def test_attention_bwd_ref_matches_jax_vjp(B, Sq, Sk, H, KH, D, Dv, causal):
    """dq, dk (over D) and dv (over Dv) of the plain backward, from the
    forward's o and row log-sum-exp, against `jax.vjp` of
    `blocked_attention`: 1e-5 abs; the CPU wrapper takes the same path."""
    rng = np.random.default_rng(D + Dv + Sq)
    q, k = (rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KH, D)))
    v = rng.standard_normal((B, Sk, KH, Dv), dtype=np.float32)
    do = rng.standard_normal((B, Sq, H, Dv), dtype=np.float32)
    out, vjp = jax.vjp(lambda a, b, c: blocked_attention(a, b, c,
                                                         causal=causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o = attention_ref(tq, tk, tv, causal=causal)
    assert float((o - _t(out)).abs().max()) <= 1e-5
    lse = attention_lse_ref(tq, tk, causal=causal)
    got = attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    for a, b in zip(got, want):
        assert float((a - _t(b)).abs().max()) <= 1e-5
    wrapped = flash_attention_backward(tq, tk, tv, o, tdo, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def test_flash_attention_backward_refuses_a_wider_v():
    q = torch.zeros((1, 8, 2, 64))
    v = torch.zeros((1, 8, 2, 96))
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_backward(q, q, v, v.expand(1, 8, 2, 96), v,
                                 torch.zeros((1, 2, 8)))


# ----------------------------------------------------------------------
# the wide-head pixtral and deepseek-v2 SMOKE against JAX
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pixtral():
    jcfg, cfg = _configs("pixtral-12b")
    assert cfg.head_dim == 160
    jstate = jax_steps.init_train_state(jax.random.PRNGKey(0), jcfg)
    ve = patch_embeddings(0, 2, cfg.num_vision_tokens, cfg.vision_dim)
    t, y = next(lm_batches(0, 2, 24, cfg.vocab_size))
    return jcfg, cfg, jstate, ve, t, y


def test_pixtral_wide_lm_loss_and_gradient_match_jax(pixtral):
    jcfg, cfg, jstate, ve, t, y = pixtral
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jnp.asarray(t), jnp.asarray(y), jcfg,
                                    vision_embeds=jnp.asarray(ve)),
        has_aux=True))(jstate.params)
    got, metrics = steps._value_and_grad(
        lambda p, _: steps.lm_loss(p, _t(t), _t(y), cfg,
                                   vision_embeds=_t(ve)),
        to_torch(_np(jstate.params), device="cpu"), None)
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-5 * float(loss)
    _assert_tree_close(got, grads, 1e-4, "gradient")


def test_pixtral_wide_train_step_matches_jax(pixtral):
    """One `make_lm_train_step` step with "vision_embeds" at head dim 160:
    metrics, params and AdamW moments 1e-4 relative against JAX's."""
    jcfg, cfg, jstate, ve, t, y = pixtral
    jstep = jax.jit(jax_steps.make_lm_train_step(jcfg, warmup=0,
                                                 total_steps=10))
    js, jm = jstep(jstate, {"tokens": jnp.asarray(t),
                            "targets": jnp.asarray(y),
                            "vision_embeds": jnp.asarray(ve)})
    state = train_state_to_torch(jstate.params, jstate.opt, "cpu")
    step = steps.make_lm_train_step(cfg, warmup=0, total_steps=10)
    state, m = step(state, {"tokens": _t(t), "targets": _t(y),
                            "vision_embeds": _t(ve)})
    for k, v in jm.items():
        assert abs(float(m[k]) - float(v)) <= 1e-4 * max(abs(float(v)),
                                                         1e-6), k
    _assert_tree_close(state.params, js.params, 1e-4, "params")
    _assert_tree_close(state.opt.mu, js.opt.mu, 1e-4, "mu")
    _assert_tree_close(state.opt.nu, js.opt.nu, 1e-4, "nu")


def test_deepseek_v2_wide_mla_lm_loss_and_gradient_match_jax():
    """q/k 192 over v 128: the loss with its load-balance and router-z
    terms 1e-5 relative, every leaf's gradient 1e-4 relative (w_kr's
    through the rope key broadcast over the heads, summed back)."""
    jcfg, cfg = _configs("deepseek-v2-236b")
    assert (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim) \
        == (192, 128)
    jp = jax_models.init_params(jax.random.PRNGKey(0), jcfg)
    t, y = next(lm_batches(0, 2, 24, cfg.vocab_size))
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jnp.asarray(t), jnp.asarray(y), jcfg),
        has_aux=True))(jp)
    got, m = steps._value_and_grad(
        lambda p, _: steps.lm_loss(p, _t(t), _t(y), cfg),
        to_torch(_np(jp), device="cpu"), None)
    for k, v in metrics.items():
        assert abs(float(m[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    assert float(metrics["lb_loss"]) > 0
    _assert_tree_close(got, grads, 1e-4, "gradient")
