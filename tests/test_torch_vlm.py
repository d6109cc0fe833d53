"""The port's vlm family (pixtral-12b) against the JAX package, on the CPU.

pixtral-12b SMOKE (2 layers, d 128, 4 heads over 2 KV heads of 32, 16
vision tokens of width 64, f32) with the JAX params bridged into torch;
the flash wrapper runs its plain version on CPU tensors.  The stub patch
embeddings are `patch_embeddings`', prepended to the text through
`vision_proj`.  Tolerances, f32 sums in another order: logits 1e-4 abs,
prefill cache leaves 1e-5 abs; `lm_loss` 1e-5 relative and its gradient
1e-4 relative per leaf; one AdamW step's params and moments 1e-4 relative
per leaf (as tests/test_torch_train_lm.py holds zamba2).
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
from repro.data import lm_batches, patch_embeddings  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import to_torch, train_state_to_torch  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import patch_embeddings as port_patches  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402

ARCH = "pixtral-12b"
B, S = 2, 24
jax_init = jax.jit(jax_models.init_params, static_argnums=(1,))
jax_forward = jax.jit(jax_models.forward, static_argnums=(2,))
jax_prefill = jax.jit(jax_models.prefill, static_argnums=(2, 3))
jax_step = jax.jit(jax_models.decode_step, static_argnums=(4,))


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


@pytest.fixture(scope="module")
def vlm():
    jcfg = jax_get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    ve = patch_embeddings(0, B, cfg.num_vision_tokens, cfg.vision_dim)
    t, y = next(lm_batches(0, B, S, cfg.vocab_size))
    return jcfg, jp, cfg, to_torch(_np(jp), device="cpu"), ve, t, y


def test_configs_param_counts_and_tree_match_jax():
    """Field for field, SMOKE included (head dim 160 at full width, 32 in
    SMOKE); full-width `param_count` equals JAX's; the port's own init
    draws JAX's tree, `vision_proj` included; the stub patches are JAX's."""
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert get_config(ARCH).head_dim == 160
    assert models.param_count(get_config(ARCH)) == jax_models.param_count(
        jax_get_config(ARCH))
    ours = models.init_params(torch.Generator().manual_seed(0),
                              get_smoke_config(ARCH), device="cpu")
    theirs = jax.eval_shape(lambda: jax_models.init_params(
        jax.random.PRNGKey(0), jax_get_smoke_config(ARCH)))
    want = [(k, tuple(v.shape)) for k, v in tree_paths(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), theirs))]
    assert [(k, tuple(v.shape)) for k, v in tree_paths(ours)] == want
    assert tuple(ours["vision_proj"].shape) == (64, 128)
    np.testing.assert_array_equal(port_patches(3, 2, 16, 8),
                                  patch_embeddings(3, 2, 16, 8))


def test_forward_logits_match_jax(vlm):
    """Logits over the vision and the text positions, 1e-4 abs; without
    vision_embeds the forward raises."""
    jcfg, jp, cfg, tp, ve, t, _ = vlm
    ref, _ = jax_forward(jp, jnp.asarray(t), jcfg,
                         vision_embeds=jnp.asarray(ve))
    out = models.forward(tp, _t(t), cfg, vision_embeds=_t(ve))
    assert tuple(out.shape) == (B, cfg.num_vision_tokens + S, cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    with pytest.raises(ValueError, match="vision_embeds"):
        models.forward(tp, _t(t), cfg)


def test_prefill_cache_and_decode_match_jax(vlm):
    """Prefill over 16 vision + 24 text positions into a cache of 64, every
    cache leaf within 1e-5, then 6 decode steps from pos 40 within 1e-4;
    a cache of 32 keeps the last 32 positions, vision ones included."""
    jcfg, jp, cfg, tp, ve, t, _ = vlm
    S_all = cfg.num_vision_tokens + S
    for cache_len in (64, 32):
        jl, _, jc = jax_prefill(jp, jnp.asarray(t), jcfg, cache_len,
                                vision_embeds=jnp.asarray(ve))
        tl, tc = models.prefill(tp, _t(t), cfg, cache_len,
                                vision_embeds=_t(ve))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        assert set(tc) == set(jc) == {"k", "v", "pos"}
        for key in jc:
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       atol=1e-5, err_msg=key)
        assert int(tc["pos"].max()) == S_all - 1
        tok, pos = np.asarray(jnp.argmax(jl[:, -1], -1)), np.full((B,), S_all)
        for _ in range(6):
            jl, jc = jax_step(jp, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32), jc, jcfg)
            tl, tc = models.decode_step(tp, _t(tok), _t(pos), tc, cfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
            tok, pos = np.asarray(jnp.argmax(jl, -1)), pos + 1


def test_vision_embeds_take_the_params_dtype(vlm):
    """bf16 params: f32 patch embeddings are cast to bf16 before
    `vision_proj`, so they give the bits of bf16 ones."""
    _, _, cfg, tp, ve, t, _ = vlm
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = tree_map(lambda x: x.to(torch.bfloat16), tp)
    a = models.forward(p16, _t(t), cfg16, vision_embeds=_t(ve))
    b = models.forward(p16, _t(t), cfg16,
                       vision_embeds=_t(ve).to(torch.bfloat16))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_lm_loss_drops_the_vision_positions_and_matches_jax(vlm):
    """The loss counts the text positions only (its value from the
    forward's text logits by hand, 1e-6 relative); loss 1e-5 relative and
    every gradient, `vision_proj`'s included, 1e-4 relative against JAX."""
    jcfg, jp, cfg, tp, ve, t, y = vlm
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jnp.asarray(t), jnp.asarray(y), jcfg,
                                    vision_embeds=jnp.asarray(ve)),
        has_aux=True))(jp)
    got, metrics = steps._value_and_grad(
        lambda p, _: steps.lm_loss(p, _t(t), _t(y), cfg,
                                   vision_embeds=_t(ve)), tp, None)
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-5 * float(loss)
    logits = models.forward(tp, _t(t), cfg, vision_embeds=_t(ve))
    by_hand = torch.nn.functional.cross_entropy(
        logits[:, cfg.num_vision_tokens:].reshape(-1, cfg.vocab_size),
        _t(y).reshape(-1).long())
    assert abs(float(by_hand) - float(metrics["loss"])) <= 1e-6 * float(
        by_hand)
    assert float(got["vision_proj"].abs().max()) > 0
    _assert_tree_close(got, grads, 1e-4, "gradient")


def test_lm_train_step_matches_jax(vlm):
    """One `make_lm_train_step` step on a batch with "vision_embeds":
    metrics, params and AdamW moments 1e-4 relative against JAX's."""
    jcfg, jp, cfg, _, ve, t, y = vlm
    jstate = jax_steps.init_train_state(jax.random.PRNGKey(0), jcfg)
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


def test_entry_points_that_cannot_take_pixtral_say_which_can(vlm):
    """JAX's ServingEngine and launchers fail on pixtral too (no vision
    embeddings); the port's refuse it up front and name the entry point
    that takes them."""
    _, _, cfg, tp, _, _, _ = vlm
    with pytest.raises(ValueError, match="vision_embeds"):
        ServingEngine(tp, cfg, device="cpu")
    with pytest.raises(SystemExit, match="vision_embeds"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="vision_embeds"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
