"""The port's ssm family (falcon-mamba-7b, Mamba1) against the JAX package,
on the CPU.

falcon-mamba-7b SMOKE (2 layers, d 128, d_inner 256, state 16, dt rank 8,
f32) with the JAX params bridged into torch.  `linear_scan_chunked` is
plain PyTorch on every device (JAX has no Pallas kernel for it either); its
within-chunk doubling scan sums in another order than
`lax.associative_scan`.  Tolerances: the scan 1e-5 abs, a Mamba1 block and
the model's logits 1e-4 abs, prefill cache leaves 1e-5 abs; the chunk
invariance at JAX's own 2e-4 relative + 2e-5 abs; greedy tokens and
parameter counts exactly; `lm_loss` 1e-5 relative and its gradient 1e-4
relative per leaf (as tests/test_torch_train_lm.py holds zamba2).
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
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCH = "falcon-mamba-7b"
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


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, get_smoke_config(ARCH), to_torch(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def block(lm):
    """One Mamba1 layer's params (JAX and torch) and an input u."""
    jcfg, _, cfg, _ = lm
    jp = jax_ssm.init_mamba1(jax.random.PRNGKey(9), jcfg)
    u = np.random.default_rng(10).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32) * 0.3
    return jp, to_torch(_np(jp), device="cpu"), u


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_configs_and_param_counts_match_jax():
    """Field for field, SMOKE included; full-width `param_count` from the
    meta device equals JAX's `eval_shape` count."""
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.is_ssm_only == theirs.is_ssm_only is True
    full = get_config(ARCH)
    assert models.param_count(full) == jax_models.param_count(
        jax_get_config(ARCH))
    leaf = models.params_shape(full)["blocks"]["mamba"]["A_log"]
    assert leaf.device.type == "meta" and tuple(leaf.shape) == (64, 8192, 16)


def test_init_params_matches_jax_tree():
    ours = models.init_params(torch.Generator().manual_seed(0),
                              get_smoke_config(ARCH), device="cpu")
    theirs = jax.eval_shape(lambda: jax_models.init_params(
        jax.random.PRNGKey(0), jax_get_smoke_config(ARCH)))
    got = [(k, tuple(v.shape)) for k, v in tree_paths(ours)]
    want = [(k, tuple(v.shape)) for k, v in tree_paths(_np_shapes(theirs))]
    assert got == want
    A_log = ours["blocks"]["mamba"]["A_log"]
    assert torch.equal(A_log[0, 3], torch.log(torch.arange(1.0, 17.0)))


def _np_shapes(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  tree)


@pytest.mark.parametrize("S,chunk", [(48, 16), (48, 48), (40, 8), (7, 7)])
def test_linear_scan_chunked_matches_jax(S, chunk):
    """The doubling scan and the chunk carry against `lax.associative_scan`
    + `lax.scan`: h_all and h_final within 1e-5 abs, from a nonzero h0."""
    rng = np.random.default_rng(S + chunk)
    a = rng.uniform(0.5, 1.0, (2, S, 6, 4)).astype(np.float32)
    u = rng.standard_normal((2, S, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    ref_all, ref_fin = jax_ssm.linear_scan_chunked(
        jnp.asarray(a), jnp.asarray(u), jnp.asarray(h0), chunk)
    h_all, h_fin = ssm.linear_scan_chunked(_t(a), _t(u), _t(h0), chunk)
    np.testing.assert_allclose(h_all.numpy(), np.asarray(ref_all), atol=1e-5)
    np.testing.assert_allclose(h_fin.numpy(), np.asarray(ref_fin), atol=1e-5)


def test_mamba1_forward_and_decode_match_jax(lm, block):
    """The block's output and cache at chunk 16 (three chunks), then 6
    decode steps from that cache: 1e-4 abs (y), 1e-5 abs (state, conv)."""
    jcfg, _, cfg, _ = lm
    jp, tp, u = block
    jy, jc = jax_ssm.mamba1_forward(jp, jnp.asarray(u), jcfg, chunk=16)
    y, c = ssm.mamba1_forward(tp, _t(u), cfg, chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    for key in ("state", "conv"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, err_msg=key)
    jconv, jh, conv, h = jc["conv"], jc["state"], c["conv"], c["state"]
    rng = np.random.default_rng(11)
    for _ in range(6):
        ut = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jconv, jh = jax_ssm.mamba1_decode(jp, jnp.asarray(ut), jcfg,
                                              jconv, jh)
        y, conv, h = ssm.mamba1_decode(tp, _t(ut), cfg, conv, h)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)


def test_chunk_size_does_not_change_the_block(lm, block):
    """JAX's own invariance test, on the port: chunk 4 against chunk 16 at
    S 16, 2e-4 relative + 2e-5 abs."""
    _, _, cfg, _ = lm
    _, tp, u = block
    u = _t(u[:, :16])
    y4, c4 = ssm.mamba1_forward(tp, u, cfg, chunk=4)
    y16, c16 = ssm.mamba1_forward(tp, u, cfg, chunk=16)
    np.testing.assert_allclose(y4.numpy(), y16.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(c4["state"].numpy(), c16["state"].numpy(),
                               rtol=2e-4, atol=2e-5)


def test_forward_logits_match_jax(lm):
    """S 128: two 64-token chunks, the path's chunk size."""
    jcfg, jp, cfg, tp = lm
    toks = _tokens(cfg, 2, 128, seed=2)
    ref, _ = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    out = models.forward(tp, _t(toks), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_prefill_cache_and_decode_match_jax(lm):
    """The prefill cache (state, conv) within 1e-5, then 8 decode steps'
    logits within 1e-4, feeding JAX's argmax to both."""
    jcfg, jp, cfg, tp = lm
    toks = _tokens(cfg, 2, 40, seed=3)
    jl, _, jc = jax_prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, 64)
    tl, tc = models.prefill(tp, _t(toks), cfg, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert set(tc) == set(jc) == {"state", "conv"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].dtype == torch.float32
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, err_msg=key)
    tok, pos = np.asarray(jnp.argmax(jl[:, -1], -1)), np.full((2,), 40)
    for _ in range(8):
        jl, jc = jax_step(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc, jcfg)
        tl, tc = models.decode_step(tp, _t(tok), _t(pos), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok, pos = np.asarray(jnp.argmax(jl, -1)), pos + 1


def test_serving_engine_greedy_matches_jax(lm):
    """6 mixed-length prompts (one longer than max_prompt) over 4 slots:
    identical tokens; no kernel runs (attention-free, Mamba1 scan plain)."""
    jcfg, jp, cfg, tp = lm
    before = (ssd_scan.launches, flash_attention.launches)
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
    assert (ssd_scan.launches, flash_attention.launches) == before


def test_lm_loss_and_gradient_match_jax(lm):
    """Through the plain scan under autograd: the loss 1e-5 relative, every
    leaf's gradient 1e-4 relative."""
    jcfg, jp, cfg, tp = lm
    t, y = next(lm_batches(0, 4, 40, cfg.vocab_size))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jnp.asarray(t), jnp.asarray(y), jcfg),
        has_aux=True))(jp)
    got, metrics = steps._value_and_grad(
        lambda p, _: steps.lm_loss(p, _t(t), _t(y), cfg), tp, None)
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-5 * float(loss)
    assert float(metrics["lb_loss"]) == float(metrics["z_loss"]) == 0.0
    want = tree_paths(_np(grads))
    have = tree_paths(got)
    assert [k for k, _ in have] == [k for k, _ in want]
    bad = {k: r for (k, g), (_, w) in zip(have, want)
           if not (r := _rel(g.numpy(), w)) <= 1e-4}
    assert not bad, bad


def test_launchers_serve_and_train_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "4", "--cache-len", "64"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    state, hist = train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device",
                              "cpu"])
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    assert int(state.opt.step) == 2


def test_launcher_tokens_match_jax_launcher(lm):
    """The serve launcher's traffic (seed 0, max_prompt 32) gives JAX's
    launcher's greedy tokens on the same weights."""
    jcfg, jp, cfg, tp = lm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=rng.integers(4, 16))
               .tolist() for _ in range(3)]
    ref = JaxServingEngine(jp, jcfg, slots=4, cache_len=64,
                           max_prompt=32).generate(prompts, max_new_tokens=6)
    out = ServingEngine(tp, cfg, slots=4, cache_len=64, max_prompt=32,
                        device="cpu").generate(prompts, max_new_tokens=6)
    assert [r.tokens for r in out] == [r.tokens for r in ref]


def test_mamba2_only_ssm_matches_jax():
    """An ssm config with Mamba2 layers (`mamba_version` 2, no shared
    attention; no published config uses it, JAX serves it): forward,
    prefill and 4 decode steps' logits 1e-4 abs, cache leaves 1e-5."""
    base = dict(family="ssm", hybrid_attn_every=0, name="mamba2-ssm-smoke")
    jcfg = dataclasses.replace(jax_get_smoke_config("zamba2-2.7b"), **base)
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), **base)
    jp = jax_init(jax.random.PRNGKey(4), jcfg)
    tp = to_torch(_np(jp), device="cpu")
    assert set(tp) == {"embed", "blocks", "final_norm", "lm_head"}
    toks = _tokens(cfg, 2, 40, seed=7)
    ref, _ = jax_forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    np.testing.assert_allclose(models.forward(tp, _t(toks), cfg).numpy(),
                               np.asarray(ref), atol=1e-4)
    jl, _, jc = jax_prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, 64)
    tl, tc = models.prefill(tp, _t(toks), cfg, 64)
    assert set(tc) == set(jc) == {"state", "conv"}
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, err_msg=key)
    tok, pos = np.asarray(jnp.argmax(jl[:, -1], -1)), np.full((2,), 40)
    for _ in range(4):
        jl, jc = jax_step(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc, jcfg)
        tl, tc = models.decode_step(tp, _t(tok), _t(pos), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok, pos = np.asarray(jnp.argmax(jl, -1)), pos + 1
