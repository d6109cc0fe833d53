"""The port's encoder-decoder (whisper-small) against the JAX package, on
the CPU.

whisper-small SMOKE (2 encoder and 2 decoder layers, d 128, 4 heads of 32,
32 stub frames, f32) with the JAX params bridged into torch; the flash
wrapper runs its plain version on CPU tensors.  Frames are the stub
frontend's `frame_embeddings`, tokens `lm_batches`'.  Tolerances, f32 sums
in another order: encoder output, cross K/V, logits 1e-4 abs; the
cross-entropy 1e-5 relative and its gradient 1e-4 relative per leaf;
cached cross K/V against recomputed ones bit for bit (`torch.equal`), the
survey's exact cache.
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
from repro.data import frame_embeddings, lm_batches  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import frame_embeddings as port_frames  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCH = "whisper-small"
B, S_DEC = 2, 12
jax_init = jax.jit(jax_models.init_params, static_argnums=(1,))
jax_encode = jax.jit(jax_encdec.encode, static_argnums=(2,))
jax_cross_kv = jax.jit(jax_encdec.cross_kv, static_argnums=(2,))
jax_fwd = jax.jit(jax_encdec.forward, static_argnums=(3,))
jax_dec = jax.jit(jax_encdec.decode_step, static_argnums=(4,))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def wm():
    jcfg = jax_get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    frames = frame_embeddings(0, B, cfg.encoder_seq, cfg.d_model)
    t, y = next(lm_batches(0, B, S_DEC, cfg.vocab_size))
    return jcfg, jp, cfg, to_torch(_np(jp), device="cpu"), frames, t, y


def test_configs_param_counts_and_tree_match_jax():
    """Field for field, SMOKE included; full-width `param_count` equals
    JAX's; the port's own init draws JAX's tree; the stub frames are
    JAX's, bit for bit."""
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert models.param_count(get_config(ARCH)) == jax_models.param_count(
        jax_get_config(ARCH))
    ours = models.init_params(torch.Generator().manual_seed(0),
                              get_smoke_config(ARCH), device="cpu")
    theirs = jax.eval_shape(lambda: jax_models.init_params(
        jax.random.PRNGKey(0), jax_get_smoke_config(ARCH)))
    want = [(k, tuple(v.shape)) for k, v in tree_paths(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), theirs))]
    assert [(k, tuple(v.shape)) for k, v in tree_paths(ours)] == want
    np.testing.assert_array_equal(port_frames(3, 2, 32, 16),
                                  frame_embeddings(3, 2, 32, 16))


def test_encode_and_cross_kv_match_jax(wm):
    jcfg, jp, cfg, tp, frames, _, _ = wm
    je = jax_encode(jp, jnp.asarray(frames), jcfg)
    te = encdec.encode(tp, _t(frames), cfg)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)
    jk, jv = jax_cross_kv(jp, je, jcfg)
    tk, tv = encdec.cross_kv(tp, _t(np.asarray(je)), cfg)
    assert tuple(tk.shape) == jk.shape == (cfg.num_layers, B, cfg.encoder_seq,
                                           cfg.num_heads, cfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_forward_logits_match_jax(wm):
    jcfg, jp, cfg, tp, frames, t, _ = wm
    ref = jax_fwd(jp, jnp.asarray(frames), jnp.asarray(t), jcfg)
    out = encdec.forward(tp, _t(frames), _t(t), cfg)
    assert tuple(out.shape) == (B, S_DEC, cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_decode_steps_match_jax(wm):
    """encode, one cross_kv, then 20 greedy decode steps from pos 0 against
    a rolling self-cache of 16 (the slots wrap): every step's logits within
    1e-4, feeding JAX's argmax to both; the self-cache positions equal."""
    jcfg, jp, cfg, tp, frames, t, _ = wm
    je = jax_encode(jp, jnp.asarray(frames), jcfg)
    jc = jax_encdec.init_dec_cache(jcfg, B, 16, jcfg.encoder_seq, jnp.float32)
    jc["xk"], jc["xv"] = jax_cross_kv(jp, je, jcfg)
    tc = encdec.init_dec_cache(cfg, B, 16, cfg.encoder_seq, device="cpu")
    tc["xk"], tc["xv"] = encdec.cross_kv(
        tp, encdec.encode(tp, _t(frames), cfg), cfg)
    tok = t[:, 0]
    for i in range(20):
        pos = np.full((B,), i)
        jl, jc = jax_dec(jp, jnp.asarray(tok), jnp.asarray(pos, jnp.int32),
                         jc, jcfg)
        tl, tc = encdec.decode_step(tp, _t(tok), _t(pos), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-5)


def test_cross_kv_cache_is_exact(wm):
    """cross_kv twice gives the same bits, and decoding against the cached
    cross K/V gives the bits of decoding with them recomputed at every
    step (JAX's test_cross_kv_cache_is_exact, and the decode it serves)."""
    _, _, cfg, tp, frames, t, _ = wm
    enc = encdec.encode(tp, _t(frames), cfg)
    kv1, kv2 = encdec.cross_kv(tp, enc, cfg), encdec.cross_kv(tp, enc, cfg)
    assert all(torch.equal(a, b) for a, b in zip(kv1, kv2))
    cached = encdec.init_dec_cache(cfg, B, 16, cfg.encoder_seq, device="cpu")
    fresh = encdec.init_dec_cache(cfg, B, 16, cfg.encoder_seq, device="cpu")
    cached["xk"], cached["xv"] = kv1
    tok = _t(t[:, 0])
    for i in range(6):
        pos = torch.full((B,), i)
        fresh["xk"], fresh["xv"] = encdec.cross_kv(tp, enc, cfg)
        a, cached = encdec.decode_step(tp, tok, pos, cached, cfg)
        b, fresh = encdec.decode_step(tp, tok, pos, fresh, cfg)
        assert torch.equal(a, b)
        tok = a.argmax(-1)


def test_cross_entropy_gradient_matches_jax(wm):
    """The token cross-entropy through `encdec.forward`, as JAX's
    tests/test_train_smoke.py trains whisper: the loss 1e-5 relative,
    every leaf's gradient against `jax.grad` 1e-4 relative."""
    jcfg, jp, cfg, tp, frames, t, y = wm

    def jax_loss(p):
        logits = jax_encdec.forward(p, jnp.asarray(frames), jnp.asarray(t),
                                    jcfg)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[..., None],
                                    -1).mean()

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(jp)

    def loss_fn(p, _):
        logits = encdec.forward(p, _t(frames), _t(t), cfg).float()
        logp = torch.log_softmax(logits, -1)
        nll = -torch.gather(logp, -1, _t(y).long()[..., None]).mean()
        return nll, {"loss": nll}

    got, metrics = steps._value_and_grad(loss_fn, tp, None)
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-5 * float(loss)
    want, have = tree_paths(_np(grads)), tree_paths(got)
    assert [k for k, _ in have] == [k for k, _ in want]
    bad = {k: r for (k, g), (_, w) in zip(have, want)
           if not (r := _rel(g.numpy(), w)) <= 1e-4}
    assert not bad, bad


def test_entry_points_that_cannot_take_whisper_say_which_can(wm):
    """JAX's ServingEngine and launchers fail on whisper too; the port's
    refuse it up front and name `encdec`.  No kernel runs."""
    _, _, cfg, tp, _, _, _ = wm
    before = flash_attention.launches
    with pytest.raises(ValueError, match="encdec"):
        ServingEngine(tp, cfg, device="cpu")
    with pytest.raises(SystemExit, match="encdec"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="encdec"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="encdec"):
        models.forward(tp, torch.zeros((1, 2), dtype=torch.long), cfg)
    assert flash_attention.launches == before
