"""The port's text side against the JAX package, on the CPU, at SMOKE size
(dit-t2i: 2 layers, d_model 128, 4 heads of 32, 16 patches; dit-t2v: 4
frames of 8 patches; 8 text tokens; the text encoder 2 layers of 4 heads
at d_model 128): the byte tokenizer, the text encoder and its pooled
vector, PromptCache (counts, content hash, LRU, metrics), the weight
bridge of the encoder and of the DiTs' cross-attention leaves, text_kv and
the t2i / t2v forward with text, with weights bridged from JAX params and
inputs from a numpy seed.

Tolerances: tokenizer arrays exact; encoder and pooled vector 1e-5;
text_kv and forwards 1e-4 with f32 params, 5e-2 with bf16 params (f32
sums in another order; bf16 weights).  A prompt-less text-enabled forward
is torch.equal to the same params' forward with the cross branch skipped.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.conditioning import PromptCache as JaxPromptCache  # noqa: E402
from repro.conditioning import encode_tokens as jax_encode  # noqa: E402
from repro.conditioning import init_text_encoder as jax_init_enc  # noqa: E402
from repro.conditioning import pooled_embedding as jax_pooled  # noqa: E402
from repro.conditioning import tokenize as jax_tokenize  # noqa: E402
from repro.conditioning import \
    text_encoder_config as jax_tc_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import dit as jax_dit  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.models import video_dit as jax_video  # noqa: E402
from repro.obs import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.conditioning import (PromptCache, encode_tokens,  # noqa: E402
                                      init_text_encoder, pooled_embedding,
                                      text_encoder_config, tokenize)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (dit, init_params,  # noqa: E402
                                perturb_zero_init, video_dit)
from repro_torch.obs import MetricsRegistry  # noqa: E402

ARCHS = ["dit-t2i", "dit-t2v"]
MODULES = {"dit-t2i": (jax_dit, dit), "dit-t2v": (jax_video, video_dit)}


def _np(a):
    return np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _model(arch, dtype=None):
    """(jax cfg, port cfg, jax params, bridged params) of `arch`'s SMOKE
    config; another params dtype casts the f32 model's params."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if dtype is None:
        jp = jax.jit(jax_perturb)(jax_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    else:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
        jp = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                    _model(arch)[2])
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@functools.lru_cache(maxsize=None)
def _encoder():
    """(jax tc, port tc, jax encoder params, bridged params) at dit-t2i
    SMOKE's width."""
    jtc = jax_tc_config(jax_smoke("dit-t2i"))
    ttc = text_encoder_config(get_smoke_config("dit-t2i"))
    jp = jax_init_enc(jax.random.PRNGKey(1), jtc)
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jtc, ttc, jp, tp


PROMPTS = ["a cat", "", "an overlong prompt, longer than eight bytes",
           [104, 105], "héllo"]


def _embeds(rng, cfg, B=2):
    """Prompt embeddings at the encoder's scale and a mask with a padded
    tail (row 0 four tokens, row 1 all eight)."""
    te = rng.standard_normal((B, cfg.dit_text_len, cfg.d_model)).astype(
        np.float32)
    tm = np.zeros((B, cfg.dit_text_len), bool)
    tm[0, :4] = True
    tm[1:] = True
    return np.where(tm[..., None], te, 0.0).astype(np.float32), tm


def _inputs(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg.dit_tokens, cfg.dit_in_dim)).astype(
        np.float32)
    t = np.array([10.0, 600.0][:B], np.float32)
    y = np.array([1, 7][:B], np.int32)
    return x, t, y


# ----------------------------------------------------------------------
# tokenizer, encoder, pooled vector
# ----------------------------------------------------------------------

@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenize_matches_jax(prompt):
    jtc, ttc, _, _ = _encoder()
    jids, jmask = jax_tokenize(prompt, jtc)
    ids, mask = tokenize(prompt, ttc)
    assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("bad", [list(range(9)), [0, 256], [-1]])
def test_tokenize_raises_as_jax(bad):
    jtc, ttc, _, _ = _encoder()
    with pytest.raises(ValueError) as jerr:
        jax_tokenize(bad, jtc)
    with pytest.raises(ValueError) as terr:
        tokenize(bad, ttc)
    assert str(terr.value) == str(jerr.value)


def test_encoder_and_pooled_embedding_match_jax():
    """A batch of prompts (one empty: every key masked) through the
    bridged encoder: embeddings and pooled vectors within 1e-5, zero at
    padding."""
    jtc, ttc, jp, tp = _encoder()
    toks = [jax_tokenize(p, jtc) for p in PROMPTS]
    ids = np.stack([t[0] for t in toks])
    mask = np.stack([t[1] for t in toks])
    jemb = jax_encode(jp, jnp.asarray(ids), jnp.asarray(mask), jtc)
    jpool = jax_pooled(jemb, jnp.asarray(mask))
    temb = encode_tokens(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                         ttc)
    tpool = pooled_embedding(temb, torch.from_numpy(mask))
    np.testing.assert_allclose(temb.numpy(), _np(jemb), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tpool.numpy(), _np(jpool), atol=1e-5,
                               rtol=1e-5)
    assert bool((temb[torch.from_numpy(~mask)] == 0).all())


def test_text_encoder_config_and_init_match_jax_shapes():
    jtc, ttc, jp, _ = _encoder()
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    assert ttc.head_dim == jtc.head_dim
    tp = init_text_encoder(torch.Generator().manual_seed(0), ttc,
                           device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes
    with pytest.raises(ValueError, match="divisible"):
        text_encoder_config(get_smoke_config("dit-t2i"), num_heads=3)
    with pytest.raises(ValueError, match="max_len"):
        text_encoder_config(get_smoke_config("dit-t2i"), max_len=0)


# ----------------------------------------------------------------------
# PromptCache
# ----------------------------------------------------------------------

SEQUENCE = ["aa", "bb", "aa", "cc", "aa", "bb", [97, 97], "dd", "cc", "aa"]


def test_prompt_cache_counts_and_metrics_match_jax():
    """One prompt sequence through both caches at capacity 2: the same
    hits, misses, evictions, sizes and entry identities after every get,
    embeddings within 1e-5, and the same registry counters and gauge."""
    jtc, ttc, jp, tp = _encoder()
    jreg, treg = JaxMetricsRegistry(), MetricsRegistry()
    jc = JaxPromptCache(jp, jtc, capacity=2, metrics=jreg, name="t2i")
    tc = PromptCache(tp, ttc, capacity=2, metrics=treg, name="t2i")
    last, hits = {}, 0
    for prompt in SEQUENCE:
        je, te = jc.get(prompt), tc.get(prompt)
        assert (tc.hits, tc.misses, tc.evictions, len(tc)) == (
            jc.hits, jc.misses, jc.evictions, len(jc)), prompt
        assert te.key == je.key
        np.testing.assert_array_equal(te.tokens, je.tokens)
        np.testing.assert_array_equal(te.mask, je.mask)
        np.testing.assert_allclose(te.embed, je.embed, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(te.pooled, je.pooled, atol=1e-5,
                                   rtol=1e-5)
        if tc.hits > hits:      # a hit returns the entry it returned before
            assert te is last[te.key]
        last[te.key], hits = te, tc.hits
    assert tc.stats == jc.stats
    for what in ("hits", "misses", "evictions"):
        name = f"repro_conditioning_prompt_cache_{what}_total"
        assert (treg.counter(name).value(cache="t2i")
                == jreg.counter(name).value(cache="t2i")), what
    size = "repro_conditioning_prompt_cache_size"
    assert treg.gauge(size).value(cache="t2i") == \
        jreg.gauge(size).value(cache="t2i")


def test_prompt_cache_content_hash_warmup_and_capacity():
    """A string and its byte spelling share one entry under JAX's key;
    warmup encodes without counting; capacity 0 raises as in JAX."""
    jtc, ttc, jp, tp = _encoder()
    c = PromptCache(tp, ttc)
    c.warmup()
    assert (c.hits, c.misses, len(c)) == (0, 0, 0)
    pe = c.get("hi")
    assert c.get([ord("h"), ord("i")]) is pe
    assert (c.hits, c.misses) == (1, 1)
    assert c.content_key("hi") == JaxPromptCache(jp, jtc).content_key("hi")
    for cap in (0, -1):
        with pytest.raises(ValueError) as jerr:
            JaxPromptCache(jp, jtc, capacity=cap)
        with pytest.raises(ValueError) as terr:
            PromptCache(tp, ttc, capacity=cap)
        assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------------------------
# the DiTs' cross-attention: params, bridge, text_kv, forward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_init_carry_the_cross_leaves(arch):
    """The bridged JAX params and the port's own init have the same
    leaves, shapes and dtypes (bf16 too); the port's init keeps JAX's draw
    structure and its gates start at zero."""
    jcfg, tcfg, jp, tp = _model(arch, "bfloat16")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(k) for k, _ in flat_t] == \
        [jax.tree_util.keystr(k) for k, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), _np(b))
    own = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    blk = own["blocks"]
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), own) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    assert torch.equal(blk["cross"]["wk"], blk["cross"]["wq"])
    if arch == "dit-t2i":       # cross wv / wo reuse the self-attention's
        assert torch.equal(blk["cross"]["wv"], blk["attn"]["wq"])
        assert torch.equal(blk["cross"]["wo"], blk["attn"]["wo"])
    assert not blk["cross_ada_w"].any() and not blk["cross_ada_b"].any()
    pert = perturb_zero_init(own, torch.Generator().manual_seed(1))
    assert pert["blocks"]["cross_ada_w"].any()
    jmod, tmod = MODULES[arch]
    assert tmod.block_branches(tcfg) == jmod.block_branches(jcfg)


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-2)])
def test_text_kv_matches_jax(dtype, tol):
    """All layers' K/V of a batch of prompt embeddings: shape (B, nl, L,
    H*hd), f32 as JAX promotes it (bf16 weights too), within tol."""
    jcfg, tcfg, jp, tp = _model("dit-t2i", dtype)
    te, _ = _embeds(np.random.default_rng(4), jcfg)
    jk, jv = jax_dit.text_kv(jp, jnp.asarray(te), jcfg)
    tk, tv = dit.text_kv(tp, torch.from_numpy(te), tcfg)
    assert tuple(tk.shape) == jk.shape and tk.dtype == torch.float32
    assert jk.dtype == jnp.float32
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=tol, rtol=tol)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("operand", ["txt_kv", "txt_embed"])
def test_text_forward_matches_jax(arch, dtype, tol, operand):
    """The t2i / t2v forward with prompt K/V projected beforehand
    (`txt_kv`, the serving path) or inline (`txt_embed`), one row with a
    padded prompt: eps within tol."""
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    jmod, tmod = MODULES[arch]
    x, t, y = _inputs(jcfg)
    te, tm = _embeds(np.random.default_rng(5), jcfg)
    if operand == "txt_kv":
        jkw = {"txt_kv": jax_dit.text_kv(jp, jnp.asarray(te), jcfg)}
        tkw = {"txt_kv": dit.text_kv(tp, torch.from_numpy(te), tcfg)}
    else:
        jkw = {"txt_embed": jnp.asarray(te)}
        tkw = {"txt_embed": torch.from_numpy(te)}
    ref = jax.jit(lambda p, x, t, y, m, kw: jmod.forward(
        p, x, t, y, jcfg, txt_mask=m, **kw))(jp, x, t, y, tm, jkw)
    out = tmod.forward(tp, torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(y), tcfg,
                       txt_mask=torch.from_numpy(tm), **tkw)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_promptless_forward_is_a_bit_exact_noop(arch):
    """A text-enabled forward with no prompt, and with an all-masked
    prompt, is torch.equal to the same params' forward with the cross
    branch skipped (the config read as text-free); a real prompt changes
    the output."""
    _, tcfg, _, tp = _model(arch)
    tmod = MODULES[arch][1]
    x, t, y = (torch.from_numpy(a) for a in _inputs(tcfg))
    skipped = tmod.forward(tp, x, t, y,
                           dataclasses.replace(tcfg, dit_text_len=0))
    L, d = tcfg.dit_text_len, tcfg.d_model
    rng = np.random.default_rng(6)
    junk = torch.from_numpy(rng.standard_normal((2, L, d)).astype(np.float32))
    for kw in ({}, {"txt_embed": junk,
                    "txt_mask": torch.zeros((2, L), dtype=torch.bool)}):
        assert torch.equal(tmod.forward(tp, x, t, y, tcfg, **kw), skipped)
    te, tm = _embeds(rng, tcfg)
    prompted = tmod.forward(tp, x, t, y, tcfg, txt_embed=torch.from_numpy(te),
                            txt_mask=torch.from_numpy(tm))
    assert float((prompted - skipped).abs().max()) > 1e-3


def test_text_configs_match_jax():
    from repro.configs import get_config as jax_get_config
    for arch in ARCHS:
        for get, jget in ((get_config, jax_get_config),
                          (get_smoke_config, jax_smoke)):
            cfg, jcfg = get(arch), jget(arch)
            for f in dataclasses.fields(cfg):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), \
                    (arch, f.name)
