"""The port's hybrid LLM path (zamba2) against the JAX package, on the CPU.

The zamba2 SMOKE config (2 layers, d 128, 4 heads over 2 KV heads, state 16,
SSD head dim 16, a shared attention block after every layer, f32) with the
JAX params bridged into torch.  On the CPU the flash and SSD wrappers run
their plain versions.  Tolerances, all f32 sums in another order: logits
1e-4 abs, prefill cache leaves 1e-5 abs; generated tokens are compared
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, forward, init_params,  # noqa: E402
                                layers, prefill)
from repro_torch.serving import ServingEngine, greedy_generate  # noqa: E402

ARCH = "zamba2-2.7b"
# jit the JAX side: one compile per shape instead of an eager dispatch per op
jax_init = jax.jit(jax_init_params, static_argnums=(1,))
jax_forward_jit = jax.jit(jax_forward, static_argnums=(2,))
jax_prefill_jit = jax.jit(jax_prefill, static_argnums=(2, 3))
jax_step = jax.jit(jax_decode_step, static_argnums=(4,))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_smoke_config(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_smoke_config(ARCH), tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_config_matches_jax():
    from repro.configs import get_config as jax_get_config
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_get_smoke_config(ARCH))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.is_hybrid == theirs.is_hybrid is True
        assert ours.is_ssm_only == theirs.is_ssm_only is False


def test_rms_norm_and_rope_match_jax():
    """Tolerance 1e-6 abs: the same f32 formulas."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16), np.float32)
    w = rng.standard_normal((16,), np.float32)
    pos = np.arange(14).reshape(2, 7) * 5
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), _t(pos), 500.0).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         500.0)), atol=1e-5)


def test_forward_logits_match_jax(lm):
    jcfg, jp, cfg, tp = lm
    toks = _tokens(cfg, 2, 40, seed=2)
    ref, _ = jax_forward_jit(jp, jnp.asarray(toks, jnp.int32), jcfg)
    out = forward(tp, _t(toks), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_prefill_cache_and_decode_match_jax(lm):
    """Every prefill cache leaf (state, conv, k, v, pos) within 1e-5, then 8
    decode steps' logits within 1e-4, feeding JAX's argmax to both."""
    jcfg, jp, cfg, tp = lm
    toks = _tokens(cfg, 2, 40, seed=3)
    jl, _, jc = jax_prefill_jit(jp, jnp.asarray(toks, jnp.int32), jcfg, 64)
    tl, tc = prefill(tp, _t(toks), cfg, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert set(tc) == set(jc) == {"state", "conv", "k", "v", "pos"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-5, err_msg=key)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))
    pos = np.full((2,), 40)
    for _ in range(8):
        jl, jc = jax_step(jp, jnp.asarray(tok, jnp.int32),
                      jnp.asarray(pos, jnp.int32), jc, jcfg)
        tl, tc = decode_step(tp, _t(tok), _t(pos), tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok, pos = np.asarray(jnp.argmax(jl, -1)), pos + 1
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_rolling_cache_wraps_like_jax(lm):
    """cache_len 16 < prompt 24: prefill keeps the last 16 positions and
    decode overwrites slot pos % 16, as JAX does."""
    jcfg, jp, cfg, tp = lm
    toks = _tokens(cfg, 1, 24, seed=4)
    jl, _, jc = jax_prefill_jit(jp, jnp.asarray(toks, jnp.int32), jcfg, 16)
    tl, tc = prefill(tp, _t(toks), cfg, 16)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    tok, pos = np.array([7]), np.array([24])
    jl, jc = jax_step(jp, jnp.asarray(tok, jnp.int32),
                      jnp.asarray(pos, jnp.int32), jc, jcfg)
    tl, tc = decode_step(tp, _t(tok), _t(pos), tc, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)


def test_serving_engine_greedy_matches_jax(lm):
    """6 mixed-length prompts (one longer than max_prompt) over 4 slots:
    identical tokens; CPU tensors take the plain versions, no kernel."""
    jcfg, jp, cfg, tp = lm
    before = (ssd_scan.launches, flash_attention.launches)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (3, 17, 9, 30, 1, 12)]
    ref = JaxServingEngine(jp, jcfg, slots=4, cache_len=64,
                           max_prompt=24).generate(prompts, max_new_tokens=10)
    out = ServingEngine(tp, cfg, slots=4, cache_len=64, max_prompt=24,
                        device="cpu").generate(prompts, max_new_tokens=10)
    assert [r.request_id for r in out] == list(range(6))
    for a, b in zip(out, ref):
        assert a.prompt == b.prompt
        assert a.tokens == b.tokens and len(a.tokens) == 10
    assert (ssd_scan.launches, flash_attention.launches) == before


def test_serving_engine_batching_isolation(lm):
    """The same prompt decodes identically alone and beside others."""
    _, _, cfg, tp = lm
    eng = ServingEngine(tp, cfg, slots=4, cache_len=64, max_prompt=8,
                        device="cpu")
    solo = eng.generate([[5, 6, 7]], max_new_tokens=5)[0].tokens
    batch = eng.generate([[9, 9], [5, 6, 7], [1, 2, 3, 4]], max_new_tokens=5)
    assert batch[1].tokens == solo
    assert len(greedy_generate(tp, cfg, [5, 6, 7], max_new_tokens=5,
                               device="cpu")) == 5


def test_eos_stops_generation(lm):
    _, _, cfg, tp = lm
    eng = ServingEngine(tp, cfg, slots=1, cache_len=64, max_prompt=8,
                        device="cpu")
    ref = eng.generate([[1, 2, 3]], max_new_tokens=12)[0].tokens
    eos = ref[2]
    eng2 = ServingEngine(tp, cfg, slots=1, cache_len=64, max_prompt=8,
                         eos_id=eos, sync_every=2, device="cpu")
    out = eng2.generate([[1, 2, 3]], max_new_tokens=12)[0].tokens
    assert out == ref[:ref.index(eos) + 1]


def test_temperature_sampling_follows_the_seed(lm):
    """Draws come from a torch.Generator seeded from `seed` (they differ
    from jax.random.categorical's): the same seed repeats them."""
    _, _, cfg, tp = lm
    eng = ServingEngine(tp, cfg, slots=2, cache_len=64, max_prompt=8,
                        temperature=1.0, device="cpu")
    prompts = [[1, 2, 3], [4, 5]]
    a = [r.tokens for r in eng.generate(prompts, max_new_tokens=8, seed=1)]
    b = [r.tokens for r in eng.generate(prompts, max_new_tokens=8, seed=1)]
    c = [r.tokens for r in eng.generate(prompts, max_new_tokens=8, seed=2)]
    assert a == b and a != c


def test_bridge_keeps_the_lm_tree():
    """bf16 leaves keep their bits; the stacked layer axis and the shared
    block keep their keys and shapes."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), dtype="bfloat16")
    jp = jax_init(jax.random.PRNGKey(1), jcfg)
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            node.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))
    assert tp["blocks"]["mamba"]["in_proj"].shape[0] == jcfg.num_layers
    assert set(tp["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}


def test_init_params_matches_jax_tree():
    """The port's own init draws the JAX tree: keys, shapes, dtypes."""
    cfg = get_smoke_config(ARCH)
    ours = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    theirs = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    jax_get_smoke_config(ARCH)))
    flat, _ = jax.tree_util.tree_flatten_with_path(theirs)
    n = 0
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype)[6:] == str(leaf.dtype)
        n += 1
    assert n == sum(1 for _ in _leaves(ours))


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def test_entry_points_need_a_device_without_cuda(lm):
    _, _, cfg, tp = lm
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tp, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    with pytest.raises(ValueError):       # params on the CPU, engine elsewhere
        ServingEngine(tp, cfg, device="meta")


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--cache-len", "64"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


def test_unported_families_raise():
    """Every LLM family of JAX's zoo is ported, the moe configs included
    (they resolve); a config of a family the zoo does not have raises in
    the model code, and the expert-parallel MoE refuses a plain tensor
    (it runs on DTensors: tests/test_torch_distributed.py)."""
    from repro_torch.models import moe
    for arch in ("deepseek-v2-236b", "arctic-480b"):
        assert get_config(arch).family == "moe"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mixtral-8x7b")
    odd = dataclasses.replace(get_smoke_config(ARCH), family="retnet")
    with pytest.raises(ValueError, match="retnet"):
        init_params(torch.Generator().manual_seed(0), odd, device="cpu")
    with pytest.raises(ValueError, match="retnet"):
        forward({}, torch.zeros((1, 2), dtype=torch.long), odd)
    arctic = get_smoke_config("arctic-480b")
    with pytest.raises(TypeError, match="DTensor"):
        moe.moe_forward({}, torch.zeros((1, 2, arctic.d_model)), arctic,
                        ep={"mesh": None})
