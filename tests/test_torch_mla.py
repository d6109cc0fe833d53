"""The port's Multi-head Latent Attention (deepseek-v2) against the JAX
package, on the CPU.

deepseek-v2-236b SMOKE (d 128, 4 heads, kv_lora_rank 32, q/k head dim 32
+ 16 over v head dim 32, f32; one layer's MLA params, JAX's, bridged into
torch).  The prefill attends through the flash wrapper with v's head dim
below q/k's, which on CPU tensors runs its plain version.  Tolerances,
f32 sums in another order: outputs 1e-4 abs, cache leaves 1e-5 abs; the
wrapper's split head dim against JAX's `blocked_attention` 1e-5 abs.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import models as jax_models  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models.layers import blocked_attention  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import mla  # noqa: E402

ARCH = "deepseek-v2-236b"
B, S = 2, 40
jax_mla_forward = jax.jit(jax_mla.mla_forward, static_argnums=(2,))
jax_mla_decode = jax.jit(jax_mla.mla_decode, static_argnums=(2,))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def layer():
    """(JAX cfg, JAX MLA params of layer 0, port cfg, bridged params)."""
    jcfg = jax_get_smoke_config(ARCH)
    jp = jax.jit(jax_models.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), jcfg)
    attn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    tp = to_torch(jax.tree_util.tree_map(np.asarray, attn), "cpu")
    return jcfg, attn, get_smoke_config(ARCH), tp


def _x(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def test_mla_params_match_jax_in_shape(layer):
    jcfg, jp, cfg, _ = layer
    own = mla.init_mla(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jp.items()}


def test_mla_forward_matches_jax(layer):
    """The prefill output 1e-4; the latents it returns for the cache,
    c_kv and the roped k_rope, 1e-5."""
    jcfg, jp, cfg, tp = layer
    x = _x(cfg, S, 1)
    ref, (ckv, kr) = jax_mla_forward(jp, jnp.asarray(x), jcfg)
    out, (t_ckv, t_kr) = mla.mla_forward(tp, _t(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(t_ckv.numpy(), np.asarray(ckv), atol=1e-5)
    np.testing.assert_allclose(t_kr.numpy(), np.asarray(kr), atol=1e-5)


@pytest.mark.parametrize("W", [48, 8192])
def test_prefill_then_absorbed_decode_matches_jax(layer, W):
    """A 40-token prefill fills a cache of W latents (W 8192: JAX's chunk
    rule walks it in two chunks of 4096, most slots empty); then 4
    absorbed decode steps: each output 1e-4, the cache leaves 1e-5 and
    positions exactly, updated in place."""
    jcfg, jp, cfg, tp = layer
    _, (ckv, kr) = jax_mla_forward(jp, jnp.asarray(_x(cfg, S, 2)), jcfg)
    j_ckv = jnp.zeros((B, W, cfg.kv_lora_rank)).at[:, :S].set(ckv)
    j_kr = jnp.zeros((B, W, cfg.qk_rope_head_dim)).at[:, :S].set(kr)
    j_pos = jnp.full((B, W), -1, jnp.int32).at[:, :S].set(jnp.arange(S))
    t_ckv, t_kr = _t(j_ckv), _t(j_kr)
    t_pos = _t(j_pos).long()
    for i in range(4):
        x = _x(cfg, 1, 10 + i)
        pos = np.full((B,), S + i)
        ref, j_ckv, j_kr, j_pos = jax_mla_decode(
            jp, jnp.asarray(x), jcfg, j_ckv, j_kr, j_pos,
            jnp.asarray(pos, jnp.int32))
        out = mla.mla_decode(tp, _t(x), cfg, t_ckv, t_kr, t_pos, _t(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(t_ckv.numpy(), np.asarray(j_ckv), atol=1e-5)
    np.testing.assert_allclose(t_kr.numpy(), np.asarray(j_kr), atol=1e-5)
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))


def test_decode_refuses_a_cache_the_chunk_rule_does_not_split(layer):
    _, _, cfg, tp = layer
    W = mla.CHUNK * 2 + 1
    with pytest.raises(ValueError, match="chunks"):
        mla.mla_decode(tp, torch.zeros((1, 1, cfg.d_model)), cfg,
                       torch.zeros((1, W, cfg.kv_lora_rank)),
                       torch.zeros((1, W, cfg.qk_rope_head_dim)),
                       torch.full((1, W), -1), torch.zeros((1,)).long())


@pytest.mark.parametrize("Sq,Sk,H,KH,D,Dv,causal,window", [
    (40, 40, 4, 4, 48, 32, True, 0),        # deepseek SMOKE's prefill
    (24, 56, 8, 2, 192, 128, True, 0),      # full width's head dims, GQA
    (33, 33, 4, 1, 64, 16, True, 8),        # a window
    (16, 30, 2, 2, 40, 24, False, 0),
])
def test_split_head_dim_on_the_cpu_matches_blocked_attention(
        Sq, Sk, H, KH, D, Dv, causal, window):
    """v's head dim below q/k's, at JAX's MLA scale 1 / sqrt(D) and at
    another one: the wrapper's plain version (CPU tensors) against JAX's
    `blocked_attention` with q at the tail of k."""
    rng = np.random.default_rng(Sq + D)
    q, k = (rng.standard_normal((B, n, h, D)).astype(np.float32)
            for n, h in ((Sq, H), (Sk, KH)))
    v = rng.standard_normal((B, Sk, KH, Dv)).astype(np.float32)
    qpos = jnp.broadcast_to(jnp.arange(Sk - Sq, Sk)[None], (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk)[None], (B, Sk))
    for scale in (1.0 / math.sqrt(D), 0.3):
        ref = blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                q_positions=qpos, k_positions=kpos,
                                scale=scale)
        out = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, scale=scale)
        assert tuple(out.shape) == (B, Sq, H, Dv)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_wrapper_refuses_a_v_wider_than_q():
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="incompatible"):
        flash_attention(q, q, torch.zeros((1, 8, 2, 48)))
    with pytest.raises(ValueError, match="incompatible"):
        flash_attention(q, q, torch.zeros((1, 8, 1, 32)))


def test_sliding_window_reaches_mla_as_in_jax(layer):
    """A windowed MLA config (deepseek-v2 has none; the port takes
    cfg.sliding_window as JAX's forward passes it): prefill within 1e-4."""
    jcfg, jp, cfg, tp = layer
    jcfg_w = dataclasses.replace(jcfg, sliding_window=8)
    cfg_w = dataclasses.replace(cfg, sliding_window=8)
    x = _x(cfg, S, 3)
    ref, _ = jax_mla.mla_forward(jp, jnp.asarray(x), jcfg_w, window=8)
    out, _ = mla.mla_forward(tp, _t(x), cfg_w)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
