"""The port's DiT, sampler and cached pipeline against the JAX package, on
the CPU, with weights bridged from JAX params and inputs from a numpy
seed.  (The self-attention runs the flash wrapper's plain version here.)"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
# the plain references compute in full f32 (only matters on a card; stated)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.diffusion import CachedDenoiser as JaxCachedDenoiser  # noqa: E402
from repro.diffusion import ddim_step as jax_ddim_step  # noqa: E402
from repro.diffusion import linear_schedule as jax_linear_schedule  # noqa: E402
from repro.diffusion import sample as jax_sample  # noqa: E402
from repro.models import dit as jax_dit  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.diffusion import (CachedDenoiser, ddim_step,  # noqa: E402
                                   linear_schedule, sample)
from repro_torch.models import dit, init_params, perturb_zero_init  # noqa: E402

# jit compiles the scanned JAX forward once per config, much faster than
# dispatching it op by op
jax_forward = jax.jit(jax_dit.forward, static_argnums=(4,))

QUICKSTART = dict(num_layers=6, d_model=256, num_heads=4, num_kv_heads=4,
                  d_ff=1024, dit_patch_tokens=64, dit_num_classes=10)


def _configs(name, dtype=None):
    """(jax cfg, port cfg) for 'smoke' or 'quickstart', optionally with the
    params dtype replaced."""
    if name == "smoke":
        jcfg, tcfg = jax_get_config("dit-xl").reduced(
            num_layers=2, dit_patch_tokens=16, dit_in_dim=8), \
            get_smoke_config("dit-xl")
    else:
        jcfg = jax_get_config("dit-xl").reduced(**QUICKSTART)
        tcfg = get_config("dit-xl").reduced(**QUICKSTART)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(jcfg):
    """Perturbed JAX params for jcfg and their bridge (built once per config:
    the eager JAX init takes seconds)."""
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    return jp, to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _inputs(cfg, B=3, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, cfg.dit_tokens, cfg.dit_in_dim), np.float32)
    t = rng.uniform(0, 999, (B,)).astype(np.float32)
    y = rng.integers(0, cfg.dit_num_classes + 1, (B,)).astype(np.int32)
    return lat, t, y


@pytest.mark.parametrize("name", ["smoke", "quickstart"])
def test_forward_and_signal_match_jax_f32(name):
    """f32 params: forward and TeaCache's modulated signal within 1e-4
    abs / 1e-4 rel (sums in another order)."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    lat, t, y = _inputs(jcfg)
    ref = jax_forward(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(y),
                      jcfg)
    out = dit.forward(tp, torch.from_numpy(lat), torch.from_numpy(t),
                      torch.from_numpy(y), tcfg)
    assert out.dtype == torch.float32
    assert float(np.abs(np.asarray(ref)).max()) > 1e-3   # not the trivial 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)

    jh, jc = jax_dit.embed_patches(jp, jnp.asarray(lat), jnp.asarray(t),
                                   jnp.asarray(y), jcfg)
    th, tc = dit.embed_patches(tp, torch.from_numpy(lat), torch.from_numpy(t),
                               torch.from_numpy(y), tcfg)
    np.testing.assert_allclose(
        dit.modulated_signal(tp, th, tc, tcfg).numpy(),
        np.asarray(jax_dit.modulated_signal(jp, jh, jc, jcfg)),
        atol=1e-4, rtol=1e-4)


def test_forward_bf16_params_keep_jax_promotion():
    """bf16 params with f32 latents: the token path runs in f32 and the
    output is f32, as JAX promotes it; the conditioning path is bf16, so
    the tolerance is bf16's (5e-2 abs / 5e-2 rel)."""
    jcfg, tcfg = _configs("smoke", dtype="bfloat16")
    jp, tp = _params(jcfg)
    assert tp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    lat, t, y = _inputs(jcfg)
    ref = jax_forward(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(y),
                      jcfg)
    out = dit.forward(tp, torch.from_numpy(lat), torch.from_numpy(t),
                      torch.from_numpy(y), tcfg)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-2,
                               rtol=5e-2)


def test_bridge_keeps_bf16_bits_and_layout():
    jcfg, _ = _configs("smoke", dtype="bfloat16")
    jp, tp = _params(jcfg)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in leaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))


def test_quickstart_taylorseer_matches_jax():
    """examples/quickstart.py's path: 40 DDIM steps under TaylorSeer
    (interval 4, order 2).  Both packages make 10/40 full computes and
    their x0 agree within 1e-3 abs / 1e-3 rel."""
    jcfg, tcfg = _configs("quickstart")
    jp, tp = _params(jcfg)
    x_T = np.random.default_rng(1).standard_normal(
        (2, jcfg.dit_patch_tokens, jcfg.dit_in_dim)).astype(np.float32)
    jsched = jax_linear_schedule(1000)
    ts = jsched.spaced(40)

    jpol = jax_make_policy("taylorseer", interval=4, order=2)
    jden = JaxCachedDenoiser(jp, jcfg, jpol, granularity="model")
    jx0, jstate = jax_sample(jden, jnp.asarray(x_T), ts, jsched,
                             step_fn=jax_ddim_step,
                             denoiser_state=jden.init_state(2))

    pol = make_policy("taylorseer", interval=4, order=2)
    den = CachedDenoiser(tp, tcfg, pol, granularity="model", device="cpu")
    x0, state = sample(den, torch.from_numpy(x_T), linear_schedule(1000)
                       .spaced(40), linear_schedule(1000), step_fn=ddim_step,
                       denoiser_state=den.init_state(2))

    assert sum(pol.static_schedule(40)) == sum(jpol.static_schedule(40)) == 10
    assert int(jstate["policy"]["n_valid"]) == 10
    assert int(state["policy"]["n_valid"]) == 10
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=1e-3,
                               rtol=1e-3)


def test_entry_points_need_a_device_without_cuda():
    """With no CUDA device, an entry point called without device= raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("dit-xl")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator(), cfg)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachedDenoiser(params, cfg)


def test_perturb_zero_init_fills_only_zero_leaves():
    cfg = get_smoke_config("dit-xl")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    out = perturb_zero_init(params, torch.Generator().manual_seed(1))
    assert bool((params["blocks"]["ada_w"] == 0).all())
    assert not bool((out["blocks"]["ada_w"] == 0).any())
    assert torch.equal(out["patch_in"], params["patch_in"])
    # the JAX init ties wk to wq (one key); the port keeps that structure
    assert torch.equal(out["blocks"]["attn"]["wq"], out["blocks"]["attn"]["wk"])
