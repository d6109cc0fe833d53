"""The port's diffusion serving engine against the JAX engine, on the CPU.

The same request list (guided and unguided rows, mixed step budgets) goes
through both engines with the same bridged weights and the JAX engine's
own initial noise injected into the port.  Cache decisions must agree
exactly (per-request computed steps, backbone row counters); outputs within
a stated tolerance."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
# the plain references compute in full f32 (only matters on a card; stated)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import \
    DiffusionServingEngine as JaxEngine  # noqa: E402
from repro.serving.diffusion import compact_rows as jax_compact_rows  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import make_policy  # noqa: E402
from repro_torch.serving.diffusion import (DiffusionRequest,  # noqa: E402
                                           DiffusionServingEngine,
                                           compact_rows)

NUM_STEPS = 8
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
             dit_patch_tokens=8, dit_in_dim=4, dit_num_classes=10)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("dit-xl").reduced(**SMALL)
    tcfg = get_config("dit-xl").reduced(**SMALL)
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _requests(cls, n=5):
    """Guided (cfg_scale 2.5) and unguided rows with budgets 8 and 6."""
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5, cfg_scale=2.5 if i % 2 == 0 else 0.0)
            for i in range(n)]


def _jax_noise(cfg):
    def noise_fn(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (cfg.dit_tokens, cfg.dit_in_dim))))
    return noise_fn


@pytest.mark.parametrize("policy", ["fora", "taylorseer"])
def test_serving_matches_jax_engine(setup, policy):
    """Exact cache decisions; x0 within 1e-4 abs / 1e-3 rel (f32 sums in
    another order over 8 DDIM steps)."""
    jcfg, tcfg, jp, tp = setup
    jeng = JaxEngine(jp, jcfg, policy, slots=2, max_steps=NUM_STEPS)
    jres = jeng.serve(_requests(JaxRequest))
    teng = DiffusionServingEngine(tp, tcfg, policy, slots=2,
                                  max_steps=NUM_STEPS,
                                  noise_fn=_jax_noise(tcfg), device="cpu")
    tres = teng.serve(_requests(DiffusionRequest))

    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for a, b in zip(tres, jres):
        assert a.record.computed_steps == b.record.computed_steps
        assert (a.record.uncond_computed_steps
                == b.record.uncond_computed_steps)
        assert a.record.admit_tick == b.record.admit_tick
        assert a.record.finish_tick == b.record.finish_tick
        assert np.isfinite(a.x0).all()
        np.testing.assert_allclose(a.x0, b.x0, atol=1e-4, rtol=1e-3)
    ts, js = teng.telemetry, jeng.telemetry
    for field in ("backbone_rows_computed", "backbone_rows_padding",
                  "backbone_rows_saved", "uncond_rows_computed",
                  "uncond_rows_saved", "ticks_full", "ticks_cond",
                  "ticks_skip", "cache_state_bytes_per_slot"):
        assert getattr(ts, field) == getattr(js, field), field
    assert ts.ticks_full > 0 and ts.backbone_rows_saved > 0


def test_taylorseer_schedule_counts_per_request(setup):
    """Each request computes exactly its static schedule's steps."""
    _, tcfg, _, tp = setup
    eng = DiffusionServingEngine(tp, tcfg, "taylorseer", slots=2,
                                 max_steps=NUM_STEPS, device="cpu")
    res = eng.serve(_requests(DiffusionRequest, n=4))
    pol = make_policy("taylorseer")
    for r in res:
        assert r.record.computed_steps == sum(
            pol.static_schedule(r.record.num_steps))
        want_u = r.record.num_steps if r.record.guided else 0
        assert r.record.uncond_computed_steps == want_u
    # distinct default noise for requests sharing a seed
    same_seed = eng.serve([DiffusionRequest(i, 4, seed=0) for i in range(2)])
    assert not np.allclose(same_seed[0].x0, same_seed[1].x0)


def test_warmup_covers_every_bucket(setup):
    _, tcfg, _, tp = setup
    eng = DiffusionServingEngine(tp, tcfg, "taylorseer", slots=3,
                                 max_steps=NUM_STEPS, device="cpu")
    assert eng.warmup() == [0, 1, 2, 3, 4, 6]


@pytest.mark.parametrize("want_c,want_u,slots", [
    ([0, 0, 0, 0], [0, 0, 0, 0], 4),
    ([1, 0, 1, 0], [0, 0, 1, 0], 4),
    ([1, 1, 1], [0, 0, 0], 3),
    ([1, 1, 1], [1, 0, 0], 3),
    ([1] * 5, [1] * 5, 5),
    ([0, 1], [1, 1], 2),
])
def test_compact_rows_matches_jax(want_c, want_u, slots):
    wc, wu = np.asarray(want_c, bool), np.asarray(want_u, bool)
    got = compact_rows(wc, wu, slots)
    ref = jax_compact_rows(wc, wu, slots)
    assert got[0] == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


def test_unported_options_raise(setup):
    _, tcfg, _, tp = setup
    # text conditioning is ported: on this class-conditioned config a
    # conditioner and a prompt are caller errors, as in JAX
    with pytest.raises(ValueError, match="not text-enabled"):
        DiffusionServingEngine(tp, tcfg, "none", conditioner=object(),
                               device="cpu")
    with pytest.raises(KeyError, match="structural"):
        make_policy("dbcache")
    eng = DiffusionServingEngine(tp, tcfg, "none", slots=1, device="cpu")
    with pytest.raises(ValueError, match="prompt on non-text config"):
        eng.serve([DiffusionRequest(0, 4, cfg_scale=2.0,
                                    neg_prompt_tokens="blurry")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DiffusionServingEngine(tp, tcfg, "none")
