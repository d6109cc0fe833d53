"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked `cuda`: they skip without a card (the fixture decides, at run
time).  This file imports torch only, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, forecast, ssd_scan  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.forecast import (basis_coeffs, forecast_basis,  # noqa: E402
                                          forecast_ref)
from repro_torch.kernels.ssd import ssd_chunked  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain references compute in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64), (1, 128, 256, 4, 1, 32),
    (1, 512, 512, 4, 2, 128), (3, 256, 256, 16, 16, 72), (2, 77, 77, 4, 4, 72),
    (1, 64, 32, 2, 2, 16),      # q longer than k: fully masked causal rows
    (2, 512, 512, 4, 4, 80),    # zamba2-2.7b attention head dim
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, KH, D, causal, window,
                                    dtype, tol):
    """Tolerance: 1e-4 abs in f32 (sum order), 2e-2 abs in bf16 (output
    rounding)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).to(dt)
    k = torch.randn((B, Sk, KH, D), generator=g, device=cuda).to(dt)
    v = torch.randn((B, Sk, KH, D), generator=g, device=cuda).to(dt)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dt
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window,dtype,offset", [
    (2, 100, 100, 4, 2, 40, True, 0, "bfloat16", 0),    # D pads 40 -> 48
    (2, 130, 130, 4, 4, 72, False, 0, "bfloat16", 0),   # D pads 72 -> 80
    (1, 96, 96, 4, 2, 12, True, 0, "bfloat16", 0),      # 24-byte rows
    (2, 70, 90, 4, 1, 18, True, 0, "float32", 0),       # 72-byte rows
    (1, 128, 128, 4, 4, 64, True, 0, "float32", 1),     # 4-byte offset
    (1, 128, 128, 4, 4, 64, False, 0, "bfloat16", 1),   # 2-byte offset
    (2, 40, 40, 2, 2, 64, True, 0, "float32", 0),       # Sk below one tile
    (2, 40, 40, 2, 2, 80, False, 0, "bfloat16", 0),
    (1, 200, 200, 4, 2, 64, True, 40, "float32", 0),    # window edge mid-tile
    (1, 200, 200, 4, 2, 80, True, 40, "bfloat16", 0),
    (2, 1, 300, 4, 2, 72, True, 0, "float32", 0),       # one query, Sk 300
    (2, 1, 300, 4, 2, 80, True, 0, "bfloat16", 0),
])
def test_flash_kernel_edge_cases(cuda, B, Sq, Sk, H, KH, D, causal, window,
                                 dtype, offset):
    """Head dims the kernel pads, rows that are not 16-byte multiples and
    views at a storage offset that is not 16-byte aligned (both staged
    element by element), a key sequence shorter than one 64-key tile, a
    window edge inside a tile, one query row.  Tolerance as above: 1e-4
    abs in f32, 2e-2 abs in bf16."""
    g = torch.Generator(device=cuda).manual_seed(4)
    dt = getattr(torch, dtype)

    def randn(*shape):
        n = B * shape[0] * shape[1] * D
        flat = torch.randn((n + offset,), generator=g, device=cuda).to(dt)
        return flat[offset:].view(B, *shape, D)

    q, k, v = randn(Sq, H), randn(Sk, KH), randn(Sk, KH)
    assert q.is_contiguous() and (q.data_ptr() % 16 != 0) == bool(offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("shape", [(3, 1), (3, 127), (4, 3, 4096),
                                   (5, 3, 4097), (3, 294912)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_kernel_matches_plain(cuda, shape, dtype):
    """Batched when the shape has 3 axes.  Tolerance: 2e-6 relative to the
    largest output in f32, one bf16 step (2^-7 relative) in bf16."""
    g = torch.Generator(device=cuda).manual_seed(1)
    d = torch.randn(shape, generator=g, device=cuda).to(getattr(torch, dtype))
    m1 = shape[-2]
    if len(shape) == 3:
        u = torch.linspace(0.25, 1.75, shape[0], device=cuda)
    else:
        u = torch.tensor(0.75, device=cuda)
    c = basis_coeffs(m1 - 1, u, "hermite")
    out = forecast(d, c)
    ref = forecast_ref(d, c)
    torch.cuda.synchronize()
    scale = max(float(ref.float().abs().max()), 1.0)
    tol = 2e-6 * scale if dtype == "float32" else 2 ** -7 * scale
    assert out.shape == ref.shape and out.dtype == d.dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("basis", ["taylor", "newton", "hermite", "ab",
                                   "foca"])
@pytest.mark.parametrize("slots", [1, 4, 8])
@pytest.mark.parametrize("n", [4096, 4097])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_basis_matches_plain(cuda, basis, slots, n, dtype):
    """The fused entry point (weights evaluated in the kernel) against
    basis_coeffs + forecast_ref on the card, with each slot's own step,
    last_step and n_valid (0 .. m+1); exactly one launch a call.  N = 4097
    takes the scalar path.  Tolerance as for `forecast`."""
    g = torch.Generator(device=cuda).manual_seed(slots)
    m1 = 3
    d = torch.randn((slots, m1, n), generator=g, device=cuda).to(
        getattr(torch, dtype))
    steps = [3 * i + 1 + i % 3 for i in range(slots)]
    last = torch.tensor([3 * i for i in range(slots)], dtype=torch.int32,
                        device=cuda)
    nv = torch.arange(slots, dtype=torch.int32, device=cuda) % (m1 + 1)
    before = forecast.launches
    out = forecast_basis(d, steps, last, nv, 3, basis, 0.5)
    assert forecast.launches == before + 1
    u = (torch.tensor(steps, dtype=torch.int32, device=cuda) - last).float() / 3.0
    ref = forecast_ref(d, basis_coeffs(m1 - 1, u, basis, 0.5, nv))
    torch.cuda.synchronize()
    scale = max(float(ref.float().abs().max()), 1.0)
    tol = 2e-6 * scale if dtype == "float32" else 2 ** -7 * scale
    assert out.shape == ref.shape and out.dtype == d.dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_forecast_basis_unbatched_and_policy_skip_tick(cuda):
    """A 0-d last_step and n_valid forecasts one stack; a skip tick of
    `PredictivePolicy.apply_slots` is one launch."""
    from repro_torch.core import PredictivePolicy
    g = torch.Generator(device=cuda).manual_seed(9)
    d = torch.randn((3, 1000), generator=g, device=cuda)
    out = forecast_basis(d, 7, torch.tensor(4, dtype=torch.int32, device=cuda),
                         torch.tensor(2, dtype=torch.int32, device=cuda), 4,
                         "hermite")
    ref = forecast_ref(d, basis_coeffs(2, torch.tensor(0.75, device=cuda),
                                       "hermite", n_valid=2))
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 2e-6 * max(
        float(ref.abs().max()), 1.0)
    pol = PredictivePolicy(4, 2, "taylor")
    states = {"diffs": torch.randn((4, 3, 8, 8), generator=g, device=cuda),
              "n_valid": torch.full((4,), 3, dtype=torch.int32, device=cuda),
              "last_step": torch.zeros((4,), dtype=torch.int32, device=cuda)}
    xs = torch.zeros((4, 8, 8), device=cuda)
    before = forecast.launches
    y, _ = pol.apply_slots(states, [1, 2, 3, 5], xs, xs)
    assert forecast.launches == before + 1 and y.shape == xs.shape


def test_teacache_served_on_the_card_matches_the_cpu(cuda):
    """A reduced DiT under TeaCache (the device want pass plans each tick)
    served on the card and on the CPU from the same weights and noise: the
    same computed steps per request, x0 within 1e-3 relative.  Every
    thresholded decision of the CPU reference lies at least 1e-4 relative
    from delta, so the exact comparison is well posed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import (DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_config("dit-xl").reduced(num_layers=2, d_model=128,
                                       num_heads=4, num_kv_heads=4, d_ff=256,
                                       dit_patch_tokens=64, dit_in_dim=8,
                                       dit_num_classes=10)
    gen = torch.Generator().manual_seed(3)
    params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)

    def noise(req):
        g = torch.Generator().manual_seed(100 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i,
                             cfg_scale=3.0 if i == 1 else 0.0)
            for i in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        p = _to_device(params, cuda) if dev == "cuda" else params
        eng = DiffusionServingEngine(p, cfg, "teacache", slots=2,
                                     max_steps=12, noise_fn=noise, device=dev)
        assert eng._static_plan is None
        plans, want_all = [], eng._want_all
        eng._want_all = lambda *a: plans.append(want_all(*a)) or plans[-1]
        out[dev] = eng.serve(reqs)
    rel = [abs(p.value[s] - p.threshold[s]) / p.threshold[s]
           for p in plans for s in range(2) if not p.forced[s]]
    assert min(rel) >= 1e-4
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.record.computed_steps == b.record.computed_steps
        rel = float(abs(a.x0 - b.x0).max() / max(abs(b.x0).max(), 1e-6))
        assert rel <= 1e-3


@pytest.mark.parametrize("mode", ["extrapolate", "lowfreq"])
@pytest.mark.parametrize("compact", [True, False])
def test_cfg_serving_card_matches_cpu(cuda, mode, compact):
    """Guided requests (one with a negative-prompt vector) under TaylorSeer
    with FasterCacheCFG, compacted or dense, on the card and on the CPU:
    the same cond and uncond computed steps, x0 within 1e-3 relative."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import FasterCacheCFG
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import (DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_config("dit-xl").reduced(num_layers=2, d_model=128,
                                       num_heads=4, num_kv_heads=4, d_ff=256,
                                       dit_patch_tokens=64, dit_in_dim=8,
                                       dit_num_classes=10)
    gen = torch.Generator().manual_seed(3)
    params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    vec = 0.02 * np.random.default_rng(7).standard_normal(
        cfg.d_model).astype(np.float32)

    def noise(req):
        g = torch.Generator().manual_seed(100 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i,
                             cfg_scale=3.0 if i != 2 else 0.0,
                             null_label=vec if i == 3 else None)
            for i in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        p = _to_device(params, cuda) if dev == "cuda" else params
        eng = DiffusionServingEngine(p, cfg, "taylorseer", slots=2,
                                     max_steps=12,
                                     cfg_policy=FasterCacheCFG(3, 12,
                                                               mode=mode),
                                     row_compaction=compact, noise_fn=noise,
                                     device=dev)
        out[dev] = eng.serve(reqs)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.record.computed_steps == b.record.computed_steps
        assert a.record.uncond_computed_steps == b.record.uncond_computed_steps
        rel = float(abs(a.x0 - b.x0).max() / max(abs(b.x0).max(), 1e-6))
        assert rel <= 1e-3


@pytest.mark.parametrize("B,S,H,D", [
    (32, 256, 16, 72),     # dit-video spatial: 2 rows x 16 frames of 256
    (512, 16, 16, 72),     # dit-video temporal: 2 rows x 256 patches of 16
    (2, 256, 12, 64),      # dit-audio self-attention
])
def test_flash_kernel_at_the_video_and_audio_shapes(cuda, B, S, H, D):
    """f32 and non-causal, as the video and audio DiTs call it; tolerance
    2e-5 abs, a few times the largest error of sound runs at these shapes
    (6e-6) and below what one TF32 pass in place of 3xTF32 gives there."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=cuda)
               for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    ref = attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert float((out - ref).abs().max()) <= 2e-5


def test_flash_grid_guard_on_the_card(cuda):
    """A batch above gridDim.z's 65535 raises before any launch."""
    from repro_torch.kernels.flash_attention import MAX_GRID_Z
    q = torch.zeros((MAX_GRID_Z + 1, 1, 1, 8), device=cuda)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="gridDim.z"):
        flash_attention(q, q, q, causal=False)
    assert flash_attention.launches == before


def _video_smoke():
    """dit-video SMOKE with seeded weights (AdaLN gates perturbed), a
    per-request noise function and three requests, one guided."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import DiffusionRequest
    cfg = get_smoke_config("dit-video")
    gen = torch.Generator().manual_seed(3)
    params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)

    def noise(req):
        g = torch.Generator().manual_seed(100 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i,
                             cfg_scale=3.0 if i == 1 else 0.0)
            for i in range(3)]
    return cfg, params, noise, reqs


@pytest.mark.parametrize("name,kw", [("teacache_video", {"delta": 0.2}),
                                     ("taylorseer", {})])
def test_video_smoke_served_on_the_card_matches_the_cpu(cuda, name, kw):
    """dit-video SMOKE served on the card and on the CPU from the same
    weights and noise: the same computed steps per request, x0 within 1e-3
    relative.  Under teacache_video (delta 0.2 splits these requests' steps)
    every thresholded decision of the CPU reference lies at least 1e-4
    relative from delta first."""
    from repro_torch.core import make_policy
    from repro_torch.serving.diffusion import DiffusionServingEngine
    cfg, params, noise, reqs = _video_smoke()
    out = {}
    for dev in ("cuda", "cpu"):
        p = _to_device(params, cuda) if dev == "cuda" else params
        eng = DiffusionServingEngine(
            p, cfg, make_policy(name, num_steps=12, frames=4, **kw),
            slots=2, max_steps=12, noise_fn=noise, device=dev)
        plans, want_all = [], eng._want_all
        eng._want_all = lambda *a: plans.append(want_all(*a)) or plans[-1]
        out[dev] = eng.serve(reqs)
    rel = [abs(p.value[s] - p.threshold[s]) / p.threshold[s]
           for p in plans for s in range(2) if not p.forced[s]]
    assert (name == "teacache_video") == bool(rel)
    assert not rel or min(rel) >= 1e-4
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.record.computed_steps == b.record.computed_steps
        rel = float(abs(a.x0 - b.x0).max() / max(abs(b.x0).max(), 1e-6))
        assert rel <= 1e-3


@pytest.mark.parametrize("gran,name,kw", [
    ("pab_video", None, {}), ("block", "fora", {"interval": 2}),
    ("deepcache", "delta_dit", {"interval": 2})])
def test_video_smoke_denoiser_card_matches_cpu(cuda, gran, name, kw):
    """CachedDenoiser at the structural granularities, 8 DDIM steps of
    dit-video SMOKE on the card and on the CPU: x0 within 1e-3 relative."""
    from repro_torch.core import make_policy
    from repro_torch.diffusion import (CachedDenoiser, ddim_step,
                                       linear_schedule, sample)
    cfg, params, noise, reqs = _video_smoke()
    sched = linear_schedule(1000)
    xT = noise(reqs[0])[None]
    out = {}
    for dev in ("cuda", "cpu"):
        p = _to_device(params, cuda) if dev == "cuda" else params
        den = CachedDenoiser(p, cfg, make_policy(name, **kw) if name else None,
                             granularity=gran, shallow_n=1, device=dev)
        x0, _ = sample(den, xT.to(dev), sched.spaced(8), sched,
                       step_fn=ddim_step, denoiser_state=den.init_state(1))
        out[dev] = x0.cpu()
    rel = float((out["cuda"] - out["cpu"]).abs().max()
                / out["cpu"].abs().max())
    assert rel <= 1e-3


@pytest.mark.parametrize("arch", ["dit-t2i", "dit-t2v"])
def test_text_promptless_forward_is_a_noop_on_the_card(cuda, arch):
    """On the card, a text-enabled SMOKE forward with no prompt and with
    an all-masked prompt is torch.equal to the same params' forward with
    the cross branch skipped; a real prompt changes it."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (dit, init_params, perturb_zero_init,
                                    video_dit)
    cfg = get_smoke_config(arch)
    mod = video_dit if cfg.dit_num_frames else dit
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = perturb_zero_init(init_params(gen, cfg, device=cuda), gen)
    x = torch.randn((2, cfg.dit_tokens, cfg.dit_in_dim), generator=gen,
                    device=cuda)
    t = torch.tensor([10.0, 600.0], device=cuda)
    y = torch.tensor([1, 7], device=cuda)
    skipped = mod.forward(params, x, t, y,
                          dataclasses.replace(cfg, dit_text_len=0))
    L = cfg.dit_text_len
    te = torch.randn((2, L, cfg.d_model), generator=gen, device=cuda)
    for kw in ({}, {"txt_embed": te, "txt_mask": torch.zeros(
            (2, L), dtype=torch.bool, device=cuda)}):
        assert torch.equal(mod.forward(params, x, t, y, cfg, **kw), skipped)
    prompted = mod.forward(params, x, t, y, cfg, txt_embed=te)
    assert float((prompted - skipped).abs().max()) > 1e-3


def test_t2i_smoke_served_on_the_card_matches_the_cpu(cuda):
    """dit-t2i SMOKE with its text encoder, the same weights on both
    devices, prompted guided requests (one negative prompt, one without a
    prompt) under TeaCache with FasterCacheCFG: the same (cond, uncond)
    computed steps, text-table builds and encoder misses; x0 within 1e-3
    relative.  Every thresholded decision of the CPU reference lies at
    least 1e-4 relative from delta first."""
    from repro_torch.conditioning import (PromptCache, init_text_encoder,
                                          text_encoder_config)
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import FasterCacheCFG, make_policy
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import (DiffusionRequest,
                                               DiffusionServingEngine)
    cfg = get_smoke_config("dit-t2i")
    gen = torch.Generator().manual_seed(3)
    params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    tc = text_encoder_config(cfg)
    enc = init_text_encoder(torch.Generator().manual_seed(4), tc,
                            device="cpu")

    def noise(req):
        g = torch.Generator().manual_seed(100 + req.request_id)
        return torch.randn((cfg.dit_tokens, cfg.dit_in_dim), generator=g)

    prompts = ("a red fox", "a lighthouse", None, "a red fox")
    reqs = [DiffusionRequest(i, num_steps=(8, 12)[i % 2], class_label=i,
                             cfg_scale=3.0 if i != 2 else 0.0,
                             prompt_tokens=prompts[i],
                             neg_prompt_tokens="blurry" if i == 0 else None)
            for i in range(4)]
    out, plans = {}, []
    for dev in ("cuda", "cpu"):
        p = _to_device(params, cuda) if dev == "cuda" else params
        cond = PromptCache(_to_device(enc, dev), tc)
        eng = DiffusionServingEngine(
            p, cfg, make_policy("teacache", delta=0.3), slots=2,
            max_steps=12, cfg_policy=FasterCacheCFG(3, 12),
            conditioner=cond, noise_fn=noise, device=dev)
        plans, want_all = [], eng._want_all
        eng._want_all = lambda *a: plans.append(want_all(*a)) or plans[-1]
        out[dev] = (eng.serve(reqs), eng.text_table_builds, cond.misses)
    rel = [abs(p.value[s] - p.threshold[s]) / p.threshold[s]
           for p in plans for s in range(2) if not p.forced[s]]
    assert rel and min(rel) >= 1e-4
    assert out["cuda"][1:] == out["cpu"][1:]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert (a.record.computed_steps, a.record.uncond_computed_steps) == (
            b.record.computed_steps, b.record.uncond_computed_steps)
        rel = float(abs(a.x0 - b.x0).max() / max(abs(b.x0).max(), 1e-6))
        assert rel <= 1e-3


def _to_device(tree, device):
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 160), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    d = torch.zeros((3, 64), device=cuda)
    with pytest.raises(ValueError):
        forecast(d, torch.zeros((3,)))          # coeffs on the CPU


@pytest.mark.parametrize("b,s,h,p,n", [
    (1, 64, 2, 16, 8), (2, 128, 4, 16, 8), (1, 96, 2, 8, 4),
    (1, 7, 2, 5, 3),            # shorter than one tile, odd widths
    (2, 130, 3, 64, 64),        # ragged tail, widest p and n
    (4, 512, 80, 64, 64),       # zamba2-2.7b prefill (4 slots x 512)
    (1, 500, 80, 64, 64),       # ragged: the plain version takes one chunk
])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n):
    """Tolerance 2e-4 abs / 1e-3 rel (chunk invariance), against the plain
    version at the longest chunk of at most 64 that divides s (64, as the
    path runs it, when 64 divides s): for a ragged s the path's plain
    version takes one chunk of s, whose cumsums (near -700 at s = 500) it
    rounds by more than that tolerance."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((b, s, h, p), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.rand((h,), generator=g, device=cuda))
    B_ = torch.randn((b, s, n), generator=g, device=cuda)
    C_ = torch.randn((b, s, n), generator=g, device=cuda)
    before = ssd_scan.launches
    y, hf = ssd_scan(x, dt, A, B_, C_)
    chunk = max(c for c in range(1, 65) if s % c == 0)
    yr, hr = ssd_chunked(x, dt, A, B_, C_, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == hf.dtype == torch.float32
    torch.testing.assert_close(y, yr, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(hf, hr, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("b,s,h,p,n", [
    (4, 512, 80, 64, 64),       # zamba2-2.7b prefill, as the path passes it
    (1, 512, 80, 64, 64),       # b 1
    (2, 130, 3, 64, 64),        # a ragged tail
    (1, 40, 2, 16, 8),          # shorter than a tile; p, n below a group
    (2, 100, 4, 48, 24),        # p across two groups, the second partial
    (1, 70, 2, 5, 3),           # odd widths: element-by-element staging
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_kernel_reads_views_of_xbc(cuda, b, s, h, p, n, dtype):
    """x, B and C as strided views (unit last stride) of one (b, s, h p +
    2 n) conv output in bf16 or f32, as `mamba2_forward` passes them,
    against the plain version on the same values.  Tolerance 2e-4 abs /
    1e-3 rel, at the longest chunk of at most 64 that divides s."""
    g = torch.Generator(device=cuda).manual_seed(s + p)
    w = h * p
    xbc = torch.randn((b, s, w + 2 * n), generator=g, device=cuda).to(
        getattr(torch, dtype))
    x = xbc[..., :w].view(b, s, h, p)
    B_, C_ = xbc[..., w:w + n], xbc[..., w + n:]
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.rand((h,), generator=g, device=cuda))
    assert not x.is_contiguous() and x.stride(-1) == 1
    before = ssd_scan.launches
    y, hf = ssd_scan(x, dt, A, B_, C_)
    chunk = max(c for c in range(1, 65) if s % c == 0)
    yr, hr = ssd_chunked(x, dt, A, B_, C_, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == hf.dtype == torch.float32
    torch.testing.assert_close(y, yr, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(hf, hr, atol=2e-4, rtol=1e-3)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """f16 inputs and a last axis that is not unit stride raise; a head dim
    above 64 (p 80) is no longer refused: it runs the general unit
    (csrc/ssd_any.cu), held against the plain version at 2e-4 abs / 1e-3
    rel."""
    from repro_torch.kernels import _build
    x = torch.zeros((1, 8, 2, 16), device=cuda)
    dt = torch.zeros((1, 8, 2), device=cuda)
    A = torch.zeros((2,), device=cuda)
    s = torch.zeros((1, 8, 4), device=cuda)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, s.half(), s.half())
    with pytest.raises(ValueError):
        ssd_scan(torch.zeros((1, 16, 2, 8), device=cuda).transpose(1, 3),
                 torch.zeros((1, 8, 2), device=cuda), A, s, s)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, s.transpose(1, 2).contiguous().transpose(1, 2), s)
    g = torch.Generator(device=cuda).manual_seed(9)
    x80 = torch.randn((1, 72, 2, 80), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((1, 72, 2), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.rand((2,), generator=g, device=cuda))
    B_, C_ = (torch.randn((1, 72, 4), generator=g, device=cuda)
              for _ in range(2))
    before = _build.launches.ssd_fwd_any
    y, hf = ssd_scan(x80, dt, A, B_, C_)
    yr, hr = ssd_chunked(x80, dt, A, B_, C_, 72)
    torch.cuda.synchronize()
    assert _build.launches.ssd_fwd_any == before + 1
    torch.testing.assert_close(y, yr, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(hf, hr, atol=2e-4, rtol=1e-3)


def test_kernel_flop_counters_match_flop_counter_mode(cuda):
    """The flash and forecast wrappers' FLOP counters on the card equal
    what FlopCounterMode counts for their plain versions (4*B*H*Sq*Sk*D
    and 2*B*(m+1)*n), so `count_flops` gives the card the CPU's count."""
    from repro_torch.obs import count_flops
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((3, 256, 16, 72), generator=g, device=cuda)
               for _ in range(3))
    before = flash_attention.flops
    n = count_flops(lambda: flash_attention(q, k, v, causal=False))
    assert flash_attention.flops - before == n == 4 * 3 * 16 * 256 * 256 * 72
    assert count_flops(lambda: attention_ref(q, k, v, causal=False)) == n
    diffs = torch.randn((4, 3, 4096), generator=g, device=cuda)
    coeffs = torch.randn((4, 3), generator=g, device=cuda)
    n = count_flops(lambda: forecast(diffs, coeffs))
    assert n == 2 * 4 * 3 * 4096
    assert count_flops(lambda: forecast_ref(diffs, coeffs)) == n


def test_program_profiles_card_match_cpu(cuda):
    """The reduced DiT's program profiles under TaylorSeer (forecast on the
    skip ticks) and TeaCache (the plan pass): identical FLOPs per program
    on the card and on the CPU, strictly rising with the bucket."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, perturb_zero_init
    from repro_torch.serving.diffusion import DiffusionServingEngine
    cfg = get_config("dit-xl").reduced(num_layers=2, d_model=128,
                                       num_heads=4, num_kv_heads=4, d_ff=256,
                                       dit_patch_tokens=64, dit_in_dim=8,
                                       dit_num_classes=10)
    gen = torch.Generator().manual_seed(3)
    params = perturb_zero_init(init_params(gen, cfg, device="cpu"), gen)
    for policy in ("taylorseer", "teacache"):
        flops = {}
        for dev in ("cuda", "cpu"):
            p = _to_device(params, cuda) if dev == "cuda" else params
            eng = DiffusionServingEngine(p, cfg, policy, slots=2,
                                         max_steps=12, device=dev)
            eng.warmup()
            flops[dev] = {k: v.flops for k, v in eng.program_profile.items()}
        assert flops["cuda"] == flops["cpu"], policy
        buckets = [flops["cpu"][b] for b in (0, 1, 2, 4)]
        assert buckets == sorted(set(buckets))


def test_fit_want_gate_on_the_card(cuda):
    """One fit_want_gate on the card from the CPU generator's gate: loss
    history within 1e-4 relative of the CPU's, a detached gate on the card,
    the loss falls."""
    from repro_torch.serving.control import fit_want_gate
    g = torch.Generator().manual_seed(2)
    pairs = []
    for T in (6, 4):
        ins = torch.randn((T, 64, 8), generator=g)
        pairs.append((ins, 0.5 * ins + 0.2 * torch.randn(ins.shape,
                                                         generator=g)))
    out = {}
    for dev in ("cuda", "cpu"):
        ps = [(i.to(dev), o.to(dev)) for i, o in pairs]
        out[dev] = fit_want_gate(torch.Generator().manual_seed(1), ps,
                                 steps=60, lr=0.5)
    (gate, hist), (_, ref) = out["cuda"], out["cpu"]
    assert gate["w"].is_cuda and not gate["w"].requires_grad
    err = max(abs(a - b) / abs(b) for a, b in zip(hist, ref))
    assert err <= 1e-4
    assert hist[-1] < hist[0]


# ----------------------------------------------------------------------
# training: the flash backward, the LSE output, the gradient guards
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", [
    (8, 256, 256, 16, 16, 72, False, 0),     # DiT-XL
    (2, 512, 512, 8, 2, 64, True, 128),       # causal GQA with a window
    (2, 77, 77, 4, 4, 72, True, 0),           # ragged
    (1, 64, 32, 2, 2, 16, True, 0),           # q longer than k: keyless rows
    (1, 128, 256, 4, 1, 128, True, 64),       # q at the tail of k, D 128
    (2, 100, 160, 4, 2, 18, True, 48),        # odd head dim
    (1, 40, 40, 2, 2, 80, False, 0),          # below one tile
    (2, 72, 72, 4, 2, 72, False, 0),          # D 72 (bf16 pads to 80), GQA 2
])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_flash_backward_kernel_matches_plain(cuda, B, Sq, Sk, H, KH, D,
                                             causal, window, dtype, tol):
    """The backward kernels under autograd against autograd of the plain
    version on float64 copies, and bitwise on a rerun.  Tolerance: 1e-4
    abs in f32, 2e-2 abs in bf16 (the gradients' bf16 rounding)."""
    from repro_torch.kernels import flash_attention_backward
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).to(dt)
    k = torch.randn((B, Sk, KH, D), generator=g, device=cuda).to(dt)
    v = torch.randn((B, Sk, KH, D), generator=g, device=cuda).to(dt)
    do = torch.randn((B, Sq, H, D), generator=g, device=cuda).to(dt)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = (flash_attention.launches, flash_attention_backward.launches)
    o = flash_attention(qg, kg, vg, causal=causal, window=window)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (qg, kg, vg), do)
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (before[0] + 1, before[1] + 1)
    again = torch.autograd.grad(flash_attention(qg, kg, vg, causal=causal,
                                                window=window),
                                (qg, kg, vg), do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(attention_ref(q64, k64, v64, causal=causal,
                                             window=window),
                               (q64, k64, v64), do.double())
    for a, b in zip(got, want):
        assert a.dtype == dt
        assert float((a.double() - b).abs().max()) <= tol
    if causal and Sq > Sk:
        assert bool((got[0][:, :Sq - Sk] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_writes_the_lse_only_under_grad(cuda, dtype):
    """Under grad the forward also writes each row's log-sum-exp (held to
    the plain one within 1e-4 abs; -1e30 for a keyless row); its output is
    the serving path's, bit for bit."""
    from repro_torch.kernels.flash_attention import attention_lse_ref, ops
    g = torch.Generator(device=cuda).manual_seed(2)
    dt = getattr(torch, dtype)
    q = torch.randn((2, 96, 4, 64), generator=g, device=cuda).to(dt)
    k = torch.randn((2, 80, 2, 64), generator=g, device=cuda).to(dt)
    lse = torch.full((2, 4, 96), 7.0, device=cuda)
    o_lse = ops._forward(q, k, k, True, 0, 0.125, lse,
                         ops.route(dt, 64, 64, True, True).forward)
    o = flash_attention(q, k, k, causal=True, scale=0.125)
    assert torch.equal(o, o_lse)
    want = attention_lse_ref(q, k, causal=True, scale=0.125)
    live = want > -1e29
    assert float((lse - want)[live].abs().max()) <= 1e-4
    assert bool((lse[~live] == -1e30).all()) and int((~live).sum()) > 0


def test_wrappers_under_grad_differentiate_or_raise(cuda):
    """No CUDA wrapper hands back an output detached from an input that
    requires a gradient: flash and the SSD scan differentiate through
    their backward kernels, the forecast raises; under no_grad all three
    launch."""
    from repro_torch.kernels.forecast import forecast_basis
    from repro_torch.kernels.ssd import ssd_scan_backward
    x = torch.randn((1, 64, 2, 16), device=cuda, requires_grad=True)
    s = torch.randn((1, 64, 16), device=cuda)
    dt = torch.rand((1, 64, 2), device=cuda)
    A = -torch.rand((2,), device=cuda)
    before = ssd_scan_backward.launches
    y, _ = ssd_scan(x, dt, A, s, s)
    assert y.grad_fn is not None
    y.sum().backward()
    assert ssd_scan_backward.launches == before + 1
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    d = torch.randn((3, 256), device=cuda, requires_grad=True)
    c = torch.tensor([1.0, 0.5, 0.25], device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        forecast(d, c)
    i32 = torch.zeros((), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        forecast_basis(d, 1, i32, i32 + 2, 1)
    with torch.no_grad():
        y, _ = ssd_scan(x, dt, A, s, s)
        assert forecast(d, c).shape == (256,)
    assert y.shape == x.shape


# the SSD scan's backward: float64 autograd of the plain version is the
# reference; f32 inputs within 1e-4 of the largest gradient, bf16 views of
# the conv output within one bf16 rounding of it (2^-8 relative to each
# element plus the f32 tolerance)
@pytest.mark.parametrize("b,s,h,p,n", [(1, 100, 2, 16, 16), (2, 128, 4, 64, 64),
                                       (2, 64, 3, 32, 16),
                                       # head groups of 2: the last has 1
                                       (4, 512, 21, 32, 32)])
@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("xbc", [False, True])
def test_ssd_backward_kernel_matches_float64(cuda, b, s, h, p, n, dh, xbc):
    from repro_torch.kernels.ssd import ssd_bwd_ref, ssd_scan_backward
    g = torch.Generator(device=cuda).manual_seed(s + h)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=cuda))
    A = -torch.exp(torch.rand((h,), generator=g, device=cuda))
    if xbc:
        buf = torch.randn((b, s, h * p + 2 * n), generator=g,
                          device=cuda).to(torch.bfloat16)
        x = buf[..., :h * p].view(b, s, h, p)
        B_, C_ = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    else:
        x = torch.randn((b, s, h, p), generator=g, device=cuda)
        B_ = torch.randn((b, s, n), generator=g, device=cuda)
        C_ = torch.randn((b, s, n), generator=g, device=cuda)
    dy = torch.randn((b, s, h, p), generator=g, device=cuda)
    dhf = torch.randn((b, h, p, n), generator=g, device=cuda) if dh else None
    before = ssd_scan_backward.launches
    got = ssd_scan_backward(x, dt, A, B_, C_, dy, dhf)
    again = ssd_scan_backward(x, dt, A, B_, C_, dy, dhf)
    torch.cuda.synchronize()
    assert ssd_scan_backward.launches == before + 2
    ref = ssd_bwd_ref(x.double(), dt.double(), A.double(), B_.double(),
                      C_.double(), dy.double(),
                      None if dhf is None else dhf.double())
    for i, (a, r) in enumerate(zip(got, ref)):
        assert torch.equal(a, again[i])            # no atomics: bitwise
        assert a.shape == r.shape
        assert a.dtype == (x.dtype if i in (0, 3, 4) else torch.float32)
        err = (a.double() - r).abs()
        tol = 1e-4 * float(r.abs().max())
        if a.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -8 * r.abs()
        assert bool((err <= tol).all()), i


def test_ssd_scan_trains_through_the_backward_kernel(cuda):
    """Autograd through `ssd_scan` on bf16 views of one buffer, as
    `mamba2_forward` passes them: the gradients reach the buffer, equal
    the backward wrapper's, and y and h_final both carry a gradient."""
    from repro_torch.kernels.ssd import ssd_scan_backward
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, p, n = 2, 130, 4, 32, 16
    buf = torch.randn((b, s, h * p + 2 * n), generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    dt = torch.rand((b, s, h), generator=g, device=cuda).requires_grad_()
    A = (-torch.rand((h,), generator=g, device=cuda)).requires_grad_()
    x = buf[..., :h * p].view(b, s, h, p)
    B_, C_ = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    y, hf = ssd_scan(x, dt, A, B_, C_)
    dy = torch.randn(y.shape, generator=g, device=cuda)
    dhf = torch.randn(hf.shape, generator=g, device=cuda)
    gbuf, gdt, gA = torch.autograd.grad((y * dy).sum() + (hf * dhf).sum(),
                                        (buf, dt, A))
    dx, ddt, dA, dB, dC = ssd_scan_backward(x.detach(), dt.detach(),
                                            A.detach(), B_.detach(),
                                            C_.detach(), dy, dhf)
    assert torch.equal(gbuf[..., :h * p].view(b, s, h, p), dx)
    assert torch.equal(gbuf[..., h * p:h * p + n], dB)
    assert torch.equal(gbuf[..., h * p + n:], dC)
    assert torch.equal(gdt, ddt) and torch.equal(gA, dA)


# the bf16 serving forward's head-dim-160 instantiation (pixtral-12b)
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", [
    (2, 1088, 1088, 32, 8, 160, True, 0),      # pixtral-12b prefill
    (1, 200, 300, 4, 2, 160, True, 64),        # q at the tail, a window
    (2, 77, 77, 4, 4, 136, False, 0),          # D pads 136 -> 160
    (1, 64, 32, 2, 2, 160, True, 0),           # fully masked causal rows
])
def test_flash_kernel_at_head_dim_160(cuda, B, Sq, Sk, H, KH, D, causal,
                                      window):
    """Tolerance 2e-2 abs, the bf16 gate (output rounding)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, KH, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, KH, D), generator=g, device=cuda).bfloat16()
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2


def test_head_dim_160_is_the_bf16_serving_path_only(cuda):
    """Above 128 the bf16 instantiation at 160 takes bf16 with 16-byte rows
    and pointers (and under grad its training forward); f32 at 160, bf16 at
    176 and 132 and a misaligned pointer at 160 no longer raise: they run
    the general forward (csrc/flash_attention_any.cu), held against the
    plain version (2e-5 abs in f32, one bf16 rounding 1.6e-2 in bf16).  f16
    still raises, launching nothing."""
    from repro_torch.kernels import _build
    g = torch.Generator(device=cuda).manual_seed(11)

    def rand(D, dt=torch.bfloat16, offset=0):
        flat = torch.randn((96 * 2 * D + offset,), generator=g, device=cuda)
        return flat.to(dt)[offset:].view(1, 96, 2, D)

    before = flash_attention.launches
    any_before = _build.launches.flash_attention_fwd_any
    with pytest.raises(TypeError):
        flash_attention(*(rand(160, torch.float16) for _ in range(3)))
    assert flash_attention.launches == before
    cases = ((rand(160, torch.float32), 2e-5), (rand(176), 1.6e-2),
             (rand(132), 1.6e-2), (rand(160, offset=1), 1.6e-2))
    for q, tol in cases:
        out = flash_attention(q, q, q)
        ref = attention_ref(q, q, q)
        torch.cuda.synchronize()
        assert out.dtype == q.dtype
        assert float((out.float() - ref.float()).abs().max()) <= tol
    assert _build.launches.flash_attention_fwd_any == any_before + len(cases)
    assert flash_attention.launches == before + len(cases)
    q = torch.zeros((1, 64, 2, 160), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    o = flash_attention(q, q, q)
    assert o.grad_fn is not None and flash_attention.launches == before + 5
    assert _build.launches.flash_attention_fwd_any == any_before + len(cases)


def _smoke_pair(arch, seed=5):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    cfg = get_smoke_config(arch)
    cpu = init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return cfg, cpu, _to_device(cpu, "cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "pixtral-12b"])
def test_ssm_and_vlm_smoke_card_match_cpu(cuda, arch):
    """f32 SMOKE on the card against the CPU: the forward's and a prefill +
    4 decode steps' logits 1e-4 relative, greedy tokens equal, `lm_loss`'s
    gradients 1e-4 relative per leaf (pixtral with patch embeddings)."""
    import numpy as np
    from repro_torch.data import lm_batches, patch_embeddings
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.train.steps import _value_and_grad, lm_loss
    cfg, cpu, card = _smoke_pair(arch)
    t, y = (torch.from_numpy(a) for a in next(lm_batches(0, 4, 100,
                                                         cfg.vocab_size)))
    kw = {}
    if cfg.family == "vlm":
        kw["vision_embeds"] = torch.from_numpy(patch_embeddings(
            5, 4, cfg.num_vision_tokens, cfg.vision_dim))
    S = t.shape[1] + (cfg.num_vision_tokens if kw else 0)
    out = {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        k = {n: v.to(dev) for n, v in kw.items()}
        with torch.no_grad():
            f = forward(p, t.to(dev), cfg, **k)
            lg, cache = prefill(p, t.to(dev), cfg, 128, **k)
            rows, tok = [lg[:, -1]], lg[:, -1].argmax(-1)
            for i in range(4):
                lg, cache = decode_step(p, tok, torch.full((4,), S + i,
                                                           device=dev),
                                        cache, cfg)
                rows.append(lg)
                tok = lg.argmax(-1)
        grads, _ = _value_and_grad(
            lambda q, _: lm_loss(q, t.to(dev), y.to(dev), cfg, **k), p, None)
        out[dev] = (f, torch.stack(rows), grads)
    assert _rel(out["cuda"][0], out["cpu"][0]) <= 1e-4
    assert _rel(out["cuda"][1], out["cpu"][1]) <= 1e-4
    assert torch.equal(out["cuda"][1].argmax(-1).cpu(),
                       out["cpu"][1].argmax(-1))
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(out["cuda"][2]), tree_leaves(out["cpu"][2])):
        assert _rel(a, b) <= 1e-4
    assert np.isfinite(float(out["cuda"][1].abs().max()))


def test_encdec_smoke_card_matches_cpu(cuda):
    """whisper-small SMOKE (f32): the forward's logits 1e-4 relative, 8
    greedy decode steps from one cross_kv equal in tokens and 1e-4 in
    logits; on the card, decoding against the cached cross K/V equals
    decoding with them recomputed, bit for bit."""
    from repro_torch.data import frame_embeddings
    from repro_torch.models import encdec
    cfg, cpu, card = _smoke_pair("whisper-small")
    B = 2
    frames = torch.from_numpy(frame_embeddings(5, B, cfg.encoder_seq,
                                               cfg.d_model))
    toks = torch.arange(1, 13).repeat(B, 1)
    out = {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        with torch.no_grad():
            f = encdec.forward(p, frames.to(dev), toks.to(dev), cfg)
            enc = encdec.encode(p, frames.to(dev), cfg)
            cache = encdec.init_dec_cache(cfg, B, 16, cfg.encoder_seq,
                                          device=dev)
            cache["xk"], cache["xv"] = encdec.cross_kv(p, enc, cfg)
            fresh = dict(cache, k=cache["k"].clone(), v=cache["v"].clone(),
                         pos=cache["pos"].clone())
            tok, rows = toks[:, 0].to(dev), []
            for i in range(8):
                pos = torch.full((B,), i, device=dev)
                lg, cache = encdec.decode_step(p, tok, pos, cache, cfg)
                fresh["xk"], fresh["xv"] = encdec.cross_kv(p, enc, cfg)
                again, fresh = encdec.decode_step(p, tok, pos, fresh, cfg)
                assert torch.equal(lg, again)
                rows.append(lg)
                tok = lg.argmax(-1)
        out[dev] = (f, torch.stack(rows))
    assert _rel(out["cuda"][0], out["cpu"][0]) <= 1e-4
    assert _rel(out["cuda"][1], out["cpu"][1]) <= 1e-4
    assert torch.equal(out["cuda"][1].argmax(-1).cpu(),
                       out["cpu"][1].argmax(-1))


# the split head dim (deepseek-v2's MLA: q/k 192 over v 128)
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,Dv,causal,window", [
    (4, 512, 512, 128, 128, 192, 128, True, 0),   # deepseek-v2 prefill
    (2, 500, 500, 16, 16, 192, 128, True, 0),     # ragged
    (1, 200, 300, 8, 2, 192, 128, True, 64),      # q at the tail, GQA, window
    (2, 77, 77, 4, 4, 136, 64, False, 0),         # D pads 136 -> 192, Dv 64
    (1, 64, 32, 2, 2, 192, 128, True, 0),         # fully masked causal rows
])
def test_flash_split_head_dim_matches_plain(cuda, B, Sq, Sk, H, KH, D, Dv,
                                            causal, window):
    """bf16 serving, the split instantiation (one launch) against
    `attention_ref` at 1/sqrt(D): 2e-2 abs, the bf16 gate (output
    rounding)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, KH, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, KH, Dv), generator=g, device=cuda).bfloat16()
    before = flash_attention.launches
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == (B, Sq, H, Dv) and out.dtype == torch.bfloat16
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_flash_split_head_dim_pads_v_under_grad(cuda, dtype, tol):
    """D <= 128 (deepseek-v2 SMOKE's 48 over 32): v zero-padded to D
    through the forward and backward kernels, the first Dv columns kept;
    above 128 in bf16 (192 over 128) the split training kernels run on v
    as it is.  Output and gradients against float64 autograd of
    `attention_ref`, 1e-4 abs in f32, 2e-2 in bf16 (the flash backward's
    gates); at 192 over 128, at the MLA's 1/sqrt(192), the gradients 2e-2
    plus one bf16 rounding (the wide rows' gate: summed dk and dv pass
    4, where half a bf16 step is 1.6e-2)."""
    from repro_torch.kernels import flash_attention_backward
    g = torch.Generator(device=cuda).manual_seed(9)
    dt = getattr(torch, dtype)
    shapes = [(48, 32, 0.2)] + ([(192, 128, 192 ** -0.5)]
                                 if dtype == "bfloat16" else [])
    for D, Dv, scale in shapes:
        q, k = (torch.randn((2, 100, 4, D), generator=g, device=cuda).to(dt)
                .requires_grad_() for _ in range(2))
        v = torch.randn((2, 100, 4, Dv), generator=g, device=cuda).to(dt) \
            .requires_grad_()
        do = torch.randn((2, 100, 4, Dv), generator=g, device=cuda).to(dt)
        before = (flash_attention.launches, flash_attention_backward.launches)
        out = flash_attention(q, k, v, causal=True, scale=scale)
        grads = torch.autograd.grad(out, (q, k, v), do)
        assert (flash_attention.launches, flash_attention_backward.launches) \
            == (before[0] + 1, before[1] + 1)
        q64, k64, v64 = (t.detach().double().requires_grad_()
                         for t in (q, k, v))
        ref = attention_ref(q64, k64, v64, causal=True, scale=scale)
        want = torch.autograd.grad(ref, (q64, k64, v64), do.double())
        assert out.shape == (2, 100, 4, Dv)
        assert float((out.double() - ref).abs().max()) <= tol
        rounding = 2.0 ** -8 if D > 128 else 0.0
        for a, b in zip(grads, want):
            assert a.shape == b.shape and a.dtype == dt
            assert float(((a.double() - b).abs()
                          - rounding * b.abs()).max()) <= tol


def test_flash_split_head_dim_refusals(cuda):
    """A v head dim above q/k's still raises, launching nothing.  What the
    split instantiations (bf16, q/k up to 192 over v up to 128, 16-byte
    rows) do not take no longer raises: f32 192 over 128, with and without
    grad, bf16 200 over 128, 192 over 136 and a misaligned v run the
    general units, held against the plain version (2e-5 abs in f32, one
    bf16 rounding in bf16) and, under grad, against float64 autograd (1e-4
    abs in f32); bf16 192 over 128 under grad runs the split training
    kernels."""
    from repro_torch.kernels import _build, flash_attention_backward
    g = torch.Generator(device=cuda).manual_seed(12)

    def rand(D, dt=torch.bfloat16, offset=0):
        flat = torch.randn((64 * 2 * D + offset,), generator=g, device=cuda)
        return flat.to(dt)[offset:].view(1, 64, 2, D)

    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(rand(128), rand(128), rand(192))
    assert flash_attention.launches == before
    any_before = _build.launches.flash_attention_fwd_any
    cases = ((rand(192, torch.float32), rand(128, torch.float32), 2e-5),
             (rand(200), rand(128), 1.6e-2), (rand(192), rand(136), 1.6e-2),
             (rand(192), rand(128, offset=1), 1.6e-2))
    for q, v, tol in cases:
        out = flash_attention(q, q, v)
        ref = attention_ref(q, q, v)
        torch.cuda.synchronize()
        assert out.shape == v.shape[:3] + (v.shape[-1],)
        assert float((out.float() - ref.float()).abs().max()) <= tol
    assert _build.launches.flash_attention_fwd_any == any_before + len(cases)
    q, v = rand(192, torch.float32), rand(128, torch.float32)
    q64, v64 = (t.double().requires_grad_() for t in (q, v))
    do = torch.randn((1, 64, 2, 128), generator=g, device=cuda)
    want = torch.autograd.grad(attention_ref(q64, q64, v64), (q64, v64),
                               do.double())
    qg, vg = q.clone().requires_grad_(), v.clone().requires_grad_()
    bwd_any = _build.launches.flash_attention_bwd_any
    flash_attention(qg, qg, vg).backward(do)
    assert _build.launches.flash_attention_bwd_any == bwd_any + 1
    for a, b in zip((qg.grad, vg.grad), want):
        assert float((a.double() - b).abs().max()) <= 1e-4
    q = rand(192).requires_grad_()
    bwd = flash_attention_backward.launches
    fwd = flash_attention.launches
    o = flash_attention(q, q, rand(128))
    o.float().sum().backward()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_backward.launches == bwd + 1
    assert _build.launches.flash_attention_bwd_any == bwd_any + 1


# the training kernels above 128: the kLse forward and the wide backward
# (csrc/flash_attention_bwd_wide.cu) at pixtral's 160 and the MLA's 192
# over 128
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,Dv,causal,window", [
    (2, 200, 200, 8, 2, 160, 160, True, 0),       # GQA group 4, causal
    (1, 200, 300, 4, 2, 160, 160, True, 64),      # q at the tail, a window
    (1, 200, 300, 16, 2, 160, 160, True, 64),     # GQA group 8, tail, window
    (2, 77, 77, 4, 4, 136, 136, False, 0),        # D pads 136 -> 160
    (1, 64, 32, 2, 2, 160, 160, True, 0),         # keyless rows
    (2, 130, 130, 8, 8, 192, 128, True, 0),       # the MLA, ragged
    (1, 200, 300, 8, 2, 192, 128, True, 64),      # GQA, tail, window
    (2, 77, 77, 4, 4, 136, 64, False, 0),         # D pads 136 -> 192, Dv 64
    (1, 64, 32, 2, 2, 192, 128, True, 0),         # keyless rows
])
def test_flash_wide_training_kernels_match_float64(cuda, B, Sq, Sk, H, KH, D,
                                                   Dv, causal, window):
    """Under autograd, one forward (kLse) and one backward launch; the
    output 2e-2 abs and the gradients 2e-2 abs plus one bf16 rounding
    (2^-8 of the float64 value: a summed GQA group grows dk and dv) off
    float64 autograd of `attention_ref`, bitwise on a rerun, and the
    forward's lse 1e-3 abs off the plain one; `attention_bwd_ref` from the
    same o and lse under the same gate."""
    from repro_torch.kernels import flash_attention_backward
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref, ops)
    g = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, KH, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, KH, Dv), generator=g, device=cuda).bfloat16()
    do = torch.randn((B, Sq, H, Dv), generator=g, device=cuda).bfloat16()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = (flash_attention.launches, flash_attention_backward.launches)
    o = flash_attention(qg, kg, vg, causal=causal, window=window)
    got = torch.autograd.grad(o, (qg, kg, vg), do)
    assert (flash_attention.launches, flash_attention_backward.launches) \
        == (before[0] + 1, before[1] + 1)
    again = torch.autograd.grad(flash_attention(qg, kg, vg, causal=causal,
                                                window=window),
                                (qg, kg, vg), do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    ref = attention_ref(q64, k64, v64, causal=causal, window=window)
    want = torch.autograd.grad(ref, (q64, k64, v64), do.double())
    assert float((o.double() - ref).abs().max()) <= 2e-2
    lse = torch.empty((B, H, Sq), device=cuda)
    entry = ops.route(q.dtype, D, Dv, ops.aligned16(D, Dv, (q, k, v)),
                      True).forward
    o2 = ops._forward(q, k, v, causal, window, D ** -0.5, lse, entry)
    lse_ref = attention_lse_ref(q, k, causal=causal, window=window)
    live = lse_ref > -1e29
    assert float((lse - lse_ref)[live].abs().max()) <= 1e-3
    plain = attention_bwd_ref(q, k, v, o2, do, lse, causal=causal,
                              window=window)
    for grads in (got, plain):
        for a, b in zip(grads, want):
            assert a.shape == b.shape and a.dtype == torch.bfloat16
            assert float(((a.double() - b).abs()
                          - 2.0 ** -8 * b.abs()).max()) <= 2e-2
    if causal and Sq > Sk:
        assert bool((got[0][:, :Sq - Sk] == 0).all())


# the general units (csrc/flash_attention_any.cu and _bwd_any.cu): f32
# above 128, bf16 above 160 or misaligned
GENERAL_SHAPES = pytest.mark.parametrize(
    "B,Sq,Sk,H,KH,D,Dv,causal,window,dtype,offset", [
        (2, 200, 200, 8, 2, 160, 160, True, 0, "float32", 0),     # GQA group 4
        (1, 200, 300, 16, 2, 160, 160, True, 64, "float32", 0),   # group 8, window
        (2, 130, 130, 8, 8, 192, 128, True, 0, "float32", 0),     # the MLA, ragged
        (1, 150, 220, 4, 2, 200, 72, True, 48, "float32", 0),     # Dv < D, window
        (1, 64, 32, 2, 2, 160, 160, True, 0, "float32", 0),       # keyless rows
        (2, 77, 77, 4, 4, 288, 288, False, 0, "float32", 0),      # two groups
        (2, 300, 300, 4, 4, 256, 256, True, 0, "bfloat16", 0),    # above 192
        (2, 300, 300, 8, 2, 136, 136, True, 0, "bfloat16", 1),    # misaligned
        (1, 64, 32, 2, 2, 200, 200, True, 0, "bfloat16", 0),      # keyless rows
    ])


@GENERAL_SHAPES
def test_flash_general_forward_matches_float64(cuda, B, Sq, Sk, H, KH, D, Dv,
                                               causal, window, dtype, offset):
    """The general forward, serving and with the lse: routed there, one
    launch of its entry a call, o within 2e-5 abs of float64
    `attention_ref` in f32 and one bf16 rounding (1.6e-2) in bf16, the lse
    within 1e-3 of float64 `attention_lse_ref` and exactly -1e30 on keyless
    rows, bitwise on a rerun.  Its plan (the entry's query, as the launch
    lint reads it): one block per (64-query tile, head, batch) for Dv <=
    192, ceil(Dv / 192) column groups above, and no spill."""
    from repro_torch.analysis.ir.launch_lint import (intercept_launches,
                                                    query_plans)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_lse_ref, ops
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(31)

    def rand(*shape):
        flat = torch.randn((math.prod(shape) + offset,), generator=g,
                           device=cuda).to(dt)
        return flat[offset:].view(shape)
    q, k, v = rand(B, Sq, H, D), rand(B, Sk, KH, D), rand(B, Sk, KH, Dv)
    aligned = ops.aligned16(D, Dv, (q, k, v))
    for grad in (False, True):
        assert ops.route(dt, D, Dv, aligned, grad).forward == ops.ANY_FWD
    scale = 1.0 / math.sqrt(D)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    ref = attention_ref(q64, k64, v64, causal=causal, window=window)
    lse_ref = attention_lse_ref(q64, k64, causal=causal, window=window)
    keyless = torch.zeros((Sq,), dtype=torch.bool, device=cuda)
    if causal and Sq > Sk:
        keyless[:Sq - Sk] = True
    tol = 2e-5 if dt == torch.float32 else 1.6e-2
    for with_lse in (False, True):
        runs, records = [], []
        before = _build.launches.flash_attention_fwd_any
        with intercept_launches(records):
            for _ in range(2):
                lse = torch.empty((B, H, Sq), device=cuda) if with_lse \
                    else None
                if with_lse:
                    o = ops._forward(q, k, v, causal, window, scale, lse,
                                     ops.ANY_FWD)
                else:
                    o = flash_attention(q, k, v, causal=causal, window=window)
                runs.append((o, lse))
        torch.cuda.synchronize()
        assert _build.launches.flash_attention_fwd_any == before + 2
        assert [r.entry for r in records] == [ops.ANY_FWD] * 2
        (o, lse), (o2, lse2) = runs
        assert o.shape == (B, Sq, H, Dv) and o.dtype == dt
        assert float((o.double() - ref).abs().max()) <= tol
        assert torch.equal(o, o2)
        if with_lse:
            assert float((lse.double() - lse_ref).abs().max()) <= 1e-3
            assert bool((lse[:, :, keyless] == -1e30).all())
            assert torch.equal(lse, lse2)
        plans = query_plans(records[0])
        assert len(plans) == 1 and plans[0].kernel == "flash_fwd_any"
        groups = -(-Dv // 192)
        assert plans[0].grid == (-(-Sq // 64) * groups * H * B, 1, 1)
        assert plans[0].local_bytes == 0


@pytest.mark.parametrize("D,Dv,dtype,tol", [
    (784, 784, "float32", 2e-5), (1680, 600, "bfloat16", 1.6e-2)])
def test_flash_general_forward_streams_q_past_shared_memory(cuda, D, Dv,
                                                            dtype, tol):
    """Past f32 D 768 and bf16 D 1664, Q and the ring do not fit in a
    block's shared memory together: each Q slab is staged beside its K slab
    (the plan asks for two stages of a K and a Q slab), with the same
    output: within 2e-5 abs of float64 in f32, one bf16 rounding in
    bf16, the lse within 1e-3."""
    from repro_torch.analysis.ir.launch_lint import (intercept_launches,
                                                    query_plans)
    from repro_torch.kernels.flash_attention import attention_lse_ref, ops
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(32)
    B, S, H = 1, 100, 2
    q, k = (torch.randn((B, S, H, D), generator=g, device=cuda).to(dt)
            for _ in range(2))
    v = torch.randn((B, S, H, Dv), generator=g, device=cuda).to(dt)
    lse = torch.empty((B, H, S), device=cuda)
    records = []
    with intercept_launches(records):
        o = ops._forward(q, k, v, True, 0, 1.0 / math.sqrt(D), lse,
                         ops.ANY_FWD)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    ref = attention_ref(q64, k64, v64)
    torch.cuda.synchronize()
    assert float((o.double() - ref).abs().max()) <= tol
    assert float((lse.double() - attention_lse_ref(q64, k64)).abs().max()) \
        <= 1e-3
    (plan,) = query_plans(records[0])
    ld = 64 + 16 // q.element_size()
    assert plan.dyn_smem == 2 * 2 * 64 * ld * q.element_size()
    assert plan.grid == (2 * -(-Dv // 192) * H * B, 1, 1)


@GENERAL_SHAPES
def test_flash_general_backward_matches_float64(cuda, B, Sq, Sk, H, KH, D, Dv,
                                                causal, window, dtype,
                                                offset):
    """The general unit's backward from the same o and lse: routed there,
    one launch of its entry, bitwise on a rerun, and its gradients within
    1e-4 abs of float64 autograd in f32, 2e-2 abs plus one bf16 rounding
    in bf16; dq of a keyless row exactly 0."""
    from repro_torch.kernels import _build, flash_attention_backward
    from repro_torch.kernels.flash_attention import attention_lse_ref, ops
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(30)

    def rand(*shape):
        flat = torch.randn((math.prod(shape) + offset,), generator=g,
                           device=cuda).to(dt)
        return flat[offset:].view(shape)
    q, k, v = rand(B, Sq, H, D), rand(B, Sk, KH, D), rand(B, Sk, KH, Dv)
    do = rand(B, Sq, H, Dv)
    assert ops.route(dt, D, Dv, ops.aligned16(D, Dv, (q, k, v)),
                     True).backward == ops.ANY_BWD
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    ref = attention_ref(q64, k64, v64, causal=causal, window=window)
    want = torch.autograd.grad(ref, (q64, k64, v64), do.double())
    o = ref.detach().to(dt).contiguous()
    lse = attention_lse_ref(q, k, causal=causal, window=window).float() \
        .contiguous()
    before = _build.launches.flash_attention_bwd_any
    got = flash_attention_backward(q, k, v, o, do, lse, causal=causal,
                                   window=window)
    again = flash_attention_backward(q, k, v, o, do, lse, causal=causal,
                                     window=window)
    assert _build.launches.flash_attention_bwd_any == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    rounding, tol = (0.0, 1e-4) if dt == torch.float32 else (2.0 ** -8, 2e-2)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dt
        assert float(((a.double() - b).abs() - rounding * b.abs()).max()) \
            <= tol
    if causal and Sq > Sk:
        assert bool((got[0][:, :Sq - Sk] == 0).all())


# the general SSD units (csrc/ssd_any.cu and ssd_bwd_any.cu): p or n above
# 64.  offset: x, B and C views start that many elements into their storage
GENERAL_SSD_SHAPES = pytest.mark.parametrize("b,s,h,p,n,xbc,dh,offset", [
    (4, 512, 80, 64, 128, True, False, 0),     # zamba2-2.7b at state 128, xBC views
    (4, 512, 80, 64, 128, False, False, 0),    # the same in f32
    (1, 500, 4, 96, 160, False, True, 0),      # ragged p 96 / n 160 / s 500
    (2, 200, 4, 64, 256, True, True, 0),       # n 256: 4 slabs, 2 chunks of 128
    (1, 130, 3, 80, 72, True, False, 1),       # bf16 views one element off 16 B
    (2, 40, 3, 72, 96, False, True, 0),        # shorter than a tile
    (1, 100, 2, 40, 1100, False, True, 0),     # n past RESIDENT_N: h in h_final
])


def _general_ssd_inputs(b, s, h, p, n, xbc, dh, offset, seed):
    """x, dt, A, B, C (bf16 views of one conv output, `offset` elements into
    its storage, or contiguous f32), dy and dh_final (or None)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -torch.exp(torch.rand((h,), generator=g, device="cuda"))
    if xbc:
        w = h * p
        flat = randn(b * s * (w + 2 * n) + offset).to(torch.bfloat16)
        buf = flat[offset:].view(b, s, w + 2 * n)
        x, B_, C_ = buf[..., :w].view(b, s, h, p), buf[..., w:w + n], \
            buf[..., w + n:]
    else:
        x, B_, C_ = randn(b, s, h, p), randn(b, s, n), randn(b, s, n)
    return (x, dt, A, B_, C_), randn(b, s, h, p), \
        randn(b, h, p, n) if dh else None


@GENERAL_SSD_SHAPES
def test_ssd_general_forward_matches_plain(cuda, b, s, h, p, n, xbc, dh,
                                           offset):
    """The general scan: routed there, one launch of `ssd_fwd_any` a call,
    y and h_final within 2e-4 abs + 1e-3 rel of `ssd_chunked` in float64
    at the longest chunk of at most 64 that divides s, bitwise on a rerun;
    the plan launches C B^T and the scan, and neither spills."""
    from repro_torch.analysis.ir.launch_lint import (intercept_launches,
                                                    query_plans)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.ops import general
    assert general(p, n)
    args, _, _ = _general_ssd_inputs(b, s, h, p, n, xbc, dh, offset, seed=41)
    records = []
    before = _build.launches.ssd_fwd_any
    with intercept_launches(records):
        (y, hf), (y2, hf2) = (ssd_scan(*args) for _ in range(2))
    torch.cuda.synchronize()
    assert _build.launches.ssd_fwd_any == before + 2
    assert [r.entry for r in records] == ["ssd_fwd_any"] * 2
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    chunk = max(c for c in range(1, 65) if s % c == 0)
    yr, hr = ssd_chunked(*(a.double() for a in args), chunk)
    for out, ref in ((y, yr), (hf, hr)):
        assert out.shape == ref.shape and out.dtype == torch.float32
        assert float(((out.double() - ref).abs()
                      - 1e-3 * ref.abs()).max()) <= 2e-4
    plans = query_plans(records[0])
    assert [pl.kernel for pl in plans] == ["ssd_cb_any", "ssd_scan_any"]
    assert all(pl.local_bytes == 0 and pl.active_blocks >= 1 for pl in plans)


@GENERAL_SSD_SHAPES
def test_ssd_general_backward_matches_float64(cuda, b, s, h, p, n, xbc, dh,
                                              offset):
    """The general scan's backward: one launch of `ssd_bwd_any` a call,
    bitwise on a rerun, each gradient within 1e-4 of its largest value of
    float64 autograd of `ssd_ref` (plus 2^-8 |ref| for the bf16 dx, dB and
    dC); the plan launches the tile scans, the states (past one tile), the
    tile terms and the group sums, and none spills."""
    from repro_torch.analysis.ir.launch_lint import (intercept_launches,
                                                    query_plans)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ssd_ref, ssd_scan_backward
    args, dy, dhf = _general_ssd_inputs(b, s, h, p, n, xbc, dh, offset,
                                        seed=42)
    records = []
    before = _build.launches.ssd_bwd_any
    with intercept_launches(records):
        got, again = (ssd_scan_backward(*args, dy, dhf) for _ in range(2))
    torch.cuda.synchronize()
    assert _build.launches.ssd_bwd_any == before + 2
    assert [r.entry for r in records] == ["ssd_bwd_any"] * 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ins = [a.detach().double().requires_grad_() for a in args]
    y64, h64 = ssd_ref(*ins)
    loss = (y64 * dy.double()).sum()
    if dh:
        loss = loss + (h64 * dhf.double()).sum()
    ref = torch.autograd.grad(loss, ins)
    x = args[0]
    for a, r, want in zip(got, ref, (x.dtype, torch.float32, torch.float32,
                                     x.dtype, x.dtype)):
        assert a.shape == r.shape and a.dtype == want
        tol = 1e-4 * float(r.abs().max())
        if a.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -8 * r.abs()
        assert bool(((a.double() - r).abs() <= tol).all())
    plans = query_plans(records[0])
    assert [pl.kernel for pl in plans] == (
        ["ssd_bwd_scan_any"] + (["ssd_bwd_state_any"] if s > 64 else [])
        + ["ssd_bwd_tile_any", "ssd_bwd_reduce_kernel"])
    assert all(pl.local_bytes == 0 and pl.active_blocks >= 1 for pl in plans)


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
def test_moe_smoke_card_matches_cpu(cuda, arch):
    """f32 SMOKE on the card against the CPU: the forward's logits and MoE
    losses and a prefill + 4 decode steps' logits 1e-4 relative, greedy
    tokens equal, `lm_loss`'s gradients 1e-4 relative per leaf."""
    from repro_torch.data import lm_batches
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.train.steps import _value_and_grad, lm_loss
    from repro_torch.tree import tree_leaves
    cfg, cpu, card = _smoke_pair(arch)
    t, y = (torch.from_numpy(a) for a in next(lm_batches(0, 4, 100,
                                                         cfg.vocab_size)))
    out = {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        with torch.no_grad():
            f, aux = forward(p, t.to(dev), cfg, with_aux=True)
            lg, cache = prefill(p, t.to(dev), cfg, 128)
            rows, tok = [lg[:, -1]], lg[:, -1].argmax(-1)
            for i in range(4):
                lg, cache = decode_step(p, tok, torch.full((4,), 100 + i,
                                                           device=dev),
                                        cache, cfg)
                rows.append(lg)
                tok = lg.argmax(-1)
        grads, _ = _value_and_grad(
            lambda q, _: lm_loss(q, t.to(dev), y.to(dev), cfg), p, None)
        out[dev] = (f, torch.stack(rows), grads, aux)
    assert _rel(out["cuda"][0], out["cpu"][0]) <= 1e-4
    assert _rel(out["cuda"][1], out["cpu"][1]) <= 1e-4
    for key in ("load_balance_loss", "router_z_loss"):
        assert _rel(out["cuda"][3][key], out["cpu"][3][key]) <= 1e-4
    assert torch.equal(out["cuda"][1].argmax(-1).cpu(),
                       out["cpu"][1].argmax(-1))
    for a, b in zip(tree_leaves(out["cuda"][2]), tree_leaves(out["cpu"][2])):
        assert _rel(a, b) <= 1e-4


# ---------------------------------------------------------------------------
# the analysis package on the card (repro_torch.analysis.ir)
# ---------------------------------------------------------------------------

def test_launch_lint_clean_over_every_entry_point(cuda):
    """Every C entry point driven at the main paths' shapes: no operand or
    plan finding, and every launch site reported."""
    from repro_torch.analysis.ir.launch_lint import lint_launches
    from repro_torch.kernels import _build
    res = lint_launches()
    assert res.issues == [], [i.message for i in res.issues]
    assert sorted(res.entries) == sorted(_build.ENTRIES)
    assert len({p.site for p in res.plans}) == 22


@pytest.mark.parametrize("arch", ["dit-xl", "dit-t2i"])
def test_warmup_verify_clean_on_the_smoke_engines(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import FasterCacheCFG
    from repro_torch.modalities import make_workload
    cfg = get_smoke_config(arch)
    wl = make_workload("t2i" if arch == "dit-t2i" else "image", cfg=cfg,
                       device=cuda)
    kw = ({"conditioner": wl.conditioner(seed=0)} if cfg.dit_text_len > 0
          else {})
    for policy in ("teacache", "taylorseer"):
        eng = wl.engine(policy, slots=4, max_steps=8,
                        cfg_policy=FasterCacheCFG(2, 8), **kw)
        eng.warmup(verify=True)
        assert eng.ir_findings == [], [
            (f.path, f.line, f.message) for f in eng.ir_findings]


def test_sync_channels_fire_on_injected_reads(cuda):
    from repro_torch.analysis.ir.op_checks import check_record, record_program
    x = torch.randn((64, 64), device=cuda)
    _, rec = record_program("inject", lambda: (x @ x).sum().cpu())
    assert [e.kind for e in rec.syncs] == ["dtoh"] and rec.sync_warnings
    _, rec = record_program("inject", lambda: (x @ x).sum().item())
    assert [e.kind for e in rec.syncs] == ["sync"] and rec.sync_warnings
    host = torch.tensor([1.0, 2.0])
    _, rec = record_program("inject", lambda: host.to(cuda) * x[0, :2])
    assert [e.kind for e in rec.syncs] == ["htod"] and rec.sync_warnings
    # a copy made inside tensor construction dispatches no operator the
    # recorder sees; torch's sync debug mode still does
    _, rec = record_program("inject", lambda: torch.as_tensor(
        [1.0, 2.0], device=cuda) * x[0, :2])
    assert rec.syncs == [] and rec.sync_warnings and check_record(rec)
    from repro_torch.device import to_device
    _, rec = record_program("clean", lambda: to_device(
        [1.0, 2.0], cuda) * x[0, :2])
    assert check_record(rec) == []


# ---------------------------------------------------------------------------
# CUDA graphs: every program captured per key replays as it runs eagerly
# ---------------------------------------------------------------------------

def _counts():
    from repro_torch.kernels import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def _snapshot(eng):
    from repro_torch.tree import tree_leaves
    return [t.clone() for t in [eng._xs, *tree_leaves(eng._states)]]


def _restore(eng, snap):
    from repro_torch.tree import tree_leaves
    for t, s in zip([eng._xs, *tree_leaves(eng._states)], snap):
        t.copy_(s)


@pytest.mark.parametrize("policy,cfg_policy", [("taylorseer", None),
                                               ("teacache", "fastercache")])
def test_graph_replay_equals_eager_per_key(cuda, policy, cfg_policy):
    """Every tick program of a warmed SMOKE engine, replayed on the inputs
    of the input class that captured it, writes the latents and states the
    same function writes eagerly on the same buffers (bitwise), and adds
    to the launch counters what the eager run launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import FasterCacheCFG
    from repro_torch.modalities import make_workload
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config("dit-xl")
    wl = make_workload("image", cfg=cfg, device=cuda)
    eng = wl.engine(policy, slots=4, max_steps=8,
                    cfg_policy=FasterCacheCFG(2, 8) if cfg_policy else None)
    eng.warmup()
    g = torch.Generator(device=cuda).manual_seed(0)
    seen = 0
    for key in eng._warmup_buckets():
        for c, u, st, _ in eng._tick_candidates(key):
            for name, a in (("want_c", c), ("want_u", u), ("steps", st)):
                eng._in.put(name, a)
            prog = eng._find_program(key)
            assert prog is not None and prog.graph is not None
            eng._xs.copy_(torch.randn(eng._xs.shape, generator=g,
                                      device=cuda))
            snap = _snapshot(eng)
            before = _counts()
            prog.run()
            torch.cuda.synchronize()
            replay = [t.clone() for t in [eng._xs,
                                          *tree_leaves(eng._states)]]
            launched = {k: n - before[k] for k, n in _counts().items()}
            _restore(eng, snap)
            before = _counts()
            prog.fn()
            torch.cuda.synchronize()
            assert {k: n - before[k] for k, n in _counts().items()} \
                == launched
            for a, b in zip(replay, [eng._xs, *tree_leaves(eng._states)]):
                assert torch.equal(a, b)
            seen += 1
    assert seen > 0


def test_graph_engine_serves_as_the_eager_one(cuda):
    """A warmed SMOKE engine (graphs) and an unwarmed one serve the same
    requests to bitwise-equal x0 with equal computed steps and equal
    launch counts, with no build, capture or cold program while serving."""
    from repro_torch.analysis.ir.retrace import RetraceSentinel
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import FasterCacheCFG
    from repro_torch.modalities import make_workload
    from repro_torch.serving.diffusion import DiffusionRequest
    cfg = get_smoke_config("dit-xl")
    wl = make_workload("image", cfg=cfg, device=cuda)
    reqs = [DiffusionRequest(i, num_steps=(6, 8)[i % 2], seed=i,
                             class_label=i % cfg.dit_num_classes,
                             cfg_scale=3.0 if i % 2 else 0.0)
            for i in range(6)]
    out = {}
    for warm in (False, True):
        eng = wl.engine("teacache", slots=4, max_steps=8,
                        cfg_policy=FasterCacheCFG(2, 8))
        if warm:
            eng.warmup()
        before = _counts()
        with RetraceSentinel() as sen:
            res = eng.serve(reqs)
        torch.cuda.synchronize()
        out[warm] = (res, {k: n - before[k] for k, n in _counts().items()},
                     sen.count)
    (eager, le, _), (graphs, lg, sentinel) = out[False], out[True]
    assert sentinel == 0 and lg == le
    for a, b in zip(graphs, eager):
        assert (a.record.computed_steps, a.record.uncond_computed_steps) \
            == (b.record.computed_steps, b.record.uncond_computed_steps)
        assert (a.x0 == b.x0).all()


def test_llm_graphs_match_eager_tokens(cuda):
    """tinyllama SMOKE: the captured prefill / decode give the greedy
    tokens and launch counts of a plain prefill / decode_step loop over
    the same chunks (two chunks through one static cache); a second
    generate captures nothing."""
    import numpy as np
    from repro_torch.analysis.ir.retrace import RetraceSentinel
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config("tinyllama-1.1b")
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                         device=cuda)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [11] * 12]
    eng = ServingEngine(params, cfg, slots=2, max_prompt=16, cache_len=64,
                        device=cuda)
    eng.generate(prompts, max_new_tokens=6)
    before = _counts()
    with RetraceSentinel() as sen:
        res = eng.generate(prompts, max_new_tokens=6)
    graphs = {k: n - before[k] for k, n in _counts().items()}
    assert sen.count == 0
    plain, before = [], _counts()
    with torch.no_grad():
        for chunk in (prompts[:2], prompts[2:]):
            toks = np.zeros((2, 16), np.int64)
            for row, p in enumerate(chunk):
                toks[row, -len(p):] = p
            logits, cache = prefill(params, torch.from_numpy(toks).to(cuda),
                                    cfg, 64, last_only=True)
            tok = logits[:, -1].argmax(-1)
            pos = torch.full((2,), 16, device=cuda)
            out = [tok]
            for _ in range(5):
                logits, cache = decode_step(params, tok, pos, cache, cfg)
                tok, pos = logits.argmax(-1), pos + 1
                out.append(tok)
            plain += torch.stack(out, 1).tolist()[:len(chunk)]
    torch.cuda.synchronize()
    eager = {k: n - before[k] for k, n in _counts().items()}
    assert [r.tokens for r in res] == plain and graphs == eager
    assert eng.programs["decode"].graph is not None
    assert eng.programs["prefill"].graph is not None


def test_train_loop_jit_matches_eager(cuda):
    """DiT-XL SMOKE: 4 steps of train_loop(jit=True) (step 1 eager, then
    the captured step) and jit=False from one state: params and moments
    within 1e-5 relative, equal launch counts."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.diffusion import linear_schedule
    from repro_torch.train.loop import train_loop
    from repro_torch.train.steps import (diffusion_batches, init_train_state,
                                         make_diffusion_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config("dit-xl")
    base = init_train_state(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    step = make_diffusion_train_step(cfg, linear_schedule(100), warmup=0,
                                     total_steps=4)
    out, counts = {}, {}
    for jit in (False, True):
        state = tree_map(lambda t: t.clone(), base)
        before = _counts()
        state, _ = train_loop(step, state, diffusion_batches(0, 4, cfg, cuda),
                              4, log_every=4, log_fn=lambda m: None, jit=jit)
        torch.cuda.synchronize()
        counts[jit] = {k: n - before[k] for k, n in _counts().items()}
        out[jit] = tree_leaves(state)
    assert counts[True] == counts[False]
    for a, b in zip(out[True], out[False]):
        a, b = a.double(), b.double()
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-30)
