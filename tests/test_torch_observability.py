"""The port's observability surface against the JAX package, on the CPU:
`TraceRecorder` (Chrome trace, cache-event JSONL, probes, the file round
trip through `signal_trace_from_files`), the engine's program profiles
(`program_profile` filled by `warmup`), `flops_per_row` against a hand
count, `redundancy_ratio`, and `profiler_trace`.

Both packages serve the same bridged weights at the SMALL DiT from JAX's
initial noise (through `noise_fn`) under TeaCache + FasterCacheCFG(3),
each thresholded TeaCache decision first checked >= 1e-4 relative from its
threshold.  Tolerances: event names, phases, tracks and counts exact; cache
events field for field, the signal within 1e-5 abs; FLOPs exact (products
only: the hand count is exact arithmetic); the redundancy ratio equal."""
import json
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import FasterCacheCFG as JaxFasterCacheCFG  # noqa: E402
from repro.core import make_policy as jax_make_policy  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import perturb_zero_init as jax_perturb  # noqa: E402
from repro.obs import ProgramProfile as JaxProfile  # noqa: E402
from repro.obs import TraceRecorder as JaxRecorder  # noqa: E402
from repro.obs import redundancy_ratio as jax_redundancy  # noqa: E402
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import \
    DiffusionServingEngine as JaxEngine  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FasterCacheCFG, make_policy  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.obs import (ProgramProfile, TraceRecorder,  # noqa: E402
                             count_flops, flops_per_row, load_cache_events,
                             policy_signature, profiler_trace,
                             redundancy_ratio, signal_trace_from_files,
                             validate_chrome_trace)
from repro_torch.serving.control import SignalTraceLog  # noqa: E402
from repro_torch.serving.diffusion import (DiffusionRequest,  # noqa: E402
                                           DiffusionServingEngine)

NUM_STEPS = 8
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
             dit_patch_tokens=8, dit_in_dim=4, dit_num_classes=10)
TEACACHE_DELTA = 0.5
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("dit-xl").reduced(**SMALL)
    tcfg = get_config("dit-xl").reduced(**SMALL)
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _jax_noise(cfg):
    def noise_fn(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (cfg.dit_tokens, cfg.dit_in_dim))))
    return noise_fn


def _requests(cls, n=5):
    """Budgets 8 and 6 alternating, requests 0, 1 and 3 guided; 5 requests
    through 2 slots, so slots are refilled."""
    return [cls(i, num_steps=(NUM_STEPS, NUM_STEPS - 2)[i % 2], seed=i,
                class_label=i % 5, cfg_scale=2.5 if i in (0, 1, 3) else 0.0)
            for i in range(n)]


@pytest.fixture(scope="module")
def recorded(setup):
    """One served queue per package under TeaCache + FasterCacheCFG(3),
    each with a probing TraceRecorder (the port's also with a
    SignalTraceLog); JAX's plan margins recorded."""
    jcfg, tcfg, jp, tp = setup
    jeng = JaxEngine(jp, jcfg, jax_make_policy("teacache",
                                               delta=TEACACHE_DELTA),
                     slots=2, max_steps=NUM_STEPS,
                     cfg_policy=JaxFasterCacheCFG(3, NUM_STEPS))
    teng = DiffusionServingEngine(
        tp, tcfg, make_policy("teacache", delta=TEACACHE_DELTA), slots=2,
        max_steps=NUM_STEPS, cfg_policy=FasterCacheCFG(3, NUM_STEPS),
        noise_fn=_jax_noise(tcfg), device="cpu")
    margins = []

    def on_tick(ev):
        if ev.metric is not None:
            margins.extend(abs(float(ev.metric[s]) - TEACACHE_DELTA)
                           / TEACACHE_DELTA
                           for s in np.nonzero(ev.active)[0])

    jrec = JaxRecorder(jeng.policy, probe_every=2)
    trec = TraceRecorder(teng.policy, probe_every=2)
    tlog = SignalTraceLog(probe_every=2)
    jres = jeng.serve(_requests(JaxRequest), hooks=[jrec, on_tick],
                      capture_latents=True)
    tres = teng.serve(_requests(DiffusionRequest), hooks=[trec, tlog.observe],
                      capture_latents=True)
    return jrec, trec, tlog, jres, tres, teng, margins


def _shape(events):
    """(ph, name, pid, tid) of every non-plan event, in order."""
    return [(e["ph"], e["name"], e["pid"], e["tid"]) for e in events
            if e.get("cat") != "plan"]


def test_trace_recorder_matches_jax(recorded):
    """The same Chrome events (names, phases, tracks, order, counts; plan
    spans at most one a tick) and cache events field for field, the signal
    within 1e-5 abs; both traces validate."""
    jrec, trec, _, jres, tres, _, margins = recorded
    assert margins and min(margins) >= MARGIN
    jrec.finish()
    trec.finish()
    assert _shape(trec.events) == _shape(jrec.events)
    n_plan = sum(e.get("cat") == "plan" for e in trec.events)
    assert 0 < n_plan <= trec.ticks_seen == jrec.ticks_seen
    for a, b in zip([e for e in trec.events if e.get("cat") != "plan"],
                    [e for e in jrec.events if e.get("cat") != "plan"]):
        aa, ba = dict(a.get("args", {})), dict(b.get("args", {}))
        sa, sb = aa.pop("signal", None), ba.pop("signal", None)
        assert aa == ba
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert abs(sa - sb) <= 1e-5
    assert len(trec.cache_events) == len(jrec.cache_events) > 0
    for a, b in zip(trec.cache_events, jrec.cache_events):
        a, b = dict(a), dict(b)
        sa, sb = a.pop("signal"), b.pop("signal")
        assert a == b
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert abs(sa - sb) <= 1e-5
    assert validate_chrome_trace(trec.chrome_trace()) == []
    assert validate_chrome_trace(jrec.chrome_trace()) == []
    assert trec.chrome_trace()["otherData"] == jrec.chrome_trace()["otherData"]
    assert trec.computed_steps_by_request() == \
        jrec.computed_steps_by_request() == \
        {r.request_id: r.record.computed_steps for r in tres}
    assert trec.uncond_steps_by_request() == \
        {r.request_id: r.record.uncond_computed_steps for r in tres}
    assert sorted(trec.probes) == sorted(jrec.probes)


def test_trace_files_round_trip(recorded, tmp_path):
    """write_chrome_trace / write_cache_events / write_probes, then
    signal_trace_from_files: the rebuilt log's entries and probes equal the
    in-memory SignalTraceLog's; a broken trace is reported."""
    _, trec, tlog, *_ = recorded
    trec.write_chrome_trace(str(tmp_path / "trace.json"))
    trec.write_cache_events(str(tmp_path / "events.jsonl"))
    trec.write_probes(str(tmp_path / "probes.npz"))
    with open(tmp_path / "trace.json") as f:
        assert validate_chrome_trace(json.load(f)) == []
    assert load_cache_events(str(tmp_path / "events.jsonl")) == \
        json.loads(json.dumps(trec.cache_events))
    log = signal_trace_from_files(str(tmp_path / "events.jsonl"),
                                  str(tmp_path / "probes.npz"))
    assert isinstance(log, SignalTraceLog)
    assert list(log.entries) == list(tlog.entries)
    assert sorted(log.probes) == sorted(tlog.probes)
    for rid, p in log.probes.items():
        q = tlog.probes[rid]
        assert (p["label"], p["steps"], p["tvals"]) == \
            (q["label"], q["steps"], q["tvals"])
        np.testing.assert_array_equal(np.stack(p["xs"]), np.stack(q["xs"]))
    bad = {"traceEvents": [{"ph": "B", "name": "a", "pid": 1, "tid": 2,
                            "ts": 5.0},
                           {"ph": "X", "name": "b", "pid": 1, "tid": 2,
                            "ts": 1.0, "dur": 1.0}]}
    problems = validate_chrome_trace(bad)
    assert any("backwards" in p for p in problems)
    assert any("unclosed" in p for p in problems)


def test_policy_signature_matches_jax():
    from repro.obs import policy_signature as jax_signature
    for jp, tp in ((None, None), ("fora", "fora"),
                   (jax_make_policy("teacache", delta=0.3),
                    make_policy("teacache", delta=0.3)),
                   (jax_make_policy("fora", interval=2),
                    make_policy("fora", interval=2))):
        assert policy_signature(tp) == jax_signature(jp)


# ----------------------------------------------------------------------
# program profiles
# ----------------------------------------------------------------------

def _hand_flops_per_row(cfg):
    """Products a backbone row computes (2 per multiply-add): patch in and
    out, the timestep MLP, each layer's AdaLN, QKV and output projections,
    the attention's two products and the MLP, the final AdaLN."""
    d, T, L, f, c = (cfg.d_model, cfg.dit_tokens, cfg.num_layers,
                     cfg.d_ff, cfg.dit_in_dim)
    layer = 2 * d * 6 * d + 4 * 2 * T * d * d + 4 * T * T * d \
        + 2 * 2 * T * d * f
    return 2 * T * c * d + 2 * 2 * d * d + L * layer + 2 * d * 2 * d \
        + 2 * T * d * c


@pytest.fixture(scope="module")
def profiled(setup):
    _, tcfg, _, tp = setup
    eng = DiffusionServingEngine(tp, tcfg, make_policy("teacache"), slots=2,
                                 max_steps=NUM_STEPS, device="cpu")
    runs = eng.warmup()
    first = dict(eng.program_profile)
    again = eng.warmup()
    return eng, runs, again, first


def test_warmup_profiles_every_program(profiled):
    """warmup still returns the buckets; program_profile holds one profile
    per bucket plus "want" (TeaCache plans on the device): FLOPs rise
    strictly with the bucket, every bucket with rows and the plan pass
    count products (the skip program's TeaCache reuse has none), bytes are
    nan, first-run seconds positive; a second warmup leaves them as they
    are."""
    eng, runs, again, first = profiled
    assert runs == again == [0, 1, 2, 4]
    prof = eng.program_profile
    assert set(prof) == {0, 1, 2, 4, "want"}
    flops = [prof[b].flops for b in (0, 1, 2, 4)]
    assert flops == sorted(set(flops)) and flops[0] == 0.0
    assert all(f > 0 for f in flops[1:]) and prof["want"].flops > 0
    for key, p in prof.items():
        assert isinstance(p, ProgramProfile) and p.key == key
        assert math.isnan(p.bytes_accessed) and p.compile_seconds > 0
        assert p is first[key]
    assert set(prof[1].as_dict()) == set(JaxProfile(1, 0.0, 0.0,
                                                    0.0).as_dict())


def test_flops_per_row_is_the_hand_count(profiled, setup):
    """The marginal FLOPs per row equal the reduced model's hand count
    exactly, and each bucket's FLOPs are the bucket times it (the compact
    tick adds no product)."""
    _, tcfg, _, _ = setup
    eng = profiled[0]
    hand = _hand_flops_per_row(tcfg)
    assert flops_per_row(eng.program_profile) == hand
    for b in (1, 2, 4):
        assert eng.program_profile[b].flops == b * hand


def test_dense_and_host_planned_profiles(setup):
    """The dense engine profiles its three kinds (full = 2S rows, cond = S
    rows); a host-planned policy (TaylorSeer) has no "want" program, as in
    JAX."""
    _, tcfg, _, tp = setup
    hand = _hand_flops_per_row(tcfg)
    dense = DiffusionServingEngine(tp, tcfg, make_policy("teacache"),
                                   slots=2, max_steps=NUM_STEPS,
                                   row_compaction=False, device="cpu")
    assert dense.warmup() == ["full", "cond", "skip"]
    p = dense.program_profile
    assert set(p) == {"full", "cond", "skip", "want"}
    assert p["full"].flops == 4 * hand and p["cond"].flops == 2 * hand
    host = DiffusionServingEngine(tp, tcfg, "taylorseer", slots=2,
                                  max_steps=NUM_STEPS, device="cpu")
    host.warmup()
    assert set(host.program_profile) == {0, 1, 2, 4}


@pytest.mark.parametrize("rows", [(48, 12, 30), (10, 0, 0), (5, 3, 1),
                                  (0, 0, 0)])
def test_redundancy_ratio_matches_jax(rows):
    """For the same profiles and telemetry rows, JAX's ratio; nan without
    a row or without a priced bucket."""
    flops = {0: 1.5e3, 1: 2e6, 2: 4e6, 4: 8.0005e6, "want": 7.0}
    tprof = {k: ProgramProfile(k, 0.1, v, math.nan) for k, v in flops.items()}
    jprof = {k: JaxProfile(k, 0.1, v, math.nan) for k, v in flops.items()}
    got, want = redundancy_ratio(tprof, *rows), jax_redundancy(jprof, *rows)
    assert set(got) == set(want)
    for k in got:
        assert (got[k] == want[k]) or (math.isnan(got[k])
                                       and math.isnan(want[k])), k
    assert math.isnan(flops_per_row({"want": tprof["want"]}))


def test_count_flops_sees_the_attention_products():
    """On CPU tensors the flash wrapper runs attention_ref, whose two
    products FlopCounterMode counts as 4*B*H*Sq*Sk*D; the kernel's own
    counter moves only on the card."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 16, 4, 8), generator=g) for _ in range(3))
    before = flash_attention.flops
    n = count_flops(lambda: flash_attention(q, k, v, causal=False))
    assert n == 4 * 2 * 4 * 16 * 16 * 8
    assert count_flops(lambda: attention_ref(q, k, v, causal=False)) == n
    assert flash_attention.flops == before


def test_profiler_trace(tmp_path):
    """A strict no-op without a directory; with one, a Chrome trace file."""
    with profiler_trace(None):
        torch.ones(4).sum()
    with profiler_trace(""):
        pass
    out = tmp_path / "prof"
    with profiler_trace(str(out)):
        (torch.ones((8, 8)) @ torch.ones((8, 8))).sum()
    files = list(out.iterdir())
    assert len(files) == 1
    with open(files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_monotonic_ns_is_integer_and_never_goes_back():
    """obs.monotonic_ns (JAX's repro.obs.monotonic_ns): integer
    nanoseconds on the monotonic clock's axis, never decreasing."""
    from repro.obs import monotonic_ns as jax_monotonic_ns
    from repro_torch.obs import monotonic, monotonic_ns
    ticks = [monotonic_ns() for _ in range(1000)]
    assert all(isinstance(t, int) for t in ticks)
    assert all(b >= a for a, b in zip(ticks, ticks[1:]))
    s, ns = monotonic(), monotonic_ns()
    assert abs(ns / 1e9 - s) < 1.0           # one axis with monotonic()
    assert isinstance(jax_monotonic_ns(), int)
