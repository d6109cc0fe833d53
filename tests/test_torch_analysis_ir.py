"""repro_torch.analysis.ir: the operator records and their contract
checks, the donation check of the train loop, the retrace sentinel, the
launch lint's checks on synthetic captures, and the golden session held
against the JAX package's.

Every check gets a firing fixture and a matched clean one.  The JAX golden
context (about half a minute on the CPU) is built once, module-scoped; the
port's is cached per process.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import all_rules, get_rule
from repro_torch.analysis.base import NotRun
from repro_torch.analysis.ir import (DonationError, LaunchCapture, LaunchPlan,
                                     RetraceSentinel, check_capture,
                                     check_donation, check_plan, check_record,
                                     record_program, verify_programs_by_key)
from repro_torch.analysis.ir.golden import (build_golden_engines,
                                            golden_context, golden_requests)
from repro_torch.analysis.ir.launch_lint import ENTRY_ARGS
from repro_torch.obs.watch import host_read

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "kernels"


@pytest.fixture(scope="module")
def jax_golden():
    from repro.analysis.ir.golden import golden_context as jax_context
    ctx = jax_context()
    assert ctx.error == "", ctx.error
    return ctx


@pytest.fixture(scope="module")
def golden():
    ctx = golden_context("cpu")
    assert ctx.error == "", ctx.error
    return ctx


# ---------------------------------------------------------------------------
# operator records: host syncs, float64, priced reads
# ---------------------------------------------------------------------------

def _kinds(rec):
    return sorted({e.kind for e in rec.syncs})


@pytest.mark.parametrize("make,kind", [
    (lambda x: x.sum().item(), "sync"),
    (lambda x: float(x.max()), "sync"),
    (lambda x: bool(x.sum() > 0), "sync"),
    (lambda x: torch.nonzero(x > 0), "data-dependent"),
    (lambda x: x[x > 0], "data-dependent"),
    (lambda x: torch.unique(x), "data-dependent"),
])
def test_op_checks_fire_on_host_syncs(make, kind):
    x = torch.randn((4, 8), generator=torch.Generator().manual_seed(0))
    _, rec = record_program("fixture", lambda: make(x))
    assert kind in _kinds(rec)
    issues = check_record(rec)
    assert issues and all(i.category == "host-sync" for i in issues)
    # anchored on this file's line, so inline suppressions apply
    assert issues[0].file == __file__ and issues[0].line > 0


def test_op_checks_fire_on_a_float64_table():
    table = torch.as_tensor(np.linspace(0.0, 1.0, 8))     # float64 numpy
    _, rec = record_program("fixture", lambda: torch.ones(8) * table)
    issues = check_record(rec)
    assert [i.category for i in issues] == ["dtype"]
    assert "float64" in issues[0].message


def test_op_checks_silent_on_a_device_program():
    x = torch.randn((4, 8), generator=torch.Generator().manual_seed(0))
    _, rec = record_program(
        "fixture", lambda: torch.where(x > 0, x, 0.0).softmax(-1) @ x.T)
    assert check_record(rec) == [] and rec.ops >= 3


def test_priced_read_counts_once_and_is_no_sync():
    x = torch.randn((3, 5), generator=torch.Generator().manual_seed(0))
    _, rec = record_program("want", lambda: host_read(torch.stack([x, x])))
    assert rec.priced_reads == 1 and rec.syncs == []
    assert check_record(rec, priced_reads=1) == []
    assert [i.category for i in check_record(rec, priced_reads=0)] == \
        ["host-sync"]
    _, none = record_program("want", lambda: x * 2)
    assert "0 priced read" in check_record(none, priced_reads=1)[0].message


def test_recorder_sees_in_place_writes():
    a, b = torch.zeros(4), torch.zeros(4)
    _, rec = record_program("fixture", lambda: (a.add_(1), b + 1))
    assert a.untyped_storage().data_ptr() in rec.written
    assert b.untyped_storage().data_ptr() not in rec.written


# ---------------------------------------------------------------------------
# donation: the train step updates every leaf in place
# ---------------------------------------------------------------------------

def _train_setup():
    from repro_torch.configs import get_smoke_config
    from repro_torch.diffusion import linear_schedule
    from repro_torch.train.steps import (init_train_state,
                                         make_diffusion_train_step)
    cfg = get_smoke_config("dit-xl").reduced(
        num_layers=1, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    step = make_diffusion_train_step(cfg, linear_schedule(50), total_steps=5)
    batch = {"latents": torch.zeros((2, cfg.dit_tokens, cfg.dit_in_dim)),
             "labels": torch.zeros((2,), dtype=torch.long),
             "generator": torch.Generator().manual_seed(1)}
    return state, step, batch


def test_train_loop_verify_donation_passes_on_the_real_step():
    from repro_torch.train.loop import train_loop
    from repro_torch.tree import tree_leaves
    state, step, batch = _train_setup()
    before = [t.untyped_storage().data_ptr() for t in tree_leaves(state)]
    out, hist = train_loop(step, state, iter([batch, batch]), 2, log_every=1,
                           log_fn=lambda s: None, verify_donation=True)
    assert [t.untyped_storage().data_ptr() for t in tree_leaves(out)] \
        == before
    assert len(hist) == 2 and int(out.opt.step) == 2


def test_train_loop_verify_donation_raises_on_a_step_returning_copies():
    from repro_torch.train.loop import train_loop
    from repro_torch.train.steps import TrainState
    from repro_torch.tree import tree_map
    state, step, batch = _train_setup()

    def copying(s, b):
        s2, m = step(s, b)
        return TrainState(tree_map(lambda t: t.clone(), s2.params),
                          s2.opt), m

    with pytest.raises(DonationError, match="not updated in place"):
        train_loop(copying, state, iter([batch]), 1, log_every=1,
                   log_fn=lambda s: None, verify_donation=True)


def test_adamw_step_counter_is_updated_in_place():
    """The repair the donation check found: the step counter was a new
    tensor every step (a second copy of a state leaf)."""
    from repro_torch.optim.adamw import adamw_init, adamw_update
    params = {"w": torch.ones(3)}
    opt = adamw_init(params)
    (p2, o2), rec = record_program("opt", lambda: adamw_update(
        {"w": torch.ones(3)}, opt, params, lr=0.1))
    assert o2.step is opt.step and int(opt.step) == 1
    assert check_donation(rec, (params, opt), (p2, o2)) is None


# ---------------------------------------------------------------------------
# retrace sentinel
# ---------------------------------------------------------------------------

def test_sentinel_selftest_sees_both_channels():
    assert RetraceSentinel().selftest()


def test_sentinel_counts_a_load_and_a_cold_program_and_nests():
    import ctypes.util
    from repro_torch.kernels import _build
    engines = build_golden_engines("cpu")
    eng = engines["image"]
    req = [r for r in golden_requests() if r.modality == "image"][:1]
    with RetraceSentinel() as outer:
        with RetraceSentinel() as inner:
            eng.serve(req)                       # never warmed: cold keys
        _build._dlopen(ctypes.util.find_library("c") or "libc.so.6")
    assert inner.programs and not inner.builds
    assert outer.count == inner.count + 1 and outer.builds
    eng.warmup()
    with RetraceSentinel() as warm:
        eng.serve(req)
    assert warm.count == 0 and warm.ok


# ---------------------------------------------------------------------------
# the golden session against JAX's
# ---------------------------------------------------------------------------

def test_golden_session_matches_jax(golden, jax_golden):
    assert golden.requests_served == jax_golden.requests_served == 8
    assert golden.sentinel_live and golden.retrace_count == 0, \
        golden.retrace_names
    ours = golden.engines["t2i"].conditioner.stats
    theirs = jax_golden.engines["t2i"].conditioner.stats
    assert (ours["misses"], ours["hits"]) == (theirs["misses"],
                                              theirs["hits"]) == (3, 2)


def test_verified_program_keys_equal_jax(golden, jax_golden):
    for modality, eng in golden.engines.items():
        ours = verify_programs_by_key(eng)
        assert set(ours) == set(jax_golden.engines[modality].program_ir), \
            modality
        assert all(v == [] for v in ours.values())


def test_golden_programs_verify_clean(golden):
    assert golden.program_findings == [], [
        (f.rule, f.path, f.line, f.message) for f in golden.program_findings]
    for eng in golden.engines.values():
        assert eng.ir_findings == []
        assert eng.program_records
        for prof in eng.program_profile.values():
            assert prof.ir_findings == ()
            assert "ir_findings" not in prof.as_dict()


def test_second_verify_runs_no_program_and_plain_warmup_records_none():
    engines = build_golden_engines("cpu")
    eng = engines["image"]
    eng.warmup()
    assert eng.ir_findings is None and eng.program_records == {}
    calls = []
    tick = eng._tick
    eng._tick = lambda *a, **k: calls.append(1) or tick(*a, **k)
    eng.warmup(verify=True)
    n = len(calls)
    assert n > 0 and eng.ir_findings == []
    eng.warmup(verify=True)
    assert len(calls) == n


def test_mixed_warmup_verify_aggregates_findings():
    from repro_torch.modalities import MixedModalityEngine
    engines = build_golden_engines("cpu")
    mixed = MixedModalityEngine(engines)
    assert mixed.ir_findings is None
    mixed.warmup(verify=True)
    assert mixed.ir_findings == []
    # a float64 engine table shows up as a finding of its pool
    engines["image"]._ab = engines["image"]._ab.astype(np.float64)
    engines["image"].warmup(verify=True)
    mixed.warmup(verify=True)
    assert [f.rule for f in mixed.ir_findings] == ["ir-dtype"]
    assert "_ab" in mixed.ir_findings[0].message


def test_verify_finds_a_sync_injected_into_a_tick():
    engines = build_golden_engines("cpu")
    eng = engines["video"]
    tick = eng._tick

    def syncing(*a, **k):
        xs, states = tick(*a, **k)
        float(xs.abs().max())                   # a stray host read
        return xs, states

    eng._tick = syncing
    eng.warmup(verify=True)
    rules = {f.rule for f in eng.ir_findings}
    assert rules == {"ir-host-sync"}
    assert all(f.path == "tests/test_torch_analysis_ir.py"
               for f in eng.ir_findings)


# ---------------------------------------------------------------------------
# launch lint: checks on synthetic captures and plans
# ---------------------------------------------------------------------------

def _flash_capture(q, k, v, o, dtype_code=0):
    B, Sq, H, D = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dtype_code, B, Sq, k.shape[1], H, k.shape[2], D, 0, 0, 0.125)
    return LaunchCapture("flash_attention_fwd", args,
                         {"q": q, "k": k, "v": v, "o": o})


def _plan(**kw):
    base = dict(site="flash_attention.cu:480", kernel="flash_fwd",
                grid=(4, 16, 8), block=(128, 1, 1), dyn_smem=40960,
                regs=128, static_smem=0, local_bytes=0, max_threads=128,
                active_blocks=2, max_dyn_smem=40960, optin_smem=232448,
                regs_per_block=65536)
    base.update(kw)
    return LaunchPlan(**base)


def test_launch_capture_clean():
    t = [torch.zeros((2, 64, 4, 32)) for _ in range(4)]
    assert check_capture(_flash_capture(*t)) == []


def test_launch_capture_fires_on_a_misaligned_pointer():
    base = torch.zeros(2 * 64 * 4 * 32 + 1)
    q = base[1:].view(2, 64, 4, 32)              # 4 bytes off
    t = [torch.zeros((2, 64, 4, 32)) for _ in range(3)]
    issues = check_capture(_flash_capture(q, *t))
    assert any("16-byte alignment" in i.message for i in issues)


def test_launch_capture_fires_on_float64_and_mixed_dtypes():
    t = [torch.zeros((2, 64, 4, 32)) for _ in range(3)]
    issues = check_capture(_flash_capture(
        torch.zeros((2, 64, 4, 32), dtype=torch.float64), *t))
    msgs = " ".join(i.message for i in issues)
    assert "float64" in msgs and "mixed floating dtypes" in msgs


def test_launch_capture_fires_on_a_strided_operand_and_int32():
    q = torch.zeros((2, 4, 64, 32)).transpose(1, 2)     # not contiguous
    t = [torch.zeros((2, 64, 4, 32)) for _ in range(3)]
    cap = _flash_capture(q, *t)
    cap.args = cap.args[:6] + (2 ** 31,) + cap.args[7:]
    msgs = " ".join(i.message for i in check_capture(cap))
    assert "not contiguous" in msgs and "does not fit the C int" in msgs


def test_launch_plan_clean():
    assert check_plan(_plan()) == []


@pytest.mark.parametrize("kw,needle", [
    ({"grid": (4, 16, 70000)}, "grid y / z"),
    ({"block": (2048, 1, 1)}, "2048 threads"),
    ({"dyn_smem": 240000, "max_dyn_smem": 240000}, "opt-in"),
    ({"regs": 255, "block": (512, 1, 1), "max_threads": 1024},
     "registers x"),
    ({"active_blocks": 0}, "occupancy 0"),
])
def test_launch_plan_fires(kw, needle):
    issues = check_plan(_plan(**kw))
    assert any(needle in i.message for i in issues), issues


def test_entry_args_match_the_declared_argtypes():
    """ENTRY_ARGS names every C argument but the stream of each entry
    point, as `_build._declare` types them, and each has its query."""
    from repro_torch.kernels import _build

    class Fn:
        argtypes = restype = None

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            object.__setattr__(self, name, fn)
            return fn

    lib = Lib()
    _build._declare(lib)
    assert set(ENTRY_ARGS) == set(_build.ENTRIES)
    for entry in _build.ENTRIES:
        assert len(getattr(lib, entry).argtypes) == len(ENTRY_ARGS[entry]) + 1
        assert getattr(lib, entry + "_plan").argtypes == \
            getattr(lib, entry).argtypes


def test_every_launch_site_goes_through_the_plan_helper():
    """No raw <<< >>> launch is left in the sources, and every C entry
    point has its query entry."""
    from repro_torch.kernels import _build
    text = "".join(p.read_text() for p in KERNELS.glob("*/csrc/*.cu"))
    assert "<<<" not in text
    assert len(re.findall(r"PLAN_LAUNCH\(", text)) == 22
    for entry in _build.ENTRIES:
        assert re.search(rf'extern "C" int {entry}_plan\(', text), entry


# ---------------------------------------------------------------------------
# the ir-* rules
# ---------------------------------------------------------------------------

def test_ir_rules_registered_and_launch_not_run_on_cpu():
    ir = sorted(r.id for r in all_rules() if r.id.startswith("ir-"))
    assert ir == ["ir-const-bloat", "ir-donation", "ir-dtype",
                  "ir-host-sync", "ir-launch", "ir-retrace"]
    with pytest.raises(NotRun, match="CUDA"):
        get_rule("ir-launch").check_project(".", "cpu")
