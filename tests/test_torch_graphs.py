"""The port's compiled programs on the CPU: every program the card captures
in a CUDA graph (`repro_torch.obs.profiling.compile_program`) runs here as
the same function over the same static buffers.

For each compiled key of a SMOKE image engine (TaylorSeer; TeaCache with
FasterCacheCFG), a t2i engine, the LLM decode and the train step: two runs
through the static buffers with two different inputs of one branch class
dispatch the same aten operators (names, shapes, dtypes under
`OpRecorder`), make no tensor from host data, and give bitwise the
results of the eager functions called with fresh arguments.  A warmed
engine still serves within the JAX engine's bounds (1e-4 abs / 1e-3 rel,
the same decisions).  Also: `forecast_basis` with steps on the device
against host steps, the three capture rules on fixtures and on
`src/repro_torch`, and the retrace sentinel's capture channel.

JAX is compiled only by the module-scoped JAX engine fixture."""
import os
import textwrap

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
from repro.serving.diffusion import DiffusionRequest as JaxRequest  # noqa: E402
from repro.serving.diffusion import \
    DiffusionServingEngine as JaxEngine  # noqa: E402
from repro.serving.diffusion import request_noise_key  # noqa: E402
from repro_torch.analysis.base import get_rule  # noqa: E402
from repro_torch.analysis.ir.op_checks import (check_const_bloat,  # noqa: E402
                                               record_program)
from repro_torch.analysis.ir.retrace import RetraceSentinel  # noqa: E402
from repro_torch.analysis.runner import run_analysis  # noqa: E402
from repro_torch.analysis.source import ModuleSource  # noqa: E402
from repro_torch.analysis.ir.verify import engine_declared  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.conditioning.encoder import (encode_tokens,  # noqa: E402
                                              pooled_embedding, tokenize)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import FasterCacheCFG, make_policy  # noqa: E402
from repro_torch.device import Staged  # noqa: E402
from repro_torch.diffusion import linear_schedule  # noqa: E402
from repro_torch.kernels.forecast import forecast_basis  # noqa: E402
from repro_torch.modalities import make_workload  # noqa: E402
from repro_torch.obs.profiling import (compile_program,  # noqa: E402
                                       program_cost)
from repro_torch.models import (decode_step, dit,  # noqa: E402
                                 init_params, prefill)
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.diffusion import (DiffusionRequest,  # noqa: E402
                                           DiffusionServingEngine,
                                           compact_rows)
from repro_torch.train.loop import StepProgram  # noqa: E402
from repro_torch.train.steps import (diffusion_batches,  # noqa: E402
                                     init_train_state,
                                     make_diffusion_train_step)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 4


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _tick_inputs(rng, c, u, steps, shift):
    """One tick's host values at the masks (c, u) and steps; `shift`
    moves every value but keeps each branch class (steps by 12, a
    multiple of every interval here)."""
    return {"want_c": c, "want_u": u, "steps": steps + 12 * shift,
            "tvals": rng.uniform(0, 999, S).astype(np.float32),
            "cfg_ws": rng.uniform(0, 1, S).astype(np.float32),
            "ab_t": rng.uniform(0.1, 0.9, S).astype(np.float32),
            "ab_n": rng.uniform(0.1, 0.9, S).astype(np.float32)}


def _check_engine(eng):
    """Every compiled tick program of a warmed engine: two inputs of its
    class, the same operators, no host data, and the static run bitwise
    equal to `_tick` on fresh arguments.  Returns the programs checked."""
    rng = np.random.default_rng(0)
    declared = engine_declared(eng)
    checked = set()
    for key in eng._warmup_buckets():
        for c, u, st, (ac, au) in eng._tick_candidates(key):
            for name, a in (("want_c", c), ("want_u", u), ("steps", st)):
                eng._in.put(name, a)
            prog = eng._find_program(key)
            if id(prog) in checked:
                continue
            checked.add(id(prog))
            seqs = []
            for shift in (0, 1):
                inp = _tick_inputs(rng, c, u, st, shift)
                for name, a in inp.items():
                    eng._in.put(name, a)
                gather = None
                if key:
                    b, *gather = compact_rows(ac, au, S)
                    assert b == key
                    eng._put_rows(key, gather)
                eng._xs.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(eng._xs.shape)).astype(np.float32)))
                xs0, st0 = eng._xs.clone(), _clone(eng._states)
                _, rec = record_program(key, prog.fn)
                assert rec.host_data == []
                assert check_const_bloat(rec, declared) == []
                seqs.append(rec.sequence)
                want_xs, want_st = eng._tick(
                    "full" if key else "skip", gather, st0, inp["steps"],
                    xs0, inp["tvals"], inp["cfg_ws"], inp["ab_t"],
                    inp["ab_n"], eng._in.dev["null_vecs"].clone(),
                    eng._in.dev["null_mask"].clone(), _clone(eng._txt),
                    c, u, eng._signal)
                assert torch.equal(eng._xs, want_xs)
                for a, b in zip(tree_leaves(eng._states),
                                tree_leaves(want_st)):
                    assert torch.equal(a, b)
            assert seqs[0] == seqs[1] and len(seqs[0]) > 0
    return checked


@pytest.fixture(scope="module")
def image_wl():
    return make_workload("image", cfg=get_smoke_config("dit-xl"),
                         device="cpu")


@pytest.mark.parametrize("policy,guided", [("taylorseer", False),
                                           ("teacache", True)])
def test_image_engine_programs_replay_as_eager(image_wl, policy, guided):
    eng = image_wl.engine(policy, slots=S, max_steps=8,
                          cfg_policy=FasterCacheCFG(2, 8) if guided else None)
    eng.warmup()
    progs = _check_engine(eng)
    assert len(progs) == eng.graph_stats()["programs"] - ("want" in
                                                          eng._programs)
    cost = program_cost(eng.program_profile[1])
    assert cost["flops"] == eng.program_profile[1].flops > 0
    assert np.isnan(cost["bytes_accessed"])
    if "want" in eng._programs:
        # the device half of the plan: the same packed rows as fresh
        prog = eng._programs["want"][0][1]
        steps = np.array([0, 1, 2, 3], np.int32)
        eng._in.put("steps", steps)
        eng._in.put("tvals", np.full(S, 500.0, np.float32))
        _, rec = record_program("want", prog.fn)
        assert rec.host_data == []
        packed, _ = eng._want.device(_clone(eng._states), steps,
                                     eng._xs.clone(),
                                     np.full(S, 500.0, np.float32),
                                     eng._labels)
        assert torch.equal(eng._plan_buf, packed)


def test_t2i_engine_programs_replay_as_eager():
    wl = make_workload("t2i", cfg=get_smoke_config("dit-t2i"), device="cpu")
    cond = wl.conditioner(seed=0)
    eng = wl.engine("taylorseer", slots=S, max_steps=8,
                    cfg_policy=FasterCacheCFG(2, 8), conditioner=cond)
    eng.warmup()
    assert {"text_kv", "text_encoder"} <= set(eng.program_profile)
    _check_engine(eng)
    # text_kv: the static tables equal text_kv of fresh embeddings
    rng = np.random.default_rng(1)
    host = rng.standard_normal(eng._txt_host.shape).astype(np.float32)
    host[..., -1] = rng.uniform(size=host.shape[:-1]) > 0.5
    eng._txt_host[...] = host
    _, rec = record_program("text_kv", lambda: eng._build_text_tables())
    packed = torch.from_numpy(host)
    tm = packed[..., -1] > 0.5
    tk, tv = dit.text_kv(eng.params, torch.where(tm[..., None],
                                                 packed[..., :-1], 0.0),
                         eng.cfg)
    assert torch.equal(eng._txt["k"], tk) and torch.equal(eng._txt["v"], tv)
    # the encoder program: two prompts, one operator sequence
    seqs = []
    for text in ("a red fox", "two blue birds on a wire"):
        ids, mask = tokenize(text, cond.tc)
        cond._in.put("ids", ids[None])
        cond._in.put("mask", mask[None])
        _, rec = record_program("text_encoder", cond._program.fn)
        assert rec.host_data == []
        seqs.append(rec.sequence)
        tid, tm = torch.from_numpy(ids[None]), torch.from_numpy(mask[None])
        emb = encode_tokens(cond.params, tid, tm, cond.tc)
        assert torch.equal(cond._out, torch.cat(
            [emb[0], pooled_embedding(emb, tm)], dim=0).float())
    assert seqs[0] == seqs[1]


def _plain_greedy(params, cfg, prompts, max_prompt, cache_len, new):
    """Greedy tokens of a plain prefill / decode_step loop over one chunk
    of right-aligned prompts (full-window logits, a cache of its own)."""
    toks = np.zeros((len(prompts), max_prompt), np.int64)
    for row, p in enumerate(prompts):
        toks[row, -len(p):] = p
    with torch.no_grad():
        logits, cache = prefill(params, torch.from_numpy(toks), cfg,
                                cache_len)
        tok = logits[:, -1].argmax(-1)
        pos = torch.full((len(prompts),), max_prompt)
        out = [tok]
        for _ in range(new - 1):
            logits, cache = decode_step(params, tok, pos, cache, cfg)
            tok, pos = logits.argmax(-1), pos + 1
            out.append(tok)
    return torch.stack(out, 1).tolist()


def test_llm_decode_program_replays_as_eager():
    cfg = get_smoke_config("tinyllama-1.1b")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServingEngine(params, cfg, slots=2, max_prompt=8, cache_len=32,
                        device="cpu")
    prompts = [[3, 4, 5], [6, 7, 8, 9]]
    res = eng.generate(prompts, max_new_tokens=4)
    assert _plain_greedy(params, cfg, prompts, 8, 32, 4) == \
        [r.tokens for r in res]
    prog = eng.programs["decode"]
    seqs = []
    for tok in ([5, 9], [17, 2]):
        eng._tok.copy_(torch.tensor(tok))
        cache0, pos0 = _clone(eng._cache), eng._pos.clone()
        _, rec = record_program("decode", prog.fn)
        assert rec.host_data == []
        seqs.append(rec.sequence)
        with torch.no_grad():
            logits, cache = decode_step(params, torch.tensor(tok), pos0,
                                        cache0, cfg)
        assert torch.equal(eng._logits, logits)
        assert torch.equal(eng._pos, pos0 + 1)
        for a, b in zip(tree_leaves(eng._cache), tree_leaves(cache)):
            assert torch.equal(a, b)
    assert seqs[0] == seqs[1]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_llm_prefill_program_fills_the_static_cache(arch):
    """The prefill program over two prompt windows: the same operators, no
    host data, the static cache (written in place over a used one) and the
    last position's logits bitwise those of a fresh eager prefill."""
    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServingEngine(params, cfg, slots=2, max_prompt=8, cache_len=32,
                        device="cpu")
    eng.generate([[3, 4, 5], [6, 7, 8, 9]], max_new_tokens=3)
    static = [t.data_ptr() for t in tree_leaves(eng._cache)]
    prog = eng.programs["prefill"]
    seqs = []
    for window in ([[0, 0, 0, 0, 0, 3, 4, 5], [0, 0, 0, 0, 6, 7, 8, 9]],
                   [[0, 0, 1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0, 0, 0, 9]]):
        eng._in.put("toks", np.asarray(window, np.int64))
        _, rec = record_program("prefill", prog.fn)
        assert rec.host_data == []
        seqs.append(rec.sequence)
        with torch.no_grad():
            full, cache = prefill(params, torch.tensor(window), cfg, 32)
            last, _ = prefill(params, torch.tensor(window), cfg, 32,
                              last_only=True)
        assert torch.equal(eng._logits, last[:, -1])
        # the last row's product alone: f32 rounding of another GEMM shape
        assert torch.allclose(last[:, -1], full[:, -1], rtol=1e-5, atol=1e-5)
        assert [t.data_ptr() for t in tree_leaves(eng._cache)] == static
        for a, b in zip(tree_leaves(eng._cache), tree_leaves(cache)):
            assert torch.equal(a, b)
        assert torch.equal(eng._pos, torch.full((2,), 8))
    assert seqs[0] == seqs[1]


def test_train_step_program_replays_as_eager():
    cfg = get_smoke_config("dit-xl")
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    step = make_diffusion_train_step(cfg, linear_schedule(100), warmup=0,
                                     total_steps=4)
    it = diffusion_batches(0, 2, cfg, "cpu")
    first = step.prepare_batch(next(it))
    state, metrics = step(state, first)
    prog = StepProgram(step, state, first, metrics)
    seqs = []
    for batch in (step.prepare_batch(next(it)), step.prepare_batch(next(it))):
        fresh = _clone(state)
        want, m = step(fresh, _clone(batch))
        _, rec = record_program("train", lambda: prog(batch))
        assert rec.host_data == []
        seqs.append(rec.sequence)
        for a, b in zip(tree_leaves(state), tree_leaves(want)):
            assert torch.equal(a, b)
        assert torch.equal(prog.metrics["loss"], m["loss"])
    assert seqs[0] == seqs[1]


# ---------------------------------------------------------------------------
# a warmed engine against the JAX engine
# ---------------------------------------------------------------------------

SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
             dit_patch_tokens=8, dit_in_dim=4, dit_num_classes=10)


def test_warmed_engine_serves_within_the_jax_bounds():
    """TeaCache + FasterCacheCFG(3) at the SMALL DiT, 5 requests through 2
    slots: the warmed port engine against the JAX engine, the same
    decisions and rows, x0 within 1e-4 abs / 1e-3 rel."""
    jcfg = jax_get_config("dit-xl").reduced(**SMALL)
    tcfg = get_config("dit-xl").reduced(**SMALL)
    jp = jax_perturb(jax_init_params(jax.random.PRNGKey(0), jcfg))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")

    def noise(req):
        key = request_noise_key(JaxRequest(req.request_id, req.num_steps,
                                           seed=req.seed))
        return torch.from_numpy(np.array(jax.random.normal(
            key, (tcfg.dit_tokens, tcfg.dit_in_dim))))

    def reqs(cls):
        return [cls(i, num_steps=(8, 6)[i % 2], seed=i, class_label=i % 5,
                    cfg_scale=2.5 if i in (0, 1, 3) else 0.0)
                for i in range(5)]

    jeng = JaxEngine(jp, jcfg, jax_make_policy("teacache", delta=0.5),
                     slots=2, max_steps=8, cfg_policy=JaxFasterCacheCFG(3, 8))
    teng = DiffusionServingEngine(tp, tcfg, make_policy("teacache",
                                                        delta=0.5),
                                  slots=2, max_steps=8,
                                  cfg_policy=FasterCacheCFG(3, 8),
                                  noise_fn=noise, device="cpu")
    teng.warmup()
    jres = jeng.serve(reqs(JaxRequest))
    with RetraceSentinel() as sen:
        tres = teng.serve(reqs(DiffusionRequest))
    assert sen.count == 0
    for a, b in zip(tres, jres):
        assert (a.record.computed_steps, a.record.uncond_computed_steps) == \
            (b.record.computed_steps, b.record.uncond_computed_steps)
        np.testing.assert_allclose(a.x0, b.x0, atol=1e-4, rtol=1e-3)
    for f in ("backbone_rows_computed", "backbone_rows_padding",
              "uncond_rows_computed", "ticks_full", "ticks_cond",
              "ticks_skip"):
        assert getattr(teng.telemetry, f) == getattr(jeng.telemetry, f), f


# ---------------------------------------------------------------------------
# forecast_basis reads its steps from the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("basis", ["taylor", "hermite", "foca"])
def test_forecast_basis_device_steps_equal_host_steps(basis):
    rng = np.random.default_rng(2)
    d = torch.from_numpy(rng.standard_normal((4, 3, 64)).astype(np.float32))
    last = torch.tensor([0, 1, 0, 4], dtype=torch.int32)
    nv = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    steps = np.array([1, 3, 5, 6])
    host = forecast_basis(d, steps, last, nv, 4, basis)
    dev = forecast_basis(d, torch.from_numpy(steps.astype(np.int32)), last,
                         nv, 4, basis)
    staged = forecast_basis(d, Staged(steps, torch.from_numpy(
        steps.astype(np.int32)), ("steps",)), last, nv, 4, basis)
    assert torch.equal(host, dev) and torch.equal(host, staged)


# ---------------------------------------------------------------------------
# the capture rules and the sentinel's capture channel
# ---------------------------------------------------------------------------

def _lint(rule_id, src, relpath="src/repro_torch/serving/x.py"):
    mod = ModuleSource("x.py", relpath, textwrap.dedent(src))
    return get_rule(rule_id).check_module(mod)


def test_jit_hygiene_fires_on_fixtures():
    found = _lint("jit-hygiene", """
        import numpy as np
        import torch
        TABLE = [1, 2]

        def _tick_static(self, opts={}):
            n = self.xs.sum().item()
            return np.asarray(self.xs) + TABLE[0]

        def serve(graphs, fn):
            for _ in range(3):
                g = torch.cuda.CUDAGraph()
                g.capture_begin()
            while True:
                with torch.cuda.graph(g):
                    fn()

        def warmup(gs):
            for g in gs:
                g.capture_begin()
        """)
    msgs = [f.message for f in found]
    assert sum("mutable default" in m for m in msgs) == 1
    assert sum("host value" in m for m in msgs) == 2
    assert sum("mutable module global 'TABLE'" in m for m in msgs) == 1
    assert sum("inside a loop body" in m for m in msgs) == 2
    assert _lint("jit-hygiene", """
        def _tick_static(self):
            self.xs.copy_(self.ys)
        """) == []


def test_pytree_registration_fires_on_fixtures():
    found = _lint("pytree-registration", """
        from dataclasses import dataclass
        import torch

        @dataclass
        class Box:
            x: torch.Tensor
            n: int

        @dataclass
        class Plain:
            n: int

        def run(dst, src):
            b = Box(torch.zeros(2), 1)
            tree_copy_(dst, b)
            compile_program(Plain(1))
        """)
    assert len(found) == 1 and "'Box'" in found[0].message


def test_const_bloat_fires_on_a_host_table_and_a_large_read():
    big = torch.zeros(1 << 15)                 # 128 KiB, undeclared
    _, rec = record_program("p", lambda: big + torch.as_tensor(
        np.ones(1 << 15, np.float32)))
    issues = check_const_bloat(rec)
    assert [i.category for i in issues] == ["const-bloat"] * 2
    assert check_const_bloat(rec, [big])[0].message.count("host data") == 1
    # the record compile_program keeps beside a program (want_record)
    prog, prof, ir = compile_program(lambda: big * 2.0, key="k",
                                     device="cpu", want_record=True)
    assert ir.key == "k" and ir.record.ops == 1 and ir.pool_bytes == 0
    assert check_const_bloat(ir.record, [big]) == []


def test_capture_rules_silent_on_the_port():
    rules = [get_rule(r) for r in ("jit-hygiene", "pytree-registration")]
    res = run_analysis(root=REPO, paths=[os.path.join(REPO, "src",
                                                      "repro_torch")],
                       rules=rules, baseline_path=os.path.join(
                           REPO, "no-baseline.json"))
    assert res.findings == []


def test_sentinel_sees_a_capture():
    assert RetraceSentinel().selftest()
    eng = ServingEngine(init_params(torch.Generator().manual_seed(0),
                                    get_smoke_config("tinyllama-1.1b"),
                                    device="cpu"),
                        get_smoke_config("tinyllama-1.1b"), slots=1,
                        max_prompt=4, cache_len=8, device="cpu")
    with RetraceSentinel() as sen:
        eng.generate([[1, 2]], max_new_tokens=3)
    assert len(sen.captures) == 2          # prefill and decode, compiled
    with RetraceSentinel() as sen:
        eng.generate([[1, 2]], max_new_tokens=3)
    assert sen.count == 0


def test_global_norm_sums_a_sliced_leaf_into_its_own_partial(monkeypatch):
    """A leaf above CHUNK elements: its slices' square-sums added into the
    leaf's own partial, which the total takes once; leaves within CHUNK
    stay one reduction each, bitwise the unsliced norm."""
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 5, generator=g),
            "b": torch.randn(8, 4, 6, generator=g),
            "c": torch.randn(7, generator=g)}
    sq = {k: torch.sum(torch.square(v)) for k, v in tree.items()}
    assert torch.equal(adamw.global_norm(tree),
                       torch.sqrt(sq["a"] + sq["b"] + sq["c"]))
    monkeypatch.setattr(adamw, "CHUNK", 48)     # b: 4 slices of 2 rows
    parts = [torch.sum(torch.square(tree["b"][i:i + 2]))
             for i in range(0, 8, 2)]
    leaf_b = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    sliced = adamw.global_norm(tree)
    assert torch.equal(sliced, torch.sqrt(sq["a"] + leaf_b + sq["c"]))
    whole = torch.sqrt(sq["a"] + sq["b"] + sq["c"])
    assert float(abs(sliced - whole)) <= 1e-6 * float(whole)
