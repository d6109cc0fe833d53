"""repro_torch.analysis: the port's lint framework and source rules, held
against the JAX package's `repro.analysis` where they share a contract.

Every rule gets a firing fixture and a matched non-firing fixture (the
negative is the positive minus the defect).  The framework's suppression
grammar, content fingerprints and baseline matching are compared with
JAX's on the same findings; clock-discipline fires at JAX's (line, col);
both policy registries hold the same names and a broken policy fires in
both.  The enforcement point: the port's tree lints clean on the CPU, and
reports ir-launch as not run there.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import all_rules, get_rule, run_analysis
from repro_torch.analysis.base import Finding, assign_fingerprints
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.cli import resolve_rules
from repro_torch.analysis.report import to_json, to_text
from repro_torch.analysis.source import ModuleSource

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         os.pardir))
SRC = os.path.join(REPO_ROOT, "src")


def lint_snippet(tmp_path, code, rule_id,
                 relpath="src/repro_torch/serving/snip.py"):
    """Write `code` at `relpath` under a scratch root and run one rule."""
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return run_analysis(root=str(tmp_path), paths=[str(path)],
                        rules=[get_rule(rule_id)],
                        baseline_path=str(tmp_path / "no_baseline.json"),
                        device="cpu")


# ---------------------------------------------------------------------------
# host-sync-in-hot-path
# ---------------------------------------------------------------------------

def test_host_sync_fires_on_tainted_sinks(tmp_path):
    res = lint_snippet(tmp_path, """
        import numpy as np
        import torch

        def tick(x):
            y = torch.sum(x)
            a = float(y)              # builtin on a torch result
            b = np.asarray(y * 2)     # through a BinOp
            c = y.item()              # method sink
            d = x.float().cpu()       # x: a parameter, origin unseen
            e = y.cpu()               # .cpu() of a torch result
            f = torch.stack([y]).numpy()
            torch.cuda.synchronize()  # unconditional
            return a, b, c, d, e, f
    """, "host-sync-in-hot-path")
    assert sorted(f.line for f in res.findings) == [7, 8, 9, 11, 12, 13], \
        to_text(res)


def test_host_sync_silent_on_host_values(tmp_path):
    res = lint_snippet(tmp_path, """
        import numpy as np
        import torch

        def tick(n, xs, t):
            a = float(n)                      # python scalar
            b = np.asarray(xs)                # host list / array
            y = torch.zeros((4,))
            c = int(y.shape[0])               # host metadata
            d = int(y.numel()) + y.dim()      # host metadata methods
            e = bool(t.device.type == "cuda")
            hist = [1.0, 2.0]
            f = float(np.percentile(hist, 99))
            return a, b, c, d, e, f
    """, "host-sync-in-hot-path")
    assert res.findings == [], to_text(res)


def test_host_sync_taints_through_vmap_callable(tmp_path):
    res = lint_snippet(tmp_path, """
        import torch

        def run(x):
            f = torch.vmap(lambda v: v * 2)
            out = f(x)
            return float(out)
    """, "host-sync-in-hot-path")
    assert [f.line for f in res.findings] == [7]


def test_host_sync_scoped_to_hot_trees(tmp_path):
    code = """
        import torch

        def f(x):
            return float(torch.sum(x))
    """
    hot = lint_snippet(tmp_path, code, "host-sync-in-hot-path",
                       relpath="src/repro_torch/core/snip.py")
    cold = lint_snippet(tmp_path, code, "host-sync-in-hot-path",
                        relpath="src/repro_torch/diffusion/snip.py")
    assert len(hot.findings) == 1 and cold.findings == []


# ---------------------------------------------------------------------------
# clock-discipline
# ---------------------------------------------------------------------------

CLOCK_SNIPPET = """
    import time

    def tick(self):
        t0 = time.perf_counter()
        t1 = time.time(); t2 = time.monotonic_ns()
        return t1 - t0 + t2
"""


def test_clock_fires_at_jax_rules_line_and_col(tmp_path):
    from repro.analysis import get_rule as jax_rule
    from repro.analysis import run_analysis as jax_run
    res = lint_snippet(tmp_path, CLOCK_SNIPPET, "clock-discipline")
    jpath = tmp_path / "src/repro/serving/snip.py"
    jpath.parent.mkdir(parents=True, exist_ok=True)
    jpath.write_text(textwrap.dedent(CLOCK_SNIPPET))
    jres = jax_run(root=str(tmp_path), paths=[str(jpath)],
                   rules=[jax_rule("clock-discipline")],
                   baseline_path=str(tmp_path / "none.json"))
    ours = [(f.line, f.col) for f in res.findings]
    assert len(ours) == 3
    assert ours == [(f.line, f.col) for f in jres.findings]


def test_clock_silent_on_obs_clock_and_strings(tmp_path):
    res = lint_snippet(tmp_path, """
        from repro_torch.obs.clock import monotonic

        def tick(self):
            now = monotonic()
            msg = "never call time.time() here"
            return now, msg
    """, "clock-discipline")
    assert res.findings == []


def test_clock_not_scoped_to_core(tmp_path):
    res = lint_snippet(tmp_path, """
        import time

        def f():
            return time.time()
    """, "clock-discipline", relpath="src/repro_torch/core/snip.py")
    assert res.findings == []


# ---------------------------------------------------------------------------
# rng-generator-discipline
# ---------------------------------------------------------------------------

def test_rng_fires_on_global_draws_and_seeding(tmp_path):
    res = lint_snippet(tmp_path, """
        import numpy as np
        import torch

        def sample(shape, x):
            a = torch.randn(shape)                 # global generator
            b = torch.randint(0, 4, shape)
            c = torch.empty(shape).normal_()       # in-place sampler
            torch.manual_seed(0)                   # global seeding
            np.random.seed(0)
            d = np.random.normal(size=shape)       # numpy's global draw
            e = torch.multinomial(x, 1)
            return a, b, c, d, e
    """, "rng-generator-discipline")
    assert sorted(f.line for f in res.findings) == [6, 7, 8, 9, 10, 11, 12], \
        to_text(res)


def test_rng_silent_with_generators(tmp_path):
    res = lint_snippet(tmp_path, """
        import numpy as np
        import torch

        def sample(shape, seed, x):
            g = torch.Generator().manual_seed(seed)
            a = torch.randn(shape, generator=g)
            b = torch.empty(shape).normal_(generator=g)
            c = torch.multinomial(x, 1, generator=g)
            rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
            return a, b, c, rng.normal(size=shape)
    """, "rng-generator-discipline")
    assert res.findings == [], to_text(res)


def test_rng_fires_on_loop_invariant_reseed(tmp_path):
    res = lint_snippet(tmp_path, """
        import torch

        def noise(reqs, seed, shape):
            out = []
            g = torch.Generator()
            for r in reqs:
                g.manual_seed(seed)          # the same stream every slot
                out.append(torch.randn(shape, generator=g))
            for r in reqs:
                for k in range(2):
                    g.manual_seed(r.seed)    # invariant in the inner loop
                    out.append(torch.randn(shape, generator=g))
            return out
    """, "rng-generator-discipline")
    assert sorted(f.line for f in res.findings) == [8, 12], to_text(res)
    assert "same stream" in res.findings[0].message


def test_rng_silent_on_per_request_reseed(tmp_path):
    res = lint_snippet(tmp_path, """
        import torch

        def noise(reqs, shape):
            out = []
            g = torch.Generator()
            for i, r in enumerate(reqs):
                g.manual_seed(r.seed * 2**32 + i)
                out.append(torch.randn(shape, generator=g))
            while reqs:
                r = reqs.pop()
                g.manual_seed(r.seed)
            return out
    """, "rng-generator-discipline")
    assert res.findings == [], to_text(res)


# ---------------------------------------------------------------------------
# policy-registry-conformance
# ---------------------------------------------------------------------------

def test_policy_conformance_clean_on_real_registry():
    findings = get_rule("policy-registry-conformance").check_project(
        REPO_ROOT, "cpu")
    assert findings == [], [f.message for f in findings]


def test_both_registries_hold_the_same_policy_names():
    import repro.core as jax_core
    import repro_torch.core as core
    assert sorted(core.POLICY_REGISTRY) == sorted(jax_core.POLICY_REGISTRY)


def test_broken_policy_fires_in_both_registries(monkeypatch):
    import jax.numpy as jnp
    import torch
    import repro.core as jax_core
    import repro_torch.core as core
    from repro.analysis import get_rule as jax_rule

    class JaxNever(jax_core.CachePolicy):
        name = "never"

        def init_state(self, shape, dtype=jnp.float32):
            return {"cache": jnp.zeros(shape, dtype)}

        def apply(self, state, step, x, compute_fn, **signals):
            return state["cache"], state

        def want_compute(self, state, step, x, **signals):
            return jnp.asarray(False)

    class TorchNever(core.CachePolicy):
        name = "never"

        def init_state(self, shape, dtype=torch.float32, *, device):
            return {"cache": torch.zeros(shape, dtype=dtype, device=device)}

        def apply(self, state, step, x, compute_fn, **signals):
            return state["cache"], state

        def want_compute(self, state, step, x=None, **signals):
            return torch.tensor(False)

    monkeypatch.setitem(jax_core.POLICY_REGISTRY, "never",
                        lambda **kw: JaxNever())
    monkeypatch.setitem(core.POLICY_REGISTRY, "never",
                        lambda **kw: TorchNever())
    ours = [f.message for f in get_rule(
        "policy-registry-conformance").check_project(REPO_ROOT, "cpu")
        if "'never'" in f.message]
    theirs = [f.message for f in jax_rule(
        "policy-registry-conformance").check_project(REPO_ROOT)
        if "'never'" in f.message]
    assert ours and theirs
    for msgs in (ours, theirs):
        assert any("FRESH state" in m for m in msgs)
        assert any("compute_fn" in m for m in msgs)


# ---------------------------------------------------------------------------
# suppressions, fingerprints and the baseline: the same as JAX's
# ---------------------------------------------------------------------------

SUPPRESS_TEXTS = [
    "a = 1  # repro-lint: disable=rule-a,rule-b -- because reasons\n",
    "# repro-lint: disable-next-line=rule-a -- why\nb = 2\nc = 3\n",
    "d = f(x)  # repro-lint: disable=all -- escape hatch\n",
    "e = 4  # repro-lint: disable = rule-c\n# repro-lint: disable=rule-d\n",
]


@pytest.mark.parametrize("text", SUPPRESS_TEXTS)
def test_suppression_grammar_matches_jax(text):
    from repro.analysis.source import ModuleSource as JaxModuleSource
    ours, theirs = ModuleSource("x.py", "x.py", text), \
        JaxModuleSource("x.py", "x.py", text)
    for line in range(1, text.count("\n") + 2):
        for rule in ("rule-a", "rule-b", "rule-c", "rule-d", "because",
                     "why"):
            assert ours.suppressed(line, rule) == theirs.suppressed(line,
                                                                    rule)


def _findings(cls):
    return [cls("host-sync-in-hot-path", "src/x/a.py", 4, 2, "m",
                snippet="y = float(t)"),
            cls("host-sync-in-hot-path", "src/x/a.py", 9, 2, "m",
                snippet="y   =   float(t)"),       # same normalized line
            cls("clock-discipline", "src/x/b.py", 3, 0, "m",
                snippet="t = time.time()"),
            cls("clock-discipline", "src/x/b.py", 7, 4, "m",
                snippet="u = time.time()")]


def test_fingerprints_match_jax():
    from repro.analysis.base import Finding as JaxFinding
    from repro.analysis.base import assign_fingerprints as jax_assign
    ours, theirs = _findings(Finding), _findings(JaxFinding)
    assign_fingerprints(ours)
    jax_assign(theirs)
    assert [f.fingerprint for f in ours] == [f.fingerprint for f in theirs]
    assert len({f.fingerprint for f in ours}) == 4   # occurrence index


def test_baseline_matching_matches_jax(tmp_path):
    from repro.analysis.base import Finding as JaxFinding
    from repro.analysis.base import assign_fingerprints as jax_assign
    from repro.analysis.baseline import Baseline as JaxBaseline
    ours, theirs = _findings(Finding), _findings(JaxFinding)
    assign_fingerprints(ours)
    jax_assign(theirs)
    Baseline.write(str(tmp_path / "ours.json"), ours[:2], "fixture")
    JaxBaseline.write(str(tmp_path / "theirs.json"), theirs[:2], "fixture")
    bo = Baseline.load(str(tmp_path / "ours.json"))
    bt = JaxBaseline.load(str(tmp_path / "theirs.json"))
    assert [bo.match(f) for f in ours] == [bt.match(f) for f in theirs] \
        == [True, True, False, False]
    assert [e["fingerprint"] for e in bo.stale(ours[1:])] == \
        [e["fingerprint"] for e in bt.stale(theirs[1:])]


def test_same_line_and_next_line_suppressions(tmp_path):
    res = lint_snippet(tmp_path, """
        import torch

        def f(x):
            y = torch.sum(x)
            a = float(y)  # repro-lint: disable=host-sync-in-hot-path -- why
            # repro-lint: disable-next-line=host-sync-in-hot-path -- why
            b = float(y * 2)
            c = float(y * 3)   # NOT suppressed
            d = float(y * 4)  # repro-lint: disable=clock-discipline
            return a, b, c, d
    """, "host-sync-in-hot-path")
    assert [f.line for f in res.findings] == [9, 10]
    assert len(res.suppressed) == 2


BASELINE_SNIPPET = """
    import torch

    def f(x):
        return float(torch.sum(x))
"""


def test_baseline_filters_and_survives_line_drift(tmp_path):
    res = lint_snippet(tmp_path, BASELINE_SNIPPET, "host-sync-in-hot-path")
    assert len(res.findings) == 1
    bl = tmp_path / "baseline.json"
    Baseline.write(str(bl), res.findings, justification="test fixture")
    snip = tmp_path / "src/repro_torch/serving/snip.py"
    rule = [get_rule("host-sync-in-hot-path")]
    res2 = run_analysis(root=str(tmp_path), paths=[str(snip)], rules=rule,
                        baseline_path=str(bl), device="cpu")
    assert res2.findings == [] and len(res2.baselined) == 1
    snip.write_text("import os\nimport sys\n" + snip.read_text())
    res3 = run_analysis(root=str(tmp_path), paths=[str(snip)], rules=rule,
                        baseline_path=str(bl), device="cpu")
    assert res3.findings == [] and len(res3.baselined) == 1
    snip.write_text(snip.read_text().replace("torch.sum(x))",
                                             "torch.sum(x) * 2)"))
    res4 = run_analysis(root=str(tmp_path), paths=[str(snip)], rules=rule,
                        baseline_path=str(bl), device="cpu")
    assert len(res4.findings) == 1 and len(res4.stale_baseline) == 1


def test_port_baseline_holds_no_entries():
    with open(os.path.join(REPO_ROOT, "tools", "lint_baseline_torch.json"),
              encoding="utf-8") as f:
        assert json.load(f)["findings"] == []


# ---------------------------------------------------------------------------
# CLI and registry
# ---------------------------------------------------------------------------

def test_cli_exits_1_on_synthetic_violation_and_writes_json(tmp_path):
    snip = tmp_path / "src/repro_torch/serving/snip.py"
    snip.parent.mkdir(parents=True)
    snip.write_text(textwrap.dedent(BASELINE_SNIPPET))
    report = tmp_path / "report.json"
    rc = cli_main(["--root", str(tmp_path), "--baseline",
                   str(tmp_path / "none.json"), "--json", str(report),
                   "--device", "cpu", "--rule", "host-sync-in-hot-path",
                   "--rule", "ir-launch", "-q", str(snip)])
    assert rc == 1
    data = json.loads(report.read_text())
    assert data["exit_code"] == 1 and data["device"] == "cpu"
    assert data["findings"][0]["rule"] == "host-sync-in-hot-path"
    assert data["findings"][0]["fingerprint"]
    assert "CUDA" in data["not_run"]["ir-launch"]


def test_cli_write_baseline_then_clean(tmp_path):
    snip = tmp_path / "src/repro_torch/serving/snip.py"
    snip.parent.mkdir(parents=True)
    snip.write_text(textwrap.dedent(BASELINE_SNIPPET))
    bl = tmp_path / "bl.json"
    args = ["--root", str(tmp_path), "--baseline", str(bl), "--rule",
            "host-sync-in-hot-path", str(snip)]
    assert cli_main(args + ["--write-baseline"]) == 0 and bl.exists()
    assert cli_main(args + ["-q"]) == 0


def test_cli_unknown_rule_is_usage_error():
    assert cli_main(["--rule", "no-such-rule"]) == 2


def test_module_entry_point_lists_rules():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--list-rules"],
        capture_output=True, text=True, timeout=120, check=True,
        env=dict(os.environ, PYTHONPATH=SRC))
    listed = {line.split()[0] for line in out.stdout.splitlines()}
    assert listed == {r.id for r in all_rules()}


def test_syntax_error_is_a_finding(tmp_path):
    snip = tmp_path / "src/repro_torch/serving/broken.py"
    snip.parent.mkdir(parents=True)
    snip.write_text("def f(:\n")
    res = run_analysis(root=str(tmp_path), paths=[str(snip)],
                       rules=[get_rule("clock-discipline")],
                       baseline_path=str(tmp_path / "none.json"))
    assert [f.rule for f in res.findings] == ["syntax-error"]


RULE_IDS = ["clock-discipline", "host-sync-in-hot-path", "ir-const-bloat",
            "ir-donation", "ir-dtype", "ir-host-sync", "ir-launch",
            "ir-retrace", "jit-hygiene", "policy-registry-conformance",
            "pytree-registration", "rng-generator-discipline"]


def test_rules_registered_with_metadata():
    rules = {r.id: r for r in all_rules()}
    assert sorted(rules) == RULE_IDS
    for r in rules.values():
        assert r.description and r.rationale


def test_rule_glob_resolves_ir_family():
    ir = [r for r in RULE_IDS if r.startswith("ir-")]
    assert sorted(r.id for r in resolve_rules(["ir-*"])) == ir
    rules = resolve_rules(["ir-dtype", "ir-*"])
    assert len(rules) == len(ir) and rules[0].id == "ir-dtype"
    with pytest.raises(KeyError):
        resolve_rules(["zz-*"])


def test_report_lists_rules_not_run(tmp_path):
    res = lint_snippet(tmp_path, BASELINE_SNIPPET, "ir-launch")
    assert res.findings == [] and "ir-launch" in res.not_run
    text = to_text(res)
    assert "not run: [ir-launch]" in text
    assert to_json(res)["not_run"] == res.not_run


# ---------------------------------------------------------------------------
# the enforcement point: the port's tree lints clean
# ---------------------------------------------------------------------------

def test_port_tree_lints_clean_on_cpu(tmp_path, capsys):
    report = tmp_path / "report.json"
    rc = cli_main(["--root", REPO_ROOT, "--device", "cpu", "--json",
                   str(report)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "not run: [ir-launch]" in text and "repro-lint: OK" in text
    data = json.loads(report.read_text())
    assert data["findings"] == [] and list(data["not_run"]) == ["ir-launch"]
    assert data["files_scanned"] > 100
    # every inline suppression carries a -- justification
    for f in data["suppressed"]:
        with open(os.path.join(REPO_ROOT, f["path"]), encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        window = "\n".join(lines[max(0, f["line"] - 2):f["line"]])
        assert "--" in window.split("repro-lint:")[-1], f


def test_the_analysis_package_loads_no_jax():
    """Every rule module imported (and the ir package): no module of JAX
    or of the JAX package is loaded."""
    code = ("import sys, repro_torch.analysis as a, repro_torch.analysis.ir; "
            "a.all_rules(); "
            "bad = [m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=SRC))
