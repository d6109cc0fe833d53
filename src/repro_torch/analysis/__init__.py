"""repro_torch.analysis — lint and runtime verification of the PyTorch
port (the counterpart of the JAX package's `repro.analysis`).

The survey's training-free caching paradigm only pays off if the serving
hot loop stays free of silent performance and correctness hazards: one
hidden host sync per tick erases the row savings that row compaction and
TeaCache-style reuse buy (and breaks a CUDA-graph capture of the tick),
and a shared generator makes "distinct" requests draw identical noise.
This package checks the port's side of those contracts: statically, over
`src/repro_torch`, and at run time, over the engines' programs, the train
step and the kernels' launches.

Rules (each one module under `repro_torch.analysis.rules`):

  host-sync-in-hot-path        float()/int()/bool()/.item()/.tolist()/
                               .cpu()/.numpy()/np.asarray() on tensors,
                               and torch.cuda.synchronize(), in serving/
                               modalities/ core/ conditioning/
  clock-discipline             wall time in serving / modalities /
                               conditioning code goes through
                               repro_torch.obs.clock
  rng-generator-discipline     draws name their torch.Generator; no
                               global seeding; no loop-invariant re-seed
                               (the counterpart of JAX's rng-key-reuse)
  policy-registry-conformance  every make_policy entry keeps the serving
                               contract the engine assumes
  jit-hygiene                  a CUDA-graph capture in a loop outside
                               warmup; mutable defaults, mutable module
                               globals or host value reads in a captured
                               function (what the graph would freeze)
  pytree-registration          a dataclass with tensor fields handed to
                               a captured program's static buffers
                               (repro_torch.tree cannot see into it)
  ir-host-sync, ir-dtype       what each warmup program's run dispatches
                               (repro_torch.analysis.ir)
  ir-const-bloat               no program makes a tensor from host data
                               or reads an undeclared large tensor (what
                               its graph would pin)
  ir-donation                  the train step updates every leaf in place
  ir-retrace                   serving after warmup builds, loads,
                               captures and runs nothing warmup did not
  ir-launch                    every kernel launch's operands and plan
                               (on the card only)

Usage:

  python -m repro_torch.analysis                  # lint src/repro_torch;
                                                  # the ir-* rules on the
                                                  # card, exit 1 on
                                                  # unsuppressed findings
  python -m repro_torch.analysis --device cpu     # the ir-* rules on the
                                                  # CPU (ir-launch: not run)
  python -m repro_torch.analysis --rule 'ir-*' --json report.json

Suppression: `# repro-lint: disable=<rule>[,<rule>...] -- why` on the
offending line (or `disable-next-line=` on the line above).  The
baseline, `tools/lint_baseline_torch.json`, holds no entries.
"""
from .base import Finding, NotRun, ProjectRule, Rule, all_rules, get_rule
from .runner import RunResult, run_analysis
from .report import to_json, to_text

__all__ = [
    "Finding", "NotRun", "Rule", "ProjectRule", "all_rules", "get_rule",
    "RunResult", "run_analysis", "to_json", "to_text",
]
