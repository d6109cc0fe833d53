"""repro_torch.analysis.ir — runtime program verification of the port (the
counterpart of the JAX package's `repro.analysis.ir`).

Where `repro_torch.analysis.rules` lints source text, this subpackage
checks what the port actually does when it runs: the operators each of an
engine's warmup programs dispatches, the train step's in-place updates,
the steady-state session after warmup, and the launch plan of every CUDA
kernel call.  The eager port has no jaxpr; one recorded run of a program
is its ground truth.

  op_checks    OpRecorder (a TorchDispatchMode): host syncs, float64,
               in-place writes, the priced reads of one program run
  verify       `verify_programs(engine)` -> registry Findings over every
               program warmup runs
  retrace      RetraceSentinel: kernel builds / loads and programs run at
               keys warmup did not run, in a scope
  launch_lint  contiguity / alignment / dtype / int32 checks of every call
               through `_build.launch`, and grid / block / shared memory /
               register / occupancy checks of each launch site's plan
  golden       the cached lint-time fixture: tiny image + video + t2i
               engines, verified and served under the sentinel

Everything surfaces through the ordinary rule registry as the five `ir-*`
rules (`python -m repro_torch.analysis --rule 'ir-*'`), through
`engine.warmup(verify=True)` and `train_loop(verify_donation=True)`.
"""
from .launch_lint import (LaunchCapture, LaunchPlan, check_capture,
                          check_plan, intercept_launches, lint_launches)
from .op_checks import (DonationError, OpIssue, OpRecord, OpRecorder,
                        check_donation, check_record, inplace_report,
                        record_program)
from .retrace import RetraceSentinel
from .verify import issue_to_finding, verify_programs, verify_programs_by_key

__all__ = [
    "LaunchCapture", "LaunchPlan", "check_capture", "check_plan",
    "intercept_launches", "lint_launches",
    "DonationError", "OpIssue", "OpRecord", "OpRecorder", "check_donation",
    "check_record", "inplace_report", "record_program",
    "RetraceSentinel",
    "issue_to_finding", "verify_programs", "verify_programs_by_key",
]
