"""repro_torch.lint — the port's static analysis and runtime sanitizers
(the counterpart of `repro.lint`, which lints JAX idioms).

Static side: ``python -m repro_torch.lint`` (default paths: `src/repro_torch`,
`tests/test_torch_*.py` and `chip_smoke.py`) runs the AST rules:

  R0  a suppression without its justification (unsuppressable), E0 a
      syntax error (`core`);
  R1  an in-place cache write without the port's drop semantics
      (`rules_scatter`: write_rows, a torch.where write-back, the paged
      write sink);
  R2  re-planning hazards: a plan cache made in a loop or thrown away, a
      CUDA-graph capture in a loop, an unhashable plan-cache key
      (`rules_recompile`);
  R3  a host sync (.item()/.cpu()/int(t)/np.asarray(t)/
      torch.cuda.synchronize) in a serving loop body (`rules_hostsync`);
  R4  time.time used for timing (`rules_timing`);
  R5  a ctypes call or signature whose arity is not its C entry's, a
      default plan over the card's shared memory a block (`rules_launch`).

Suppression: ``# lint: disable=R1 -- <at least three words>``. Exit codes:
0 clean, 1 findings, 2 usage.

IR side: ``python -m repro_torch.lint --ir [--device cpu|cuda]`` traces the
entry-point registry on fake tensors and runs the passes I1-I5 over the
recorded op streams (`repro_torch.lint.ir`).

Runtime side: `sanitize.enable_sanitizers` (rank and dtype promotion
raise, debug-NaNs) and `sanitize.CompileGuard` with `guard_entries`
(nothing planned, built or allocated grows after warm-up).
"""
from __future__ import annotations

# importing the rule modules registers them with core's registry
from . import (  # noqa: F401
    rules_hostsync,
    rules_launch,
    rules_recompile,
    rules_scatter,
    rules_timing,
)
from .core import (  # noqa: F401
    Finding,
    LintModule,
    lint_file,
    lint_paths,
    lint_source,
    registered_rules,
    report_json,
    write_json,
)
from .sanitize import (  # noqa: F401
    CompileGuard,
    Probe,
    SanitizerError,
    enable_sanitizers,
    growth_probes,
    guard_entries,
    restore_sanitizers,
    sanitizers_requested,
)

#: what ``python -m repro_torch.lint`` lints when given no paths (from the
#: repository root)
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py")

__all__ = [
    "DEFAULT_PATHS",
    "Finding",
    "LintModule",
    "lint_file",
    "lint_paths",
    "lint_source",
    "registered_rules",
    "report_json",
    "write_json",
    "CompileGuard",
    "Probe",
    "SanitizerError",
    "enable_sanitizers",
    "growth_probes",
    "guard_entries",
    "restore_sanitizers",
    "sanitizers_requested",
]
