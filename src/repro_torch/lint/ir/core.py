"""repro_torch.lint.ir core: the IR entry model, the pass registry and the
op-record helpers (the counterpart of `repro.lint.ir.core`).

The IR suite is the AST linter's complement. Instead of parsing source it
*runs* a registry of hot-path entry points (the mpGeMM impls of
`kernels.ops`, `Engine.step_entries()`, `ModelDrafter.step_entries()`) on
fake tensors under `roofline.hlo_stats.trace_step` — no data, no launch,
no allocation — and runs pluggable passes over the recorded op stream
(`hlo_stats.Trace`: every op below autograd, each kernel launch as its
``repro_torch::*`` operator, with the ids of its operand and result
tensors). What the AST cannot see (a quantized value promoted to float
before its scale, a host sync inside a step, a dead product left by a
refactor, a step that moves far more bytes than its cost model, or any
structural change to a serving step) is what these passes check.

Findings reuse `lint.core.Finding` and the same exit-code contract (0
clean / 1 findings / 2 usage). Source-comment suppressions make no sense
for a trace, so the suppression contract moves to the registry: an entry
declares ``suppress={"I4": "<justification, ≥3 words>"}``; an
under-justified suppression is itself a finding (I0, unsuppressable),
mirroring the AST side's R0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator

from ..core import MIN_JUSTIFICATION_WORDS, Finding

#: pass id -> (one-line description, check callable)
_PASSES: dict[str, tuple[str, Callable[["IREntry"], Iterable[Finding]]]] = {}


def ir_pass(pass_id: str, description: str):
    """Decorator registering ``check(entry) -> Iterable[Finding]``."""

    def deco(fn):
        _PASSES[pass_id] = (description, fn)
        fn.pass_id = pass_id
        fn.description = description
        return fn

    return deco


def registered_passes() -> dict[str, str]:
    return {pid: desc for pid, (desc, _) in sorted(_PASSES.items())}


@dataclasses.dataclass
class IREntry:
    """One traced entry point: a name, its `hlo_stats.Trace`, and pass
    metadata.

    name      stable identifier ("mpgemm/vlut/M16", "engine/chunk_verify");
              doubles as the snapshot filename (with '/' -> '__').
    trace     the `Trace` of the entry run once on fake tensors.
    kind      "mpgemm" | "engine" | "drafter" | "step" — passes gate on it.
    meta      pass inputs: mpgemm entries carry m_out/k/m_tokens/fused for
              the I4 cross-check and a traffic_factor; engine entries the
              `step_entries()` name they trace ("step").
    suppress  pass id -> justification (≥3 words); suppressed passes are
              skipped for this entry, bad justifications are I0 findings.
    device    the fake tensors' device type ("cpu" | "cuda"): the snapshot
              folder.
    fn        the traced callable (a caller may run it on real tensors).
    """

    name: str
    trace: Any
    kind: str = "mpgemm"
    meta: dict = dataclasses.field(default_factory=dict)
    suppress: dict = dataclasses.field(default_factory=dict)
    device: str = "cpu"
    fn: Callable | None = None

    @property
    def path(self) -> str:
        """Pseudo-path used in Finding rows (there is no source file)."""
        return f"<trace:{self.name}>"


# --------------------------------------------------------------------------
# op records
# --------------------------------------------------------------------------
def op_name(op: dict) -> str:
    """``aten::mm`` -> ``mm``."""
    return op["op"].partition("::")[2]


def op_namespace(op: dict) -> str:
    return op["op"].partition("::")[0]


def require_ids(entry: IREntry) -> None:
    """Refuse a record without tensor ids (an older `Trace.to_json`): the
    dataflow passes cannot run on it."""
    if any("ids" not in op for op in entry.trace.ops):
        raise ValueError(
            f"{entry.name}: the trace's op records carry no tensor ids (a trace "
            f"saved before ids were recorded); retrace it with hlo_stats.trace_step")


def ops_with_ids(trace) -> Iterator[tuple[dict, list, list]]:
    """(op, operand ids, result ids) in dispatch order."""
    for op in trace.ops:
        yield op, op["ids"]["in"], op["ids"]["out"]


def fmt_tensor(d) -> str:
    """``["T", [2, 3], "float32"]`` -> ``float32[2,3]``."""
    return f"{d[2]}[{','.join(str(x) for x in d[1])}]"


# --------------------------------------------------------------------------
# running the passes
# --------------------------------------------------------------------------
def run_passes(entries: Iterable[IREntry], select: set[str] | None = None,
               **pass_kwargs) -> list[Finding]:
    """Run every registered pass over every entry -> sorted findings.

    Extra keyword args are forwarded to passes that accept them (the
    snapshot pass takes ``snapshot_root``/``update_snapshots``); passes that
    do not declare the kwarg are called with the entry alone."""
    findings: list[Finding] = []
    for entry in entries:
        # registry-level suppression contract (I0 mirrors the AST R0)
        active_suppress: set[str] = set()
        for pid, justification in sorted(entry.suppress.items()):
            if len(str(justification).split()) < MIN_JUSTIFICATION_WORDS:
                findings.append(Finding(
                    "I0", entry.path, 0, 0,
                    f"suppression of {pid} lacks a justification "
                    f"(≥{MIN_JUSTIFICATION_WORDS} words)",
                ))
            else:
                active_suppress.add(pid)
        for pid, (_desc, check) in sorted(_PASSES.items()):
            if select is not None and pid not in select:
                continue
            if pid in active_suppress:
                continue
            code = check.__code__
            kw = {k: v for k, v in pass_kwargs.items()
                  if k in code.co_varnames[: code.co_argcount]}
            findings.extend(check(entry, **kw))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
