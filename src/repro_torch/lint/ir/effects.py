"""I2 — effect/host audit: a serving step must be a pure device program
(the counterpart of `repro.lint.ir.effects`).

A step that reads a value back to the host (``.item()``, ``int(t)``,
``bool(t)``, ``nonzero``, a boolean mask, ``torch.equal``) waits for the
device and serializes the dispatch queue; one that copies live data between
host and device per step pays a transfer the step should not need (the
dynamic R3 rule's static sibling, and what a CUDA graph of the step could
not capture). The trace makes both explicit:

* a host-sync op anywhere in the stream (`HOST_SYNCS`);
* a trace that stopped early (`Trace.stopped`): on fake tensors a
  data-dependent op has no answer, so the op the trace stopped at is the
  sync, reported here rather than crashing the run;
* a ``_to_copy`` / ``copy_`` across devices whose source derives from the
  step's *arguments* — a host↔device transfer of live data. A copy of a
  constant the step builds itself (a table, a mask) is not flagged.
"""
from __future__ import annotations

from typing import Iterable

from ..core import Finding
from .core import IREntry, ir_pass, op_name, ops_with_ids, require_ids

#: ops that read a device value back to the host
HOST_SYNCS = frozenset({"_local_scalar_dense", "nonzero", "masked_select", "is_nonzero",
                        "equal", "item"})
_COPIES = frozenset({"_to_copy", "copy_", "copy"})


@ir_pass("I2", "effect/host audit: no host-sync op (.item(), nonzero, a boolean "
               "mask, equal), no data-dependent stop, no host<->device copy of "
               "argument-derived data in a step")
def check_effects(entry: IREntry) -> Iterable[Finding]:
    require_ids(entry)
    trace = entry.trace
    findings: list[Finding] = []
    derived = {a[0] for a in trace.arguments}
    for i, (op, ins, outs) in enumerate(ops_with_ids(trace)):
        name = op_name(op)
        if name in HOST_SYNCS:
            findings.append(Finding(
                "I2", entry.path, 0, 0,
                f"host sync `{op['op']}` at op {i} — a serving step must not read a "
                f"device value back (keep it on the device, or batch one copy per "
                f"tick outside the step)"))
        elif name in _COPIES and ins:
            src = ins[-1] if name in ("copy_", "copy") else ins[0]
            dst_dev = (ins[0] if name in ("copy_", "copy") else (outs or ins)[0])[2]
            if src[2].split(":")[0] != dst_dev.split(":")[0] and src[0] in derived:
                findings.append(Finding(
                    "I2", entry.path, 0, 0,
                    f"`{op['op']}` of argument-derived data from {src[2]} to {dst_dev} at "
                    f"op {i} — live values cross between host and device every step"))
        if any(t[0] in derived for t in ins):
            derived.update(t[0] for t in outs)
    if trace.stopped:
        findings.append(Finding(
            "I2", entry.path, 0, 0,
            f"the trace stopped at `{trace.stopped['op']}` ({trace.stopped['error']}) "
            f"after {len(trace.ops)} op(s): a data-dependent op — the step reads a "
            f"device value back to the host"))
    return findings
