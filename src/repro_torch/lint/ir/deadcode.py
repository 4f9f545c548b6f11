"""I3 — dead code: heavy or large ops whose results reach no output (the
counterpart of `repro.lint.ir.deadcode`).

The fused-epilogue refactor class: a rework leaves the old intermediate (a
full-vocab logits cube, a dequantized dense weight, an extra layout pass)
still computed but no longer consumed. An eager step has no compiler to
drop it: every dead op in the trace is work the card does for nothing.

Liveness runs backward over the op stream, by tensor and storage id. Live
at the end: the step's result tensors (`Trace.outputs`). An op is live
when one of its results is live, when it writes in place into a storage
that a live op reads later or into an argument's storage (the cache, the
parameters, the optimizer state: `Trace.memory`'s alias set), or when it
is a collective. A live op makes its operands live, and the storages they
view: liveness flows through views to their base, so an in-place write
through a view of a buffer read later is live. Only *expensive* dead ops
are findings: products, sorts and kernel operators at any size
(`HEAVY`), or any other non-view op materializing at least
`MIN_DEAD_BYTES`.
"""
from __future__ import annotations

from typing import Iterable

from ...roofline.hlo_stats import COLLECTIVE_NAMESPACES, KERNEL_NAMESPACE, _tensors, nbytes
from ..core import Finding
from .core import IREntry, fmt_tensor, ir_pass, op_name, op_namespace, require_ids

HEAVY = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "_int_mm", "mv",
                   "dot", "sort", "topk", "convolution",
                   "_scaled_dot_product_flash_attention",
                   "_scaled_dot_product_efficient_attention"})
#: a dead cheap op must at least materialize this much to be worth a report
MIN_DEAD_BYTES = 1 << 16


@ir_pass("I3", "dead code: products, kernel launches and large intermediates whose "
               "results reach neither the step's output nor an argument's storage")
def check_deadcode(entry: IREntry) -> Iterable[Finding]:
    require_ids(entry)
    trace = entry.trace
    arg_sids = {a[1] for a in trace.arguments}
    live_tids = {t[0] for t in trace.outputs}
    live_sids = {t[1] for t in trace.outputs}
    findings: list[Finding] = []
    for i in range(len(trace.ops) - 1, -1, -1):
        op = trace.ops[i]
        ins, outs = op["ids"]["in"], op["ids"]["out"]
        live = (any(t[0] in live_tids for t in outs)
                or op_namespace(op) in COLLECTIVE_NAMESPACES
                or (op["inplace"] and any(t[1] in live_sids or t[1] in arg_sids
                                          for t in outs + ins[:1])))
        if live:
            live_tids.update(t[0] for t in ins)
            live_sids.update(t[1] for t in ins)
            continue
        heavy = op_name(op) in HEAVY or op_namespace(op) == KERNEL_NAMESPACE
        size = 0 if op["view"] else nbytes(op["out"])
        if heavy or size >= MIN_DEAD_BYTES:
            shapes = ", ".join(fmt_tensor(d) for d in _tensors(op["out"]))
            findings.append(Finding(
                "I3", entry.path, 0, 0,
                f"dead `{op['op']}` at op {i} — its result(s) [{shapes}] reach no "
                f"output ({size} B computed and dropped); a refactor left the old "
                f"intermediate behind"))
    return findings

