"""I1 — quantized-dtype flow: the LUT datapath stays in narrow int types
(the counterpart of `repro.lint.ir.dtype_flow`).

The paper's fused kernel hinges on one invariant: values *derived from the
packed ternary weights* flow through {uint8, int8, int32} until the scale
epilogue dequantizes them. A step that converts quantized values to float
and then runs the heavy math in float (a float product over decoded trits)
has silently forfeited the paper's arithmetic — numerically identical,
performance class lost. The trace makes that promotion explicit.

Taint analysis over the op stream, by tensor id: the seeds are the uint8
tensors among the step's arguments (the packed trit codes). Taint flows
from an op's value operands to its results, with two kills:

* a ``repro_torch::*`` kernel operator: the kernel owns its datapath (the
  plan tests and the chip's bit-exact checks cover it), and its results
  are post-epilogue;
* the *dequant* ``mul``: a tainted float operand times an untainted float
  operand (the weight or activation scale).

Index operands (`INDEX_OPERANDS`: gather, index_select, index, index_put,
scatter, embedding, ...) carry no taint: codes used as LUT *indices* are
the point of the method.

Finding: a floating product (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
``addbmm``, ``matmul``, ``mv``, ``dot``) with a tainted floating operand —
quantized values promoted to float before any scale, fed to the heavy op.
Integer products over tainted int8/int32 operands are the intended
datapath and stay silent.
"""
from __future__ import annotations

from typing import Iterable

from ..core import Finding
from ...roofline.hlo_stats import _tensors
from .core import IREntry, fmt_tensor, ir_pass, op_name, op_namespace, ops_with_ids, require_ids

_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "mv", "dot"})
#: op → the argument positions that are indices, not values
INDEX_OPERANDS = {
    "index_select": (2,), "gather": (2,), "index": (1,), "_unsafe_index": (1,),
    "index_put": (1,), "index_put_": (1,), "_index_put_impl_": (1,),
    "scatter": (2,), "scatter_": (2,), "scatter_add": (2,), "scatter_add_": (2,),
    "scatter_reduce": (2,), "scatter_reduce_": (2,), "index_copy": (2,),
    "index_copy_": (2,), "index_add": (2,), "index_add_": (2,), "embedding": (1,),
    "take_along_dim": (1,), "take": (1,),
}
_FLOATS = ("float", "bfloat16", "half")


def _is_float(dtype: str) -> bool:
    return dtype.startswith(_FLOATS)


def value_operands(op: dict, ins: list) -> list[tuple[list, list]]:
    """[(ids, description)] of an op's tensor operands that carry values:
    the flattened operands of every argument but the index ones."""
    skip = INDEX_OPERANDS.get(op_name(op), ())
    descs = []
    for i, a in enumerate(op["args"]):
        descs += [(i, d) for d in _tensors(a)]
    descs += [(-1, d) for v in op["kwargs"].values() for d in _tensors(v)]
    return [(ids, d) for ids, (i, d) in zip(ins, descs) if i not in skip]


@ir_pass("I1", "quantized-dtype flow: values derived from packed ternary codes stay "
               "integer until the scale epilogue; a float product over still-quantized "
               "values is a finding")
def check_dtype_flow(entry: IREntry) -> Iterable[Finding]:
    require_ids(entry)
    trace = entry.trace
    tainted = {a[0] for a in trace.arguments if a[4] == "uint8"}
    findings: list[Finding] = []
    for op, ins, outs in ops_with_ids(trace):
        name = op_name(op)
        if op_namespace(op) == "repro_torch":
            tainted.difference_update(t[0] for t in outs)
            continue
        vals = value_operands(op, ins)
        hot = [(ids, d) for ids, d in vals if ids[0] in tainted]
        if name in _PRODUCTS:
            bad = [d for _, d in hot if _is_float(d[2])]
            if bad:
                findings.append(Finding(
                    "I1", entry.path, 0, 0,
                    f"`{op['op']}` consumes a floating operand ({fmt_tensor(bad[0])}) "
                    f"derived from packed ternary codes with no scale applied — the "
                    f"quantized datapath was promoted to float before the dequant "
                    f"epilogue"))
        out_tainted = bool(hot)
        if out_tainted and name in ("mul", "mul_") and len(vals) == 2:
            (ia, da), (ib, db) = vals
            if _is_float(da[2]) and _is_float(db[2]) and (
                    (ia[0] in tainted) != (ib[0] in tainted)):
                out_tainted = False
        if out_tainted:
            tainted.update(t[0] for t in outs)
        else:
            tainted.difference_update(t[0] for t in outs)
    return findings
