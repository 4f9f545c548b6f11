"""I4 — traffic model: a step's bytes moved against the roofline (the
counterpart of `repro.lint.ir.traffic`).

The estimate is the trace's eager traffic (`hlo_stats.op_traffic`, the
model `step_stats` sums into ``traffic_bytes``): every non-view op charges
its operands and its result — eager PyTorch materializes each — a gather
twice its result, a partial in-place write three times its update, and a
kernel operator its `mpgemm_cost` / flash bytes. For mpGeMM entries it is
held against the analytic `roofline.analysis.mpgemm_cost` model: a finding
fires when

    estimate > factor * mpgemm_cost(m_out, k, m_tokens, g=4).bytes

with ``factor`` = entry.meta["traffic_factor"] (default `DEFAULT_FACTOR`;
the registry sets per-impl factors about 2x above the ratio measured at
`registry.FULL_MS`, written in tests/test_torch_lint_ir.py), so a rework
that suddenly materializes a few times more intermediates blows through.
The eager port materializes more than XLA fuses away, so JAX's factors do
not carry over. Entries without cost meta (the engine steps have no
single-GeMM model) are skipped.
"""
from __future__ import annotations

from typing import Iterable

from ...roofline.hlo_stats import op_traffic
from ..core import Finding
from .core import IREntry, ir_pass

#: the fused serving path's budget (measured ~5x at M 256, registry.FULL_MS)
DEFAULT_FACTOR = 10.0


def estimate_bytes(trace) -> float:
    """The trace's eager traffic (`hlo_stats.op_traffic` summed)."""
    return float(sum(op_traffic(op) for op in trace.ops))


def model_bytes(meta: dict) -> float:
    from ...roofline.analysis import mpgemm_cost

    return mpgemm_cost(meta["m_out"], meta["k"], meta["m_tokens"], 4,
                       fused=bool(meta.get("fused", True)))[1]


@ir_pass("I4", "traffic model: the trace's eager bytes cross-checked against "
               "roofline.analysis.mpgemm_cost (finding when the estimate exceeds the "
               "model by the configured factor)")
def check_traffic(entry: IREntry) -> Iterable[Finding]:
    meta = entry.meta
    if not all(k in meta for k in ("m_out", "k", "m_tokens")):
        return  # no analytic model for this entry's step
    est, model = estimate_bytes(entry.trace), model_bytes(meta)
    factor = float(meta.get("traffic_factor", DEFAULT_FACTOR))
    if model > 0 and est > factor * model:
        yield Finding(
            "I4", entry.path, 0, 0,
            f"traffic estimate {est / 1e6:.2f} MB exceeds {factor:g}x the roofline "
            f"model ({model / 1e6:.2f} MB) for M={meta['m_tokens']}, K={meta['k']}, "
            f"N={meta['m_out']} — the step materializes far more than the mpGeMM cost "
            f"model allows (estimate/model = {est / model:.1f}x)")
