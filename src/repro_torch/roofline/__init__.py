"""repro_torch.roofline — analytic cost model (ported from `repro.roofline`):
`mpgemm_cost`, `count_params`, `model_flops`, `collective_bytes` and the
dry run's `Roofline` (on an H100's peaks); and the step statistics
(`hlo_stats`: `trace_step`, `step_stats`, `HloStats`), which the JAX
package reads from compiled HLO and the port from a fake-tensor trace of
its own steps."""
from .analysis import Roofline, collective_bytes, count_params, model_flops, mpgemm_cost
from .hlo_stats import HloStats, Trace, step_stats, trace_step

__all__ = ["Roofline", "collective_bytes", "count_params", "model_flops", "mpgemm_cost",
           "HloStats", "Trace", "step_stats", "trace_step"]
