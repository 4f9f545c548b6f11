"""repro_torch.roofline — analytic cost model (ported from `repro.roofline`):
`mpgemm_cost`, `count_params`, `model_flops` and the dry run's `Roofline`
(on an H100's peaks). The JAX package's HLO parsing (`hlo_stats`,
`collective_bytes`) needs a compiled XLA module and has no counterpart
here."""
from .analysis import Roofline, count_params, model_flops, mpgemm_cost

__all__ = ["Roofline", "count_params", "model_flops", "mpgemm_cost"]
