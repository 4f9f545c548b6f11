"""repro_torch.roofline — analytic cost of the mpGeMM kernels (ported from
`repro.roofline`: `mpgemm_cost` only; the JAX package's HLO parsing needs a
compiled XLA module and has no counterpart here)."""
from .analysis import mpgemm_cost

__all__ = ["mpgemm_cost"]
