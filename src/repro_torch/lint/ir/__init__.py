"""repro_torch.lint.ir — analysis of the serving hot path's traced op
streams (the counterpart of `repro.lint.ir`, which reads jaxprs).

``python -m repro_torch.lint --ir [--device cpu|cuda]`` traces the
entry-point registry (`registry`: the `kernels.ops` mpGeMM impls x fusion
modes, `Engine.step_entries()`, `ModelDrafter.step_entries()`) on fake
tensors with `roofline.hlo_stats.trace_step` and runs the passes:

  I0 registry suppressions carry a justification (`core`)
  I1 quantized-dtype flow: no float product over still-packed codes
  I2 effect/host audit: no host sync, no host<->device copy of live data
  I3 dead code: no product or large intermediate that reaches no output
  I4 traffic: the eager bytes within a factor of `mpgemm_cost`'s
  I5 golden op-stream snapshots under tests/torch_ir_snapshots/<device>/
"""
from __future__ import annotations

# importing the pass modules registers them with the pass registry
from . import (  # noqa: F401
    deadcode,
    dtype_flow,
    effects,
    snapshots,
    traffic,
)
from .core import IREntry, ir_pass, registered_passes, run_passes  # noqa: F401
from .registry import (  # noqa: F401
    default_entries,
    engine_entries,
    mpgemm_entries,
    pinned_trace_env,
)
from .snapshots import signature, snapshot_dir, write_snapshot  # noqa: F401

__all__ = [
    "IREntry",
    "ir_pass",
    "registered_passes",
    "run_passes",
    "default_entries",
    "engine_entries",
    "mpgemm_entries",
    "pinned_trace_env",
    "signature",
    "snapshot_dir",
    "write_snapshot",
]
