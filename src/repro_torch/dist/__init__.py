"""repro_torch.dist — the distribution layer (ported from `repro.dist` onto
`torch.distributed`):

  sharding         — name-based specs for params, optimizer state, caches,
                     batches and activations; DTensor placements; the
                     sharding context (`shard_act`, `dispatch_blocks`).
  compression      — int8 + error-feedback gradient compression for the
                     accumulation boundary, and `compressed_psum`.
  fault_tolerance  — preemption guard, straggler monitor, bounded restarts.
"""
from . import compression, fault_tolerance, sharding

__all__ = ["compression", "fault_tolerance", "sharding"]
