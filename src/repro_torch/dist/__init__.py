"""repro_torch.dist — gradient compression and fault tolerance (ported
from `repro.dist`; the sharding rules and collectives wait for
`torch.distributed`).

  compression      — int8 + error-feedback gradient compression for the
                     accumulation boundary.
  fault_tolerance  — preemption guard, straggler monitor, bounded restarts.
"""
from . import compression, fault_tolerance

__all__ = ["compression", "fault_tolerance"]
