"""repro_torch.serve — slot-based continuous-batching serving with
whole-prompt admission (ported from `repro.serve`)."""
from .engine import Engine, Request
from .sampling import sample
from .scheduler import ContinuousBatchingScheduler, ServeStats

__all__ = ["Engine", "Request", "sample", "ContinuousBatchingScheduler", "ServeStats"]
