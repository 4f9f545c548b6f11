"""repro_torch.serve — slot-based continuous-batching serving (ported from
`repro.serve`): whole-prompt or chunked prefill, plain or speculative
decode (chain, adaptive-K, stochastic, tree)."""
from .engine import Engine, Request
from .sampling import accept_speculative, accept_tree, greedy_accept, sample
from .scheduler import ContinuousBatchingScheduler, ServeStats

__all__ = ["Engine", "Request", "sample", "greedy_accept", "accept_speculative",
           "accept_tree", "ContinuousBatchingScheduler", "ServeStats"]
