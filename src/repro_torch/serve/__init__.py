"""repro_torch.serve — slot-based continuous-batching serving (ported from
`repro.serve`): whole-prompt or chunked prefill, plain or speculative
decode (chain, adaptive-K, stochastic, tree), a dense or a paged KV cache
(`Engine(paged_kv=PagedKVConfig(...))`: block tables, radix prefix sharing,
a host-RAM offload tier)."""
from .engine import Engine, Request
from .paging import OutOfPages, PagedKVConfig, Pager
from .sampling import accept_speculative, accept_tree, greedy_accept, sample
from .scheduler import ContinuousBatchingScheduler, ServeStats

__all__ = ["Engine", "Request", "sample", "greedy_accept", "accept_speculative",
           "accept_tree", "ContinuousBatchingScheduler", "ServeStats",
           "PagedKVConfig", "Pager", "OutOfPages"]
