"""Token sampling: greedy / temperature / top-k (ported from
`repro.serve.sampling`; the speculative acceptance rules are not ported
yet). Random draws come from an explicit `torch.Generator`, so they differ
from `jax.random`'s: only greedy sampling is bit-comparable across the two
packages."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) → (B,) int32.

    Greedy (temperature <= 0) takes the first maximal index, as jnp.argmax.
    top_k keeps exactly top_k candidates (0 = unrestricted): ties at the
    k-th logit are broken toward lower token ids, as `jax.lax.top_k` breaks
    them (the first k of a stable descending sort; `torch.topk` keeps no
    such order). top_k > V is clamped to V; top_k < 0 is rejected."""
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    top_k = min(top_k, logits.shape[-1])
    if top_k:
        idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :top_k]
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, idx, True)
        logits = torch.where(keep, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
