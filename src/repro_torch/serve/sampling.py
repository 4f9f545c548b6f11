"""Token sampling: greedy / temperature / top-k, plus the speculative
acceptance rules (ported from `repro.serve.sampling`): exact greedy matching
and Leviathan-style rejection sampling over a chain verify step's (B, K+1, V)
logits, and `accept_tree` (the longest accepted root-to-leaf path) over a
tree verify step's (B, N_nodes, V) logits.

Both acceptance rules take an optional ``draft_mask`` so a batch can mix
per-slot draft lengths: acceptance never runs past a row's first masked
(padded) position, and the token emitted there is a full target sample
(nothing was proposed there, so nothing was rejected).

Random draws come from an explicit `torch.Generator`, so they differ from
`jax.random`'s: only greedy results are bit-comparable across the two
packages, the rest is compared in distribution."""
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


def _categorical(probs: torch.Tensor, generator) -> torch.Tensor:
    """One draw per row of (..., V) unnormalized probabilities → (...,)."""
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator)[:, 0].reshape(probs.shape[:-1])


# --------------------------------------------------------------------------
# Speculative acceptance
# --------------------------------------------------------------------------
def greedy_accept(draft: torch.Tensor, target_tokens: torch.Tensor,
                  draft_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Longest accepted draft prefix under exact greedy matching.

    draft (B, K) proposed tokens; target_tokens (B, K+1) the target's greedy
    picks at each verified position. Draft token j is accepted iff it equals
    the target's pick after the j-1 previously accepted tokens and, when
    draft_mask (B, K) bool is given, iff position j is a real proposal.
    → (B,) int32 in [0, K]."""
    matches = draft == target_tokens[:, :-1]
    if draft_mask is not None:
        matches = matches & draft_mask
    return torch.cumprod(matches.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def accept_speculative(draft: torch.Tensor, target_logits: torch.Tensor,
                       generator: torch.Generator | None = None, *,
                       temperature: float = 0.0, draft_probs: torch.Tensor | None = None,
                       draft_mask: torch.Tensor | None = None):
    """Acceptance rule over one verify step. → (n_accepted (B,) int32,
    out (B, K+1) int32); the caller emits out[:, :n_accepted+1].

    draft (B, K); target_logits (B, K+1, V) from `models.verify_step`;
    draft_mask (B, K) bool, True at real proposals (rows with fewer real
    drafts stop there, and the token emitted at the first padded position is
    a full target sample).

    temperature <= 0: exact greedy matching, token for token what
    sequential greedy decode emits.

    temperature > 0: Leviathan et al. rejection sampling. Draft token x is
    accepted with probability min(1, p(x)/q(x)); at the first rejection the
    token is resampled from the normalized residual (p-q)+, after full
    acceptance the bonus comes from the last position. q is one-hot at the
    draft (a deterministic drafter) unless draft_probs (B, K, V) gives a
    stochastic drafter's distributions. When the residual vanishes (p <= q
    everywhere: round-off or an inconsistent q) the resample is from p with
    the rejected token zeroed, so it is never re-emitted at its own place.
    The generator is drawn from in this order: the (B, K) uniforms, the
    (B, K) residual resamples, with a draft_mask the (B, K) full target
    samples, then the (B,) bonus tokens."""
    b, kp1, v = target_logits.shape
    k = kp1 - 1
    mask = None if draft_mask is None else draft_mask.to(torch.bool)
    draft = draft.to(torch.long)
    if temperature <= 0.0:
        tgt = torch.argmax(target_logits, dim=-1).to(torch.int32)          # (B, K+1)
        return greedy_accept(draft, tgt, mask), tgt

    logits = target_logits.to(torch.float32)
    p = torch.softmax(logits / temperature, dim=-1)                     # (B, K+1, V)
    p_k = p[:, :k]
    p_draft = torch.gather(p_k, -1, draft[..., None])[..., 0]
    one_hot = torch.nn.functional.one_hot(draft, v).to(p.dtype)
    if draft_probs is None:                       # deterministic proposal
        q = one_hot
        q_draft = torch.ones_like(p_draft)
    else:
        q = draft_probs.to(p.dtype)
        q_draft = torch.gather(q, -1, draft[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, device=p.device)
    accept = u < p_draft / torch.clamp_min(q_draft, 1e-20)
    if mask is not None:
        accept = accept & mask
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    # rejection fires only where p(x) <= q(x), so the residual is already 0
    # at the rejected token; the fallback keeps it so (p with x removed)
    residual = torch.clamp_min(p_k - q, 0.0)
    rsum = residual.sum(-1, keepdim=True)
    fallback = p_k * (1.0 - one_hot)
    fallback = fallback / torch.clamp_min(fallback.sum(-1, keepdim=True), 1e-30)
    residual = torch.where(rsum > 0, residual / torch.clamp_min(rsum, 1e-30), fallback)
    resample = _categorical(torch.clamp_min(residual, 1e-30), generator)   # (B, K)
    if mask is not None:
        # padded positions proposed nothing: the correction is a full
        # target sample for that position
        full = _categorical(p_k, generator)
        resample = torch.where(mask, resample, full)
    bonus = _categorical(p[:, -1], generator)
    j = torch.arange(k, device=p.device)[None, :]
    mid = torch.where(j < n_acc[:, None], draft, resample)
    return n_acc, torch.cat([mid, bonus[:, None]], dim=1).to(torch.int32)


def accept_tree(tokens: torch.Tensor, target_logits: torch.Tensor, tree,
                generator: torch.Generator | None = None, *, temperature: float = 0.0):
    """Acceptance rule over one *tree* verify step.

    tokens (B, N) node tokens in DraftTree order (column 0 is the root, the
    last sampled token); target_logits (B, N, V) from verify_step(...,
    tree=...). → (n_acc (B,), out (B, K+1), path (B, K+1)), all int32:
    n_acc accepted draft nodes along the winning root-to-leaf path, in
    [0, K]; out the path's accepted tokens then one correction/bonus token
    at column n_acc (later columns repeat it); path the winning leaf's node
    per depth (column 0 is the root), the cache compaction's gather map.

    Node j is accepted iff its token equals the target's argmax at its
    parent and its ancestors are all accepted; the winner is the deepest
    accepted path, ties to the lowest-rank (chain-proposal) branch. At
    temperature > 0 the path matching stays greedy and only the correction
    token is sampled from the last accepted node's distribution: every
    emitted token is a valid target sample, but the joint distribution is
    greedy-filtered, not the target's (as in the JAX package)."""
    b, n, v = target_logits.shape
    dev = target_logits.device
    from repro_torch.spec.tree import device_array

    parents = device_array(tree, "parents", dev, torch.long)                   # (N,)
    paths = device_array(tree, "leaf_paths", dev, torch.long)                  # (L, K+1)
    k = paths.shape[1] - 1
    tgt = torch.argmax(target_logits, dim=-1).to(torch.int32)                  # (B, N)
    match = tokens.to(torch.int32) == tgt[:, parents]
    match[:, 0] = True                                                          # root given
    pm = match[:, paths]                                                        # (B, L, K+1)
    acc_len = torch.cumprod(pm.to(torch.int32), dim=-1).sum(dim=-1) - 1        # (B, L)
    best = torch.argmax(acc_len, dim=-1)          # the first maximum: lowest rank
    n_acc = torch.gather(acc_len, 1, best[:, None])[:, 0]
    path = paths[best]                                                          # (B, K+1)
    path_tok = torch.gather(tokens.to(torch.int32), 1, path)
    path_tgt = torch.gather(tgt, 1, path)
    if temperature > 0.0:
        last = torch.gather(path, 1, n_acc[:, None])[:, 0]
        corr_logits = target_logits[torch.arange(b, device=dev), last].to(torch.float32)
        corr = _categorical(torch.softmax(corr_logits / temperature, dim=-1),
                            generator)[:, None].to(torch.int32)
    else:
        corr = torch.gather(path_tgt, 1, n_acc[:, None])
    d = torch.arange(k + 1, device=dev)[None, :]
    nxt = torch.cat([path_tok[:, 1:], path_tgt[:, -1:]], dim=1)
    out = torch.where(d < n_acc[:, None], nxt, corr).to(torch.int32)
    return n_acc.to(torch.int32), out, path.to(torch.int32)
