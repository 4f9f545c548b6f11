"""Drafter protocol + the weight-free prompt-lookup (n-gram) drafter (a copy
of `repro.spec.drafter`, numpy only; stochastic drafters take a
`torch.Generator` where the JAX package passes a PRNG key).

A drafter proposes K candidate continuation tokens per active slot each
decode tick. The engine hands it the full per-slot context (prompt +
everything generated so far) and expects a dense (max_slots, K) proposal —
static shapes keep the verify step one shape for every tick.
"""
from __future__ import annotations

import numpy as np


class Drafter:
    """Interface the engine drives. Subclasses override `propose`; the slot
    lifecycle hooks are optional (stateless drafters ignore them)."""

    def on_admit(self, slot: int, prompt: np.ndarray) -> None:
        """A request's prompt is fully in `slot`'s cache (prompt = its
        tokens). Under chunked prefill this fires at the PREFILLING→DECODING
        transition — after the *last* chunk — never mid-prefill, so a
        mirrored-cache drafter syncs the whole prompt exactly once."""

    def on_release(self, slot: int) -> None:
        """The request in `slot` finished; the slot will be reused."""

    def propose(
        self,
        contexts: list,
        k: int,
        *,
        slot_k: np.ndarray | None = None,
        generator=None,
        temperature: float = 0.0,
        return_probs: bool = False,
        tree=None,
    ):
        """contexts: one entry per slot — the full token context (prompt +
        generated) as a 1-D int array for active slots, None for free slots.
        → (max_slots, k) int32 draft tokens (free-slot rows are ignored).

        slot_k: per-slot effective draft length in [0, k] (adaptive-K
        engines, chain mode only). Columns >= slot_k[i] are padding the
        engine masks out of acceptance — a drafter may fill them with
        anything valid and may skip per-slot work for slot_k[i]==0 rows,
        but must keep the dense (max_slots, k) shape.

        generator / temperature: stochastic drafters sample proposals at
        `temperature`, drawing from the `torch.Generator` `generator`
        (greedy when temperature<=0 or generator is None).

        return_probs: also return the per-position proposal distributions —
        `(draft, probs)` with probs (max_slots, k, V) float tensor, or
        `(draft, None)` from a deterministic drafter (the engine then treats
        the proposal as one-hot).

        tree: a spec.tree.DraftTree — propose a draft *tree* instead of a
        chain: → (max_slots, tree.n_draft) int32 node tokens in the
        DraftTree flattening order (column j-1 = node j; rank-0 children are
        the drafter's best candidate, so the all-rank-0 path should be the
        chain proposal). Mutually exclusive with slot_k/return_probs."""
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup / self-drafting (no extra weights): match the context's
    trailing n-gram (n = max_n .. min_n) against earlier context; if it
    recurred, propose the k tokens that followed its most recent earlier
    occurrence. Repetition-heavy contexts — code, summarization, test-time
    scaling loops re-reading their own output — hit constantly; the fallback
    (repeat the last token) keeps shapes static when nothing matches."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}..{max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def _propose_one(self, ctx: np.ndarray, k: int) -> np.ndarray:
        L = len(ctx)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            suffix = ctx[L - n:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
            starts = np.nonzero((windows == suffix).all(axis=1))[0]
            starts = starts[starts < L - n]          # drop the suffix itself
            if starts.size:
                cont = ctx[starts[-1] + n : starts[-1] + n + k]
                out = np.full(k, cont[-1] if cont.size else ctx[-1], ctx.dtype)
                out[: cont.size] = cont
                return out
        return np.full(k, ctx[-1], ctx.dtype)

    def _candidates(self, ctx: np.ndarray, c: int) -> np.ndarray:
        """Top-c next-token candidates after `ctx`: the tokens that followed
        earlier occurrences of the trailing n-gram, ranked by occurrence
        count (recency breaks ties); padded with the best candidate (or the
        fallback last token) when fewer than c distinct continuations
        exist."""
        L = len(ctx)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            suffix = ctx[L - n:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
            starts = np.nonzero((windows == suffix).all(axis=1))[0]
            starts = starts[starts < L - n]          # drop the suffix itself
            if starts.size:
                nxt = ctx[starts + n]
                uniq, inv, counts = np.unique(
                    nxt, return_inverse=True, return_counts=True
                )
                last_seen = np.zeros(len(uniq), np.int64)
                last_seen[inv] = np.arange(len(nxt))  # most recent occurrence
                order = np.lexsort((last_seen, counts))[::-1]
                ranked = uniq[order]
                out = np.full(c, ranked[0], ranked.dtype)
                out[: min(c, len(ranked))] = ranked[:c]
                return out
        return np.full(c, ctx[-1], ctx.dtype)

    def _propose_tree_one(self, ctx: np.ndarray, tree) -> np.ndarray:
        """Fill one slot's draft tree: every node's children are the top-b
        n-gram continuations of that node's *hypothesis* context (ctx + the
        tokens along its root path), so each branch tracks its own history
        rather than the chain's."""
        out = np.zeros(tree.n_draft, np.int64)
        hyp = {0: ctx}
        cands: dict = {}
        for j in range(1, tree.n_nodes):
            p = int(tree.parents[j])
            if p not in cands:
                width = int(tree.branching[int(tree.depths[j]) - 1])
                cands[p] = self._candidates(hyp[p], width)
            tok = cands[p][int(tree.ranks[j])]
            out[j - 1] = tok
            hyp[j] = np.concatenate([hyp[p], [tok]])
        return out

    def propose(
        self,
        contexts: list,
        k: int,
        *,
        slot_k: np.ndarray | None = None,
        generator=None,
        temperature: float = 0.0,
        return_probs: bool = False,
        tree=None,
    ):
        width = tree.n_draft if tree is not None else k
        out = np.zeros((len(contexts), width), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is None or (slot_k is not None and slot_k[i] == 0):
                continue                    # free or skip-drafting slot
            ctx = np.asarray(ctx, np.int64)
            if tree is not None:
                out[i] = self._propose_tree_one(ctx, tree)
            else:
                out[i] = self._propose_one(ctx, k)
        if return_probs:
            return out, None                # deterministic → one-hot proposal
        return out
