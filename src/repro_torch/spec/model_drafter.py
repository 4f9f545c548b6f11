"""ModelDrafter — a smaller ternary draft model with a mirrored slot cache
(ported from `repro.spec.model_drafter`).

The drafter owns its own packed model, ModelConfig, and a batched KV cache
shaped like the engine's (max_slots, max_len), on the engine's device and
sharing no tensor with the engine's cache. Each `propose` call:

  1. *resync* — the tokens the target accepted since the last call (1..k+1 of
     them per slot) are pushed through the draft model in ONE multi-token
     `verify_step` (per-slot positions, padded to k+1 so every call has one
     shape), giving the first draft token from the final real position's
     logits;
  2. *draft* — k-1 single-token decode steps extend the proposal;
  3. *rollback* — the cache idx is restored to the accepted-token count
     (`models.rollback_cache`), so speculated draft state never contaminates
     the next resync (position-masked attention + write-before-attend, as
     for the target's rollback).

Drafting is greedy by default, so the proposal is deterministic and rejection
sampling treats it as one-hot. With `temperature > 0` and a `torch.Generator`
the proposal is *sampled* at that temperature, and `propose(...,
return_probs=True)` returns the per-position sampling distributions q
(max_slots, k, V) on the device — `serve.sampling.accept_speculative` takes
them as `draft_probs`. Passing the target's own model and config yields the
always-accept oracle.

`propose(..., tree=DraftTree)` proposes a token *tree*: the same single chain
pass runs (resync + k-1 greedy decode steps), keeping each position's top-b
tokens; the tree's depth-d candidates are the top-b_d tokens after d-1 argmax
tokens (Medusa-style; the all-rank-0 path is exactly the chain proposal).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import module_to, resolve_device
from repro_torch.models import (
    decode_step,
    init_cache,
    prefill,
    prefill_into_slot,
    rollback_cache,
    verify_step,
)

from .drafter import Drafter


def top_candidates(logits: torch.Tensor, b: int) -> torch.Tensor:
    """(B, V) → (B, b) indices of the b largest logits, ties toward lower
    ids (`jax.lax.top_k`'s order: the first b of a stable descending sort)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :b]


class ModelDrafter(Drafter):
    def __init__(self, params, cfg, *, max_slots: int, max_len: int, device="cuda"):
        if any(s.mixer == "ssm" for s in cfg.layer_specs()):
            raise ValueError("ModelDrafter needs a rollbackable cache; the "
                             "draft config has ssm mixers")
        if any(s.window for s in cfg.layer_specs()):
            raise ValueError("ModelDrafter needs a rollbackable cache; the "
                             "draft config has windowed (ring-cache) layers")
        self.device = resolve_device(device)
        self.params = module_to(params, self.device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, max_slots, max_len, device=self.device)
        #: per-slot count of context tokens the draft cache has absorbed
        self.synced = np.zeros(max_slots, np.int64)
        # the step entries (`step_entries`), the JAX drafter's jitted callables
        self._prefill = lambda p, c, t: prefill(p, t, c, cfg)
        self._verify = lambda p, c, t: verify_step(p, t, c, cfg)
        self._decode = lambda p, c, t: decode_step(p, t, c, cfg)

    def step_entries(self) -> dict:
        """The step callables this drafter dispatches through (the JAX
        drafter's `jit_entries`), for `Engine.step_entries`."""
        return {"prefill": self._prefill, "verify": self._verify, "decode": self._decode}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def on_admit(self, slot: int, prompt: np.ndarray) -> None:
        # the same bucketed admission as Engine.add, so the draft cache's
        # positions can never drift from the target's
        _, self.cache, _ = prefill_into_slot(
            self.params, self.cache, slot, prompt, self.cfg, max_len=self.max_len,
            prefill_fn=self._prefill)
        self.synced[slot] = len(prompt)

    # ------------------------------------------------------------------
    def _pick(self, row_logits, generator, temperature: float, want_q: bool):
        """One draft position: (B, V) logits → (B,) int32 device tokens (+
        the (B, V) proposal distribution on the device when requested).
        Greedy (one-hot q) unless temperature > 0 and a generator is given;
        then the tokens are sampled at that temperature and q is the
        matching softmax."""
        if temperature > 0.0 and generator is not None:
            q = torch.softmax(row_logits.to(torch.float32) / temperature, dim=-1)
            tok = torch.multinomial(q, 1, generator=generator)[:, 0]
            q = q if want_q else None
        else:
            tok = torch.argmax(row_logits, dim=-1)
            q = (torch.nn.functional.one_hot(tok, row_logits.shape[-1]).to(torch.float32)
                 if want_q else None)
        return tok.to(torch.int32), q

    def _resync(self, contexts: list, window: int):
        """Absorb the tokens the target accepted since the last call (one
        multi-token verify over a (B, window) batch) and roll the cache back
        to the synced boundary. Free slots are left alone: their `synced`
        entry and cache rows are whatever the last occupant left (admission
        rewrites both). → (last-real-position logits (B, V), rolled-back
        cache, active mask)."""
        b = self.max_slots
        tokens = np.zeros((b, window), np.int32)
        delta = np.ones(b, np.int64)
        base = np.zeros(b, np.int64)
        active = np.zeros(b, bool)
        for i, ctx in enumerate(contexts):
            if ctx is None:
                continue
            active[i] = True
            base[i] = self.synced[i]
            d = len(ctx) - self.synced[i]
            assert 1 <= d <= window, (
                f"slot {i}: draft cache out of sync ({d} unseen tokens, "
                f"window {window}) — was on_admit called?"
            )
            delta[i] = d
            tokens[i, :d] = ctx[self.synced[i]:]
            tokens[i, d:] = ctx[-1]     # pad; rolled back below
        logits, cache = self._verify(self.params, self.cache, self._dev(tokens))
        row = logits[torch.arange(b, device=self.device), self._dev(delta - 1)]   # (B, V)
        # keep only the real (accepted) tokens in the cache; free slots keep
        # their stale synced value rather than being scribbled on
        self.synced = np.where(active, base + delta, self.synced)
        cache = rollback_cache(cache, self._dev(self.synced))
        return row, cache, active

    @torch.no_grad()
    def propose(self, contexts: list, k: int, *, slot_k: np.ndarray | None = None,
                generator=None, temperature: float = 0.0, return_probs: bool = False,
                tree=None):
        if tree is not None:
            return self._propose_tree(contexts, tree)
        b = self.max_slots
        # 1. resync: absorb the accepted tokens, one multi-token step
        #    (window k+1 = the most a chain verify step can emit)
        row, cache, active = self._resync(contexts, k + 1)
        # per-position (B,) tokens and (B, V) distributions, on the device
        # until the one host copy at the end
        tok, q0 = self._pick(row, generator, temperature, return_probs)
        cols, qs = [tok], [q0]
        # 2. draft: decode steps (positions continue per slot), capped at
        # the deepest k_eff any *active* slot asked for. Padded columns
        # (beyond a slot's k_eff, or beyond the cap) repeat the previous
        # token; the engine's draft_mask keeps acceptance away from them.
        k_hi = k if slot_k is None else int(
            max((int(slot_k[i]) for i in range(b) if active[i]), default=0))
        for j in range(1, k):
            if j < k_hi:
                step_logits, cache = self._decode(self.params, cache, cols[-1][:, None])
                tok, qj = self._pick(step_logits, generator, temperature, return_probs)
            else:
                tok = cols[-1]
                qj = (torch.nn.functional.one_hot(tok.long(), self.cfg.vocab)
                      .to(torch.float32) if return_probs else None)
            cols.append(tok)
            qs.append(qj)
        draft = torch.stack(cols, dim=1).cpu().numpy()         # (B, K) int32
        # 3. rollback: drop the speculated draft state
        self.cache = rollback_cache(cache, self._dev(self.synced))
        if return_probs:
            return draft, torch.stack(qs, dim=1)      # (B, K, V), on the device
        return draft

    def _propose_tree(self, contexts: list, tree) -> np.ndarray:
        """Medusa-style batched tree proposal: ONE greedy chain pass (the
        resync verify + k-1 decode steps chain mode runs), keeping each
        position's top-b tokens. Depth d's candidates are the top-b_d tokens
        of the chain's logits after d-1 argmax tokens; rank 0 is the argmax,
        so the all-rank-0 path is the chain proposal. Children of non-argmax
        branches are conditioned on the argmax prefix (the Medusa
        approximation). → (max_slots, tree.n_draft) int32 node tokens."""
        b = self.max_slots
        k = tree.k
        row, cache, _ = self._resync(contexts, k + 1)
        # cand[d-1]: (B, branching[d-1]) on the device; column 0 is the
        # argmax chain token
        cand: list = [top_candidates(row, int(tree.branching[0])).to(torch.int32)]
        for d in range(2, k + 1):
            step_logits, cache = self._decode(self.params, cache, cand[-1][:, :1])
            cand.append(top_candidates(step_logits, int(tree.branching[d - 1])).to(torch.int32))
        self.cache = rollback_cache(cache, self._dev(self.synced))
        # one host copy: every depth's candidates side by side
        flat = torch.cat(cand, dim=1).cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(tree.branching[:k])])
        cand = [flat[:, offs[d]:offs[d + 1]] for d in range(k)]
        out = np.zeros((b, tree.n_draft), np.int32)
        for j in range(1, tree.n_nodes):
            d = int(tree.depths[j])
            out[:, j - 1] = cand[d - 1][:, int(tree.ranks[j])]
        return out
