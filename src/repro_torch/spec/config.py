"""SpecConfig — the speculative-decoding knobs `Engine(spec=...)` consumes (a
copy of `repro.spec.config`; `build` makes the port's drafters)."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class SpecConfig:
    """Configuration for speculative decoding.

    k            draft tokens proposed per verify step; each step runs the
                 target once over (B, k+1) tokens and emits 1..k+1 of them.
    drafter      'ngram' (prompt-lookup, no extra weights) | 'model' (a
                 smaller ternary draft model).
    ngram_max/min  longest/shortest suffix n-gram the NgramDrafter matches.
    draft_params / draft_cfg  the draft model (a packed `models.LM`) and its
                 ModelConfig (drafter='model' only). Passing the target's
                 own model is the always-accept oracle — useful for
                 benchmarking the verification ceiling.

    Adaptive per-slot draft length (all shapes stay static — one (B, k+1)
    verify shape serves every mixture of slot speeds):

    adaptive_k   track a per-slot acceptance-rate EWMA and draft only
                 k_eff = k_policy(ewma) real tokens per slot, padding the
                 row's tail with masked drafts that acceptance never runs
                 past. Cold slots (ewma < skip_below) skip drafting entirely
                 (k_eff=0: a plain last-token decode row), recovering plain-
                 decode cost on adversarial contexts.
    accept_ewma  EWMA decay: after each verify step a drafting slot updates
                 ewma ← accept_ewma·ewma + (1-accept_ewma)·(n_acc/k_eff).
                 Slots start optimistic (ewma=1.0) on admission.
    k_min        floor on k_eff for slots that do draft (and the probe
                 length for cold slots).
    skip_below   acceptance EWMA below which a slot stops drafting.
    probe_every  a cold slot re-probes with k_min drafts after this many
                 consecutive skipped steps, so it can warm back up.

    Stochastic drafting (drafter='model' only):

    stochastic   with temperature>0 serving, the ModelDrafter samples its
                 proposals at the serving temperature and returns the
                 per-position draft distributions; the engine feeds them to
                 `accept_speculative(draft_probs=...)` so emitted tokens are
                 exact target-model samples with the draft model's full
                 (not just argmax) probability mass counted toward
                 acceptance. With temperature<=0 drafting stays greedy.

    Tree-structured verification (Medusa/SpecInfer-style):

    tree         per-depth branching factors (b1, b2, ...) of a draft
                 *tree* of depth k: the drafter proposes its top-b_d
                 candidates at each of the first len(tree) depths (a chain
                 continuation per leaf afterwards), the engine flattens the
                 tree into ONE (B, n_nodes) verify pass — the Vec-LUT
                 kernels see M = n_nodes parallel tokens per slot, well past
                 the chain mode's M = k+1 — and acceptance keeps the longest
                 accepted root-to-leaf path (see spec.tree.DraftTree for the
                 flattening order and serve.sampling.accept_tree for the
                 rule). None (the default) is chain mode, bit-identical to
                 pre-tree behavior. Greedy tree output stays token-for-token
                 identical to plain decode. tree is mutually exclusive with
                 adaptive_k and stochastic (per-slot row padding and exact
                 multi-candidate rejection sampling are chain-mode
                 machinery; see accept_tree's TODO).
    """
    k: int = 4
    drafter: str = "ngram"
    ngram_max: int = 3
    ngram_min: int = 1
    draft_params: Any = None
    draft_cfg: Any = None
    # adaptive per-slot draft length
    adaptive_k: bool = False
    accept_ewma: float = 0.75
    k_min: int = 1
    skip_below: float = 0.125
    probe_every: int = 8
    # stochastic (sampled) ModelDrafter proposals
    stochastic: bool = False
    # tree-structured multi-candidate verification
    tree: tuple | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")
        if self.drafter not in ("ngram", "model"):
            raise ValueError(
                f"SpecConfig.drafter must be 'ngram' or 'model', got {self.drafter!r}"
            )
        if self.drafter == "model" and (
            self.draft_params is None or self.draft_cfg is None
        ):
            raise ValueError("drafter='model' needs draft_params and draft_cfg")
        if not 0.0 <= self.accept_ewma < 1.0:
            raise ValueError(
                f"SpecConfig.accept_ewma must be in [0, 1), got {self.accept_ewma}"
            )
        if not 1 <= self.k_min <= self.k:
            raise ValueError(
                f"SpecConfig.k_min must be in [1, k={self.k}], got {self.k_min}"
            )
        if not 0.0 <= self.skip_below <= 1.0:
            raise ValueError(
                f"SpecConfig.skip_below must be in [0, 1], got {self.skip_below}"
            )
        if self.probe_every < 1:
            raise ValueError(
                f"SpecConfig.probe_every must be >= 1, got {self.probe_every}"
            )
        if self.stochastic and self.drafter != "model":
            raise ValueError(
                "SpecConfig.stochastic needs drafter='model'; deterministic "
                "drafters are already exact as one-hot proposals"
            )
        if self.tree is not None:
            if self.adaptive_k:
                raise ValueError(
                    "SpecConfig.tree is incompatible with adaptive_k: per-slot "
                    "k_eff row padding is chain-mode machinery"
                )
            if self.stochastic:
                raise ValueError(
                    "SpecConfig.tree is incompatible with stochastic: exact "
                    "multi-candidate rejection sampling is not implemented "
                    "(accept_tree falls back to greedy path matching at "
                    "temperature>0; see its TODO)"
                )
            self.tree = tuple(int(b) for b in self.tree)
            # validates factors, depth <= k, and the flattened node cap
            from .tree import build_tree

            build_tree(self.k, self.tree)

    def k_policy(self, ewma: float, skip_streak: int = 0) -> int:
        """Effective draft length for a slot whose acceptance EWMA is `ewma`.

        Warm slots draft proportionally to their acceptance (clamped to
        [k_min, k]); cold slots (ewma < skip_below) draft nothing — their
        verify row is a plain last-token decode — except for a k_min probe
        after `probe_every` consecutive skips so acceptance can recover."""
        if not self.adaptive_k:
            return self.k
        if ewma < self.skip_below:
            return self.k_min if skip_streak >= self.probe_every else 0
        return min(self.k, max(self.k_min, int(round(ewma * self.k))))

    def tree_struct(self):
        """The static DraftTree layout for `tree`, or None in chain mode."""
        if self.tree is None:
            return None
        from .tree import build_tree

        return build_tree(self.k, self.tree)

    def build(self, *, max_slots: int, max_len: int, device="cuda"):
        """Instantiate the configured drafter for an engine's slot layout,
        its cache on `device`."""
        from .drafter import NgramDrafter
        from .model_drafter import ModelDrafter

        if self.drafter == "ngram":
            return NgramDrafter(max_n=self.ngram_max, min_n=self.ngram_min)
        return ModelDrafter(
            self.draft_params, self.draft_cfg,
            max_slots=max_slots, max_len=max_len, device=device,
        )
