"""repro_torch.spec — speculative decoding (ported from `repro.spec`).

Plain decode runs the target one token per slot per tick, so every mpGeMM
launch sees N = max_slots tokens. Speculation turns decode into draft →
verify → accept: a drafter proposes K tokens per slot, one batched
`models.verify_step` runs the target over all (B, K+1) candidates (N =
B·(K+1) per launch), and an acceptance rule keeps the longest valid prefix,
rolling the cache back past the first rejection (`models.rollback_cache`).

  * SpecConfig    the knobs: draft length `k`, the drafter, adaptive per-slot
                  draft lengths (`adaptive_k`), stochastic model drafting
                  (`stochastic`), tree verification (`tree`).
  * DraftTree     the static flattened tree layout (`build_tree`).
  * NgramDrafter  prompt lookup: no extra weights.
  * ModelDrafter  a smaller ternary model with a mirrored slot cache.

`SpecConfig`, `DraftTree`, `build_tree` and the n-gram drafter are copies of
the JAX package's numpy-only modules. Greedy speculative output is token for
token that of plain decode; at temperature > 0 Leviathan-style rejection
sampling (`serve.sampling.accept_speculative`) emits target-model samples.
"""
from .config import SpecConfig
from .drafter import Drafter, NgramDrafter
from .model_drafter import ModelDrafter
from .tree import DraftTree, build_tree

__all__ = [
    "SpecConfig", "Drafter", "NgramDrafter", "ModelDrafter",
    "DraftTree", "build_tree",
]
