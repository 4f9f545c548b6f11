"""repro_torch.models — the GQA decoder of the serving and training paths,
ported from `repro.models` (attention mixer, dense FFN, dense KV cache,
chunked CE loss, the multi-token verify step and its cache bookkeeping)."""
from .common import linear_apply, rmsnorm_apply, rope
from .convert import pack_params
from .decoder import (
    LM,
    compact_tree_cache,
    compress_layout,
    decode_step,
    init_cache,
    init_lm,
    lm_hidden,
    lm_logits,
    lm_loss,
    prefill,
    prefill_bucket,
    prefill_into_slot,
    reset_slot_idx,
    rollback_cache,
    scatter_slot_cache,
    stacked_shapes,
    verify_step,
)

__all__ = [
    "linear_apply", "rmsnorm_apply", "rope", "pack_params", "LM", "compress_layout",
    "decode_step", "init_cache", "init_lm", "stacked_shapes",
    "lm_hidden", "lm_logits", "lm_loss", "prefill", "prefill_bucket",
    "prefill_into_slot", "rollback_cache", "scatter_slot_cache",
    "verify_step", "reset_slot_idx", "compact_tree_cache",
]
