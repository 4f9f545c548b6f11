"""repro_torch.models — the GQA decoder of the serving path, ported from
`repro.models` (attention mixer, dense FFN, dense KV cache)."""
from .common import linear_apply, rmsnorm_apply, rope
from .convert import pack_params
from .decoder import (
    LM,
    decode_step,
    init_cache,
    init_lm,
    lm_hidden,
    prefill,
    prefill_bucket,
    prefill_into_slot,
    rollback_cache,
    scatter_slot_cache,
)

__all__ = [
    "linear_apply", "rmsnorm_apply", "rope", "pack_params", "LM", "decode_step", "init_cache", "init_lm",
    "lm_hidden", "prefill", "prefill_bucket",
    "prefill_into_slot", "rollback_cache", "scatter_slot_cache",
]
