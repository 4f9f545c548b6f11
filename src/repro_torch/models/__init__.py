"""repro_torch.models — the models of the serving and training paths,
ported from `repro.models` (attention, MLA and SSM mixers, dense and MoE FFNs,
dense and paged KV caches, chunked CE loss, the multi-token verify step and
its cache bookkeeping, and the encoder-decoder with its cross-attention)."""
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
from .encdec import EncDec, encdec_init, encdec_loss, encode, encoder_specs, sinusoid_positions
from .mla import MLA, mla_apply, mla_cache_init, mla_init
from .paged import (
    POOL_KEYS,
    compact_paged_block,
    gather_page,
    page_phys,
    page_scatter,
    page_view,
    restore_page,
    scrub_pages,
    set_block_tables,
)
from .ssm import SSM, ssm_apply, ssm_cache_init, ssm_init

__all__ = [
    "linear_apply", "rmsnorm_apply", "rope", "pack_params", "LM", "compress_layout",
    "decode_step", "init_cache", "init_lm", "stacked_shapes",
    "lm_hidden", "lm_logits", "lm_loss", "prefill", "prefill_bucket",
    "prefill_into_slot", "rollback_cache", "scatter_slot_cache",
    "verify_step", "reset_slot_idx", "compact_tree_cache",
    "MLA", "mla_apply", "mla_cache_init", "mla_init",
    "POOL_KEYS", "page_phys", "page_scatter", "page_view", "set_block_tables",
    "scrub_pages", "compact_paged_block", "gather_page", "restore_page",
    "SSM", "ssm_apply", "ssm_cache_init", "ssm_init",
    "EncDec", "encdec_init", "encdec_loss", "encode", "encoder_specs", "sinusoid_positions",
]
