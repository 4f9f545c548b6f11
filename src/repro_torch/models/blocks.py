"""Pre-norm residual blocks (ported from `repro.models.blocks`): the
attention mixer plus the dense FFN. The other mixers (MLA, SSM), MoE FFNs
and cross-attention are not ported yet."""
from __future__ import annotations

import torch
from torch import nn

from .attention import attn_apply, attn_cache_init, attn_init
from .common import rmsnorm_apply, rmsnorm_init
from .moe import dense_ffn_apply, dense_ffn_init


class Block(nn.Module):
    def __init__(self, mixer_norm, mixer, ffn_norm, ffn):
        super().__init__()
        self.mixer_norm, self.mixer = mixer_norm, mixer
        self.ffn_norm, self.ffn = ffn_norm, ffn


def _check_spec(spec) -> None:
    if spec.mixer != "attn" or spec.ffn != "dense" or spec.cross_attn:
        raise NotImplementedError(
            f"layer {spec} is not ported yet: repro_torch has the attention "
            "mixer with the dense FFN only"
        )


def block_init(cfg, spec, *, generator, device) -> Block:
    _check_spec(spec)
    kw = dict(generator=generator, device=device)
    return Block(rmsnorm_init(cfg.d_model, device), attn_init(cfg, spec, **kw),
                 rmsnorm_init(cfg.d_model, device),
                 dense_ffn_init(cfg, spec.d_ff or cfg.d_ff, **kw))


def block_cache_init(cfg, spec, batch: int, max_len: int, dtype, device) -> dict:
    _check_spec(spec)
    return attn_cache_init(cfg, spec, batch, max_len, dtype, device)


def block_apply(p: Block, x: torch.Tensor, *, cfg, spec, mode: str = "serve",
                cache: dict | None = None, verify: bool = False, tree=None,
                prefill_resume: bool = False):
    """→ (x, new_cache). `prefill_resume` selects the MLA mixer's chunked
    prefill read; the attention mixer reads the same way either way, so it
    has no effect here (as in the JAX package)."""
    h = rmsnorm_apply(p.mixer_norm, x, cfg.norm_eps)
    y, new_cache = attn_apply(p.mixer, h, cfg=cfg, spec=spec, mode=mode, cache=cache,
                              verify=verify, tree=tree)
    x = x + y
    hf = rmsnorm_apply(p.ffn_norm, x, cfg.norm_eps)
    return x + dense_ffn_apply(p.ffn, hf, mode), new_cache
