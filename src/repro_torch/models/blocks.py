"""Pre-norm residual blocks (ported from `repro.models.blocks`): the
attention, MLA or SSM mixer, the enc-dec decoder's optional
cross-attention, and a dense, Mixture-of-Experts or no FFN."""
from __future__ import annotations

import torch
from torch import nn

from .attention import (
    attn_apply,
    attn_cache_init,
    attn_init,
    cross_attn_apply,
    cross_attn_init,
    cross_attn_kv,
)
from .common import rmsnorm_apply, rmsnorm_init
from .mla import mla_apply, mla_cache_init, mla_init
from .moe import dense_ffn_apply, dense_ffn_init, moe_apply, moe_init
from .ssm import ssm_apply, ssm_cache_init, ssm_init

_MIXER_INIT = {"attn": attn_init, "mla": mla_init, "ssm": ssm_init}
_CACHE_INIT = {"attn": attn_cache_init, "mla": mla_cache_init, "ssm": ssm_cache_init}


class Block(nn.Module):
    def __init__(self, mixer_norm, mixer, ffn_norm=None, ffn=None, cross_norm=None, cross=None):
        super().__init__()
        self.mixer_norm, self.mixer = mixer_norm, mixer
        self.cross_norm, self.cross = cross_norm, cross
        self.ffn_norm, self.ffn = ffn_norm, ffn


def _check_spec(spec) -> None:
    if spec.mixer not in _MIXER_INIT or spec.ffn not in ("dense", "moe", "none"):
        raise NotImplementedError(
            f"layer {spec} is not ported yet: repro_torch has the attention, "
            "MLA and SSM mixers with a dense, MoE or no FFN only"
        )


def block_init(cfg, spec, *, generator, device) -> Block:
    _check_spec(spec)
    kw = dict(generator=generator, device=device)
    mixer = _MIXER_INIT[spec.mixer](cfg, spec, **kw)
    cross = ({"cross_norm": rmsnorm_init(cfg.d_model, device), "cross": cross_attn_init(cfg, **kw)}
             if spec.cross_attn else {})
    if spec.ffn == "none":
        return Block(rmsnorm_init(cfg.d_model, device), mixer, **cross)
    ffn = (moe_init(cfg, **kw) if spec.ffn == "moe"
           else dense_ffn_init(cfg, spec.d_ff or cfg.d_ff, **kw))
    return Block(rmsnorm_init(cfg.d_model, device), mixer, rmsnorm_init(cfg.d_model, device), ffn,
                 **cross)


def block_cache_init(cfg, spec, batch: int, max_len: int, dtype, device, enc_len: int = 0,
                     page_size: int = 0, n_pages: int = 0) -> dict:
    """One layer's cache; page_size > 0 builds the paged layout. A
    cross-attention layer also holds the encoder output's keys and values
    (``xk``, ``xv``: (batch, enc_len, KV, D)), written by the prefill."""
    if page_size and spec.mixer == "ssm":
        raise ValueError(
            "ssm layers carry recurrent state, not per-position KV — there "
            "is nothing page-granular to own, so paged caching refuses them")
    _check_spec(spec)
    c = _CACHE_INIT[spec.mixer](cfg, spec, batch, max_len, dtype, device,
                                page_size=page_size, n_pages=n_pages)
    if spec.cross_attn:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def block_apply(p: Block, x: torch.Tensor, *, cfg, spec, mode: str = "serve",
                cache: dict | None = None, enc_out: torch.Tensor | None = None,
                causal: bool = True, verify: bool = False, tree=None,
                prefill_resume: bool = False):
    """→ (x, new_cache, aux_loss): aux is the MoE router loss (0 for other
    FFNs and outside training). `prefill_resume` selects the MLA mixer's
    chunked prefill read; the attention mixer reads the same way either
    way, so it does not take it (as in the JAX package).

    A cross-attention layer attends `enc_out`: with a cache, a prefill
    (enc_out given) computes the cross keys and values and stores them in
    the cache's dtype, and a decode step (enc_out None) reuses them; with
    no cache they are computed from enc_out."""
    h = rmsnorm_apply(p.mixer_norm, x, cfg.norm_eps)
    if spec.mixer == "mla":
        y, new_cache = mla_apply(p.mixer, h, cfg=cfg, spec=spec, mode=mode, cache=cache,
                                 verify=verify, tree=tree, prefill_resume=prefill_resume)
    elif spec.mixer == "ssm":
        if verify:
            raise ValueError(
                "multi-token verification needs a rollbackable cache; "
                "ssm mixers carry recurrent state and cannot be verified")
        y, new_cache = ssm_apply(p.mixer, h, cfg=cfg, spec=spec, mode=mode, cache=cache)
    else:
        y, new_cache = attn_apply(p.mixer, h, cfg=cfg, spec=spec, mode=mode, cache=cache,
                                  causal=causal, verify=verify, tree=tree)
    x = x + y

    if spec.cross_attn:
        hc = rmsnorm_apply(p.cross_norm, x, cfg.norm_eps)
        if cache is not None:
            new_cache = dict(new_cache or {})
            if enc_out is not None:         # prefill: compute and store the cross K/V
                xk, xv = cross_attn_kv(p.cross, enc_out, cfg, mode)
                new_cache["xk"] = xk.to(cache["xk"].dtype)
                new_cache["xv"] = xv.to(cache["xv"].dtype)
            else:                           # decode: reuse the cached cross K/V
                new_cache["xk"], new_cache["xv"] = cache["xk"], cache["xv"]
            xk, xv = new_cache["xk"], new_cache["xv"]
        else:
            xk, xv = cross_attn_kv(p.cross, enc_out, cfg, mode)
        x = x + cross_attn_apply(p.cross, hc, xk, xv, cfg, mode)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn != "none":
        hf = rmsnorm_apply(p.ffn_norm, x, cfg.norm_eps)
        if spec.ffn == "moe":
            y, aux = moe_apply(p.ffn, hf, cfg, mode)
        else:
            y = dense_ffn_apply(p.ffn, hf, mode)
        x = x + y
    return x, new_cache, aux
