"""Decoder-only LM and its serving entry points (ported from
`repro.models.decoder`).

The JAX package scans stacked "stages" of repeated layers; here the layers
are an `nn.ModuleList` walked by a Python loop, and the KV cache is a list
with one dict per layer. Serving entry points keep the JAX names:
`init_cache`, `prefill`, `decode_step`, `prefill_bucket`,
`prefill_into_slot`, `scatter_slot_cache`, `rollback_cache`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device

from .blocks import block_apply, block_cache_init, block_init
from .common import Linear, embed_apply, embed_init, linear_init, rmsnorm_apply, rmsnorm_init


class LM(nn.Module):
    def __init__(self, embed, layers, final_norm, head=None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.head = head


def init_lm(cfg, generator: torch.Generator) -> LM:
    """Random weights drawn from `generator`, on its device (dense "qw"
    linears: pack them with `pack_params` before serving)."""
    device = resolve_device(generator.device)
    kw = dict(generator=generator, device=device)
    head = (None if cfg.tie_embeddings
            else linear_init(cfg.d_model, cfg.vocab, cfg, quant=False, **kw))
    return LM(
        embed_init(cfg.vocab, cfg.d_model, cfg, **kw),
        [block_init(cfg, spec, **kw) for spec in cfg.layer_specs()],
        rmsnorm_init(cfg.d_model, device),
        head,
    )


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> list[dict]:
    """One dense cache dict per layer. The default dtype is bf16 whatever
    the model's dtype, as in the JAX package (decode attention then runs in
    bf16, and the `wo` BitLinear sees bf16 activations)."""
    device = resolve_device(device)
    return [block_cache_init(cfg, spec, batch, max_len, dtype, device)
            for spec in cfg.layer_specs()]


def lm_hidden(model: LM, tokens: torch.Tensor, cfg, *, cache: list | None = None):
    """tokens: int (B, S) → (hidden (B, S, d), new_cache)."""
    x = embed_apply(model.embed, tokens, cfg)
    new_cache = []
    for i, (layer, spec) in enumerate(zip(model.layers, cfg.layer_specs())):
        x, nc = block_apply(layer, x, cfg=cfg, spec=spec,
                            cache=cache[i] if cache is not None else None)
        new_cache.append(nc)
    x = rmsnorm_apply(model.final_norm, x, cfg.norm_eps)
    return x, (new_cache if cache is not None else None)


def _head_matmul(model: LM, h: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits against the tied table (or the untied head). A plain f32
    matmul: callers on CUDA keep TF32 off (torch's default)."""
    w = (model.head.w if isinstance(model.head, Linear) else model.embed.table.T)
    return h.to(torch.float32) @ w.to(torch.float32)


def prefill(model: LM, tokens: torch.Tensor, cache: list, cfg):
    """Run the prompt through the model, filling the cache.
    → (last-position logits (B, V), new_cache)."""
    h, new_cache = lm_hidden(model, tokens, cfg, cache=cache)
    return _head_matmul(model, h[:, -1:, :], cfg)[:, 0], new_cache


def decode_step(model: LM, tokens: torch.Tensor, cache: list, cfg):
    """One decode step. tokens: (B, 1) int → (logits (B, V), new_cache)."""
    h, new_cache = lm_hidden(model, tokens, cfg, cache=cache)
    return _head_matmul(model, h[:, -1:, :], cfg)[:, 0], new_cache


def prefill_bucket(n: int, max_len: int | None = None) -> int:
    """Pad prompt lengths to 16-multiples (left padding gives pad tokens
    negative positions, masked everywhere), clamped to `max_len` so
    positions never alias modulo the cache length."""
    b = max(16, (n + 15) // 16 * 16)
    if max_len is not None:
        b = min(b, max_len)
    return max(b, n)


def prefill_into_slot(model: LM, cache: list, slot: int, prompt, cfg, *,
                      max_len: int):
    """Admit one prompt into batched slot `slot`: a B=1 bucketed,
    left-padded prefill into a fresh cache (pad positions negative, set via
    `rollback_cache`), then copied into the slot of the batched cache.
    → (logits (1, V), cache, padded_len)."""
    device = cache[0]["k"].device
    n = len(prompt)
    bucket = prefill_bucket(n, max_len)
    single = init_cache(cfg, 1, max_len, device=device)
    if bucket != n:
        single = rollback_cache(single, torch.tensor([n - bucket], dtype=torch.int32, device=device))
    tok = np.zeros((1, bucket), np.int32)
    tok[0, bucket - n:] = prompt
    logits, single = prefill(model, torch.from_numpy(tok).to(device), single, cfg)
    return logits, scatter_slot_cache(cache, single, slot), bucket


def scatter_slot_cache(full_cache: list, single_cache: list, slot: int) -> list:
    """Copy a B=1 cache into batched slot `slot`, in place."""
    for full, one in zip(full_cache, single_cache):
        for key, leaf in full.items():
            leaf[slot:slot + 1] = one[key].to(leaf.dtype)
    return full_cache


def rollback_cache(cache: list, new_idx: torch.Tensor) -> list:
    """Set every per-slot cache write position to `new_idx` ((B,) int).
    Entries past the new idx keep stale K/V, but their recorded positions
    exceed every later query position until overwritten."""
    return [dict(layer, idx=new_idx.to(torch.int32).expand_as(layer["idx"]).clone())
            for layer in cache]
