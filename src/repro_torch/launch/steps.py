"""Serving step builders (ported from `repro.launch.steps`): one greedy
prefill step and one greedy decode step, for a decoder-only `LM` or an
encoder-decoder `EncDec`. They are the enc-dec model's serving path: the
`serve.Engine` takes decoder-only models only.

    prefill = make_prefill_step(cfg)
    tok, cache = prefill(model, init_cache(cfg, B, max_len, enc_len=S_enc),
                         {"tokens": prompts, "frames": frames})
    decode = make_decode_step(cfg)
    tok, cache = decode(model, cache, tok[:, None])

An enc-dec prefill encodes the frames (mode "serve"), runs the decoder's
prefill with the encoder output (each layer stores its cross K/V in the
cache), and takes the argmax; decode steps reuse the cached cross K/V.
Each step runs without autograd on `device` (the card unless asked for the
CPU): the batch's tensors are moved there, and the model and the cache
must already be there. The JAX module's mesh half (the train step, the
abstract state and input specs of the dry run) comes with the port of
`dist.sharding`; without a mesh its activation constraints are the
identity, so these steps leave them out.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step as model_decode
from repro_torch.models import encode
from repro_torch.models import prefill as model_prefill


def make_prefill_step(cfg: ModelConfig, *, device="cuda"):
    """→ ``prefill_step(model, cache, batch) -> (next tokens (B,) int32,
    new_cache)``; batch: "tokens" (B, S) int and, for an enc-dec model,
    "frames" (B, S_enc, d_model)."""
    is_encdec = cfg.family == "encdec"
    device = resolve_device(device)

    @torch.no_grad()
    def prefill_step(model, cache, batch):
        tokens = batch["tokens"].to(device)
        enc_out, dec = None, model
        if is_encdec:
            enc_out = encode(model, batch["frames"].to(device), cfg, mode="serve")
            dec = model.decoder
        logits, new_cache = model_prefill(dec, tokens, cache, cfg, enc_out=enc_out)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, device="cuda"):
    """→ ``decode_step(model, cache, tokens (B, 1)) -> (next tokens (B,)
    int32, new_cache)``."""
    is_encdec = cfg.family == "encdec"
    device = resolve_device(device)

    @torch.no_grad()
    def decode_step(model, cache, tokens):
        dec = model.decoder if is_encdec else model
        logits, new_cache = model_decode(dec, tokens.to(device), cache, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_cache

    return decode_step
