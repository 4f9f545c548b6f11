"""Encoder-decoder (Whisper-style) built from the same blocks (ported from
`repro.models.encdec`).

The audio conv frontend is a stub, as in the JAX package: the model takes
precomputed frame embeddings (B, S_enc, d_model), adds fixed sinusoidal
positions and runs a bidirectional encoder stack. The decoder is the `LM`
whose layers carry cross-attention to the encoder output; a prefill
computes each layer's cross K/V into the cache and decode steps reuse
them.

`EncDec` holds the encoder (its layers and final norm) and the decoder;
its parameter names start with "encoder." and "decoder.", the JAX pytree's
``{"encoder": {"stages", "final_norm"}, "decoder": ...}``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec

from .blocks import block_init
from .common import rmsnorm_apply, rmsnorm_init, torch_dtype
from .decoder import LM, init_lm, layers_apply, lm_loss


class Encoder(nn.Module):
    def __init__(self, layers, final_norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


class EncDec(nn.Module):
    def __init__(self, encoder: Encoder, decoder: LM):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder


def encoder_specs(cfg) -> tuple[LayerSpec, ...]:
    # no RoPE (sinusoidal absolute positions), full bidirectional attention
    return tuple(LayerSpec(mixer="attn", rope_theta=0.0, ffn="dense")
                 for _ in range(cfg.enc_layers))


def sinusoid_positions(s: int, d: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(s, d): sin of the angles, then their cos. The frequency step
    log(10000) / d, the exp and the angles are f32, as in the JAX package
    (a Python-float log would round the step in f64 first), then cast to
    `dtype`."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    step = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device)) / d
    ang = pos * torch.exp(-dim * step)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def encdec_init(cfg, generator: torch.Generator, *, device=None) -> EncDec:
    """Random weights drawn from `generator`, on its device (or `device`,
    "meta" for shapes alone): the encoder's layers, then the decoder
    (`init_lm`); dense "qw" linears, to pack with `pack_params` before
    serving."""
    device = resolve_device(generator.device if device is None else device)
    layers = [block_init(cfg, spec, generator=generator, device=device)
              for spec in encoder_specs(cfg)]
    return EncDec(Encoder(layers, rmsnorm_init(cfg.d_model, device)),
                  init_lm(cfg, generator, device=device))


def encode(model: EncDec, frames: torch.Tensor, cfg, *, mode: str = "train") -> torch.Tensor:
    """frames: (B, S_enc, d_model) stub embeddings → the encoder output,
    (B, S_enc, d_model) in the model's dtype."""
    _, s, d = frames.shape
    dtype = torch_dtype(cfg)
    x = frames.to(dtype) + sinusoid_positions(s, d, dtype, device=frames.device)
    x, _, _ = layers_apply(model.encoder.layers, encoder_specs(cfg), x, cfg=cfg, mode=mode,
                           causal=False)
    return rmsnorm_apply(model.encoder.final_norm, x, cfg.norm_eps)


def encdec_loss(model: EncDec, frames: torch.Tensor, tokens: torch.Tensor,
                labels: torch.Tensor, cfg, *, mode: str = "train",
                loss_mask: torch.Tensor | None = None):
    """The decoder's chunked CE over `tokens` attending the encoded
    `frames`. → (loss, {"ce", "aux", "tokens"})."""
    enc_out = encode(model, frames, cfg, mode=mode)
    return lm_loss(model.decoder, tokens, labels, cfg, mode=mode, enc_out=enc_out,
                   loss_mask=loss_mask)
