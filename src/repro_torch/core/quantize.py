"""Quantization: BitNet-b1.58 absmean ternary weights + per-token int8
activations (ported from `repro.core.quantize`; the STE fake-quants of the
training path are not ported yet).

    w_scale = mean(|W|) + eps      (per output channel or per tensor)
    W_t     = clip(round(W / w_scale), -1, 1)

    a_scale[n] = max(max_k |A[k, n]|, eps) / 127
    A_q        = clip(round(A / a_scale), -127, 127)  int8

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
quantizers divide by the scale (never multiply by a reciprocal), so both
packages produce the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-6
Q_MAX = 127.0


class TernaryWeight(NamedTuple):
    values: torch.Tensor  # int8 ternary, same shape as source weight
    scale: torch.Tensor   # f32, per-channel (M,) or scalar ()


def ternary_quantize(w: torch.Tensor, per_channel: bool = True) -> TernaryWeight:
    """Absmean ternary quantization (BitNet b1.58). w: (..., M, K) float."""
    w = w.to(torch.float32)
    if per_channel:
        scale = w.abs().mean(-1) + EPS                      # (..., M)
        t = torch.round(w / scale[..., None])
    else:
        scale = w.abs().mean((-2, -1)) + EPS                # (...,)
        t = torch.round(w / scale[..., None, None])
    t = t.clamp(-1, 1)
    return TernaryWeight(t.to(torch.int8), scale)


def act_token_scale(a: torch.Tensor) -> torch.Tensor:
    """Per-token scale for a token-minor (K, N) activation → (N,) f32.

    The single definition of the mpGeMM quantizer scale: the fused kernels
    take it as an input and quantize tile by tile, the plain versions and
    the oracle use it directly, so every path rounds identically."""
    amax = a.to(torch.float32).abs().amax(0)
    return torch.clamp_min(amax, EPS) / Q_MAX


def act_quant_tokens(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialized per-token int8 quantization of a token-minor (K, N)
    activation → (a_q int8 (K, N), a_scale f32 (N,))."""
    a = a.to(torch.float32)
    scale = act_token_scale(a)
    q = torch.round(a / scale[None, :]).clamp(-Q_MAX, Q_MAX).to(torch.int8)
    return q, scale
