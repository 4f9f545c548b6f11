"""Quantization: BitNet-b1.58 absmean ternary weights + per-token int8
activations (ported from `repro.core.quantize`), with the straight-through
fake-quants (STE) of the QAT training path.

    w_scale = mean(|W|) + eps      (per output channel or per tensor)
    W_t     = clip(round(W / w_scale), -1, 1)

    a_scale[n] = max(max_k |A[k, n]|, eps) / 127
    A_q        = clip(round(A / a_scale), -127, 127)  int8

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
quantizers divide by the scale (never multiply by a reciprocal), so both
packages produce the same bits. Both activation scales, the mpGeMM
`act_token_scale` and the QAT `act_quant_int8`, are the jitted JAX form, a
product with 1/127 rounded to f32 (`INV_Q_MAX`): the JAX package runs both
under `jit` (its mpGeMM entries and its train step), where XLA rewrites the
division by 127; eager JAX divides and differs by one ulp in some scales.

The STE form is ``w + (wq - w).detach()``: forward ``wq`` (up to the
rounding of the two adds in the working dtype, as in JAX), backward the
identity.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


#: 1/127 rounded to f32. Under `jax.jit`, XLA rewrites the JAX package's
#: ``max(amax, eps) / 127`` (a division by a constant) into a product with
#: this reciprocal, which differs from the true quotient by one ulp for some
#: values; the activation scales follow the jitted form, the one every JAX
#: mpGeMM path and the JAX train step run.
INV_Q_MAX = float(np.float32(1.0) / np.float32(Q_MAX))


def act_token_scale(a: torch.Tensor) -> torch.Tensor:
    """Per-token scale for a token-minor (K, N) activation → (N,) f32.

    The single definition of the mpGeMM quantizer scale: the fused kernels
    take it as an input and quantize tile by tile, the plain versions, the
    unfused pipeline, `vlut_gemm` and the oracle use it directly, so every
    path rounds identically — and as the jitted JAX package does
    (`INV_Q_MAX`)."""
    amax = a.to(torch.float32).abs().amax(0)
    return torch.clamp_min(amax, EPS) * INV_Q_MAX


def act_quant_tokens(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialized per-token int8 quantization of a token-minor (K, N)
    activation → (a_q int8 (K, N), a_scale f32 (N,))."""
    a = a.to(torch.float32)
    scale = act_token_scale(a)
    q = torch.round(a / scale[None, :]).clamp(-Q_MAX, Q_MAX).to(torch.int8)
    return q, scale


def ternary_dequantize(tw: TernaryWeight) -> torch.Tensor:
    scale = tw.scale[..., None] if tw.scale.ndim == tw.values.ndim - 1 else tw.scale
    return tw.values.to(torch.float32) * scale


def fake_ternary(w: torch.Tensor, per_channel: bool = True) -> torch.Tensor:
    """QAT fake-quant with straight-through estimator: forward =
    dequant(quant(w)), backward = identity."""
    wq = ternary_dequantize(ternary_quantize(w, per_channel)).to(w.dtype)
    return w + (wq - w).detach()


def fake_ternary_cols(w: torch.Tensor) -> torch.Tensor:
    """STE fake-quant of a (..., K, M) weight with per-output-channel (M)
    absmean scales, computed without transposes."""
    wf = w.to(torch.float32)
    scale = wf.abs().mean(-2, keepdim=True) + EPS                    # (...,1,M)
    t = torch.round(wf / scale).clamp(-1, 1)
    wq = (t * scale).to(w.dtype)
    return w + (wq - w).detach()


class QuantizedActivation(NamedTuple):
    values: torch.Tensor  # int8
    scale: torch.Tensor   # f32, per token, broadcastable against values


def act_quant_int8(a: torch.Tensor, axis: int = -1) -> QuantizedActivation:
    """Symmetric per-token int8 quantization; `axis` is the feature axis that
    is reduced (each token keeps its own scale). The scale is the jitted JAX
    form (`INV_Q_MAX`), as the JAX train step computes it."""
    a = a.to(torch.float32)
    amax = a.abs().amax(axis, keepdim=True)
    scale = torch.clamp_min(amax, EPS) * INV_Q_MAX
    q = torch.round(a / scale).clamp(-Q_MAX, Q_MAX).to(torch.int8)
    return QuantizedActivation(q, scale)


def fake_act_quant(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """STE int8 activation fake-quant (training path). ``deq`` is computed
    in f32 and cast to ``a.dtype``; the two adds then round in ``a.dtype``
    (in bf16 the result is not bit-equal to ``deq``), as in JAX."""
    q = act_quant_int8(a, axis)
    deq = (q.values.to(torch.float32) * q.scale).to(a.dtype)
    return a + (deq - a).detach()
