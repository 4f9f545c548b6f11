"""Gradient compression with error feedback (ported from
`repro.dist.compression`): the trainer's ``grad_compression`` at the
gradient-accumulation boundary.

Gradients are dicts keyed by parameter name. Large leaves are compressed to
row-wise int8 `QTensor`s (the optimizer states' format), and the
quantization residual is carried in an error-feedback dict, so the signal
drains over steps instead of being lost. Small leaves (norms, biases) pass
through uncompressed; "large" is read from ``shapes`` when given (see
`optim.adamw`). The collective-side ``compressed_psum`` waits for the
port of `dist` to `torch.distributed`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.optim import QTensor, dequantize_blockwise, quantize_blockwise

#: leaves smaller than this stay uncompressed (matches optim.adamw.SMALL)
SMALL = 4096


def ef_init(grads: dict) -> dict:
    """Zero error-feedback dict shaped like the gradients (f32)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def compress_tree(grads: dict, ef: dict, shapes: dict | None = None) -> tuple[dict, dict]:
    """(grads, ef) → (compressed, new_ef).

    Per leaf: x = g + ef; large leaves become QTensor(x) with
    new_ef = x - dequant(QTensor(x)) (exact error accounting), small leaves
    pass through with zero error."""
    shapes = shapes or {}
    comp, new_ef = {}, {}
    for n, g in grads.items():
        x = g.to(torch.float32) + ef[n]
        shape = shapes.get(n, tuple(x.shape))
        if math.prod(shape) >= SMALL and len(shape) >= 1:
            q = quantize_blockwise(x)
            comp[n], new_ef[n] = q, x - dequantize_blockwise(q)
        else:
            comp[n], new_ef[n] = x, torch.zeros_like(x)
    return comp, new_ef


def decompress_tree(comp: dict) -> dict:
    """Inverse of :func:`compress_tree`'s quantization (f32 dict)."""
    return {n: dequantize_blockwise(x) if isinstance(x, QTensor) else x
            for n, x in comp.items()}
