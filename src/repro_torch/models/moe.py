"""Feed-forward layers (ported from `repro.models.moe`): only the dense
SwiGLU FFN so far; the routed MoE layers are not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import linear_apply, linear_init


class DenseFFN(nn.Module):
    def __init__(self, w1: nn.Module, w3: nn.Module, w2: nn.Module):
        super().__init__()
        self.w1, self.w3, self.w2 = w1, w3, w2


def dense_ffn_init(cfg, d_ff: int | None = None, *, generator, device) -> DenseFFN:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device)
    return DenseFFN(linear_init(d, f, cfg, **kw), linear_init(d, f, cfg, **kw),
                    linear_init(f, d, cfg, **kw))


def dense_ffn_apply(p: DenseFFN, x: torch.Tensor, mode: str = "serve") -> torch.Tensor:
    h = F.silu(linear_apply(p.w1, x, mode)) * linear_apply(p.w3, x, mode)
    return linear_apply(p.w2, h, mode)
