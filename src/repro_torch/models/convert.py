"""Offline weight transformation (ported from `repro.models.convert`):
every quantizable linear (`QLinear`, dense (K, M) weight, or (E, K, M)
stacked experts) becomes a `PackedLinear` — absmean ternary quantization
per output channel, then trit-code packing at 1.6/2.0 bits per weight
along the last axis."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.packing import pack_weight
from repro_torch.core.quantize import ternary_quantize

from .common import PackedLinear, QLinear


@torch.no_grad()
def pack_params(model: nn.Module, cfg) -> nn.Module:
    """Replace every QLinear of `model` by its PackedLinear, IN PLACE (the
    dense weights are released as they are packed); returns `model`."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, QLinear):
                w = child.qw.to(torch.float32).swapaxes(-1, -2)     # (..., M, K)
                tw = ternary_quantize(w, per_channel=True)
                setattr(parent, name, PackedLinear(
                    pack_weight(tw.values, tw.scale, mode=cfg.pack_mode)))
    return model

