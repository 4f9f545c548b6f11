"""Offline weight transformation (ported from `repro.models.convert`):
every quantizable linear (`QLinear`, dense (K, M) weight, or (E, K, M)
stacked experts) becomes a `PackedLinear` — absmean ternary quantization
per output channel, then trit-code packing at 1.6/2.0 bits per weight
along the last axis."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.packing import PackedWeight, pack_weight
from repro_torch.core.quantize import ternary_quantize

from .common import PackedLinear, QLinear

#: f32 elements quantized at once: stacked experts are packed a few at a
#: time, so a full-width stack never passes through f32 whole
PACK_ELEMENTS = 1 << 28


def _pack(qw: torch.Tensor, mode: str) -> PackedWeight:
    w = qw.to(torch.float32).swapaxes(-1, -2)                        # (..., M, K)
    tw = ternary_quantize(w, per_channel=True)
    return pack_weight(tw.values, tw.scale, mode=mode)


@torch.no_grad()
def pack_params(model: nn.Module, cfg) -> nn.Module:
    """Replace every QLinear of `model` by its PackedLinear, IN PLACE (the
    dense weights are released as they are packed); returns `model`. The
    scales are per output channel, so packing stacked experts in chunks
    gives each expert's bytes."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, QLinear):
                qw = child.qw
                if qw.ndim == 3:
                    step = (len(qw) if qw.device.type == "meta"
                            else max(1, PACK_ELEMENTS // qw[0].numel()))
                    parts = [_pack(qw[i:i + step], cfg.pack_mode) for i in range(0, len(qw), step)]
                    pw = PackedWeight(*(torch.cat([getattr(p, f) for p in parts])
                                        for f in ("packed5", "packed4", "scale")), K=parts[0].K)
                else:
                    pw = _pack(qw, cfg.pack_mode)
                setattr(parent, name, PackedLinear(pw))
    return model

