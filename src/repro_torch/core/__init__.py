"""Packing and quantization numerics (ported from `repro.core`)."""
from .packing import (
    GROUP_SIZES,
    PackedWeight,
    pack_group_sizes,
    pack_ternary,
    pack_weight,
    sign_matrix,
    unpack_ternary,
)
from .quantize import (
    EPS,
    Q_MAX,
    QuantizedActivation,
    TernaryWeight,
    act_quant_int8,
    act_quant_tokens,
    act_token_scale,
    fake_act_quant,
    fake_ternary,
    fake_ternary_cols,
    ternary_dequantize,
    ternary_quantize,
)

__all__ = [
    "GROUP_SIZES", "PackedWeight", "pack_group_sizes", "pack_ternary",
    "pack_weight", "sign_matrix", "unpack_ternary",
    "EPS", "Q_MAX", "QuantizedActivation", "TernaryWeight", "act_quant_int8",
    "act_quant_tokens", "act_token_scale", "fake_act_quant", "fake_ternary",
    "fake_ternary_cols", "ternary_dequantize", "ternary_quantize",
]
