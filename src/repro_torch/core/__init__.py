"""The paper's contribution in plain PyTorch (ported from `repro.core`):
packing and quantization numerics, Algorithm 1 (`vlut`) and the baseline
methods it is compared against (`baselines`)."""
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
from .vlut import (
    lookup_accumulate,
    max_block_int16,
    precompute_lut,
    precompute_lut_naive,
    precompute_lut_topological,
    vlut_gemm,
)
from .baselines import (
    dense_gemm_f32,
    lut_gemm_auto,
    mad_gemm,
    mad_gemm_int8,
    scalar_lut_gemm,
)

__all__ = [
    "GROUP_SIZES", "PackedWeight", "pack_group_sizes", "pack_ternary",
    "pack_weight", "sign_matrix", "unpack_ternary",
    "EPS", "Q_MAX", "QuantizedActivation", "TernaryWeight", "act_quant_int8",
    "act_quant_tokens", "act_token_scale", "fake_act_quant", "fake_ternary",
    "fake_ternary_cols", "ternary_dequantize", "ternary_quantize",
    "lookup_accumulate", "max_block_int16", "precompute_lut",
    "precompute_lut_naive", "precompute_lut_topological", "vlut_gemm",
    "dense_gemm_f32", "lut_gemm_auto", "mad_gemm", "mad_gemm_int8", "scalar_lut_gemm",
]
